"""Counterpart of anorag_tpu/utils/ner.py,
copied as it is with its imports renamed to anorag_tpu_torch.

EnhancedNER: typed rule-based named-entity recognition.

Parity target: upstream utils/enhanced_ner.py:7-160 (spacy-backed
there). Host-side NER is not performance-critical (SURVEY.md §2.11), so this
is a typed rule engine over the same entity classes the pipeline consumes
(PERSON, ORG, GPE, WORK_OF_ART, EVENT, DATE) with an optional spacy upgrade
when a model is locally installed.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

from anorag_tpu_torch.utils.text import normalize_entity

_DATE = re.compile(
    r"\b(?:january|february|march|april|may|june|july|august|september|october|"
    r"november|december)\s+\d{1,2}(?:,\s*\d{4})?\b|\b(1[0-9]{3}|20[0-9]{2})\b",
    re.IGNORECASE)
_QUOTED = re.compile(r'"([^"]{2,80})"|“([^”]{2,80})”')
# connectors (of/the/de/...) are infix-only: each extension segment must end
# in a capitalized word, and the connector alternation is anchored so "de"
# cannot match the first two chars of "designed" (entities never end
# mid-word or on a connector)
_CAP = re.compile(r"\b(?:[A-Z][\w'&.-]*)(?:\s+(?:(?:of|the|de|von|van|da|and|&)\s+)*[A-Z][\w'&.-]*)*")
_ORG_SUFFIX = re.compile(
    r"\b(Inc|Corp|Ltd|LLC|Labs|Institute|University|Company|Group|Records|Studios)\b")
_GPE_CUE = re.compile(r"\b(in|at|from|near|city of|capital of)\s+([A-Z][\w'-]+(?:\s+[A-Z][\w'-]+)?)")
_PERSON_TITLE = re.compile(r"\b(?:Mr|Mrs|Ms|Dr|Prof|Sir)\.?\s+([A-Z][\w'-]+(?:\s+[A-Z][\w'-]+)?)")
_EVENT_CUE = re.compile(r"\b([A-Z][\w'-]+(?:\s+[A-Z][\w'-]+)*\s+(?:War|Festival|Olympics|Award|Tour|Summit))\b")


class EnhancedNER:
    def __init__(self, use_spacy: bool = True):
        self._nlp = None
        if use_spacy:
            try:
                import spacy

                self._nlp = spacy.load("en_core_web_sm")
            except Exception:
                self._nlp = None

    def extract(self, text: str) -> List[Tuple[str, str]]:
        """[(entity, type)] with types PERSON/ORG/GPE/WORK_OF_ART/EVENT/DATE."""
        if self._nlp is not None:
            doc = self._nlp(text)
            return [(e.text, e.label_) for e in doc.ents]
        return self._rule_extract(text or "")

    def _rule_extract(self, text: str) -> List[Tuple[str, str]]:
        out: Dict[str, str] = {}

        def put(ent: str, typ: str, overwrite: bool = False):
            ent = normalize_entity(ent).rstrip(".,;:")
            if len(ent) >= 2 and (overwrite or ent not in out):
                out[ent] = typ

        for m in _DATE.finditer(text):
            put(m.group(0), "DATE")
        for m in _QUOTED.finditer(text):
            put(m.group(1) or m.group(2) or "", "WORK_OF_ART")
        for m in _EVENT_CUE.finditer(text):
            put(m.group(1), "EVENT", overwrite=True)
        for m in _PERSON_TITLE.finditer(text):
            put(m.group(1), "PERSON", overwrite=True)
        for m in _GPE_CUE.finditer(text):
            put(m.group(2), "GPE")
        for m in _CAP.finditer(text):
            ent = m.group(0)
            if normalize_entity(ent) in out:
                continue
            if _ORG_SUFFIX.search(ent):
                put(ent, "ORG")
            elif len(ent.split()) == 2 and all(w[0].isupper() for w in ent.split()):
                put(ent, "PERSON")
            else:
                put(ent, "WORK_OF_ART")
        # drop date-typed capitals that are pure years already covered
        return [(e, t) for e, t in out.items() if not (t != "DATE" and e.isdigit())]

    def extract_typed(self, text: str) -> Dict[str, List[str]]:
        grouped: Dict[str, List[str]] = {}
        for ent, typ in self.extract(text):
            grouped.setdefault(typ, []).append(ent)
        return grouped

    def entity_diff(self, original: str, summary: str) -> List[str]:
        """Entities in `original` missing from `summary` (SummaryAuditor stage 1)."""
        orig = {e.lower() for e, _ in self.extract(original)}
        summ = {e.lower() for e, _ in self.extract(summary)}
        return sorted(orig - summ)
