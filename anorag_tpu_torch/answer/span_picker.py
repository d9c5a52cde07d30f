"""Counterpart of anorag_tpu/answer/span_picker.py,
copied as it is with its imports renamed to anorag_tpu_torch.

SpanPicker: extractive answer-span selection.

Parity target: upstream answer/span_picker.py:20-543 — candidate
spans from quotes / patterns / noun-phrase-shaped capitals, a feature bank
(question type agreement, span type, context overlap, position, length), a
logistic head with calibration load and a heuristic fallback.
"""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from anorag_tpu_torch.reasoning.qa_coverage import question_type
from anorag_tpu_torch.utils.text import split_sentences, tokenize_no_stop

_QUOTED = re.compile(r'"([^"]{2,60})"|“([^”]{2,60})”')
_YEAR = re.compile(r"\b(1[0-9]{3}|20[0-9]{2})\b")
_DATE = re.compile(
    r"\b(?:january|february|march|april|may|june|july|august|september|october|"
    r"november|december)\s+\d{1,2}(?:,\s*\d{4})?\b", re.IGNORECASE)
_CAPSPAN = re.compile(r"\b(?:[A-Z][\w'.-]*)(?:\s+(?:of|the|[A-Z][\w'.-]*)){0,4}")
_NUMBER = re.compile(r"\b\d[\d,.]*\b")


_PACK_MARKER = re.compile(r"^(?:\[?P\d+\]?|[A-Za-z]+_\d+)$")


def candidate_spans(text: str) -> List[Tuple[str, str]]:
    """[(span, span_type)] from one context text. Structured-packer
    artifacts — paragraph labels like '[P8]' and note/qid tokens like
    'synth_1' — are never answer spans and are excluded."""
    out: List[Tuple[str, str]] = []
    seen = set()

    def add(span: str, stype: str):
        s = span.strip(" ,.;")
        if (s and s.lower() not in seen and 1 <= len(s) <= 60
                and not _PACK_MARKER.match(s)):
            seen.add(s.lower())
            out.append((s, stype))

    for m in _QUOTED.finditer(text):
        add(m.group(1) or m.group(2) or "", "quoted")
    for m in _DATE.finditer(text):
        add(m.group(0), "time")
    for m in _YEAR.finditer(text):
        add(m.group(0), "time")
    for m in _CAPSPAN.finditer(text):
        add(m.group(0), "entity")
    for m in _NUMBER.finditer(text):
        add(m.group(0), "number")
    return out


_TYPE_AGREEMENT = {
    ("person", "entity"): 1.0, ("place", "entity"): 0.9, ("thing", "entity"): 0.7,
    ("thing", "quoted"): 0.9, ("time", "time"): 1.0, ("thing", "number"): 0.5,
    ("manner", "number"): 0.6,
}


class SpanPicker:
    def __init__(self):
        self.w: Optional[np.ndarray] = None
        self.b: float = 0.0

    def features(self, question: str, span: str, stype: str, sentence: str,
                 position: float) -> np.ndarray:
        """22-feature bank at the reference's surface
        (upstream answer/span_picker.py:168-316): base overlap/
        position/type-agreement features, question-type x span-type
        interactions, span-shape linguistics, and in-sentence context
        cues."""
        qt = question_type(question)
        q_toks = set(tokenize_no_stop(question))
        s_toks = set(tokenize_no_stop(sentence))
        span_toks = set(tokenize_no_stop(span))
        q_low, s_low, sp_low = question.lower(), sentence.lower(), span.lower()
        # --- question-type x span-type interactions (ref :246-273)
        who_q = float(any(w in q_low for w in ("who", "whom", "whose")))
        when_q = float("when" in q_low or "what year" in q_low
                       or "which year" in q_low)
        howmany_q = float("how many" in q_low or "how much" in q_low)
        where_q = float("where" in q_low or "which city" in q_low
                        or "what city" in q_low)
        is_person_name = float(bool(
            re.match(r"^[A-Z][a-z'’-]+(\s+[A-Z][a-z'’-]+)*$", span)))
        has_digits = float(bool(re.search(r"\d", span)))
        is_date_like = float(bool(_YEAR.search(span) or _DATE.search(span)))
        # --- context cues (ref :300-316)
        span_at = s_low.find(sp_low)
        is_at = s_low.find(" is ")
        was_at = s_low.find(" was ")
        jac_union = len(q_toks | span_toks)
        return np.array(
            [
                _TYPE_AGREEMENT.get((qt, stype), 0.4),
                len(q_toks & s_toks) / max(len(q_toks), 1),        # context overlap
                1.0 - len(span_toks & q_toks) / max(len(span_toks), 1),  # span not in question
                min(len(span) / 30.0, 1.0),
                1.0 - position,                                     # earlier sentences favored
                float(stype == "quoted"),
                float(stype == "entity"),
                float(stype == "time"),
                float(sp_low in s_low),                             # span verbatim in context
                # question-span jaccard (ref _compute_text_similarity)
                len(q_toks & span_toks) / max(jac_union, 1),
                who_q * is_person_name,
                when_q * is_date_like,
                howmany_q * has_digits,
                where_q * float(stype == "entity" and not is_person_name
                                or " in " + sp_low in s_low),
                # span-shape linguistics (ref _get_span_type_features)
                is_person_name,
                has_digits,
                is_date_like,
                float(bool(span) and span[0].isupper()),
                float(any(w in sp_low.split() for w in ("the", "a", "an"))),
                # in-sentence context (ref _get_context_features)
                float(0 <= is_at < span_at),
                float(0 <= was_at < span_at),
                float(sp_low + "," in s_low),
            ],
            np.float32,
        )

    def _score(self, f: np.ndarray) -> float:
        if self.w is not None and len(self.w) == len(f):
            return float(1.0 / (1.0 + np.exp(-(f @ self.w + self.b))))
        # fallback: type agreement + context overlap dominate
        return float(0.35 * f[0] + 0.30 * f[1] + 0.20 * f[2] + 0.05 * f[3] + 0.10 * f[4])

    def pick_best_span(self, question: str, context: str) -> Optional[Dict[str, Any]]:
        sents = split_sentences(context)
        best: Optional[Dict[str, Any]] = None
        for si, sent in enumerate(sents):
            pos = si / max(len(sents) - 1, 1)
            for span, stype in candidate_spans(sent):
                f = self.features(question, span, stype, sent, pos)
                s = self._score(f)
                if best is None or s > best["score"]:
                    best = {"span": span, "score": s, "type": stype, "sentence": sent}
        return best

    # calibration -----------------------------------------------------------
    def load_calibration(self, path_or_dict) -> bool:
        try:
            d = path_or_dict
            if isinstance(path_or_dict, (str, Path)):
                with open(path_or_dict) as fh:
                    d = json.load(fh)
            sp = d.get("span_picker") or d
            if "w" in sp:
                w = np.asarray(sp["w"], np.float32)
                # a calibration trained on an older feature bank is
                # ignored (length mismatch would crash scoring)
                probe = self.features("Who is A?", "A", "entity", "A is.", 0.0)
                if len(w) == len(probe):
                    self.w = w
                    self.b = float(sp.get("b", 0.0))
                    return True
        except Exception:
            pass
        return False

    def train(self, examples: Sequence[Tuple[str, str, str, str, float, float]],
              epochs: int = 300, lr: float = 0.5) -> float:
        """examples: (question, span, stype, sentence, position, label)."""
        x = np.stack([self.features(q, s, t, sent, pos)
                      for q, s, t, sent, pos, _ in examples])
        y = np.array([lab for *_, lab in examples], np.float32)
        w = np.zeros(x.shape[1], np.float32)
        b = 0.0
        for _ in range(epochs):
            p = 1.0 / (1.0 + np.exp(-(x @ w + b)))
            g = p - y
            w -= lr * (x.T @ g) / len(y)
            b -= lr * float(g.mean())
        self.w, self.b = w, b
        p = 1.0 / (1.0 + np.exp(-(x @ w + b)))
        return float(np.mean((p > 0.5) == (y > 0.5)))
