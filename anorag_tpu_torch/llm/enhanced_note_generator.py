"""Counterpart of anorag_tpu/llm/enhanced_note_generator.py,
copied as it is with its imports renamed to anorag_tpu_torch.

EnhancedAtomicNoteGenerator: entity-slot + relation-hint enrichment.

Parity target: upstream llm/enhanced_atomic_note_generator.py — the
enriched variant of AtomicNoteGenerator that (1) supplies typed entity cards
(from EnhancedNER) and relation hints (from the note_keys lexicon) to the
prompt, and (2) post-fills typed head/tail slots + audits the results.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from anorag_tpu_torch.llm.note_generator import AtomicNoteGenerator
from anorag_tpu_torch.llm.summary_auditor import SummaryAuditor
from anorag_tpu_torch.utils.ner import EnhancedNER


class EnhancedAtomicNoteGenerator(AtomicNoteGenerator):
    def __init__(self, llm, cfg: Optional[Any] = None, audit: bool = True,
                 embedding_manager=None):
        super().__init__(llm, cfg)
        self.ner = EnhancedNER(use_spacy=False)
        self.auditor = SummaryAuditor(llm=llm) if audit else None
        self.em = embedding_manager
        nk = self.cfg.get("note_keys", {}) or {}
        self.rel_lexicon: Dict[str, List[str]] = nk.get("rel_lexicon", {})
        self.type_hints: Dict[str, List[str]] = nk.get("type_hints", {})
        self.relation_type_map: Dict[str, Dict[str, str]] = nk.get("relation_type_map", {})

    def generate_atomic_notes(self, chunks):
        notes = super().generate_atomic_notes(chunks)
        nq = self.cfg.get("note_quality", {}) or {}
        nf_cfg = nq.get("noise_filter", {}) or {}
        if nf_cfg.get("enabled"):
            from anorag_tpu_torch.llm.note_quality import EnhancedNoiseFilter

            nf = EnhancedNoiseFilter(
                usefulness_threshold=float(nf_cfg.get("usefulness_threshold", 0.65)),
                min_content_length=int(nf_cfg.get("min_content_length", 20)))
            notes, dropped = nf.filter_notes(notes)
            self.stats["noise_filtered"] += len(dropped)
        rn_cfg = nq.get("related_notes", {}) or {}
        if rn_cfg.get("enabled"):
            from anorag_tpu_torch.llm.note_quality import NoteSimilarityCalculator

            calc = NoteSimilarityCalculator(
                embedding_manager=self.em,
                similarity_threshold=float(rn_cfg.get("similarity_threshold", 0.75)),
                max_related_notes=int(rn_cfg.get("max_related_notes", 5)))
            notes = calc.find_related_notes(notes)
        return notes

    def generate_for_chunk(self, chunk: Dict[str, Any]) -> List[Dict[str, Any]]:
        chunk = dict(chunk)
        text = chunk.get("text") or ""
        typed = self.ner.extract_typed(text)
        cards = [f"{e} ({t})" for t, ents in typed.items() for e in ents[:4]]
        hints = [rel for rel, cues in self.rel_lexicon.items()
                 if any(c in text.lower() for c in cues)]
        chunk["entity_cards"] = cards + [f"relation hint: {h}" for h in hints]
        notes = super().generate_for_chunk(chunk)
        return [self._enrich(n, typed, text) for n in notes]

    def _enrich(self, note: Dict[str, Any], typed: Dict[str, List[str]],
                chunk_text: str) -> Dict[str, Any]:
        # typed head/tail slots from the relation_type_map
        rel = note.get("rel") or ""
        tmap = self.relation_type_map.get(rel, {})
        if tmap:
            note.setdefault("type_head", tmap.get("head"))
            note.setdefault("type_tail", tmap.get("tail"))
        # type tags from title suffixes ("(album)" etc.)
        title = (note.get("title") or "").lower()
        for typ, markers in self.type_hints.items():
            if any(m.lower() in title for m in markers):
                note["title_type"] = typ
                break
        note["entity_types"] = {
            e: t for t, ents in typed.items() for e in ents
            if e in (note.get("entities") or [])
        }
        if self.auditor is not None:
            audit = self.auditor.audit_note(chunk_text, note)
            note["needs_rewrite"] = audit["needs_rewrite"]
        return note
