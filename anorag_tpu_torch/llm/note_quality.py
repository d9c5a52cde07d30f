"""Counterpart of anorag_tpu/llm/note_quality.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Note-quality post-passes: related-note linking, usefulness scoring,
and source-coverage evaluation.

Parity targets:
  * NoteSimilarityCalculator (upstream utils/note_similarity.py:
    115-240) — attach `related_notes` per note from blended content
    similarity + entity overlap, thresholded, top-k capped;
  * EnhancedNoiseFilter (upstream utils/enhanced_noise_filter.py)
    — usefulness score = weighted importance + content-length +
    verified-entity ratio, plus noise-pattern rejection;
  * evaluate_note_coverage (upstream utils/note_coverage_eval.py:
    46-160) — per-chunk sentence coverage report + missing-sentences
    dump under debug paths.

TPU design: the reference runs its own sentence-transformer + sklearn
cosine matrix here; this module reuses the pipeline's EmbeddingManager
and the batched top-k kernel (one (N, N) pass) instead of a second model.
"""
from __future__ import annotations

import re
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from anorag_tpu_torch.ops.topk import dense_topk_np
from anorag_tpu_torch.utils.logging import get_logger
from anorag_tpu_torch.utils.text import tokenize_no_stop

logger = get_logger("anorag.note_quality")


class NoteSimilarityCalculator:
    """Blended note-note similarity -> `related_notes` annotations.

    score = content_weight * cos(content_emb) + entity_weight * jaccard(entities)
    capped at `max_related_notes` neighbors above `similarity_threshold`.
    """

    def __init__(self, embedding_manager=None, similarity_threshold: float = 0.75,
                 max_related_notes: int = 5, content_weight: float = 0.7,
                 entity_weight: float = 0.3):
        self.em = embedding_manager
        self.similarity_threshold = similarity_threshold
        self.max_related_notes = max_related_notes
        self.content_weight = content_weight
        self.entity_weight = entity_weight

    def _content_sims(self, notes: Sequence[Dict[str, Any]], k: int):
        if self.em is not None:
            emb = self.em.encode_atomic_notes(list(notes)).astype(np.float32)
        else:  # hash-free fallback: token-set vectors via bincount-ish trick
            from anorag_tpu_torch.models.hash_embedder import HashEmbedder

            emb = HashEmbedder(dim=256).encode(
                [(n.get("content") or "") for n in notes])
        emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
        return dense_topk_np(emb, emb, min(k + 1, len(notes)))

    def find_related_notes(self, notes: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
        notes = [dict(n) for n in notes]
        if len(notes) < 2:
            for n in notes:
                n["related_notes"] = []
            return notes
        vals, idx = self._content_sims(notes, self.max_related_notes * 2)
        ent_sets = [set(str(e).lower() for e in (n.get("entities") or []))
                    for n in notes]
        for i, n in enumerate(notes):
            related = []
            for r in range(vals.shape[1]):
                j = int(idx[i, r])
                if j == i or j < 0:
                    continue
                ej = ent_sets[i] & ent_sets[j]
                union = ent_sets[i] | ent_sets[j]
                ent_sim = len(ej) / len(union) if union else 0.0
                score = (self.content_weight * float(vals[i, r])
                         + self.entity_weight * ent_sim)
                if score >= self.similarity_threshold:
                    related.append({
                        "note_id": notes[j].get("note_id"),
                        "similarity": round(score, 4),
                        "shared_entities": sorted(ej),
                    })
            related.sort(key=lambda d: -d["similarity"])
            n["related_notes"] = related[: self.max_related_notes]
        total = sum(len(n["related_notes"]) for n in notes)
        logger.info("related-note linking: %d links over %d notes", total, len(notes))
        return notes


_NOISE_PATTERNS = [
    re.compile(r"^\s*$"),
    re.compile(r"^\s*\.\.\.\s*$"),
    re.compile(r"^\s*[\W_]+\s*$"),
    re.compile(r"^\s*(?:the|a|an|and|or|but)\s*$", re.IGNORECASE),
    re.compile(r"^\s*\d+\s*$"),
]

_QUALITY_CUES = (
    "born", "died", "created", "founded", "established", "married",
    "known for", "famous for", "described as", "son of", "daughter of",
    "worked with", "first", "last", "during", "since",
)


class EnhancedNoiseFilter:
    """Usefulness scoring + noise rejection for generated notes.

    usefulness = w_imp * importance + w_len * content_length_score
               + w_ent * verified_entity_ratio (+ small quality-cue bonus);
    notes matching a noise pattern or scoring under `usefulness_threshold`
    are dropped (the caller keeps the stats).
    """

    def __init__(self, usefulness_threshold: float = 0.65,
                 min_content_length: int = 20,
                 max_content_length_for_score: int = 100,
                 w_importance: float = 0.4, w_length: float = 0.3,
                 w_entities: float = 0.3):
        self.usefulness_threshold = usefulness_threshold
        self.min_content_length = min_content_length
        self.max_len_for_score = max_content_length_for_score
        self.w = (w_importance, w_length, w_entities)

    def is_noise(self, note: Dict[str, Any]) -> bool:
        content = note.get("content") or ""
        return any(p.match(content) for p in _NOISE_PATTERNS) \
            or len(content.strip()) < self.min_content_length

    def usefulness_score(self, note: Dict[str, Any]) -> float:
        content = note.get("content") or ""
        importance = float(note.get("importance_score", 0.5))
        length_score = min(len(content) / self.max_len_for_score, 1.0)
        ents = note.get("entities") or []
        verified = [e for e in ents if str(e).lower() in content.lower()]
        ent_ratio = len(verified) / len(ents) if ents else 0.0
        w_imp, w_len, w_ent = self.w
        score = w_imp * importance + w_len * length_score + w_ent * ent_ratio
        lower = content.lower()
        if any(c in lower for c in _QUALITY_CUES):
            score = min(1.0, score + 0.1)
        return score

    def filter_notes(self, notes: Sequence[Dict[str, Any]]):
        kept, dropped = [], []
        for n in notes:
            if self.is_noise(n) or self.usefulness_score(n) < self.usefulness_threshold:
                dropped.append(n)
            else:
                kept.append(n)
        if dropped:
            logger.info("noise filter: dropped %d/%d notes", len(dropped), len(notes))
        return kept, dropped


def evaluate_note_coverage(
    chunks: Sequence[Dict[str, Any]],
    notes: Sequence[Dict[str, Any]],
    threshold: float = 0.6,
    min_sentence_tokens: int = 6,
    critical_threshold: float = 0.5,
    report_path: Optional[str] = None,
    missing_path: Optional[str] = None,
) -> Dict[str, Any]:
    """Per-chunk sentence coverage of the generated notes.

    A source sentence counts as covered when some note of its chunk
    reaches `threshold` token recall against it. Returns {per_chunk,
    mean_coverage, critical_chunks, n_missing}; optionally writes the
    report + missing-sentence dump (the reference's debug/ artifacts).
    """
    from anorag_tpu_torch.utils.text import split_sentences

    notes_by_chunk: Dict[Any, List[Dict[str, Any]]] = defaultdict(list)
    for n in notes:
        notes_by_chunk[n.get("chunk_index")].append(n)

    per_chunk, missing = [], []
    for ci, chunk in enumerate(chunks):
        cidx = chunk.get("chunk_index", ci)
        text = chunk.get("text") or ""
        sents = [s for s in split_sentences(text)
                 if len(tokenize_no_stop(s)) >= min_sentence_tokens]
        if not sents:
            continue
        note_toks = [set(tokenize_no_stop((n.get("content") or "")
                                          + " " + (n.get("raw_span") or "")))
                     for n in notes_by_chunk.get(cidx, [])]
        covered = 0
        for s in sents:
            st = set(tokenize_no_stop(s))
            best = max((len(st & nt) / max(len(st), 1) for nt in note_toks),
                       default=0.0)
            if best >= threshold:
                covered += 1
            else:
                missing.append({"chunk_index": cidx, "sentence": s,
                                "best_recall": round(best, 3)})
        per_chunk.append({"chunk_index": cidx, "n_sentences": len(sents),
                          "covered": covered,
                          "coverage": round(covered / len(sents), 4)})
    mean_cov = (sum(c["coverage"] for c in per_chunk) / len(per_chunk)
                if per_chunk else 1.0)
    result = {
        "per_chunk": per_chunk,
        "mean_coverage": round(mean_cov, 4),
        "critical_chunks": [c["chunk_index"] for c in per_chunk
                            if c["coverage"] < critical_threshold],
        "n_missing": len(missing),
    }
    if report_path:
        from anorag_tpu_torch.utils.file_io import write_json

        Path(report_path).parent.mkdir(parents=True, exist_ok=True)
        write_json(report_path, result)
    if missing_path:
        from anorag_tpu_torch.utils.file_io import write_jsonl

        Path(missing_path).parent.mkdir(parents=True, exist_ok=True)
        write_jsonl(missing_path, missing)
    logger.info("note coverage: mean %.3f, %d critical chunks, %d missing sentences",
                mean_cov, len(result["critical_chunks"]), len(missing))
    return result
