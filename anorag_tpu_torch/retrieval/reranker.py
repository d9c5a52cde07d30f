"""Listwise reranker + score fusion.

Counterpart of anorag_tpu/retrieval/reranker.py, copied with its imports
renamed, except _get_cross_encoder: the cross-encoder backend ('jax')
needs models/cross_encoder.py, which is not ported yet (ROADMAP, queue 1),
so it raises NotImplementedError. The lexical backend, the default, is
the reference's.

Parity target: upstream retrieval/listt5_reranker.py — a listwise
reranker over the top candidates whose scores are fused with the base score
at `calibration.listt5_weight` (default 0.35, :254-320). The reference runs
a T5 on CUDA; here the reranker is backend-pluggable:
  * 'lexical' (default): deterministic query-candidate overlap scoring with
    temperature scaling — no weights needed;
  * 'jax': a trained listwise cross-encoder
    (models/cross_encoder.py::CrossEncoderReranker — [CLS] query [SEP]
    candidate [SEP] transformer, scalar relevance head, listwise-CE
    trained); loads an orbax checkpoint or accepts an in-image-trained
    instance.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from anorag_tpu_torch.utils.text import tokenize_no_stop


def candidate_text(c: Dict[str, Any]) -> str:
    return f"{c.get('title', '')} {c.get('content', c.get('text', ''))}".strip()


class ListwiseReranker:
    def __init__(self, backend: str = "lexical", temperature: float = 1.0,
                 max_candidates: int = 24, embedding_manager=None,
                 cross_encoder=None, checkpoint: Optional[str] = None):
        self.backend = backend
        self.temperature = temperature
        self.max_candidates = max_candidates
        self.em = embedding_manager  # legacy arg, kept for API stability
        self._xenc = cross_encoder
        self._checkpoint = checkpoint

    def _get_cross_encoder(self):
        if self._xenc is None:
            raise NotImplementedError(
                "the cross-encoder rerank backend needs models/cross_encoder.py, "
                "which is not ported yet (ROADMAP, queue 1); use the lexical "
                "backend")
        return self._xenc

    def score(self, query: str, candidates: Sequence[Dict[str, Any]]) -> List[float]:
        cands = list(candidates)[: self.max_candidates]
        if not cands:
            return []
        if self.backend == "jax":
            xenc = self._get_cross_encoder()
            raw = xenc.score_pairs(
                query, [candidate_text(c) for c in cands]).astype(np.float64)
        else:
            q_toks = set(tokenize_no_stop(query))
            raw = np.array(
                [
                    len(q_toks & set(tokenize_no_stop(candidate_text(c))))
                    / max(len(q_toks), 1)
                    for c in cands
                ],
                np.float64,
            )
        # listwise softmax with temperature scaling
        z = raw / max(self.temperature, 1e-6)
        z = z - z.max()
        p = np.exp(z)
        p /= p.sum() or 1.0
        scores = p.tolist()
        return scores + [0.0] * (len(candidates) - len(cands))


def fuse_scores(
    candidates: List[Dict[str, Any]],
    list_scores: Sequence[float],
    weights: Optional[Dict[str, float]] = None,
) -> List[Dict[str, Any]]:
    """fused = (1-w)*base + w*list_score, w = listt5_weight (default .35)."""
    w = (weights or {}).get("listt5_weight", 0.35)
    base = np.array(
        [float(c.get("final_base_score", c.get("final_score", 0.0))) for c in candidates],
        np.float64,
    )
    if base.max() > 0:
        base = base / base.max()
    ls = np.asarray(list(list_scores) + [0.0] * (len(candidates) - len(list_scores)))
    if ls.max() > 0:
        ls = ls / ls.max()
    out = []
    for c, b, l in zip(candidates, base, ls):
        m = dict(c)
        m["fused_score"] = float((1 - w) * b + w * l)
        out.append(m)
    return out


def sort_desc(candidates: List[Dict[str, Any]], key: str) -> List[Dict[str, Any]]:
    return sorted(candidates, key=lambda c: -float(c.get(key, 0.0)))
