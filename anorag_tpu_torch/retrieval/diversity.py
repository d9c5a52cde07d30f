"""Counterpart of anorag_tpu/retrieval/diversity.py,
copied as it is with its imports renamed to anorag_tpu_torch.

DiversityScheduler: dedup + greedy diversity-gain context selection.

Parity target: upstream retrieval/diversity_scheduler.py — semantic
and topical diversity evaluators, dedup strategies (exact / hash / fuzzy /
semantic / hybrid, :287-446), greedy selection maximizing diversity gain
under evidence-type quotas (:651-806), coverage metrics (:841). Pairwise
similarity runs vectorized on the embedding matrix.
"""
from __future__ import annotations

import hashlib
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np

from anorag_tpu_torch.index.entity_index import levenshtein_ratio
from anorag_tpu_torch.utils.text import tokenize_no_stop


def _text(note: Dict[str, Any]) -> str:
    return f"{note.get('title','')} {note.get('content','')}".strip()


def _norm_rows(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-9)


class DiversityScheduler:
    def __init__(
        self,
        dedup_strategy: str = "hybrid",      # exact|hash|fuzzy|semantic|hybrid
        semantic_dup_threshold: float = 0.92,
        fuzzy_dup_threshold: float = 0.9,
        diversity_weight: float = 0.5,
        max_per_type: Optional[Dict[str, int]] = None,
    ):
        self.dedup_strategy = dedup_strategy
        self.semantic_dup_threshold = semantic_dup_threshold
        self.fuzzy_dup_threshold = fuzzy_dup_threshold
        self.diversity_weight = diversity_weight
        self.max_per_type = max_per_type or {}

    # --------------------------------------------------------------- dedup
    def deduplicate(self, candidates: List[Dict[str, Any]],
                    embeddings: Optional[np.ndarray] = None) -> List[int]:
        """Returns kept indices (first occurrence wins)."""
        keep: List[int] = []
        seen_exact: set = set()
        seen_hash: set = set()
        sem = None
        if embeddings is not None and self.dedup_strategy in ("semantic", "hybrid"):
            sem = _norm_rows(np.asarray(embeddings, np.float32))
        kept_texts: List[str] = []
        for i, c in enumerate(candidates):
            t = _text(c)
            if self.dedup_strategy in ("exact", "hybrid") and t in seen_exact:
                continue
            h = hashlib.md5(" ".join(sorted(tokenize_no_stop(t))).encode()).hexdigest()
            if self.dedup_strategy in ("hash", "hybrid") and h in seen_hash:
                continue
            if self.dedup_strategy == "fuzzy" and any(
                levenshtein_ratio(t[:120], kt[:120]) >= self.fuzzy_dup_threshold
                for kt in kept_texts
            ):
                continue
            if sem is not None and keep:
                sims = sem[keep] @ sem[i]
                if float(sims.max()) >= self.semantic_dup_threshold:
                    continue
            keep.append(i)
            seen_exact.add(t)
            seen_hash.add(h)
            kept_texts.append(t)
        return keep

    # ------------------------------------------------------------- select
    def schedule_candidates(
        self,
        candidates: List[Dict[str, Any]],
        top_k: int = 10,
        embeddings: Optional[np.ndarray] = None,
    ) -> List[Dict[str, Any]]:
        """Greedy: pick argmax(relevance + w * diversity_gain) under
        per-evidence-type quotas."""
        if not candidates:
            return []
        kept_idx = self.deduplicate(candidates, embeddings)
        cands = [candidates[i] for i in kept_idx]
        emb = None
        if embeddings is not None:
            emb = _norm_rows(np.asarray(embeddings, np.float32)[kept_idx])
        else:
            # token-set embedding surrogate for diversity gain
            toks = [set(tokenize_no_stop(_text(c))) for c in cands]

        rel = np.array(
            [float(c.get("final_score", c.get("similarity", 0.0))) for c in cands], np.float32
        )
        if rel.max() > 0:
            rel = rel / rel.max()
        chosen: List[int] = []
        type_counts: Dict[str, int] = defaultdict(int)
        while len(chosen) < min(top_k, len(cands)):
            best_i, best_gain = -1, -np.inf
            for i in range(len(cands)):
                if i in chosen:
                    continue
                etype = str(cands[i].get("retrieval_method", "hybrid"))
                cap = self.max_per_type.get(etype)
                if cap is not None and type_counts[etype] >= cap:
                    continue
                if not chosen:
                    div = 1.0
                elif emb is not None:
                    div = 1.0 - float((emb[chosen] @ emb[i]).max())
                else:
                    div = 1.0 - max(
                        len(toks[i] & toks[j]) / max(len(toks[i] | toks[j]), 1) for j in chosen
                    )
                gain = rel[i] + self.diversity_weight * div
                if gain > best_gain:
                    best_gain, best_i = gain, i
            if best_i < 0:
                break
            chosen.append(best_i)
            type_counts[str(cands[best_i].get("retrieval_method", "hybrid"))] += 1
        return [cands[i] for i in chosen]

    # ------------------------------------------------------------ metrics
    def coverage_metrics(self, selected: List[Dict[str, Any]]) -> Dict[str, Any]:
        docs = {str(c.get("doc_id")) for c in selected}
        ents = set()
        for c in selected:
            ents |= set(str(e).lower() for e in (c.get("entities") or []))
        types = defaultdict(int)
        for c in selected:
            types[str(c.get("retrieval_method", "hybrid"))] += 1
        return {
            "n_selected": len(selected),
            "unique_docs": len(docs),
            "unique_entities": len(ents),
            "type_distribution": dict(types),
        }
