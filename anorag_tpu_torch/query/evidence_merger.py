"""Counterpart of anorag_tpu/query/evidence_merger.py,
copied as it is with its imports renamed to anorag_tpu_torch.

EvidenceMerger: merge notes retrieved for different sub-questions.

Parity target: upstream query/evidence_merger.py:43-341 — collect
with per-note `subq_source` provenance, dedup (:170), merge strategies
simple / weighted / ranked (query-embedding rerank) (:227-311), and merge
statistics (:313).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class EvidenceMerger:
    def __init__(self, strategy: str = "weighted"):
        self.strategy = strategy
        self.last_stats: Dict[str, Any] = {}

    def merge_evidence(
        self,
        per_subquestion: Dict[str, List[Dict[str, Any]]],
        query_emb: Optional[np.ndarray] = None,
        note_embeddings: Optional[Dict[str, np.ndarray]] = None,
        top_k: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        collected: List[Dict[str, Any]] = []
        for sq, notes in per_subquestion.items():
            for n in notes:
                m = dict(n)
                m.setdefault("subq_source", sq)
                collected.append(m)

        merged: Dict[str, Dict[str, Any]] = {}
        dup_count = 0
        for m in collected:
            nid = m.get("note_id")
            if nid in merged:
                dup_count += 1
                old = merged[nid]
                if self.strategy == "weighted":
                    old["final_score"] = float(old.get("final_score", 0.0)) + \
                        0.5 * float(m.get("final_score", 0.0))
                elif float(m.get("final_score", 0.0)) > float(old.get("final_score", 0.0)):
                    merged[nid] = m
                src = old.setdefault("subq_sources", [old.get("subq_source")])
                if m.get("subq_source") not in src:
                    src.append(m.get("subq_source"))
            else:
                merged[nid] = m

        out = list(merged.values())
        if self.strategy == "ranked" and query_emb is not None and note_embeddings:
            q = np.asarray(query_emb, np.float32).reshape(-1)
            qn = q / max(np.linalg.norm(q), 1e-9)
            for m in out:
                e = note_embeddings.get(m.get("note_id"))
                if e is not None:
                    e = np.asarray(e, np.float32)
                    m["final_score"] = float(e @ qn / max(np.linalg.norm(e), 1e-9))
        out.sort(key=lambda m: -float(m.get("final_score", 0.0)))
        if top_k:
            out = out[:top_k]
        self.last_stats = {
            "n_subquestions": len(per_subquestion),
            "n_collected": len(collected),
            "n_merged": len(out),
            "n_duplicates": dup_count,
            "strategy": self.strategy,
        }
        return out
