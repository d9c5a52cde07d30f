"""Atomic-note contract: normalize_note, copied from
anorag_tpu/validators/note_validator.py so both packages index the same
note fields (note_id, doc_id, title, content, raw_span, entities, ...)."""
from __future__ import annotations

from typing import Any, Dict


def normalize_note(note: Dict[str, Any]) -> Dict[str, Any]:
    """Fill every contract field with the reference's backfill rules:
    canonical id/doc/title/content aliases, method normalization to the
    enum, hop_no default 1, bridge fields."""
    n = dict(note)
    n.setdefault("note_id", n.get("id") or f"note_{abs(hash(n.get('content', ''))) % 10**10}")
    n.setdefault("doc_id", n.get("document_id", "unknown"))
    n.setdefault("paragraph_idxs", n.get("paragraph_indices", []))
    n.setdefault("title", n.get("document_title", ""))
    n.setdefault("content", n.get("text", ""))
    n.setdefault("raw_span", n.get("content", ""))
    n.setdefault("entities", [])
    n.setdefault("final_score", float(n.get("score", n.get("similarity", 0.0)) or 0.0))
    method = str(n.get("retrieval_method") or n.get("method") or "hybrid")
    if method in ("dense", "vector", "semantic"):
        n["retrieval_method"] = "dense"
    elif method in ("bm25", "sparse", "lexical"):
        n["retrieval_method"] = "bm25"
    elif method in ("graph", "graph_search"):
        n["retrieval_method"] = "graph"
    elif method == "prf_bridge":
        n["retrieval_method"] = "prf_bridge"
    else:
        n["retrieval_method"] = "hybrid"
    if "hop_no" not in n:
        hop_type = str(n.get("hop_type", "")).lower()
        n["hop_no"] = 2 if ("second" in hop_type or hop_type == "2") else (
            3 if ("third" in hop_type or hop_type == "3") else 1)
    if "bridge_entity" not in n:
        path = n.get("path") or n.get("bridge_path") or []
        n["bridge_entity"] = path[-1] if isinstance(path, list) and path else None
    n.setdefault("bridge_path", n.get("path", []))
    return n
