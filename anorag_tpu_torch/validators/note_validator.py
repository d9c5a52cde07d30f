"""Counterpart of anorag_tpu/validators/note_validator.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Atomic-note schema validation.

Parity target: upstream validators/note_schema.py +
note_validator.py:21 — the canonical note contract every stage reads
(query_processor.py:2543-2589): note_id, doc_id, title, content, raw_span,
entities, paragraph_idxs, final_score, retrieval_method, hop_no,
bridge_entity, bridge_path.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

NOTE_SCHEMA: Dict[str, type] = {
    "note_id": str,
    "doc_id": str,
    "title": str,
    "content": str,
    "raw_span": str,
    "entities": list,
    "paragraph_idxs": list,
    "final_score": float,
    "retrieval_method": str,
    "hop_no": int,
    "bridge_path": list,
}

RETRIEVAL_METHODS = {"dense", "bm25", "graph", "prf_bridge", "hybrid"}


def validate_note(note: Dict[str, Any], strict: bool = False) -> Tuple[bool, List[str]]:
    issues: List[str] = []
    if not isinstance(note, dict):
        return False, ["note is not a dict"]
    for key, typ in NOTE_SCHEMA.items():
        if key not in note:
            issues.append(f"missing field: {key}")
        elif strict and not isinstance(note[key], typ) and note[key] is not None:
            issues.append(f"wrong type for {key}: {type(note[key]).__name__}")
    rm = note.get("retrieval_method")
    if rm is not None and rm not in RETRIEVAL_METHODS:
        issues.append(f"unknown retrieval_method: {rm}")
    hop = note.get("hop_no")
    if hop is not None and (not isinstance(hop, int) or hop < 1):
        issues.append(f"invalid hop_no: {hop}")
    return not issues, issues


def normalize_note(note: Dict[str, Any]) -> Dict[str, Any]:
    """Fill every contract field with the reference's backfill rules
    (query_processor.py:2543-2589): canonical id/doc/title/content aliases,
    method normalization to the enum, hop_no default 1, bridge fields."""
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
