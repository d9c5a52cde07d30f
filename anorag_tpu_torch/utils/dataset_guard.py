"""Counterpart of anorag_tpu/utils/dataset_guard.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Dataset guard: namespace isolation across retrieval stages.

Parity target: the reference's utils/dataset_guard (4-stage namespace
filtering, query_processor.py:2119,2186,2255,2320) — candidates must belong
to the active dataset namespace at initial recall, post-fusion, post-two-hop,
and final scheduling; violations are counted and (in strict mode) raised.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from anorag_tpu_torch.utils.logging import get_logger

logger = get_logger("anorag.guard")

STAGES = ("initial_recall", "post_fusion", "post_two_hop", "final_scheduling")


def note_namespace(note: Dict[str, Any], default: Optional[str] = None) -> Optional[str]:
    return note.get("namespace") or note.get("dataset") or default


def filter_notes_by_namespace(
    candidates: Sequence[Dict[str, Any]],
    namespace: Optional[str],
    stage: str = "initial_recall",
    strict: bool = False,
    stats: Optional[Dict[str, int]] = None,
) -> List[Dict[str, Any]]:
    if not namespace:
        return list(candidates)
    kept, dropped = [], 0
    for c in candidates:
        ns = note_namespace(c, default=namespace)
        if str(ns) == str(namespace):
            kept.append(c)
        else:
            dropped += 1
    if dropped:
        logger.debug("namespace guard %s: dropped %d foreign candidates", stage, dropped)
        if stats is not None:
            stats[stage] = stats.get(stage, 0) + dropped
        if strict and not kept:
            raise ValueError(
                f"namespace guard ({stage}): all {dropped} candidates foreign to {namespace}")
    return kept


def assert_single_namespace(notes: Sequence[Dict[str, Any]]) -> Optional[str]:
    """Verify a final bundle is namespace-pure; returns the namespace."""
    spaces = {note_namespace(n) for n in notes} - {None}
    if len(spaces) > 1:
        raise AssertionError(f"mixed namespaces in final bundle: {sorted(map(str, spaces))}")
    return next(iter(spaces), None)
