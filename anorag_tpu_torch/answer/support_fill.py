"""Counterpart of anorag_tpu/answer/support_fill.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Post-hoc support-idx repair.

Parity target: upstream utils/support_fill.py:9-290 (used at
query_processor.py:2475-2483) — after the answer is produced, make the
predicted support idxs defensible: prefer paragraphs containing the answer,
add entity-overlap bridging paragraphs, dedup, keep order, cap at K.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from anorag_tpu_torch.utils.text import extract_entities_fallback, normalize_answer


def fill_support_idxs_noid(
    answer: str,
    selected_notes: Sequence[Dict[str, Any]],
    existing_idxs: Optional[Sequence[int]] = None,
    query: str = "",
    max_support: int = 4,
) -> List[int]:
    """Returns repaired paragraph idxs."""
    out: List[int] = [int(i) for i in (existing_idxs or [])]

    def add(pidx: Optional[int]):
        if pidx is not None and int(pidx) not in out:
            out.append(int(pidx))

    ans_norm = normalize_answer(answer or "")
    # 1. answer-containing paragraphs
    if ans_norm:
        for n in selected_notes:
            text = normalize_answer(f"{n.get('title','')} {n.get('raw_span','')} {n.get('content','')}")
            if ans_norm in text:
                for p in n.get("paragraph_idxs") or []:
                    add(p)
    # 2. entity-overlap bridging paragraphs (connect question to answer)
    q_ents = set(e.lower() for e in extract_entities_fallback(query)) if query else set()
    if q_ents:
        for n in selected_notes:
            ents = set(str(e).lower() for e in (n.get("entities") or []))
            if ents & q_ents:
                for p in n.get("paragraph_idxs") or []:
                    add(p)
    # 3. top-score fallback when still empty
    if not out:
        ranked = sorted(
            selected_notes,
            key=lambda n: -float(n.get("final_score", n.get("similarity", 0.0))),
        )
        for n in ranked:
            for p in n.get("paragraph_idxs") or []:
                add(p)
            if out:
                break
    return out[:max_support]
