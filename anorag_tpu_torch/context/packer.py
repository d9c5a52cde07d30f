"""Counterpart of anorag_tpu/context/packer.py,
copied as it is with its imports renamed to anorag_tpu_torch.

ContextPacker: selected notes -> numbered prompt paragraphs.

Parity target: upstream context/packer.py — convert notes to
paragraphs, structure-based packing via StructurePacker when enabled, else
legacy `[P{idx}]`-tagged concatenation (:32-192); build predicted support
idxs and estimate the required evidence count via KEstimator (:194-246).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from anorag_tpu_torch.support.k_estimator import KEstimator
from anorag_tpu_torch.utils.text import estimate_tokens


class ContextPacker:
    def __init__(self, max_tokens: Optional[int] = None, use_structure: bool = False,
                 structure_packer=None, k_estimator: Optional[KEstimator] = None):
        self.max_tokens = max_tokens
        self.use_structure = use_structure
        self.structure_packer = structure_packer
        self.k_estimator = k_estimator or KEstimator()

    @staticmethod
    def note_paragraph(note: Dict[str, Any]) -> Tuple[int, str]:
        """(paragraph_idx, text) for one note."""
        idxs = note.get("paragraph_idxs") or []
        pidx = int(idxs[0]) if idxs else -1
        title = note.get("title") or ""
        body = note.get("raw_span") or note.get("content") or ""
        text = f"{title}: {body}" if title else body
        return pidx, text.strip()

    def pack_context(
        self,
        notes: Sequence[Dict[str, Any]],
        query: str = "",
    ) -> Tuple[str, List[int]]:
        """Returns (context string with [P{idx}] tags, support idxs)."""
        if self.use_structure and self.structure_packer is not None:
            try:
                ctx, support = self.structure_packer.pack_evidence(list(notes), query)
                if ctx:
                    return ctx, support
            except Exception:
                # reference behavior: structured packing failures fall back
                # to legacy concatenation (context/packer.py:102)
                pass
        lines: List[str] = []
        support: List[int] = []
        budget = self.max_tokens
        for note in notes:
            pidx, text = self.note_paragraph(note)
            if not text:
                continue
            line = f"[P{pidx}] {text}" if pidx >= 0 else text
            if budget is not None:
                cost = estimate_tokens(line)
                if cost > budget:
                    break
                budget -= cost
            lines.append(line)
            if pidx >= 0 and pidx not in support:
                support.append(pidx)
        return "\n".join(lines), support

    def build_support_idxs(self, notes: Sequence[Dict[str, Any]], query: str = "",
                           cap: Optional[int] = None) -> List[int]:
        """Support idxs ordered by note score, truncated to the estimated K
        (graph-distance K over the candidate note graph, complexity
        fallback — ref support/k_estimator.py:41-77)."""
        k = cap or self.k_estimator.estimate_K_from_candidates(query, list(notes))
        out: List[int] = []
        for note in notes:
            for pidx in note.get("paragraph_idxs") or []:
                if pidx not in out:
                    out.append(int(pidx))
                if len(out) >= k:
                    return out
        return out
