"""Counterpart of anorag_tpu/answer/path_validator.py,
copied as it is with its imports renamed to anorag_tpu_torch.

PathValidator: ensure the final evidence bundle matches the expected
relation pattern.

Parity target: upstream pipeline/path_validator.py:44-190 — check
that a selected bundle contains (1) a note resolving the first relation of
the expected chain and (2) a note resolving the last; if not, rebuild the
bundle from the wider candidate pool.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from anorag_tpu_torch.retrieval.path_aware_ranker import predicates_of


def _note_predicates(note: Dict[str, Any]) -> List[str]:
    text = f"{note.get('title','')} {note.get('content','')}".lower()
    hits = list(predicates_of(text))
    if note.get("rel"):
        hits.append(str(note["rel"]))
    return hits


class PathValidator:
    def __init__(self, rel_chains: Optional[Sequence[Sequence[str]]] = None,
                 allow_partial: bool = True):
        self.rel_chains = [list(c) for c in (rel_chains or [])]
        self.allow_partial = allow_partial

    @staticmethod
    def _matches(rel: str, constraint: str) -> bool:
        return constraint == "*" or rel in constraint.split("|")

    def bundle_valid(self, bundle: Sequence[Dict[str, Any]], chain: Sequence[str]) -> bool:
        if not chain:
            return True
        preds = [set(_note_predicates(n)) for n in bundle]
        def covered(constraint):
            return any(any(self._matches(p, constraint) for p in ps) for ps in preds)
        if self.allow_partial:
            return covered(chain[0]) or covered(chain[-1])
        return all(covered(c) for c in chain)

    def ensure_valid_bundle(
        self,
        bundle: List[Dict[str, Any]],
        candidates: List[Dict[str, Any]],
        query: str = "",
    ) -> List[Dict[str, Any]]:
        """If the bundle misses the expected relations, pull covering notes
        from the candidate pool (keeping bundle order first)."""
        chain = self._chain_for_query(query)
        if not chain or self.bundle_valid(bundle, chain):
            return bundle
        out = list(bundle)
        have_ids = {n.get("note_id") for n in out}
        for constraint in (chain[0], chain[-1]):
            if any(any(self._matches(p, constraint) for p in _note_predicates(n)) for n in out):
                continue
            fix = next(
                (c for c in candidates
                 if c.get("note_id") not in have_ids
                 and any(self._matches(p, constraint) for p in _note_predicates(c))),
                None,
            )
            if fix is not None:
                out.append(fix)
                have_ids.add(fix.get("note_id"))
        return out

    def _chain_for_query(self, query: str) -> Optional[List[str]]:
        from anorag_tpu_torch.answer.answer_selector import extract_rel_chain

        chain = extract_rel_chain(query, self.rel_chains)
        if chain:
            return chain
        return self.rel_chains[0] if self.rel_chains else None
