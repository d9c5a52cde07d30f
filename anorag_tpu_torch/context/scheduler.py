"""Counterpart of anorag_tpu/context/scheduler.py,
copied as it is with its imports renamed to anorag_tpu_torch.

ContextScheduler + MultiHopContextScheduler.

Parity target: upstream utils/context_scheduler.py — legacy
importance-ranked selection with a coverage guard (at least one evidence
note per sub-question, :78); the multi-hop variant adds path scores,
completeness, and reasoning-chain closure (:144-249).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from anorag_tpu_torch.utils.text import tokenize_no_stop


def _score(c: Dict[str, Any]) -> float:
    return float(c.get("final_score", c.get("final_similarity", c.get("similarity", 0.0))))


class ContextScheduler:
    def __init__(self, max_notes: int = 20):
        self.max_notes = max_notes

    def schedule(
        self,
        candidates: List[Dict[str, Any]],
        sub_questions: Optional[Sequence[str]] = None,
    ) -> List[Dict[str, Any]]:
        ranked = sorted(candidates, key=_score, reverse=True)
        selected = ranked[: self.max_notes]
        if sub_questions:
            selected = self._coverage_guard(selected, ranked, sub_questions)
        return selected

    def _coverage_guard(self, selected, ranked, sub_questions):
        """Ensure >=1 note covering each sub-question; swap in the best
        covering note for the weakest selected one when missing."""
        out = list(selected)
        for sq in sub_questions:
            sq_toks = set(tokenize_no_stop(sq))

            def covers(c):
                toks = set(tokenize_no_stop(f"{c.get('title','')} {c.get('content','')}"))
                return len(sq_toks & toks) >= max(1, len(sq_toks) // 3)

            if any(covers(c) for c in out):
                continue
            best = next((c for c in ranked if covers(c)), None)
            if best is not None:
                if len(out) >= self.max_notes and out:
                    out[-1] = best
                else:
                    out.append(best)
        return out


class MultiHopContextScheduler(ContextScheduler):
    def __init__(self, max_notes: int = 20, hop_decay: float = 0.85,
                 path_weight: float = 0.2, closure_bonus: float = 0.1):
        super().__init__(max_notes)
        self.hop_decay = hop_decay
        self.path_weight = path_weight
        self.closure_bonus = closure_bonus

    def schedule_for_multi_hop(
        self,
        candidates: List[Dict[str, Any]],
        sub_questions: Optional[Sequence[str]] = None,
        bridge_entity: Optional[str] = None,
    ) -> List[Dict[str, Any]]:
        cands = []
        for c in candidates:
            m = dict(c)
            hop = int(m.get("hop_no", 1))
            s = _score(m) * (self.hop_decay ** (hop - 1))
            s += self.path_weight * float(m.get("path_score", m.get("graph_score", 0.0)))
            # reasoning-chain closure: notes naming the bridge entity close
            # the chain between hops
            if bridge_entity:
                ents = {str(e).lower() for e in (m.get("entities") or [])}
                if bridge_entity.lower() in ents:
                    s += self.closure_bonus
            m["final_score"] = s
            cands.append(m)
        # completeness: keep at least one note from each hop present
        selected = sorted(cands, key=_score, reverse=True)[: self.max_notes]
        hops_present = {int(c.get("hop_no", 1)) for c in selected}
        for c in sorted(cands, key=_score, reverse=True):
            h = int(c.get("hop_no", 1))
            if h not in hops_present:
                if selected:
                    selected[-1] = c
                else:
                    selected.append(c)
                hops_present.add(h)
        if sub_questions:
            selected = self._coverage_guard(selected, sorted(cands, key=_score, reverse=True),
                                            sub_questions)
        return selected
