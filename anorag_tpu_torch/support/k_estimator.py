"""Counterpart of anorag_tpu/support/k_estimator.py,
copied as it is with its imports renamed to anorag_tpu_torch.

KEstimator: how many support paragraphs does this question need?

Parity target: upstream support/k_estimator.py:18-460 — K is driven
by the graph distance between the question-anchor note and the top answer
note over a shared-entity candidate graph (:41-160: K = shortest path + 1,
clamped), with question complexity (hop markers, conjunctions, nested
'of the' chains) as the fallback; thresholds are calibratable. The
shortest-path relaxation is ops/graph.py::k_hop_distances (the CSR
Bellman-Ford primitive) instead of networkx; graph_distance calls the
port's torch version on host tensors, the one function that differs from
the copy.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence

from anorag_tpu_torch.utils.text import tokenize_no_stop

_NESTED_OF = re.compile(r"\bof the\b", re.IGNORECASE)
_CONJ = re.compile(r"\b(and|both|as well as)\b", re.IGNORECASE)
_COMPARATIVE = re.compile(r"\b(more|less|older|younger|earlier|later|than)\b", re.IGNORECASE)
_MULTIHOP_CUES = re.compile(
    r"\b(spouse|director|performer|author|founder|capital|mother|father|president)\b",
    re.IGNORECASE,
)


class KEstimator:
    def __init__(self, base_k: int = 2, max_k: int = 4, thresholds: Optional[Dict[str, float]] = None):
        self.base_k = base_k
        self.max_k = max_k
        self.thresholds = thresholds or {"complexity_per_k": 1.0}

    def question_complexity(self, question: str) -> float:
        q = question or ""
        score = 0.0
        score += len(_NESTED_OF.findall(q))          # each nesting ~ one hop
        score += 0.5 * len(_CONJ.findall(q))
        score += 0.5 * bool(_COMPARATIVE.search(q))
        score += 0.5 * min(len(_MULTIHOP_CUES.findall(q)), 2)
        return score

    def estimate_K(self, question: str, graph_distance: Optional[int] = None) -> int:
        k = self.base_k
        k += int(self.question_complexity(question) / max(self.thresholds["complexity_per_k"], 1e-6))
        if graph_distance is not None:
            k = max(k, graph_distance)
        return int(min(max(k, 1), self.max_k))

    # ------------------------------------------------- graph-distance mode
    @staticmethod
    def _note_tokens(note: Dict[str, Any]) -> set:
        return set(tokenize_no_stop(
            f"{note.get('title', '')} {note.get('content', note.get('text', ''))}"))

    def graph_distance(self, question: str,
                       candidates: Sequence[Dict[str, Any]]) -> Optional[int]:
        """Hop count anchor -> answer over the candidate note graph.

        anchor = candidate with the highest question token overlap
        (ref :231-260); answer = the top-ranked candidate; edges connect
        notes sharing an entity or a doc (ref builds similarity/entity-
        overlap edges, :82-130). Returns None when undefined (no distinct
        anchor, or unreachable) so the caller falls back to complexity.
        """
        n = len(candidates)
        if n < 2:
            return None
        q_toks = set(tokenize_no_stop(question))
        overlaps = [len(q_toks & self._note_tokens(c)) / max(len(q_toks), 1)
                    for c in candidates]
        anchor = max(range(n), key=lambda i: overlaps[i])
        answer = 0
        if anchor == answer or overlaps[anchor] == 0:
            return None

        ent_sets: List[set] = [
            set(str(e).lower() for e in (c.get("entities") or [])) for c in candidates]
        adj: List[List[int]] = [[] for _ in range(n)]
        for i in range(n):
            for j in range(i + 1, n):
                if (ent_sets[i] & ent_sets[j]) or (
                        candidates[i].get("doc_id") is not None
                        and candidates[i].get("doc_id") == candidates[j].get("doc_id")):
                    adj[i].append(j)
                    adj[j].append(i)
        width = max((len(a) for a in adj), default=0)
        if width == 0:
            return None

        import numpy as np
        import torch

        from anorag_tpu_torch.ops.graph import k_hop_distances

        nbr = np.full((n, width), -1, np.int32)
        for i, a in enumerate(adj):
            nbr[i, : len(a)] = a
        seed = np.zeros((n,), bool)
        seed[anchor] = True
        # a graph of one query's candidates (tens of nodes), on the host
        _, hops = k_hop_distances(
            torch.from_numpy(nbr), torch.ones((n, width), dtype=torch.float32),
            torch.from_numpy(seed), k_hops=self.max_k)
        h = int(hops[answer])
        return h if h >= 0 else None

    def estimate_K_from_candidates(
            self, question: str,
            candidates: Sequence[Dict[str, Any]]) -> int:
        """Reference :41-77 semantics: K = anchor->answer path length + 1
        when the graph yields a distance, else the complexity heuristic."""
        d = self.graph_distance(question, candidates)
        if d is not None and d > 0:
            return int(min(max(d + 1, self.base_k, 1), self.max_k))
        return self.estimate_K(question)

    def calibrate(self, dev_items: list, predicted_fn) -> Dict[str, Any]:
        """Sweep complexity_per_k to best match gold support counts."""
        best, best_err = self.thresholds["complexity_per_k"], float("inf")
        for cand in (0.5, 0.75, 1.0, 1.5, 2.0):
            self.thresholds["complexity_per_k"] = cand
            err = 0.0
            for item in dev_items:
                gold_k = len(item.get("gold_support_idxs", []) or []) or 2
                err += abs(self.estimate_K(item.get("question", "")) - gold_k)
            if err < best_err:
                best_err, best = err, cand
        self.thresholds["complexity_per_k"] = best
        return {"complexity_per_k": best, "abs_error": best_err}
