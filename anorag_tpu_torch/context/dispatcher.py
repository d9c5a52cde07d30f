"""Counterpart of anorag_tpu/context/dispatcher.py,
copied as it is with its imports renamed to anorag_tpu_torch.

ContextDispatcher: structure-enhanced final-context selection.

Parity target: upstream utils/context_dispatcher.py — two modes:
  * legacy quota: split candidates into semantic vs graph by source tag,
    take top final_semantic_count (8) / final_graph_count (5), merge, and
    apply the bridge policy (keepalive = bridge notes always survive;
    boost = +epsilon to bridge scores) (:68-105);
  * graph-aware two-stage: stage 1 selects paths via GraphAwareRetrieval,
    stage 2 greedily fills a token budget (1800) maximizing coverage gain
    minus redundancy (:107-250).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from anorag_tpu_torch.utils.logging import get_logger
from anorag_tpu_torch.utils.text import estimate_tokens, tokenize_no_stop

logger = get_logger("anorag.context")


class ContextDispatcher:
    def __init__(
        self,
        final_semantic_count: int = 8,
        final_graph_count: int = 5,
        bridge_policy: str = "keepalive",     # keepalive | boost | none
        bridge_boost_epsilon: float = 0.02,
        use_graph_aware: bool = False,
        token_budget: int = 1800,
        graph_aware_retrieval=None,
        debug_log: bool = False,
    ):
        self.final_semantic_count = final_semantic_count
        self.final_graph_count = final_graph_count
        self.bridge_policy = bridge_policy
        self.bridge_boost_epsilon = bridge_boost_epsilon
        self.use_graph_aware = use_graph_aware
        self.token_budget = token_budget
        self.gar = graph_aware_retrieval
        self.debug_log = debug_log

    @classmethod
    def from_config(cls, cfg, graph_aware_retrieval=None) -> "ContextDispatcher":
        d = cfg.get("context_dispatcher", {}) or {}
        return cls(
            final_semantic_count=d.get("final_semantic_count", 8),
            final_graph_count=d.get("final_graph_count", 5),
            bridge_policy=d.get("bridge_policy", "keepalive"),
            bridge_boost_epsilon=d.get("bridge_boost_epsilon", 0.02),
            use_graph_aware=d.get("use_graph_aware", False),
            token_budget=d.get("token_budget", 1800),
            graph_aware_retrieval=graph_aware_retrieval,
            debug_log=d.get("debug_log", False),
        )

    # -------------------------------------------------------------- entry
    def dispatch(self, candidates: List[Dict[str, Any]], query: str = "",
                 query_emb: Optional[np.ndarray] = None) -> List[Dict[str, Any]]:
        if not candidates:
            return []
        if self.use_graph_aware and self.gar is not None:
            return self._dispatch_graph_aware(candidates, query, query_emb)
        return self._dispatch_legacy(candidates)

    # ------------------------------------------------------------- legacy
    @staticmethod
    def _score(c: Dict[str, Any]) -> float:
        return float(c.get("final_score", c.get("final_similarity", c.get("similarity", 0.0))))

    @staticmethod
    def _is_bridge(c: Dict[str, Any]) -> bool:
        tags = c.get("tags") or {}
        return bool(c.get("is_bridge") or tags.get("is_bridge") or c.get("bridge_entity"))

    @staticmethod
    def _source(c: Dict[str, Any]) -> str:
        tags = c.get("tags") or {}
        src = tags.get("source") or c.get("retrieval_method") or "semantic"
        return "graph" if src == "graph" else "semantic"

    def _dispatch_legacy(self, candidates: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        cands = [dict(c) for c in candidates]
        if self.bridge_policy == "boost":
            for c in cands:
                if self._is_bridge(c):
                    c["final_score"] = self._score(c) + self.bridge_boost_epsilon
        semantic = sorted((c for c in cands if self._source(c) == "semantic"),
                          key=self._score, reverse=True)
        graph = sorted((c for c in cands if self._source(c) == "graph"),
                       key=self._score, reverse=True)
        selected = semantic[: self.final_semantic_count] + graph[: self.final_graph_count]
        if self.bridge_policy == "keepalive":
            chosen = {id(c) for c in selected}
            for c in cands:
                if self._is_bridge(c) and id(c) not in chosen:
                    selected.append(c)
        selected.sort(key=self._score, reverse=True)
        if self.debug_log:
            logger.info("dispatch: %d semantic, %d graph, %d final",
                        len(semantic), len(graph), len(selected))
        return selected

    # --------------------------------------------------------- graph-aware
    def _dispatch_graph_aware(self, candidates, query, query_emb) -> List[Dict[str, Any]]:
        by_id = {c.get("note_id"): c for c in candidates}
        seed_idxs = [
            self.gar.gi.idx_of(nid) for nid in by_id if self.gar.gi.idx_of(nid) >= 0
        ]
        paths = self.gar.generate_and_select_paths(seed_idxs[:10], query_emb=query_emb)
        # stage-1 pool: path notes first, then remaining candidates by score
        pool: List[Dict[str, Any]] = []
        seen = set()
        for p in paths:
            for nid in p["note_ids"]:
                if nid in seen:
                    continue
                seen.add(nid)
                note = by_id.get(nid) or dict(self.gar.gi.note(self.gar.gi.idx_of(nid)))
                pool.append(note)
        for c in sorted(candidates, key=self._score, reverse=True):
            if c.get("note_id") not in seen:
                pool.append(c)
                seen.add(c.get("note_id"))
        # stage 2: greedy token-budget fill maximizing coverage - redundancy
        q_toks = set(tokenize_no_stop(query))
        covered: set = set()
        budget = self.token_budget
        selected: List[Dict[str, Any]] = []
        for c in pool:
            text = f"{c.get('title','')} {c.get('content','')}"
            cost = estimate_tokens(text)
            if cost > budget:
                continue
            toks = set(tokenize_no_stop(text))
            gain = len((toks & q_toks) - covered) + 0.1 * len(toks - covered)
            redundancy = len(toks & covered) / max(len(toks), 1)
            if selected and gain - redundancy <= 0:
                continue
            selected.append(c)
            covered |= toks
            budget -= cost
            if budget <= 0:
                break
        return selected
