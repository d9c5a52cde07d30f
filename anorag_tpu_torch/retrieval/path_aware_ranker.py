"""Counterpart of anorag_tpu/retrieval/path_aware_ranker.py,
copied as it is with its imports renamed to anorag_tpu_torch.

PathAwareRanker: per-query entity-graph reranking.

Parity target: upstream retrieval/path_aware_ranker.py — a
self-contained reranker that (1) extracts entities/relations from the query
and candidate texts with rules (:248-392), (2) builds an in-memory
lightweight entity graph with BFS path finding and k-hop expansion
(:77-246), (3) scores each candidate
    path_score = 0.4*key_entity_coverage + 0.3*expanded_coverage
               + 0.3*avg_path_score                        (:712-759)
and blends
    final = w_sem*semantic + w_ent*entity_overlap + w_cons*path_consistency
          + w_path*path_score, x0.7 soft penalty when the query has no
    extractable entities (:510-624), attaching path explanations (:761-810).
"""
from __future__ import annotations

import functools
import re
from collections import defaultdict, deque
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from anorag_tpu_torch.utils.logging import log_performance
from anorag_tpu_torch.utils.text import extract_entities_fallback, tokenize_no_stop

_PREDICATE_MAP = {
    "performed_by": r"\bperform(?:ed|s)? by\b|\bperformer\b|\bsings?\b|\bsang\b",
    "spouse_of": r"\bspouse\b|\bmarried\b|\bwife\b|\bhusband\b",
    "born_in": r"\bborn (?:in|at)\b|\bbirthplace\b",
    "member_of": r"\bmember of\b|\bjoined\b|\bbelongs to\b",
    "located_in": r"\blocated in\b|\bsituated\b|\bcapital of\b",
    "founded_by": r"\bfounded\b|\bfounder\b|\bestablished\b",
    "directed_by": r"\bdirect(?:ed|or)\b",
    "released_in": r"\breleased?\b",
}
_PREDICATE_COMPILED = [(p, re.compile(pat)) for p, pat in _PREDICATE_MAP.items()]


@functools.lru_cache(maxsize=65536)
def predicates_of(text_low: str) -> Tuple[str, ...]:
    """Predicate labels whose cue patterns match the (lowercased) text.
    Cached: notes are static per KB and validators/rankers re-extract the
    same texts every query (profiled at 94k regex searches per 3 batches)."""
    return tuple(p for p, pat in _PREDICATE_COMPILED if pat.search(text_low))


class EntityGraph:
    """Tiny per-query entity graph: nodes = lowercase entities, edges tagged
    with predicates + the contributing candidate index."""

    def __init__(self):
        self.adj: Dict[str, List[Tuple[str, str, int]]] = defaultdict(list)

    def add(self, a: str, b: str, rel: str, cand_idx: int) -> None:
        a, b = a.lower(), b.lower()
        if a == b:
            return
        self.adj[a].append((b, rel, cand_idx))
        self.adj[b].append((a, rel, cand_idx))

    def k_hop(self, seeds: Sequence[str], k: int = 2) -> Set[str]:
        seen = set(s.lower() for s in seeds if s.lower() in self.adj)
        frontier = set(seen)
        for _ in range(k):
            nxt = set()
            for u in frontier:
                for v, _, _ in self.adj[u]:
                    if v not in seen:
                        nxt.add(v)
            seen |= nxt
            frontier = nxt
        return seen

    def find_paths(self, src: str, dst: str, max_len: int = 3) -> List[List[str]]:
        src, dst = src.lower(), dst.lower()
        if src not in self.adj:
            return []
        out, q = [], deque([[src]])
        while q:
            path = q.popleft()
            if len(path) > max_len:
                continue
            u = path[-1]
            if u == dst and len(path) > 1:
                out.append(path)
                continue
            for v, _, _ in self.adj[u]:
                if v not in path:
                    q.append(path + [v])
        return out


class PathAwareRanker:
    def __init__(
        self,
        w_semantic: float = 0.4,
        w_entity: float = 0.2,
        w_consistency: float = 0.15,
        w_path: float = 0.25,
        no_entity_penalty: float = 0.7,
        k_hop: int = 2,
    ):
        self.w_semantic = w_semantic
        self.w_entity = w_entity
        self.w_consistency = w_consistency
        self.w_path = w_path
        self.no_entity_penalty = no_entity_penalty
        self.k_hop = k_hop

    # ---------------------------------------------------------- extraction
    @staticmethod
    def extract_entities(text: str) -> List[str]:
        return extract_entities_fallback(text, max_entities=12)

    @staticmethod
    def extract_predicates(text: str) -> List[str]:
        return list(predicates_of((text or "").lower()))

    def _edge_triples(self, candidates: Sequence[Dict[str, Any]]):
        """Interned (src, dst, cand_idx, rel) edge lists + id<->entity maps.

        One extraction pass shared by the native (C++) and Python graph
        paths; edge order here defines BFS path order in both."""
        ent2id: Dict[str, int] = {}
        id2ent: List[str] = []
        src: List[int] = []
        dst: List[int] = []
        cnd: List[int] = []
        rels: List[str] = []
        for i, c in enumerate(candidates):
            text = f"{c.get('title','')} {c.get('content','')}"
            ents = [str(e) for e in (c.get("entities") or [])] or self.extract_entities(text)
            ents = [e.lower() for e in ents]
            preds = self.extract_predicates(text)
            rel = preds[0] if preds else "related_to"
            for a in range(len(ents)):
                for b in range(a + 1, min(len(ents), a + 5)):
                    ea, eb = ents[a], ents[b]
                    if ea == eb:
                        continue
                    for e in (ea, eb):
                        if e not in ent2id:
                            ent2id[e] = len(id2ent)
                            id2ent.append(e)
                    src.append(ent2id[ea])
                    dst.append(ent2id[eb])
                    cnd.append(i)
                    rels.append(rel)
        return src, dst, cnd, rels, ent2id, id2ent

    def _build_graph(self, candidates: Sequence[Dict[str, Any]]) -> EntityGraph:
        g = EntityGraph()
        src, dst, cnd, rels, _, id2ent = self._edge_triples(candidates)
        for a, b, i, rel in zip(src, dst, cnd, rels):
            g.add(id2ent[a], id2ent[b], rel, i)
        return g

    def _graph_features(
        self, candidates: Sequence[Dict[str, Any]], q_entities: Sequence[str],
        use_native: Optional[bool] = None,
    ) -> Tuple[Set[str], np.ndarray]:
        """(k-hop expanded entity set, per-candidate path-edge contribution
        counts). C++ fast path (anorag_pathrank) with a pure-Python fallback
        of identical semantics."""
        n = len(candidates)
        if not q_entities:
            return set(), np.zeros(n, np.int32)
        src, dst, cnd, rels, ent2id, id2ent = self._edge_triples(candidates)
        q_ids = [ent2id.get(e, -1) for e in q_entities]

        if use_native is not False:
            from anorag_tpu_torch.native import pathrank_native

            res = pathrank_native(src, dst, cnd, len(id2ent), n, q_ids,
                                  k_hop=self.k_hop, max_len=3, per_pair_cap=8)
            if res is not None:
                mask, contributing = res
                expanded = {id2ent[j] for j in np.nonzero(mask)[0]}
                return expanded, contributing
            if use_native is True:
                raise RuntimeError("native pathrank requested but unavailable")

        g = EntityGraph()
        for a, b, i, rel in zip(src, dst, cnd, rels):
            g.add(id2ent[a], id2ent[b], rel, i)
        expanded = g.k_hop(list(q_entities), self.k_hop)
        counts: Dict[int, int] = defaultdict(int)
        for a in range(len(q_entities)):
            for b in range(a + 1, len(q_entities)):
                for path in g.find_paths(q_entities[a], q_entities[b], max_len=3)[:8]:
                    for u, v in zip(path, path[1:]):
                        for (w, _, ci) in g.adj[u]:
                            if w == v:
                                counts[ci] += 1
        contributing = np.zeros(n, np.int32)
        for ci, cnt in counts.items():
            contributing[ci] = cnt
        return expanded, contributing

    # ------------------------------------------------------------- ranking
    @log_performance
    def rerank_candidates(self, query: str, candidates: List[Dict[str, Any]],
                          top_k: Optional[int] = None) -> List[Dict[str, Any]]:
        if not candidates:
            return []
        q_entities = [e.lower() for e in self.extract_entities(query)]
        expanded, contributing = self._graph_features(candidates, q_entities)
        q_tokens = set(tokenize_no_stop(query))

        n = len(candidates)
        semantic = np.array(
            [float(c.get("final_score", c.get("similarity", 0.0))) for c in candidates],
            np.float32,
        )
        mx = semantic.max()
        if mx > 0:
            semantic = semantic / mx

        key_cov = np.zeros(n, np.float32)
        exp_cov = np.zeros(n, np.float32)
        ent_overlap = np.zeros(n, np.float32)
        consistency = np.zeros(n, np.float32)
        for i, c in enumerate(candidates):
            c_ents = set(str(e).lower() for e in (c.get("entities") or []))
            text_toks = set(tokenize_no_stop(f"{c.get('title','')} {c.get('content','')}"))
            if q_entities:
                key_cov[i] = len(c_ents & set(q_entities)) / len(q_entities)
                if expanded:
                    exp_cov[i] = len(c_ents & expanded) / len(expanded)
            if c_ents:
                ent_overlap[i] = len(text_toks & q_tokens) / max(len(q_tokens), 1)
            preds = self.extract_predicates(c.get("content") or "")
            q_preds = self.extract_predicates(query)
            if q_preds:
                consistency[i] = len(set(preds) & set(q_preds)) / len(set(q_preds))

        # avg path score: candidates contributing edges on paths between
        # query entities get credit
        avg_path = np.zeros(n, np.float32)
        top = contributing.max() if contributing.size else 0
        if top > 0:
            avg_path = contributing.astype(np.float32) / float(top)

        path_score = 0.4 * key_cov + 0.3 * exp_cov + 0.3 * avg_path
        final = (
            self.w_semantic * semantic + self.w_entity * ent_overlap
            + self.w_consistency * consistency + self.w_path * path_score
        )
        if not q_entities:
            final = final * self.no_entity_penalty

        order = np.argsort(-final, kind="stable")
        out = []
        for i in order[: top_k or n]:
            c = dict(candidates[int(i)])
            c["path_aware_score"] = float(final[i])
            c["final_score"] = float(final[i])
            c["path_info"] = {
                "key_entity_coverage": float(key_cov[i]),
                "expanded_coverage": float(exp_cov[i]),
                "avg_path_score": float(avg_path[i]),
                "explanation": self._explain(candidates[int(i)], q_entities),
            }
            out.append(c)
        return out

    @staticmethod
    def _explain(candidate: Dict[str, Any], q_entities: Sequence[str]) -> str:
        hits = [
            str(e) for e in (candidate.get("entities") or [])
            if str(e).lower() in set(q_entities)
        ]
        if hits:
            return f"covers query entities: {', '.join(hits)}"
        return "no direct query-entity coverage"
