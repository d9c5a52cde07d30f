"""GraphRetriever: k-hop retrieval + reasoning-path retrieval.

Counterpart of anorag_tpu/graph/retriever.py, copied with its imports
renamed, except _initial_candidates (:118-145): the reference normalizes
the whole (N, D) corpus on the host for every query; here the embedding
scores are one matvec on the graph index's device with its row norms
computed once (GraphIndex.cosines), equal to the reference's up to
rounding.

Parity target: upstream graph/graph_retriever.py — two modes:
  (a) k-hop: weighted shortest-path from seed notes within cutoff k;
      score = centrality / (distance + eps) * importance (:61-92). Here the
      per-seed Dijkstra loop becomes ONE on-device multi-source relaxation
      (ops.graph.k_hop_distances) since scores only need the min distance to
      the seed set.
  (b) reasoning paths: initial candidates from embedding/keyword/entity
      signals (:128-201), bounded BFS path discovery (:635), composite path
      scoring (relation weights + centrality + coherence + topic consistency
      + keyword overlap + reasoning value, :290-470), diversity selection by
      node-overlap threshold (:472-513), result notes with path explanations
      (:514-634).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from anorag_tpu_torch.graph.graph_index import GraphIndex
from anorag_tpu_torch.graph.relation_extractor import RELATION_TYPES
from anorag_tpu_torch.ops.graph import k_hop_scores
from anorag_tpu_torch.utils.text import tokenize_no_stop

_TYPE_NAMES = list(RELATION_TYPES)


@dataclass
class ReasoningPath:
    nodes: List[int]
    relations: List[str] = field(default_factory=list)
    score: float = 0.0

    def explanation(self, gi: GraphIndex) -> str:
        parts = []
        for i, n in enumerate(self.nodes):
            title = gi.note(n).get("title") or gi.note(n).get("note_id")
            parts.append(str(title))
            if i < len(self.relations):
                parts.append(f"--[{self.relations[i]}]-->")
        return " ".join(parts)


class GraphRetriever:
    def __init__(
        self,
        graph_index: GraphIndex,
        k_hop: int = 2,
        max_hops: int = 3,
        max_paths: int = 10,
        min_path_score: float = 0.3,
        min_path_score_floor: float = 0.1,
        min_path_score_step: float = 0.05,
        path_diversity_threshold: float = 0.7,
        max_initial_candidates: int = 20,
        branch_factor: int = 6,
    ):
        self.gi = graph_index
        self.k_hop = k_hop
        self.max_hops = max_hops
        self.max_paths = max_paths
        self.min_path_score = min_path_score
        self.min_path_score_floor = min_path_score_floor
        self.min_path_score_step = min_path_score_step
        self.diversity_threshold = path_diversity_threshold
        self.max_initial_candidates = max_initial_candidates
        self.branch_factor = branch_factor
        # lazy inverted indexes over the STATIC note corpus: token -> note
        # ids and entity -> note ids. The per-query scan that re-tokenized
        # all N notes profiled at ~40 ms/query on 10k notes; with the
        # inverted form a query touches only its terms' posting lists.
        self._tok_index: Optional[Dict[str, List[int]]] = None
        self._ent_index: Optional[Dict[str, List[int]]] = None
        self._ent_sets: Optional[List[set]] = None

    def _ensure_indexes(self) -> None:
        if self._tok_index is not None:
            return
        tok_index: Dict[str, List[int]] = {}
        ent_index: Dict[str, List[int]] = {}
        ent_sets: List[set] = []
        for i, n in enumerate(self.gi.notes):
            toks = set(tokenize_no_stop(f"{n.get('title','')} {n.get('content','')}"))
            for t in toks:
                tok_index.setdefault(t, []).append(i)
            nents = set(str(e).lower() for e in (n.get("entities") or []))
            ent_sets.append(nents)
            for e in nents:
                ent_index.setdefault(e, []).append(i)
        self._tok_index, self._ent_index, self._ent_sets = tok_index, ent_index, ent_sets

    # -------------------------------------------------------------- k-hop
    def retrieve(self, seed_note_ids: Sequence[str], top_k: int = 20,
                 importance: Optional[np.ndarray] = None) -> List[Dict[str, Any]]:
        """k-hop expansion from seeds, scored centrality/(dist+eps)."""
        seeds = [self.gi.idx_of(nid) for nid in seed_note_ids]
        seeds = [s for s in seeds if s >= 0]
        if not seeds or not self.gi.notes:
            return []
        scores = k_hop_scores(self.gi.graph, seeds, self.gi.centrality, k_hops=self.k_hop)
        if importance is not None:
            scores = scores * np.asarray(importance, np.float32)
        order = np.argsort(-scores, kind="stable")
        out = []
        for i in order[:top_k]:
            if scores[i] <= 0:
                break
            note = dict(self.gi.note(int(i)))
            note["graph_score"] = float(scores[i])
            note["retrieval_method"] = "graph"
            out.append(note)
        return out

    # ---------------------------------------------------- reasoning paths
    def _initial_candidates(
        self,
        query_emb: Optional[np.ndarray],
        keywords: Sequence[str],
        entities: Sequence[str],
    ) -> List[int]:
        scores = np.zeros(len(self.gi.notes), np.float32)
        if query_emb is not None and self.gi.embeddings is not None:
            # one matvec on the index's device with its cached row norms
            scores += self.gi.cosines(query_emb)
        kw = set(k.lower() for k in keywords)
        ents = set(e.lower() for e in entities)
        if kw or ents:
            # inverted-index accumulation == the old full scan's
            # 0.3*|kw n toks| + 0.5*|ents n nents| per note (each matching
            # term contributes exactly once per note)
            self._ensure_indexes()
            for k in kw:
                for i in self._tok_index.get(k, ()):
                    scores[i] += 0.3
            for e in ents:
                for i in self._ent_index.get(e, ()):
                    scores[i] += 0.5
        order = np.argsort(-scores, kind="stable")
        return [int(i) for i in order[: self.max_initial_candidates] if scores[i] > 0]

    def _discover_paths(self, starts: Sequence[int]) -> List[ReasoningPath]:
        """Bounded-width BFS over the padded neighbor table."""
        g = self.gi.graph
        paths: List[ReasoningPath] = []
        for s in starts:
            frontier = [ReasoningPath(nodes=[s])]
            for _ in range(self.max_hops):
                nxt: List[ReasoningPath] = []
                for p in frontier:
                    u = p.nodes[-1]
                    order = np.argsort(-g.nbr_w[u], kind="stable")[: self.branch_factor]
                    for j in order:
                        v = int(g.nbr[u, j])
                        if v < 0 or v in p.nodes:
                            continue
                        nxt.append(
                            ReasoningPath(
                                nodes=p.nodes + [v],
                                relations=p.relations + [_TYPE_NAMES[int(g.nbr_t[u, j])]],
                            )
                        )
                if not nxt:
                    break
                frontier = nxt[: self.max_paths * 4]
                paths.extend(frontier)
        return paths

    def _score_path(self, p: ReasoningPath, keywords: Sequence[str],
                    topic_of: Optional[Dict[int, int]] = None) -> float:
        g = self.gi.graph
        # relation-type weight + reasoning value along edges
        rel_w, rv = [], []
        for i in range(len(p.nodes) - 1):
            u, v = p.nodes[i], p.nodes[i + 1]
            row = g.nbr[u]
            j = int(np.argmax(row == v))
            rel_w.append(float(g.nbr_w[u, j]))
            rv.append(RELATION_TYPES.get(p.relations[i], (0.5, 0.5))[1])
        # tiny python lists: sum/len beats np.mean dispatch (profiled 22k
        # np.mean calls per 12 queries in this scorer)
        rel_score = sum(rel_w) / len(rel_w) if rel_w else 0.0
        reasoning = sum(rv) / len(rv) if rv else 0.0
        # node centrality
        cent = self.gi.centrality
        centrality = sum(float(cent[n]) for n in p.nodes) / len(p.nodes)
        cent_norm = centrality * len(self.gi.notes)  # ~1 for average node
        # coherence: consecutive notes share entities (precomputed sets)
        self._ensure_indexes()
        coher = []
        for i in range(len(p.nodes) - 1):
            a = self._ent_sets[p.nodes[i]]
            b = self._ent_sets[p.nodes[i + 1]]
            coher.append(1.0 if a & b else 0.0)
        coherence = sum(coher) / len(coher) if coher else 0.0
        # topic consistency
        if topic_of:
            topics = [topic_of.get(n, -1) for n in p.nodes]
            topic_cons = float(len(set(topics)) == 1)
        else:
            topic_cons = 0.5
        # keyword overlap
        kw = set(k.lower() for k in keywords)
        if kw:
            hit = 0
            for n in p.nodes:
                toks = set(tokenize_no_stop(self.gi.note(n).get("content") or ""))
                hit += bool(kw & toks)
            kw_overlap = hit / len(p.nodes)
        else:
            kw_overlap = 0.0
        return float(
            0.30 * rel_score + 0.15 * min(cent_norm, 2.0) / 2.0 + 0.20 * coherence
            + 0.10 * topic_cons + 0.10 * kw_overlap + 0.15 * reasoning
        )

    @staticmethod
    def _overlap(a: ReasoningPath, b: ReasoningPath) -> float:
        sa, sb = set(a.nodes), set(b.nodes)
        return len(sa & sb) / max(1, min(len(sa), len(sb)))

    def _select_diverse(self, paths: List[ReasoningPath]) -> List[ReasoningPath]:
        """Greedy by score; drop paths overlapping a kept path above the
        diversity threshold. Relax min score stepwise down to the floor if
        nothing passes (the reference's stepped relaxation)."""
        paths = sorted(paths, key=lambda p: -p.score)
        thr = self.min_path_score
        while True:
            kept: List[ReasoningPath] = []
            for p in paths:
                if p.score < thr:
                    break
                if all(self._overlap(p, q) < self.diversity_threshold for q in kept):
                    kept.append(p)
                if len(kept) >= self.max_paths:
                    break
            if kept or thr <= self.min_path_score_floor:
                return kept
            thr = max(self.min_path_score_floor, thr - self.min_path_score_step)

    def retrieve_with_reasoning_paths(
        self,
        query_emb: Optional[np.ndarray] = None,
        top_k: int = 20,
        keywords: Sequence[str] = (),
        entities: Sequence[str] = (),
        topic_of: Optional[Dict[int, int]] = None,
    ) -> Tuple[List[Dict[str, Any]], List[ReasoningPath]]:
        if not self.gi.notes:
            return [], []
        starts = self._initial_candidates(query_emb, keywords, entities)
        if not starts:
            return [], []
        paths = self._discover_paths(starts[:8])
        for p in paths:
            p.score = self._score_path(p, keywords, topic_of)
        selected = self._select_diverse(paths)
        # notes on selected paths, scored by best containing path
        best: Dict[int, float] = {}
        via: Dict[int, ReasoningPath] = {}
        for p in selected:
            for n in p.nodes:
                if p.score > best.get(n, -1.0):
                    best[n] = p.score
                    via[n] = p
        order = sorted(best, key=lambda n: -best[n])[:top_k]
        notes = []
        for n in order:
            note = dict(self.gi.note(n))
            note["graph_score"] = best[n]
            note["retrieval_method"] = "graph"
            note["path_explanation"] = via[n].explanation(self.gi)
            notes.append(note)
        return notes, selected
