"""GraphAwareRetrieval: two-stage path generation + diverse selection.

Counterpart of anorag_tpu/graph/graph_retrieval.py, copied with its
imports renamed, except subgraph_nodes, whose thresholded relaxation runs
on the graph's device (ops/graph.k_hop_distances on the graph's tensors),
and generate_and_select_paths, which takes the endpoints' similarities to
the query in one call on the graph index's device (GraphIndex.cosines)
where the reference takes them row by row on the host.

Parity target: upstream graph/graph_retrieval.py — build a subgraph
around semantic+BM25 seeds within a radius / edge-weight threshold (:77),
generate paths outward from each node (:213), score each path as
  alpha * endpoint_sim + beta * avg_edge_weight + gamma * entity_coverage
  - length_penalty * len                                   (:241)
then select greedily with an overlap penalty (:279-338). Path scoring is
vectorized (ops.graph.path_score_components).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from anorag_tpu_torch.graph.graph_index import GraphIndex
from anorag_tpu_torch.ops.graph import k_hop_distances, path_score_components


class GraphAwareRetrieval:
    def __init__(
        self,
        graph_index: GraphIndex,
        radius: int = 2,
        edge_threshold: float = 0.3,
        alpha: float = 0.5,
        beta: float = 0.3,
        gamma: float = 0.2,
        length_penalty: float = 0.05,
        max_path_len: int = 3,
        overlap_penalty: float = 0.5,
    ):
        self.gi = graph_index
        self.radius = radius
        self.edge_threshold = edge_threshold
        self.alpha = alpha
        self.beta = beta
        self.gamma = gamma
        self.length_penalty = length_penalty
        self.max_path_len = max_path_len
        self.overlap_penalty = overlap_penalty

    def subgraph_nodes(self, seed_idxs: Sequence[int]) -> List[int]:
        """Nodes within `radius` hops of any seed via edges above threshold."""
        g = self.gi.graph
        if not seed_idxs or g is None:
            return []
        t = g.tensors()
        mask = torch.zeros(g.n_nodes, dtype=torch.bool, device=t["nbr"].device)
        mask[[s for s in seed_idxs if 0 <= s < g.n_nodes]] = True
        nbr_w = torch.where(t["nbr_w"] >= self.edge_threshold, t["nbr_w"], 0.0)
        nbr = torch.where(nbr_w > 0, t["nbr"], -1)
        dist, _ = k_hop_distances(nbr, nbr_w, mask, self.radius)
        return [int(i) for i in np.nonzero(dist.cpu().numpy() < 1e30)[0]]

    def _paths_from(self, start: int, nodes: set) -> List[List[int]]:
        g = self.gi.graph
        paths = [[start]]
        out = []
        for _ in range(self.max_path_len - 1):
            nxt = []
            for p in paths:
                u = p[-1]
                for j in range(g.nbr.shape[1]):
                    v = int(g.nbr[u, j])
                    if v < 0:
                        break
                    if v in p or v not in nodes or g.nbr_w[u, j] < self.edge_threshold:
                        continue
                    nxt.append(p + [v])
            out.extend(nxt)
            paths = nxt
            if not paths:
                break
        return out

    def generate_and_select_paths(
        self,
        seed_idxs: Sequence[int],
        query_emb: Optional[np.ndarray] = None,
        query_entities: Sequence[str] = (),
        max_paths: int = 8,
    ) -> List[Dict[str, Any]]:
        nodes = self.subgraph_nodes(seed_idxs)
        node_set = set(nodes)
        all_paths: List[List[int]] = []
        for s in seed_idxs:
            if s in node_set:
                all_paths.extend(self._paths_from(s, node_set))
        if not all_paths:
            all_paths = [[s] for s in seed_idxs if s in node_set]
        if not all_paths:
            return []

        g = self.gi.graph
        maxlen = max(len(p) for p in all_paths)
        pw = np.zeros((len(all_paths), max(maxlen - 1, 1)), np.float32)
        plen = np.zeros(len(all_paths), np.int32)
        endpoint = np.zeros(len(all_paths), np.float32)
        coverage = np.zeros(len(all_paths), np.float32)
        q_ents = set(e.lower() for e in query_entities)
        if query_emb is not None and self.gi.embeddings is not None:
            endpoint[:] = self.gi.cosines(query_emb, [p[-1] for p in all_paths])
        for i, p in enumerate(all_paths):
            plen[i] = len(p)
            for h in range(len(p) - 1):
                u, v = p[h], p[h + 1]
                j = int(np.argmax(g.nbr[u] == v))
                pw[i, h] = g.nbr_w[u, j]
            if q_ents:
                covered = set()
                for n in p:
                    covered |= q_ents & set(
                        str(x).lower() for x in (self.gi.note(n).get("entities") or [])
                    )
                coverage[i] = len(covered) / len(q_ents)
        scores = path_score_components(
            pw, np.maximum(plen - 1, 0), endpoint, coverage,
            alpha=self.alpha, beta=self.beta, gamma=self.gamma,
            length_penalty=self.length_penalty,
        )
        # greedy diverse selection with node-overlap penalty
        order = np.argsort(-scores, kind="stable")
        chosen: List[int] = []
        covered_nodes: set = set()
        for i in order:
            p = all_paths[int(i)]
            overlap = len(set(p) & covered_nodes) / len(p)
            if scores[i] - self.overlap_penalty * overlap <= 0 and chosen:
                continue
            chosen.append(int(i))
            covered_nodes |= set(p)
            if len(chosen) >= max_paths:
                break
        return [
            {
                "nodes": all_paths[i],
                "note_ids": [self.gi.note(n).get("note_id") for n in all_paths[i]],
                "score": float(scores[i]),
            }
            for i in chosen
        ]
