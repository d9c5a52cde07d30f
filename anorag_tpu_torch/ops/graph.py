"""Graph compute as tensor ops: the k-hop shortest-distance relaxation.

Counterpart of anorag_tpu/ops/graph.py::k_hop_distances (:124-155), the
primitive that KEstimator.graph_distance calls. The reference computes it
with jax.numpy outside any Pallas kernel; here it is plain torch on the
tensors' device. The rest of the module (CSR graphs, PageRank, k-hop
scores) serves the per-query graph pipeline and is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

INF = 3.0e38


def k_hop_distances(nbr: torch.Tensor, nbr_w: torch.Tensor, seed_mask: torch.Tensor,
                    k_hops: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted shortest distance from the seed set within k hops.

    Bellman-Ford style relaxation, k rounds over the padded (N, max_deg)
    neighbour table nbr (-1 pads) with edge lengths nbr_w: dist (N,) f32
    (INF if unreachable), hops (N,) i32 = the round at which a node was
    first reached (-1 if never, 0 for a seed).
    """
    n = nbr.shape[0]
    valid = nbr >= 0
    flat_target = nbr.clamp_min(0).reshape(-1).long()
    inf = torch.tensor(INF, dtype=torch.float32, device=nbr.device)
    dist = torch.where(seed_mask, torch.zeros((), device=nbr.device), inf)
    hops = torch.where(seed_mask, 0, -1).to(torch.int32)
    edge_w = torch.where(valid, nbr_w.to(torch.float32), inf)
    for h in range(k_hops):
        # candidate distance to each node via incoming edges:
        # for edge (i -> nbr[i, j]): dist[i] + w
        cand = torch.where(valid, dist[:, None] + edge_w, inf).reshape(-1)
        best = torch.full((n,), INF, dtype=torch.float32, device=nbr.device)
        best = best.scatter_reduce(0, flat_target, cand, "amin")
        improved = best < dist
        dist = torch.where(improved, best, dist)
        hops = torch.where(improved & (hops < 0), h + 1, hops).to(torch.int32)
    return dist, hops
