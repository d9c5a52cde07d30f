"""Graph compute as tensor ops: CSR adjacency, PageRank, k-hop expansion,
components and path scores.

Counterpart of anorag_tpu/ops/graph.py, every name of it. The reference
computes these with jax.numpy outside any Pallas kernel; here they are
plain torch on the graph's device:
  * CSRGraph and build_csr (:28-92) are the same numpy arrays (CSR plus a
    padded (N, max_deg) neighbour table), with the device their tensors
    go to (`device`, the card unless the caller asks for the CPU) and
    those tensors uploaded once (CSRGraph.tensors);
  * pagerank (:95-122) is power iteration whose scatter of each node's
    mass sums every target's edges in a fixed order (segment_reduce over
    the edges sorted by target once), so two runs give the same bits;
  * k_hop_distances (:124-155) is a Bellman-Ford relaxation by
    scatter_reduce "amin"; k_hop_scores (:157-177) returns numpy, as the
    reference does;
  * k_hop_frontier (:180-195) and connected_components (:198-211) take
    their tensors on the graph's device; path_score_components (:214-229)
    is numpy, as the reference's.
Besides, the port's own row_norms and cosines: the cosines of corpus rows
with a query on the rows' device, their norms computed once for the f32
corpus copy that the processor's stages and its graph share.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from anorag_tpu_torch.device import DeviceLike, resolve_device

INF = 3.0e38


@dataclass
class CSRGraph:
    """Undirected weighted graph, CSR + padded neighbor table."""

    indptr: np.ndarray       # (N+1,)
    indices: np.ndarray      # (nnz,)
    weights: np.ndarray      # (nnz,) f32
    edge_types: np.ndarray   # (nnz,) i32 (index into type vocabulary)
    n_nodes: int
    # padded device form
    nbr: np.ndarray          # (N, max_deg) i32, -1 pad
    nbr_w: np.ndarray        # (N, max_deg) f32
    nbr_t: np.ndarray        # (N, max_deg) i32
    device: DeviceLike = None
    _tensors: Optional[Dict[str, torch.Tensor]] = field(default=None, repr=False,
                                                        compare=False)

    @property
    def n_edges(self) -> int:
        return len(self.indices) // 2

    def tensors(self) -> Dict[str, torch.Tensor]:
        """nbr (int64) and nbr_w on the graph's device, uploaded once."""
        if self._tensors is None:
            dev = resolve_device(self.device)
            self._tensors = {
                "nbr": torch.from_numpy(self.nbr).to(dev, torch.int64),
                "nbr_w": torch.from_numpy(self.nbr_w).to(dev),
            }
        return self._tensors


def build_csr(
    n_nodes: int,
    edges: Sequence[Tuple[int, int, float, int]],
    max_deg: Optional[int] = None,
    *,
    device: DeviceLike = None,
) -> CSRGraph:
    """edges = (u, v, weight, type_id), undirected (stored both ways).
    `device` is where the graph's tensors go (CSRGraph.tensors)."""
    if len(edges):
        arr = np.asarray([(u, v, w, t) for (u, v, w, t) in edges], dtype=np.float64)
        u = arr[:, 0].astype(np.int64)
        v = arr[:, 1].astype(np.int64)
        w = arr[:, 2].astype(np.float32)
        t = arr[:, 3].astype(np.int32)
        src = np.concatenate([u, v])
        dst = np.concatenate([v, u])
        ww = np.concatenate([w, w])
        tt = np.concatenate([t, t])
    else:
        src = dst = np.zeros(0, np.int64)
        ww = np.zeros(0, np.float32)
        tt = np.zeros(0, np.int32)

    order = np.argsort(src, kind="stable")
    src, dst, ww, tt = src[order], dst[order], ww[order], tt[order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)

    deg = np.diff(indptr)
    md = int(deg.max()) if n_nodes and len(src) else 1
    if max_deg is not None:
        md = min(md, max_deg)
    md = max(1, md)
    nbr = np.full((n_nodes, md), -1, np.int32)
    nbr_w = np.zeros((n_nodes, md), np.float32)
    nbr_t = np.zeros((n_nodes, md), np.int32)
    for i in range(n_nodes):
        lo, hi = indptr[i], indptr[i + 1]
        # keep strongest edges when truncating to max_deg
        seg = slice(lo, hi)
        ws = ww[seg]
        keep = np.argsort(-ws, kind="stable")[:md]
        k = len(keep)
        nbr[i, :k] = dst[seg][keep]
        nbr_w[i, :k] = ws[keep]
        nbr_t[i, :k] = tt[seg][keep]
    return CSRGraph(indptr, dst.astype(np.int32), ww, tt, n_nodes, nbr, nbr_w, nbr_t,
                    device=device)


def pagerank(nbr: torch.Tensor, nbr_w: torch.Tensor, alpha: float = 0.85,
             iters: int = 30) -> torch.Tensor:
    """Weighted PageRank by power iteration over the padded neighbor table
    (-1 pads), on the tensors' device.

    Matches networkx.pagerank semantics: transition probability out of node i
    along edge (i,j) = w_ij / sum_k w_ik; dangling mass redistributed
    uniformly.
    """
    n = nbr.shape[0]
    valid = nbr >= 0
    w = torch.where(valid, nbr_w.to(torch.float32), 0.0)
    # each row's weights summed column by column, in the reference's order
    out_sum = w[:, :1].clone()                           # (N, 1)
    for j in range(1, w.shape[1]):
        out_sum += w[:, j:j + 1]
    p_trans = torch.where(out_sum > 0, w / out_sum.clamp_min(1e-30), 0.0)
    dangling = out_sum[:, 0] <= 0
    # the edges by target (stable), once: each target's in-edges are then
    # summed in row order, whatever the threads' timing
    edge = torch.nonzero(valid.reshape(-1)).squeeze(1)
    target = nbr.reshape(-1)[edge].long()
    order = torch.argsort(target, stable=True)
    edge, in_deg = edge[order], torch.bincount(target, minlength=n)
    r = torch.full((n,), 1.0 / n, dtype=torch.float32, device=nbr.device)
    for _ in range(iters):
        contrib = (r[:, None] * p_trans).reshape(-1)[edge]
        flat = torch.segment_reduce(contrib, "sum", lengths=in_deg, unsafe=True)
        dangling_mass = torch.where(dangling, r, 0.0).sum()
        r = (1 - alpha) / n + alpha * (flat + dangling_mass / n)
    return r


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


def k_hop_scores(
    graph: CSRGraph,
    seeds: Sequence[int],
    centrality: np.ndarray,
    k_hops: int = 2,
    eps: float = 0.1,
) -> np.ndarray:
    """score(node) = centrality / (distance + eps) for reachable nodes, 0
    elsewhere — the k-hop retrieval scoring of GraphRetriever.retrieve,
    computed on the graph's device; (N,) f32 numpy."""
    seeds = [s for s in seeds if 0 <= s < graph.n_nodes]
    if not seeds:
        return np.zeros(graph.n_nodes, np.float32)
    t = graph.tensors()
    dev = t["nbr"].device
    seed_mask = torch.zeros(graph.n_nodes, dtype=torch.bool, device=dev)
    seed_mask[torch.tensor(seeds, device=dev)] = True
    dist, _ = k_hop_distances(t["nbr"], t["nbr_w"], seed_mask, k_hops)
    cent = torch.as_tensor(np.asarray(centrality, np.float32), device=dev)
    reach = dist < INF / 2
    return torch.where(reach, cent / (dist + eps), 0.0).cpu().numpy()


def k_hop_frontier(nbr: torch.Tensor, seed_mask: torch.Tensor, k_hops: int) -> torch.Tensor:
    """Boolean reachability within k hops (unweighted) — cheap expansion
    used for candidate pools."""
    valid = nbr >= 0
    flat_target = nbr.clamp_min(0).reshape(-1).long()
    n = nbr.shape[0]
    mask = seed_mask.to(torch.bool)
    for _ in range(k_hops):
        hits = torch.zeros((n,), dtype=torch.int32, device=nbr.device)
        hits.index_add_(0, flat_target, (mask[:, None] & valid).reshape(-1).to(torch.int32))
        mask = mask | (hits > 0)
    return mask


def connected_components(graph: CSRGraph, max_iters: int = 64) -> np.ndarray:
    """Label propagation components (for graph quality metrics), on the
    graph's device; (N,) int32 numpy labels."""
    t = graph.tensors()
    nbr = t["nbr"]
    valid = nbr >= 0
    safe = nbr.clamp_min(0)
    big = torch.iinfo(torch.int32).max
    labels = torch.arange(graph.n_nodes, dtype=torch.int32, device=nbr.device)
    for _ in range(max_iters):
        nbr_lab = torch.where(valid, labels[safe], big)
        labels = torch.minimum(labels, nbr_lab.min(dim=1).values)
    return labels.cpu().numpy()


def path_score_components(
    path_weights: np.ndarray,     # (P, L) edge weights along each path, 0 pad
    path_len: np.ndarray,         # (P,)
    endpoint_sim: np.ndarray,     # (P,)
    coverage: np.ndarray,         # (P,)
    alpha: float = 0.5,
    beta: float = 0.3,
    gamma: float = 0.2,
    length_penalty: float = 0.05,
) -> np.ndarray:
    """Vectorized path scoring: alpha*endpoint_sim + beta*avg_edge_weight +
    gamma*coverage - length_penalty*len
    (the GraphAwareRetrieval scoring form, graph/graph_retrieval.py:241)."""
    avg_w = path_weights.sum(axis=1) / np.maximum(path_len, 1)
    return (alpha * endpoint_sim + beta * avg_w + gamma * coverage
            - length_penalty * path_len).astype(np.float32)


def row_norms(emb: torch.Tensor) -> torch.Tensor:
    """max(|e|, 1e-9) of each row of emb, on its device, computed once per
    tensor and kept beside it (as its attribute `_row_norms`)."""
    norms = getattr(emb, "_row_norms", None)
    if norms is None:
        norms = emb._row_norms = torch.linalg.vector_norm(emb, dim=1).clamp_min(1e-9)
    return norms


def cosines(emb: torch.Tensor, q, rows: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Cosine of each row of emb (all, or `rows`) with the query q (D,),
    e.q / (max(|e|, 1e-9) * max(|q|, 1e-9)), on emb's device with
    row_norms: (len,) f32."""
    norms = row_norms(emb)
    if rows is not None:
        sel = torch.as_tensor(np.asarray(rows, np.int64), device=emb.device)
        emb, norms = emb[sel], norms[sel]
    q = torch.as_tensor(q, dtype=torch.float32).reshape(-1).to(emb.device)
    qn = max(float(torch.linalg.vector_norm(q)), 1e-9)
    return (emb @ q) / (norms * qn)
