"""TopicClustering: note embeddings -> topic pools.

Counterpart of anorag_tpu/doc/clustering.py, copied with its imports
renamed, except where the reference computes with jax.numpy: here that is
torch on the tensor's device, and TopicClustering takes the device
(keyword only; the card unless the caller asks for the CPU) and moves the
embeddings there. _pairwise_sq_dists (:29) is a matmul a row chunk and
returns the (N, N) tensor on that device; find_optimal_eps (:45) takes
its k-distance by torch.topk; density_cluster (:60) thresholds on the
device and walks the core points on the host as the reference does, with
the port's build_csr / connected_components; the k-means path runs the
port's auto_k and kmeans_fit on the device (numpy input counts as the
CPU, as in ops/kmeans.py).

Parity target: upstream doc/clustering.py — cluster note embeddings
(GPU cuML / CPU HDBSCAN/KMeans/DBSCAN in the reference, :71-170) and emit
labels + topic pools with keywords (:238-336). Methods here:
  * kmeans (default): Lloyd k-means (ops.kmeans) with elbow auto-K;
    optional low-cohesion noise drop;
  * dbscan / hdbscan: density clustering without per-point region
    queries: the k-distance matrix and eps-neighborhoods are batched
    matmuls + top-k, auto-eps is the k-distance knee (ref :149-170), and
    clusters are connected components of the core-point epsilon graph via
    ops.graph label propagation; border points adopt their nearest core's
    label, the rest are noise (-1).
"""
from __future__ import annotations

from collections import Counter, defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from anorag_tpu_torch.device import DeviceLike, resolve_device
from anorag_tpu_torch.ops.kmeans import auto_k, kmeans_fit
from anorag_tpu_torch.utils.logging import get_logger
from anorag_tpu_torch.utils.text import tokenize_no_stop

logger = get_logger("anorag.doc")


def _pairwise_sq_dists(emb, chunk: int = 4096) -> torch.Tensor:
    """(N, N) squared L2 via |x|^2 - 2xy + |y|^2 matmuls (chunked rows),
    on emb's device."""
    x = torch.as_tensor(emb).float()
    sq = torch.sum(x * x, dim=1)
    out = torch.empty((len(x), len(x)), dtype=torch.float32, device=x.device)
    for lo in range(0, len(x), chunk):
        hi = min(lo + chunk, len(x))
        cross = torch.matmul(x[lo:hi], x.T)
        d = sq[lo:hi, None] - 2.0 * cross + sq[None, :]
        out[lo:hi] = torch.clamp_min(d, 0.0)
    return out


def find_optimal_eps(sq_dists, min_samples: int) -> float:
    """k-distance knee (ref :149-170): sort every point's distance to its
    min_samples-th neighbour, eps = the largest jump, clamped to a sane
    band."""
    sq_dists = torch.as_tensor(sq_dists)
    k = min(min_samples + 1, sq_dists.shape[1])  # +1: self at distance 0
    neg_topk = torch.topk(-sq_dists, k, dim=1).values
    k_d = np.sqrt(np.maximum(-neg_topk[:, -1].cpu().numpy(), 0.0))
    k_d = np.sort(k_d)
    if len(k_d) < 3:
        return float(max(k_d[-1], 0.1)) if len(k_d) else 0.5
    diffs = np.diff(k_d)
    knee = int(np.argmax(diffs))
    return float(max(0.05, min(2.0, k_d[knee])))


def density_cluster(
    emb,
    min_samples: int = 3,
    eps: Optional[float] = None,
    max_neighbors: int = 64,
) -> Tuple[np.ndarray, float]:
    """DBSCAN labels (noise = -1) for unit-scale embeddings (numpy or a
    tensor; computed on its device).

    Core test + neighbor lists come from one batched distance computation
    instead of per-point region queries; core-core components run
    through the CSR label-propagation primitive. Returns (labels, eps)."""
    from anorag_tpu_torch.ops.graph import build_csr, connected_components

    n = len(emb)
    if n == 0:
        return np.zeros(0, np.int64), 0.0
    emb = torch.as_tensor(emb)
    sq_dev = _pairwise_sq_dists(emb)
    if eps is None:
        eps = find_optimal_eps(sq_dev, min_samples)
    within_dev = sq_dev <= eps * eps
    counts = within_dev.sum(dim=1).cpu().numpy()   # includes self
    core = counts >= (min_samples + 1)
    sq, within = sq_dev.cpu().numpy(), within_dev.cpu().numpy()
    del sq_dev, within_dev

    # epsilon graph over core points (degree capped: nearest max_neighbors)
    edges = []
    core_idx = np.where(core)[0]
    core_set = set(core_idx.tolist())
    for i in core_idx:
        nbrs = np.where(within[i])[0]
        if len(nbrs) > max_neighbors:
            order = np.argsort(sq[i][nbrs])[:max_neighbors]
            nbrs = nbrs[order]
        for j in nbrs:
            if j > i and j in core_set:
                edges.append((int(i), int(j), 1.0, 0))
    comp = connected_components(build_csr(n, edges, device=emb.device))

    labels = np.full(n, -1, np.int64)
    if len(core_idx):
        # densify component ids over cores to 0..C-1
        uniq = {c: li for li, c in enumerate(sorted(set(int(comp[i]) for i in core_idx)))}
        for i in core_idx:
            labels[i] = uniq[int(comp[i])]
        # border points: adopt the nearest core within eps
        for i in np.where(~core)[0]:
            cands = core_idx[within[i][core_idx]]
            if len(cands):
                labels[i] = labels[cands[np.argmin(sq[i][cands])]]
    return labels, float(eps)


class TopicClustering:
    def __init__(self, method: str = "kmeans", n_clusters: int = 0,
                 max_clusters: int = 20, iters: int = 15,
                 noise_threshold: float = 0.0, seed: int = 0,
                 min_samples: int = 3, eps: Optional[float] = None, *,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.method = method
        self.n_clusters = n_clusters
        self.max_clusters = max_clusters
        self.iters = iters
        self.noise_threshold = noise_threshold
        self.seed = seed
        self.min_samples = min_samples
        self.eps = eps

    def cluster_notes(self, notes: Sequence[Dict[str, Any]],
                      embeddings) -> Dict[str, Any]:
        """Returns {labels, topic_pools, n_clusters} (the clustering.json
        artifact shape). `embeddings` is numpy or a tensor; the clustering
        runs on self.device."""
        n = len(notes)
        if n == 0:
            return {"labels": [], "topic_pools": [], "n_clusters": 0}
        if n == 1:
            return {"labels": [0], "topic_pools": self._pools(notes, np.zeros(1, int)),
                    "n_clusters": 1}
        emb = torch.as_tensor(embeddings).to(self.device, torch.float32)
        if self.method.lower() in ("dbscan", "hdbscan", "density"):
            labels, eps = density_cluster(emb, min_samples=self.min_samples,
                                          eps=self.eps)
            pools = self._pools(notes, labels)
            logger.info("density-clustered %d notes into %d topics "
                        "(eps=%.3f, %d noise)", n, len(pools), eps,
                        int((labels < 0).sum()))
            return {"labels": labels.tolist(), "topic_pools": pools,
                    "n_clusters": int(len(pools)), "eps": eps}
        k = self.n_clusters or auto_k(emb, max_k=min(self.max_clusters, n),
                                      iters=max(self.iters // 2, 5), seed=self.seed)
        k = max(1, min(k, n))
        centroids, labels = kmeans_fit(emb, k, iters=self.iters, seed=self.seed)
        labels = labels.cpu().numpy()
        if self.noise_threshold > 0:
            emb = emb.cpu().numpy()
            c = centroids.cpu().numpy()
            sims = np.einsum("nd,nd->n",
                             emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9),
                             c[labels] / np.maximum(np.linalg.norm(c[labels], axis=1, keepdims=True), 1e-9))
            labels = np.where(sims < self.noise_threshold, -1, labels)
        pools = self._pools(notes, labels)
        logger.info("clustered %d notes into %d topics", n, len(pools))
        return {"labels": labels.tolist(), "topic_pools": pools,
                "n_clusters": int(len(pools))}

    @staticmethod
    def _pools(notes: Sequence[Dict[str, Any]], labels: np.ndarray) -> List[Dict[str, Any]]:
        groups: Dict[int, List[int]] = defaultdict(list)
        for i, l in enumerate(labels):
            if int(l) >= 0:
                groups[int(l)].append(i)
        pools = []
        for label, idxs in sorted(groups.items()):
            token_counts: Counter = Counter()
            for i in idxs:
                token_counts.update(tokenize_no_stop(
                    f"{notes[i].get('title','')} {notes[i].get('content','')}"))
            keywords = [w for w, _ in token_counts.most_common(5)]
            pools.append({
                "topic_id": label,
                "note_ids": [notes[i].get("note_id") for i in idxs],
                "keywords": keywords,
                "description": " / ".join(keywords[:3]),
                "size": len(idxs),
            })
        return pools
