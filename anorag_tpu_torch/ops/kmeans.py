"""Lloyd k-means for the IVF index and the topic clustering.

Counterpart of anorag_tpu/ops/kmeans.py: _kmeans_fit_np (:19), kmeans_fit
(:58) with its Lloyd path (:68-122), kmeans_inertia (:125) and the elbow
auto_k (:132). A corpus of
at most 4096 rows on the CPU takes the numpy path, which is the reference's
own and gives the same centroids from the same seed. Otherwise Lloyd runs on
the tensor's device: assignment is one matmul per row chunk, the update an
index_add_.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_NP_SMALL_N = 4096
_ROW_CHUNK = 1 << 18        # rows per step where an (N, D) temporary would form


def _kmeans_fit_np(x: np.ndarray, n_clusters: int, iters: int,
                   seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy Lloyd: farthest-point init over a seeded subsample, empty
    clusters keep their centroid (the reference's small-corpus path)."""
    x = np.asarray(x, np.float32)
    n, d = x.shape
    rng = np.random.default_rng(seed)
    s = min(n, max(8 * n_clusters, 4096))
    xs = x[rng.integers(0, n, s)] if s < n else x
    first = int(rng.integers(0, len(xs)))
    centroids = np.zeros((n_clusters, d), np.float32)
    centroids[0] = xs[first]
    min_d = np.sum((xs - xs[first]) ** 2, axis=1)
    for j in range(1, n_clusters):
        nxt = int(np.argmax(min_d))
        centroids[j] = xs[nxt]
        min_d = np.minimum(min_d, np.sum((xs - xs[nxt]) ** 2, axis=1))
    x_sq = np.sum(x * x, axis=1, keepdims=True)

    def assign(c):
        dist = x_sq - 2.0 * (x @ c.T) + np.sum(c * c, axis=1)[None, :]
        return np.argmin(dist, axis=1).astype(np.int32)

    for _ in range(iters):
        a = assign(centroids)
        for j in range(n_clusters):
            members = x[a == j]
            if len(members):
                centroids[j] = members.mean(axis=0)
    return centroids, assign(centroids)


def _assign(x: torch.Tensor, x_sq: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Nearest centroid by |x|^2 - 2 x.c + |c|^2, per row chunk."""
    c_sq = (c * c).sum(dim=1)[None, :]
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    for lo in range(0, x.shape[0], _ROW_CHUNK):
        xc = x[lo:lo + _ROW_CHUNK]
        dist = x_sq[lo:lo + _ROW_CHUNK] - 2.0 * torch.matmul(xc, c.T) + c_sq
        out[lo:lo + _ROW_CHUNK] = dist.argmin(dim=1).int()
    return out


def _kmeans_fit_lloyd(x: torch.Tensor, n_clusters: int, iters: int,
                      seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd on x's device: farthest-point init over a subsample drawn with
    a torch.Generator seeded from `seed` (the reference draws it with
    jax.random, whose numbers torch cannot reproduce), then `iters` rounds
    of assignment and mean update; empty clusters keep their centroid."""
    n, d = x.shape
    gen = torch.Generator(device=x.device).manual_seed(seed)
    x_sq = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    for lo in range(0, n, _ROW_CHUNK):
        xc = x[lo:lo + _ROW_CHUNK].float()
        x_sq[lo:lo + _ROW_CHUNK] = (xc * xc).sum(dim=1, keepdim=True)
    s = min(n, max(8 * n_clusters, 4096))
    if s < n:
        rows = torch.randint(0, n, (s,), generator=gen, device=x.device)
        xs = x[rows].float()
    else:
        xs = x.float()
    first = int(torch.randint(0, s, (1,), generator=gen, device=x.device))
    centroids = torch.zeros((n_clusters, d), dtype=torch.float32, device=x.device)
    centroids[0] = xs[first]
    min_d = ((xs - xs[first][None, :]) ** 2).sum(dim=1)
    for j in range(1, n_clusters):
        nxt = int(min_d.argmax())
        centroids[j] = xs[nxt]
        min_d = torch.minimum(min_d, ((xs - xs[nxt][None, :]) ** 2).sum(dim=1))
    for _ in range(iters):
        a = _assign(x, x_sq, centroids).long()
        sums = torch.zeros_like(centroids)
        for lo in range(0, n, _ROW_CHUNK):
            sums.index_add_(0, a[lo:lo + _ROW_CHUNK], x[lo:lo + _ROW_CHUNK].float())
        counts = torch.bincount(a, minlength=n_clusters).float()
        new_c = sums / counts.clamp_min(1.0)[:, None]
        centroids = torch.where((counts > 0)[:, None], new_c, centroids)
    return centroids, _assign(x, x_sq, centroids)


def kmeans_fit(x, n_clusters: int, iters: int = 15,
               seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means: (centroids (K, D) f32, assignments (N,) int32), on
    x's device (numpy input counts as the CPU). At most 4096 rows on the
    CPU take the reference's numpy path; otherwise Lloyd runs on the
    device (see _kmeans_fit_lloyd for how its init differs)."""
    x = torch.as_tensor(x)
    if x.shape[0] <= _NP_SMALL_N and x.device.type == "cpu":
        c, a = _kmeans_fit_np(x.float().numpy(), n_clusters, iters, seed)
        return torch.from_numpy(c), torch.from_numpy(a)
    return _kmeans_fit_lloyd(x, n_clusters, iters, seed)


def kmeans_inertia(x, centroids, assignments) -> float:
    """Sum of squared distances of rows to their centroids: on the card for
    a CUDA tensor (row chunks, summed in f64), else on the host
    in numpy, as the reference computes it."""
    if torch.is_tensor(x) and x.device.type != "cpu":
        c = torch.as_tensor(centroids, device=x.device).float()
        a = torch.as_tensor(assignments, device=x.device).long()
        total = torch.zeros((), dtype=torch.float64, device=x.device)
        for lo in range(0, x.shape[0], _ROW_CHUNK):
            diff = x[lo:lo + _ROW_CHUNK].float() - c[a[lo:lo + _ROW_CHUNK]]
            total += (diff * diff).sum(dtype=torch.float64)
        return float(total)
    x, centroids, assignments = (
        t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
        for t in (x, centroids, assignments))
    diff = x.astype(np.float32) - centroids[assignments]
    return float(np.sum(diff * diff))


def auto_k(x, max_k: int = 20, iters: int = 10, seed: int = 0) -> int:
    """Elbow auto-K: fit K = 1 .. max_k with kmeans_fit on x's device and
    pick the K where the marginal inertia reduction drops below 15% of the
    first drop (the reference's rule, on the same fits)."""
    n = x.shape[0]
    max_k = max(2, min(max_k, n))
    xs = torch.as_tensor(x)
    inertias = []
    ks = list(range(1, max_k + 1))
    for k in ks:
        c, a = kmeans_fit(xs, k, iters=iters, seed=seed)
        inertias.append(kmeans_inertia(xs, c, a))
    drops = [inertias[i - 1] - inertias[i] for i in range(1, len(inertias))]
    if not drops or drops[0] <= 0:
        return min(2, n)
    for i, d in enumerate(drops):
        if d < 0.15 * drops[0]:
            return ks[i]  # K before this drop
    return ks[-1]
