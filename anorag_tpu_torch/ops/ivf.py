"""IVF (cluster-pruned) dense search.

Counterpart of anorag_tpu/ops/ivf.py: IVFLayout (:30), build_ivf (:56),
select_blocks (:97), ivf_probe (:228-239), ivf_search (:242),
_ivf_search_np (:314) and tune_nprobe (:334). Notes are k-means clustered
and stored sorted by cluster; a batch scores the (nlist, D) centroids,
picks nprobe clusters per query, and scans only the corpus blocks those
clusters touch, a row counting for a query only when its cluster is among
that query's nprobe.

The TPU kernel _ivf_kernel (:119) is csrc/streaming_topk.cu, reached
through ivf_scan; ivf_scan_ref is its plain version. The reference cuts a
batch into chunks to fit a TPU's VMEM (:262-278); the port does not, and
its results are the same because validity is decided per query.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from anorag_tpu_torch.ops.kmeans import kmeans_fit
from anorag_tpu_torch.ops.topk import (NEG_INF, SCAN_CHUNK, _chunked_topk,
                                       _load_topk, _round_up,
                                       check_kernel_operands, dense_topk_np,
                                       kernel_dtype_code, top_k, vec_ok)

KERNEL_ROWS = 64             # block_rows must be a multiple (csrc kRows)


@dataclass
class IVFLayout:
    """Cluster-sorted corpus layout; host arrays as in the reference, with
    device copies made on first use."""

    centroids: np.ndarray            # (nlist, D) f32
    perm: np.ndarray                 # (N,) sorted position -> original row
    cluster_ids: np.ndarray          # (N_pad,) cluster of each sorted row, -1 pad
    block_first_cluster: np.ndarray  # (num_blocks,)
    block_last_cluster: np.ndarray   # (num_blocks,)
    block_rows: int
    n: int
    _dev: Dict[Tuple[str, str], torch.Tensor] = field(default_factory=dict,
                                                      repr=False)

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def num_blocks(self) -> int:
        return len(self.block_first_cluster)

    def device_array(self, name: str, device: torch.device) -> torch.Tensor:
        """`centroids`, `perm` or `cluster_ids` on `device`, cached."""
        key = (name, str(device))
        if key not in self._dev:
            self._dev[key] = torch.from_numpy(getattr(self, name)).to(device)
        return self._dev[key]


def ivf_layout_from_numpy(centroids, perm, cluster_ids, block_first_cluster,
                          block_last_cluster, block_rows: int, n: int) -> IVFLayout:
    """The port's IVFLayout from another layout's fields as numpy arrays
    (for example anorag_tpu's build_ivf output), so a search can run on
    exactly the layout the reference built."""
    return IVFLayout(
        centroids=np.ascontiguousarray(centroids, np.float32),
        perm=np.ascontiguousarray(perm, np.int64),
        cluster_ids=np.ascontiguousarray(cluster_ids, np.int32),
        block_first_cluster=np.ascontiguousarray(block_first_cluster, np.int32),
        block_last_cluster=np.ascontiguousarray(block_last_cluster, np.int32),
        block_rows=int(block_rows), n=int(n))


def ivf_layout_from_assign(emb, centroids, assign, block_rows: int = 1024,
                           dtype: torch.dtype | None = None):
    """Cluster sort and block bounds for a given clustering: (layout,
    sorted rows (N_pad, D) in `dtype` (default emb's) on emb's device, pad
    rows zero). The sort is stable, so rows keep their order within a
    cluster, as in the reference."""
    emb = torch.as_tensor(emb)
    n, d = emb.shape
    dev = emb.device
    assign = torch.as_tensor(assign, device=dev).long()
    perm = torch.argsort(assign, stable=True)
    block_rows = max(128, min(block_rows, _round_up(n, 128)))
    n_pad = _round_up(n, block_rows)
    sorted_emb = torch.zeros((n_pad, d), dtype=dtype or emb.dtype, device=dev)
    for lo in range(0, n, SCAN_CHUNK):
        hi = min(lo + SCAN_CHUNK, n)
        sorted_emb[lo:hi] = emb[perm[lo:hi]].to(sorted_emb.dtype)
    cid = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    cid[:n] = assign[perm].int()
    blocks = cid.view(n_pad // block_rows, block_rows)
    valid = blocks >= 0
    any_valid = valid.any(dim=1)
    int_max = torch.iinfo(torch.int32).max
    first = torch.where(any_valid, torch.where(valid, blocks, int_max).amin(dim=1), -1)
    last = torch.where(any_valid, blocks.amax(dim=1), -1)
    layout = ivf_layout_from_numpy(
        torch.as_tensor(centroids).float().cpu().numpy(), perm.cpu().numpy(),
        cid.cpu().numpy(), first.cpu().numpy(), last.cpu().numpy(), block_rows, n)
    layout._dev[("cluster_ids", str(dev))] = cid
    return layout, sorted_emb


def build_ivf(emb, nlist: int = 20, iters: int = 15, block_rows: int = 1024,
              seed: int = 0, dtype: torch.dtype | None = None):
    """K-means + cluster sort on emb's device: (layout, sorted rows)."""
    emb = torch.as_tensor(emb)
    nlist = max(1, min(nlist, emb.shape[0]))
    centroids, assign = kmeans_fit(emb, nlist, iters=iters, seed=seed)
    return ivf_layout_from_assign(emb, centroids, assign, block_rows, dtype)


def select_blocks(layout: IVFLayout, probe_clusters) -> np.ndarray:
    """Sorted ids of the blocks any selected cluster of the batch touches,
    padded with -1 to a power of two."""
    wanted = np.unique(np.asarray(probe_clusters).reshape(-1))
    wanted = wanted[wanted >= 0]
    lo = layout.block_first_cluster[:, None]
    hi = layout.block_last_cluster[:, None]
    mask = (lo[:, 0] >= 0) & np.any((wanted[None, :] >= lo) & (wanted[None, :] <= hi), axis=1)
    ids = np.nonzero(mask)[0].astype(np.int32)
    bucket = 1
    while bucket < max(len(ids), 1):
        bucket *= 2
    out = np.full((bucket,), -1, np.int32)
    out[: len(ids)] = ids
    return out


def ivf_probe(layout: IVFLayout, queries, nprobe: int) -> torch.Tensor:
    """Top-nprobe centroids per query by f32 inner product, ties to the
    lower cluster: (B, nprobe) int32 on the queries' device."""
    nprobe = min(nprobe, layout.nlist)
    q = torch.as_tensor(queries).float()
    scores = torch.matmul(q, layout.device_array("centroids", q.device).T)
    return top_k(scores, nprobe)[1].int()


def _scanned_rows(blk_ids: torch.Tensor, n_scan: int, n_rows: int,
                  block_rows: int) -> torch.Tensor:
    scanned = torch.zeros(-(-n_rows // block_rows), dtype=torch.bool,
                          device=blk_ids.device)
    scanned[blk_ids[:n_scan].long()] = True
    return scanned.repeat_interleave(block_rows)[:n_rows]


def ivf_scan_ref(queries: torch.Tensor, sorted_emb: torch.Tensor,
                 cluster_ids: torch.Tensor, sel: torch.Tensor,
                 blk_ids: torch.Tensor, n_scan: int, k: int, block_rows: int,
                 chunk: int = SCAN_CHUNK):
    """Plain version of ivf_scan: f32 scores of the corpus-dtype queries,
    masked to NEG_INF off the scanned blocks and off each query's clusters,
    per corpus chunk, then a stable sort by (score descending, lower row
    first). Returns (B, k) f32 values and int32 sorted-corpus rows, -1
    where no valid row is left."""
    n_rows = sorted_emb.shape[0]
    q32 = queries.to(sorted_emb.dtype).float()
    row_ok = _scanned_rows(blk_ids, n_scan, n_rows, block_rows)

    def score(lo, hi):
        s = torch.matmul(q32, sorted_emb[lo:hi].float().T)
        cid = cluster_ids[lo:hi].long()[None, :]
        valid = torch.zeros(s.shape, dtype=torch.bool, device=s.device)
        for p in range(sel.shape[1]):
            valid |= cid == sel[:, p:p + 1].long()
        return torch.where(valid & row_ok[None, lo:hi], s, NEG_INF)

    vals, idx = _chunked_topk(score, n_rows, min(k, n_rows), chunk)
    return vals, torch.where(vals > NEG_INF / 2, idx, -1).int()


def ivf_scan(queries: torch.Tensor, sorted_emb: torch.Tensor,
             cluster_ids: torch.Tensor, sel: torch.Tensor, blk_ids: torch.Tensor,
             n_scan: int, k: int, block_rows: int):
    """Exact top-k over the blocks blk_ids[:n_scan] of a cluster-sorted
    corpus, a row valid for a query when its cluster id is in that query's
    sel row: (B, k) f32 values and int32 sorted-corpus rows, sorted by
    (score descending, lower row first), (NEG_INF, -1) where unfilled.
    queries (B, D) in sorted_emb's dtype (bf16 or f32), cluster_ids
    (N_pad,) int32, sel (B, nprobe) int32, blk_ids int32. CUDA tensors
    launch csrc/streaming_topk.cu and count one launch in ivf_scan.launches;
    CPU tensors run ivf_scan_ref."""
    if (sorted_emb.dim() != 2 or queries.dim() != 2
            or queries.shape[1] != sorted_emb.shape[1]):
        raise ValueError(f"ivf_scan: sorted_emb (N, D) and queries (B, D), got "
                         f"{tuple(sorted_emb.shape)} and {tuple(queries.shape)}")
    code = kernel_dtype_code(sorted_emb)
    if queries.dtype != sorted_emb.dtype:
        raise TypeError(f"ivf_scan: queries {queries.dtype} must be in the corpus "
                        f"dtype {sorted_emb.dtype}")
    for name, t in (("cluster_ids", cluster_ids), ("sel", sel), ("blk_ids", blk_ids)):
        if t.dtype != torch.int32:
            raise TypeError(f"ivf_scan: {name} must be int32, got {t.dtype}")
    (b, d), n_rows = queries.shape, sorted_emb.shape[0]
    if (tuple(cluster_ids.shape) != (n_rows,) or sel.dim() != 2
            or sel.shape[0] != b or blk_ids.dim() != 1
            or not 0 <= n_scan <= blk_ids.shape[0]):
        raise ValueError("ivf_scan: cluster_ids (N_pad,), sel (B, nprobe) and "
                         "blk_ids with at least n_scan entries")
    if block_rows % KERNEL_ROWS:
        raise ValueError(f"ivf_scan: block_rows {block_rows} is not a multiple "
                         f"of {KERNEL_ROWS}")
    if check_kernel_operands("ivf_scan", k, queries, sorted_emb, cluster_ids,
                             sel, blk_ids):
        return ivf_scan_ref(queries, sorted_emb, cluster_ids, sel, blk_ids,
                            n_scan, k, block_rows)
    lib = _load_topk()
    dev = sorted_emb.device
    splits = lib.anorag_topk_splits(b, max(n_scan, 1), dev.index)
    part_v = torch.empty((b, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, splits, k), dtype=torch.int32, device=dev)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    err = lib.anorag_ivf_topk(
        queries.data_ptr(), sorted_emb.data_ptr(), cluster_ids.data_ptr(),
        sel.data_ptr(), sel.shape[1], blk_ids.data_ptr(), n_scan, block_rows,
        code, b, n_rows, d, k, vec_ok(d, sorted_emb, queries), splits,
        part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ivf_scan kernel launch failed: CUDA error {err}")
    ivf_scan.launches += 1
    return vals, idx


ivf_scan.launches = 0


def ivf_search(layout: IVFLayout, sorted_emb: torch.Tensor, queries, k: int,
               nprobe: int = 4, use_kernel: bool | None = None):
    """IVF top-k: (scores (B, k) f32, ORIGINAL rows (B, k) int64) as numpy,
    sorted descending; slots with no valid row are (-inf, -1).
    use_kernel None or True scans with ivf_scan (the kernel on the card);
    False runs the numpy oracle _ivf_search_np, on CPU tensors only: on
    the card it raises ValueError, since only the kernel scans there."""
    dev = sorted_emb.device
    if use_kernel is False and dev.type != "cpu":
        raise ValueError("ivf_search: use_kernel=False names the numpy oracle, "
                         "which takes CPU tensors; on the card the IVF scan "
                         "kernel always runs")
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    sel = ivf_probe(layout, q, nprobe)
    sel_np = sel.cpu().numpy()
    if use_kernel is False:
        return _ivf_search_np(layout, sorted_emb.float().cpu().numpy(),
                              q.cpu().numpy(), k, sel_np)
    blk_ids = select_blocks(layout, sel_np)
    n_scan = int((blk_ids >= 0).sum())
    k_eff = min(k, layout.n)
    vals, pos = ivf_scan(q.to(sorted_emb.dtype).contiguous(), sorted_emb,
                         layout.device_array("cluster_ids", dev), sel.contiguous(),
                         torch.from_numpy(blk_ids).to(dev), n_scan, k_eff,
                         layout.block_rows)
    filled = vals > NEG_INF / 2
    perm = layout.device_array("perm", dev)
    orig = torch.where(filled, perm[pos.long().clamp(0, layout.n - 1)], -1)
    vals = torch.where(filled, vals, float("-inf"))
    if k_eff < k:
        vals = torch.nn.functional.pad(vals, (0, k - k_eff), value=float("-inf"))
        orig = torch.nn.functional.pad(orig, (0, k - k_eff), value=-1)
    return vals.cpu().numpy(), orig.cpu().numpy()


def _ivf_search_np(layout: IVFLayout, sorted_emb: np.ndarray, queries: np.ndarray,
                   k: int, sel: np.ndarray):
    """Numpy oracle with the same per-query nprobe semantics."""
    b = queries.shape[0]
    vals = np.full((b, k), -np.inf, np.float32)
    idx = np.full((b, k), -1, np.int64)
    cids = layout.cluster_ids[: layout.n]
    for qi in range(b):
        rows = np.nonzero(np.isin(cids, sel[qi]))[0]
        if len(rows) == 0:
            continue
        scores = sorted_emb[rows] @ queries[qi].astype(np.float32)
        kk = min(k, len(rows))
        top = np.argpartition(-scores, kk - 1)[:kk]
        top = top[np.argsort(-scores[top], kind="stable")]
        vals[qi, :kk] = scores[top]
        idx[qi, :kk] = layout.perm[rows[top]]
    return vals, idx


def tune_nprobe(layout: IVFLayout, sorted_emb: torch.Tensor, emb_f32: np.ndarray,
                sample_queries: np.ndarray, k: int = 10,
                target_recall: float = 0.9, **search_kw) -> int:
    """The smallest nprobe whose recall@k against exact search reaches the
    target (nlist if none does)."""
    _, exact_idx = dense_topk_np(emb_f32, sample_queries, k)
    for nprobe in range(1, layout.nlist + 1):
        _, idx = ivf_search(layout, sorted_emb, sample_queries, k, nprobe=nprobe,
                            **search_kw)
        hits = np.mean([len(set(idx[q]) & set(exact_idx[q])) / k
                        for q in range(len(sample_queries))])
        if hits >= target_recall:
            return nprobe
    return layout.nlist
