"""IVF (cluster-pruned) dense search.

Counterpart of anorag_tpu/ops/ivf.py: IVFLayout (:30), build_ivf (:56),
select_blocks (:97), ivf_probe (:228-239), ivf_search (:242),
_ivf_search_np (:314) and tune_nprobe (:334). Notes are k-means clustered
and stored sorted by cluster; a batch scores the (nlist, D) centroids,
picks nprobe clusters per query, and scans only the corpus blocks those
clusters touch, a row counting for a query only when its cluster is among
that query's nprobe.

The TPU kernel _ivf_kernel (:119) is csrc/ivf_scan.cu, reached through
ivf_scan; ivf_scan_ref is its plain version. The kernel scans each probed
cluster once for each tile of the queries that probe it: ivf_work_plan (a
one-CTA kernel in the same source; plain version ivf_work_plan_ref) inverts
the probes into those tiles on the device and splits each tile's rows into
about equal units, one wave of CTAs; ivf_query_tile and ivf_max_splits
bound the tile and the splits. The reference cuts a batch into chunks to
fit a TPU's VMEM (:262-278); the port does not, and its results are the
same because validity is decided per query.
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from anorag_tpu_torch.ops.kmeans import kmeans_fit
from anorag_tpu_torch.ops.topk import (NEG_INF, SCAN_CHUNK, _chunked_topk,
                                       _round_up, check_kernel_operands,
                                       dense_topk_np, kernel_dtype_code, top_k,
                                       vec_ok)

KERNEL_ROWS = 64             # block_rows must be a multiple (csrc kRows)
MAX_LISTS = 256              # sorted partials one merge warp takes (csrc kMaxLists)
SMALL_K = 128                # largest k of the 64-query tile (csrc kSmallK)
PARTIAL_BYTES = 64 << 20     # budget of the (B, nprobe * splits, k) partials


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
    cluster_offsets: np.ndarray      # (nlist + 1,) int64, see cluster_offsets_np
    _dev: Dict[Tuple[str, str], torch.Tensor] = field(default_factory=dict,
                                                      repr=False)

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def num_blocks(self) -> int:
        return len(self.block_first_cluster)

    def device_array(self, name: str, device: torch.device) -> torch.Tensor:
        """`centroids`, `perm`, `cluster_ids` or `cluster_offsets` on
        `device`, cached."""
        key = (name, str(device))
        if key not in self._dev:
            self._dev[key] = torch.from_numpy(getattr(self, name)).to(device)
        return self._dev[key]


def cluster_offsets_np(cluster_ids: np.ndarray, nlist: int) -> np.ndarray:
    """(nlist + 1,) int64 offsets of a cluster-sorted layout: cluster c
    holds the rows [off[c], off[c + 1]). Raises ValueError unless the ids
    are non-decreasing in [0, nlist) with only -1 pads after them, as both
    packages' build_ivf leave them (a stable sort by cluster)."""
    cid = np.asarray(cluster_ids)
    n = int((cid >= 0).sum())
    valid = cid[:n]
    if ((valid < 0).any() or (cid[n:] != -1).any() or (np.diff(valid) < 0).any()
            or (n and valid[-1] >= nlist)):
        raise ValueError("cluster_ids must be sorted by cluster, in [0, nlist), "
                         "with -1 pads only at the end")
    return np.searchsorted(valid, np.arange(nlist + 1), side="left").astype(np.int64)


def ivf_layout_from_numpy(centroids, perm, cluster_ids, block_first_cluster,
                          block_last_cluster, block_rows: int, n: int) -> IVFLayout:
    """The port's IVFLayout from another layout's fields as numpy arrays
    (for example anorag_tpu's build_ivf output), so a search can run on
    exactly the layout the reference built; cluster_offsets are computed
    here."""
    centroids = np.ascontiguousarray(centroids, np.float32)
    cluster_ids = np.ascontiguousarray(cluster_ids, np.int32)
    return IVFLayout(
        centroids=centroids,
        perm=np.ascontiguousarray(perm, np.int64),
        cluster_ids=cluster_ids,
        block_first_cluster=np.ascontiguousarray(block_first_cluster, np.int32),
        block_last_cluster=np.ascontiguousarray(block_last_cluster, np.int32),
        block_rows=int(block_rows), n=int(n),
        cluster_offsets=cluster_offsets_np(cluster_ids, centroids.shape[0]))


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
    where no valid row is left. Pad rows (cluster id -1) never count, even
    for a sel entry of -1: this differs on purpose from the JAX kernel
    (anorag_tpu/ops/ivf.py:151, `cids == sel`), which would count them
    there, and matches the CUDA kernel, whose plan drops every negative
    entry. No caller passes -1 (the reference pads sel with -2)."""
    n_rows = sorted_emb.shape[0]
    q32 = queries.to(sorted_emb.dtype).float()
    row_ok = _scanned_rows(blk_ids, n_scan, n_rows, block_rows)

    def score(lo, hi):
        s = torch.matmul(q32, sorted_emb[lo:hi].float().T)
        cid = cluster_ids[lo:hi].long()[None, :]
        valid = torch.zeros(s.shape, dtype=torch.bool, device=s.device)
        for p in range(sel.shape[1]):
            valid |= cid == sel[:, p:p + 1].long()
        return torch.where(valid & (cid >= 0) & row_ok[None, lo:hi], s, NEG_INF)

    vals, idx = _chunked_topk(score, n_rows, min(k, n_rows), chunk)
    return vals, torch.where(vals > NEG_INF / 2, idx, -1).int()


class IVFWorkPlan(NamedTuple):
    """Which queries meet which rows in ivf_scan's kernel. A tile is up to
    q_tile queries that probe one cluster: tile t holds the entries
    [tile_start[t], tile_start[t] + tile_count[t]) of `pairs`, and its
    cluster's rows are cut into tile_splits[t] splits of whole 64-row
    sub-tiles. A (tile, split) unit is one CTA: unit u belongs to the first
    tile t with unit_end[t] > u, and the kernel launches `grid` CTAs, a
    bound on the units."""

    pairs: torch.Tensor   # (B * nprobe,) int32 query * nprobe + probe slot;
                          # the kept pairs first, by (cluster, query)
    tiles: torch.Tensor   # (5, max_tiles) int32: the rows below
    q_tile: int
    grid: int

    @property
    def max_tiles(self) -> int:
        return self.tiles.shape[1]

    @property
    def tile_cluster(self) -> torch.Tensor:   # -1 for a surplus tile
        return self.tiles[0]

    @property
    def tile_start(self) -> torch.Tensor:
        return self.tiles[1]

    @property
    def tile_count(self) -> torch.Tensor:     # 0 for a surplus tile
        return self.tiles[2]

    @property
    def tile_splits(self) -> torch.Tensor:    # 0 for a surplus or empty tile
        return self.tiles[3]

    @property
    def unit_end(self) -> torch.Tensor:       # running sum of tile_splits
        return self.tiles[4]


def max_plan_tiles(b: int, nprobe: int, nlist: int, q_tile: int) -> int:
    """The most tiles a plan can have: each probed cluster's last tile may
    be part-full, the others are full, so sum(ceil(count_c / q_tile)) <=
    min(nlist, B * nprobe) + ceil(B * nprobe / q_tile). The plan's arrays
    are this long, so the host never waits on the plan."""
    m = b * nprobe
    return min(nlist, m) + -(-m // q_tile)


def ivf_work_plan_ref(sel: torch.Tensor, offsets: torch.Tensor, q_tile: int,
                      slots: int, max_splits: int) -> IVFWorkPlan:
    """Plain version of ivf_work_plan, torch ops on sel's device with no
    host sync: invert sel (B, nprobe) into tiles of at most q_tile queries
    of one cluster. nlist is
    offsets' length less one. Entries < 0 (the reference pads with -2) or
    >= nlist are dropped, and a cluster repeated in a query's row is kept
    once, at its lowest slot; the kept (query, slot) pairs are sorted by
    (cluster, query) and each cluster's run is cut into tiles of q_tile.
    A tile whose cluster has n sub-tiles of 64 rows gets
    min(max(1, n * slots // W), n, max_splits) splits, W the sub-tiles of
    all tiles: the units number about `slots` (the CTAs the card holds at
    once) and each scans about W / slots sub-tiles; a tile of an empty
    cluster gets none."""
    b, p = sel.shape
    nlist = offsets.shape[0] - 1
    dev = sel.device
    max_tiles = max_plan_tiles(b, p, nlist, q_tile)
    grid = max(1, min(slots + max_tiles, max_tiles * max_splits))
    if nlist == 0:
        tiles = torch.zeros((5, max_tiles), dtype=torch.int32, device=dev)
        tiles[0] = -1
        return IVFWorkPlan(torch.arange(b * p, dtype=torch.int32, device=dev),
                           tiles, q_tile, grid)
    # each slot's cluster, nlist where the slot is dropped
    s = sel.long()
    s = s.masked_fill((s < 0) | (s >= nlist), nlist)
    sv, order = torch.sort(s, dim=1, stable=True)
    rep = torch.nn.functional.pad(sv[:, 1:] == sv[:, :-1], (1, 0))
    s = s.scatter(1, order, sv.masked_fill(rep, nlist))
    key, pairs = torch.sort((s * b + torch.arange(b, device=dev)[:, None]).reshape(-1),
                            stable=True)
    # the kept pairs of cluster c are pairs[first[c]:first[c + 1]]
    first = torch.searchsorted(key, torch.arange(nlist + 1, device=dev) * b)
    tiles = (first[1:] - first[:-1] + q_tile - 1) // q_tile
    tile_end = torch.cumsum(tiles, 0)
    t = torch.arange(max_tiles, device=dev)
    c = torch.searchsorted(tile_end, t, right=True)      # nlist: a surplus tile
    surplus = c >= nlist
    c = c.clamp_max(nlist - 1)
    start = first[c] + (t - (tile_end - tiles)[c]) * q_tile
    count = torch.clamp(first[c + 1] - start, max=q_tile).masked_fill(surplus, 0)
    n_sub = (offsets[c + 1] - offsets[c] + KERNEL_ROWS - 1) // KERNEL_ROWS
    n_sub = n_sub.masked_fill(surplus, 0)
    splits = torch.minimum((n_sub * slots // n_sub.sum().clamp_min(1)).clamp_min(1),
                           n_sub.clamp_max(max_splits))
    out = torch.stack([c.masked_fill(surplus, -1), start.masked_fill(surplus, 0),
                       count, splits, torch.cumsum(splits, 0)]).int()
    return IVFWorkPlan(pairs.int(), out, q_tile, grid)


def ivf_work_plan(sel: torch.Tensor, offsets: torch.Tensor, q_tile: int,
                  slots: int, max_splits: int) -> IVFWorkPlan:
    """ivf_work_plan_ref's plan. sel (B, nprobe) int32 and offsets (nlist +
    1,) int64 on one CUDA device launch the plan kernel of csrc/ivf_scan.cu
    (one CTA, no host sync; the entries of `pairs` after the kept pairs are
    not written) and count one launch in ivf_work_plan.launches; CPU tensors
    run ivf_work_plan_ref."""
    if sel.dtype != torch.int32 or sel.dim() != 2:
        raise TypeError("ivf_work_plan: sel must be (B, nprobe) int32")
    if offsets.dtype != torch.int64 or offsets.dim() != 1:
        raise TypeError("ivf_work_plan: offsets must be (nlist + 1,) int64")
    b, p = sel.shape
    if sel.device.type == "cpu" and offsets.device.type == "cpu":
        return ivf_work_plan_ref(sel, offsets, q_tile, slots, max_splits)
    dev = sel.device
    if not (sel.is_cuda and offsets.device == dev and sel.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError("ivf_work_plan: sel and offsets must be contiguous on one "
                         "CUDA device (or both on the CPU)")
    nlist = offsets.shape[0] - 1
    max_tiles = max_plan_tiles(b, p, nlist, q_tile)
    grid = max(1, min(slots + max_tiles, max_tiles * max_splits))
    pairs = torch.empty(b * p, dtype=torch.int32, device=dev)
    tiles = torch.empty((5, max_tiles), dtype=torch.int32, device=dev)
    if max_tiles == 0:
        return IVFWorkPlan(pairs, tiles, q_tile, grid)
    ws = torch.empty(4 * nlist + b * p, dtype=torch.int32, device=dev)
    err = _load_ivf().anorag_ivf_plan(
        sel.data_ptr(), b, p, offsets.data_ptr(), nlist, q_tile, slots, max_splits,
        max_tiles, ws.data_ptr(), pairs.data_ptr(), tiles.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ivf_work_plan kernel launch failed: CUDA error {err}")
    ivf_work_plan.launches += 1
    return IVFWorkPlan(pairs, tiles, q_tile, grid)


ivf_work_plan.launches = 0


def ivf_query_tile(b: int, nprobe: int, nlist: int, k: int) -> int:
    """Queries a tile of the kernel: 64 where k <= SMALL_K and the batch
    gives a probed cluster 16 or more queries on average, else 16 (k up to
    1024, or a small batch, where a 64-query tile is mostly padding). The
    threshold is where the two tiles crossed in chip_smoke.py's side-by-side
    timing on an H100 at nlist 20, nprobe 4, k 20 and 30 (PERF.md): the
    16-query tile ahead up to 12.8 queries a cluster (B 64), the 64-query
    one from 19.2 (B 96)."""
    m = b * nprobe
    return 64 if k <= SMALL_K and m >= 16 * min(nlist, m) else 16


def ivf_max_splits(b: int, nprobe: int, k: int) -> int:
    """The most splits of a tile: nprobe * splits <= MAX_LISTS (one merge
    level) and the (B, nprobe * splits, k) f32 + int32 partials within
    PARTIAL_BYTES; at least 1."""
    return max(1, min(MAX_LISTS // max(nprobe, 1),
                      PARTIAL_BYTES // max(8 * b * nprobe * k, 1)))


def ivf_launch_shape(b: int, nprobe: int, nlist: int,
                     k: int) -> Tuple[int, int, int]:
    """(q_tile, max_splits, list_stride) of the kernel's launch: the
    partials are (B, list_stride, k), nprobe * max_splits lists rounded up
    to a multiple of MAX_LISTS when they need two merge levels."""
    q_tile = ivf_query_tile(b, nprobe, nlist, k)
    max_splits = ivf_max_splits(b, nprobe, k)
    lists = nprobe * max_splits
    return (q_tile, max_splits,
            lists if lists <= MAX_LISTS else _round_up(lists, MAX_LISTS))


def offsets_from_cluster_ids(cluster_ids: torch.Tensor) -> torch.Tensor:
    """cluster_offsets_np on cluster_ids' device: nlist is the largest id
    plus one (one read to the host)."""
    key = torch.where(cluster_ids < 0, torch.iinfo(torch.int32).max, cluster_ids)
    nlist = int(cluster_ids.max()) + 1 if cluster_ids.numel() else 0
    return torch.searchsorted(key, torch.arange(max(nlist, 0) + 1, device=key.device,
                                                dtype=key.dtype))


_ivf_lib = None


def _load_ivf() -> ctypes.CDLL:
    """csrc/ivf_scan.cu's library, built on first use, its C signature set
    once."""
    global _ivf_lib
    if _ivf_lib is None:
        from anorag_tpu_torch import _build

        _ivf_lib = set_signatures(_build.load("ivf_scan"))
    return _ivf_lib


def set_signatures(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of a build of csrc/ivf_scan.cu."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.anorag_ivf_scan.argtypes = [p, p, i, ll, i, i, p, p, i, p, p, i, i,
                                    i, i, i, i, i, p, p, p, p, p, p, i, p]
    lib.anorag_ivf_scan.restype = i
    lib.anorag_ivf_slots.argtypes = [i, i, i, i]
    lib.anorag_ivf_slots.restype = i
    lib.anorag_ivf_plan.argtypes = [p, i, i, p, i, i, i, i, i, p, p, p, i, p]
    lib.anorag_ivf_plan.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def ivf_slots(code: int, q_tile: int, k: int, device_index: int) -> int:
    """CTAs of the kernel instance (dtype code, q_tile, k) that card
    device_index holds at once, from the CUDA occupancy calculator."""
    n = _load_ivf().anorag_ivf_slots(code, q_tile, k, device_index)
    if n <= 0:
        raise RuntimeError(f"ivf_scan occupancy query failed: CUDA error {-n}")
    return n


def _launch_scan(queries: torch.Tensor, sorted_emb: torch.Tensor, sel: torch.Tensor,
                 blk_ids: torch.Tensor, n_scan: int, k: int, block_rows: int,
                 offsets: torch.Tensor, q_tile: int):
    """ivf_scan's kernel launch on checked operands with tiles of q_tile
    queries (16, or 64 where k <= SMALL_K): the plan, the filled partials,
    the scanned-block flags. ivf_scan passes ivf_query_tile's choice;
    chip_smoke.py times both tiles through here."""
    (b, d), n_rows, nprobe = queries.shape, sorted_emb.shape[0], sel.shape[1]
    dev = sorted_emb.device
    code = kernel_dtype_code(sorted_emb)
    _, max_splits, stride = ivf_launch_shape(b, nprobe, offsets.shape[0] - 1, k)
    plan = ivf_work_plan(sel, offsets, q_tile, ivf_slots(code, q_tile, k, dev.index),
                         max_splits)
    part_v = torch.full((b, stride, k), NEG_INF, dtype=torch.float32, device=dev)
    part_i = torch.full((b, stride, k), -1, dtype=torch.int32, device=dev)
    mid_v = mid_i = None
    if stride > MAX_LISTS:
        mid_v = torch.empty((b, stride // MAX_LISTS, k), dtype=torch.float32, device=dev)
        mid_i = torch.empty((b, stride // MAX_LISTS, k), dtype=torch.int32, device=dev)
    scanned = torch.zeros(-(-n_rows // block_rows), dtype=torch.uint8, device=dev)
    scanned.index_fill_(0, blk_ids[:n_scan].long(), 1)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    err = _load_ivf().anorag_ivf_scan(
        queries.data_ptr(), sorted_emb.data_ptr(), code, b, d,
        vec_ok(d, sorted_emb, queries), offsets.data_ptr(), scanned.data_ptr(),
        block_rows, plan.pairs.data_ptr(), plan.tiles.data_ptr(), plan.max_tiles,
        plan.grid, q_tile, nprobe, max_splits, stride, k, part_v.data_ptr(),
        part_i.data_ptr(), None if mid_v is None else mid_v.data_ptr(),
        None if mid_i is None else mid_i.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ivf_scan kernel launch failed: CUDA error {err}")
    return vals, idx


_checked = (None, None, None)   # the pair _check_offsets last checked


def _check_offsets(offsets: torch.Tensor, cluster_ids: torch.Tensor) -> None:
    """Assert on offsets' device, with no host sync (on the card a failure
    surfaces at the next synchronisation), that offsets are cluster_ids'
    cluster offsets: non-decreasing, each the first row of its cluster
    0..nlist found by binary search in the sorted ids, the last one the
    first pad row, so no cluster id lies past them. The kernel then reads
    only rows of sorted_emb. A search repeats the layout's two cached
    tensors, so the pair last checked, unchanged since (the same objects at
    the same versions), is not checked again: the check's dozen small
    launches cost about 0.4 ms of host time a call on the card."""
    global _checked
    versions = (offsets._version, cluster_ids._version)
    off_ref, cid_ref, seen = _checked
    if (seen == versions and off_ref is not None and off_ref() is offsets
            and cid_ref() is cluster_ids):
        return
    big = torch.iinfo(torch.int32).max
    key = torch.where(cluster_ids < 0, big, cluster_ids)
    n = offsets.shape[0]
    probe = torch.arange(n + 1, device=key.device, dtype=key.dtype)
    want = torch.searchsorted(key, probe.masked_fill(probe == n, big))
    ok = ((want[:-1] == offsets).all() & (want[-1] == offsets[-1])
          & (offsets[1:] >= offsets[:-1]).all())
    torch._assert_async(ok, "ivf_scan: cluster_offsets are not the offsets of "
                            "cluster_ids (length nlist + 1, sorted by cluster)")
    _checked = (weakref.ref(offsets), weakref.ref(cluster_ids), versions)


def ivf_scan(queries: torch.Tensor, sorted_emb: torch.Tensor,
             cluster_ids: torch.Tensor, sel: torch.Tensor, blk_ids: torch.Tensor,
             n_scan: int, k: int, block_rows: int, *,
             cluster_offsets: Optional[torch.Tensor] = None):
    """Exact top-k over the blocks blk_ids[:n_scan] of a cluster-sorted
    corpus, a row valid for a query when its cluster id is in that query's
    sel row: (B, k) f32 values and int32 sorted-corpus rows, sorted by
    (score descending, lower row first), (NEG_INF, -1) where unfilled.
    queries (B, D) in sorted_emb's dtype (bf16 or f32), cluster_ids
    (N_pad,) int32, sel (B, nprobe) int32, blk_ids int32. The kernel relies
    on each cluster's rows being contiguous (the corpus sorted by cluster,
    pads -1 at the end, as build_ivf leaves it) and reads cluster c's rows
    from cluster_offsets (nlist + 1,) int64, the layout's
    cluster_offsets; absent, they are computed from cluster_ids. Offsets
    that are not cluster_ids' (a wrong length, shifted, past the corpus)
    fail _check_offsets' assertion: at once on the CPU, on the card at the
    next synchronisation. CUDA tensors launch csrc/ivf_scan.cu and count
    one launch in ivf_scan.launches; CPU tensors run ivf_scan_ref."""
    if (sorted_emb.dim() != 2 or queries.dim() != 2
            or queries.shape[1] != sorted_emb.shape[1]):
        raise ValueError(f"ivf_scan: sorted_emb (N, D) and queries (B, D), got "
                         f"{tuple(sorted_emb.shape)} and {tuple(queries.shape)}")
    kernel_dtype_code(sorted_emb)                    # raises on another dtype
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
    operands = [queries, sorted_emb, cluster_ids, sel, blk_ids]
    if cluster_offsets is not None:
        if (cluster_offsets.dtype != torch.int64 or cluster_offsets.dim() != 1
                or cluster_offsets.shape[0] == 0):
            raise TypeError("ivf_scan: cluster_offsets must be (nlist + 1,) int64")
        operands.append(cluster_offsets)
    if check_kernel_operands("ivf_scan", k, *operands):
        if cluster_offsets is not None:
            _check_offsets(cluster_offsets, cluster_ids)
        return ivf_scan_ref(queries, sorted_emb, cluster_ids, sel, blk_ids,
                            n_scan, k, block_rows)
    if n_rows >= 1 << 31:
        raise ValueError(f"ivf_scan: {n_rows} rows; the kernel's rows are int32")
    nprobe = sel.shape[1]
    if b == 0 or nprobe == 0:
        return (torch.full((b, k), NEG_INF, dtype=torch.float32, device=queries.device),
                torch.full((b, k), -1, dtype=torch.int32, device=queries.device))
    offsets = (cluster_offsets if cluster_offsets is not None
               else offsets_from_cluster_ids(cluster_ids))
    _check_offsets(offsets, cluster_ids)
    vals, idx = _launch_scan(queries, sorted_emb, sel, blk_ids, n_scan, k, block_rows,
                             offsets, ivf_query_tile(b, nprobe, offsets.shape[0] - 1, k))
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
                         layout.block_rows,
                         cluster_offsets=layout.device_array("cluster_offsets", dev))
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
