"""Dense top-k search and hybrid dense + BM25 top-k by candidate-union fusion.

Counterpart of anorag_tpu/ops/topk.py: NEG_INF and POS_INF (:32), _round_up
(:36), dense_topk_xla (:369), _sort_topk (:410), dense_topk (:432), _pad_k
(:550), hybrid_topk (:562), hybrid_topk_bucketed_tiled (:625),
BucketedSparsePlan and make_bucketed_plan (:662, :669), hybrid_topk_bucketed
(:705), hybrid_fuse (:750), bucket_topk (:297), _bucket_finish (:361) and
dense_topk_np (:838).

The TPU kernel _topk_kernel (:40) is csrc/streaming_topk.cu, reached through
dense_topk_kernel (method="kernel" / use_kernel=True, the counterpart of
method="pallas" / use_pallas=True); dense_topk_ref is its plain version.
The TPU kernel _bucket_kernel (:172) is csrc/bucket_winners.cu, reached
through bucket_winners (two routes, bucket_route; the wgmma route's split
tables merged by bucket_merge); bucket_winners_ref is its plain version, the
counterpart of the oracle _bucket_winners_xla (:273), and bucket_merge_ref
the merge's.

Tie rule: every route returns the exact top-k by (score descending, lower
row first), lax.top_k's rule, as the reference's "exact" and "scan" methods
do. The reference's Pallas kernel keeps, among exactly tied scores, the rows
its slot history leaves (ROADMAP, faults found); the port does not copy it.
The matmuls outside the kernel stay torch.matmul, as the reference leaves
them to XLA.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

NEG_INF = -3.0e38
POS_INF = 3.0e38
SCAN_CHUNK = 65536          # corpus rows per step of the chunked scan


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def top_k(x: torch.Tensor, k: int):
    """lax.top_k along the last dim: values descending, ties to the lower
    index, exact membership at the k-th value. For f32, one torch.topk over
    int64 keys that hold the value's order-preserving bits above the
    reversed index, so no two keys tie (-0.0 counts as 0.0, as in a sort);
    other dtypes take a stable sort."""
    k = min(k, x.shape[-1])
    if x.dtype != torch.float32:
        vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
        return vals[..., :k], idx[..., :k]
    bits = (x + 0.0).view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    del bits                            # one int64 copy at a time
    key *= 1 << 32
    key += 0xFFFFFFFF - torch.arange(x.shape[-1], device=x.device)
    idx = torch.topk(key, k, dim=-1).indices
    return x.gather(-1, idx), idx


def _dense_candidates(emb: torch.Tensor, queries: torch.Tensor, k: int,
                      chunk_rows: int):
    """Exact top-k of queries @ emb.T by (score descending, lower row
    first), in f32 (bf16 rows are widened, so products are exact and sums
    f32, as preferred_element_type=f32 gives), over corpus chunks of at most
    chunk_rows rows: only one chunk is widened at a time. Returns (B, k)
    values and int64 rows."""
    q = queries.float()
    n = emb.shape[0]
    return _chunked_topk(lambda lo, hi: torch.matmul(q, emb[lo:hi].float().T),
                         n, min(k, n), chunk_rows)


def hybrid_fuse(
    emb: torch.Tensor,          # (N, D)
    queries: torch.Tensor,      # (B, D)
    sp_vals_all: torch.Tensor,  # (B, M) BM25 top-m values (0 for invalid)
    sp_docs_all: torch.Tensor,  # (B, M) doc ids (-1 invalid)
    sp_max: torch.Tensor,       # (B, 1) per-query max BM25
    k: int,
    n_docs: int,
    dense_k: int = 128,
    sparse_weight: float = 0.6,
    recall_target: float = 0.95,
    materialize_bytes: int = 8 * 1024**3,
):
    """Dense candidates + candidate-union fusion given the sparse top-m
    tables: final = dense + sparse_weight * bm25 / max_bm25 over the union
    of the dense top-dense_k and the sparse top-m. A dense candidate outside
    the sparse top-m scores 0 on the sparse side (the reference's documented
    approximation, ops/topk.py:596-598). The dense candidates are exact and
    scanned SCAN_CHUNK rows at a time (fewer when materialize_bytes, the
    reference's bound on a (B, rows) f32 score block, allows fewer), so no
    f32 copy of the corpus forms. recall_target is accepted for the
    reference's signature and has no effect: every route is exact. Returns
    (scores (B, k), ids (B, k)) sorted descending; id -1 pads."""
    sp_vals, sp_docs = sp_vals_all, sp_docs_all
    b = queries.shape[0]
    inv_max = torch.where(sp_max > 0, 1.0 / sp_max.clamp_min(1e-30), 0.0)
    chunk_rows = max(1, min(SCAN_CHUNK, materialize_bytes // max(4 * b, 1)))
    d_vals, d_idx = _dense_candidates(emb, queries, dense_k, chunk_rows)
    # sparse candidates' dense scores: row gather + einsum, f32
    sp_emb = emb[sp_docs.clamp_min(0).long()]                    # (B, M, D)
    sp_dense = torch.einsum("bmd,bd->bm", sp_emb.float(), queries.float())
    # sparse score of dense candidates: equality match vs the lookup table
    eq = d_idx[:, :, None] == sp_docs[:, None, :]                # (B, Kd, M)
    d_sparse = torch.where(eq, sp_vals[:, None, :], 0.0).sum(dim=-1)

    fused_d = d_vals + sparse_weight * d_sparse * inv_max        # (B, Kd)
    fused_s = sp_dense + sparse_weight * sp_vals * inv_max       # (B, M)
    # mask invalid sparse candidates and those already in the dense list
    dup = (sp_docs[:, :, None] == d_idx[:, None, :]).any(dim=-1)
    fused_s = torch.where((sp_docs >= 0) & ~dup, fused_s, NEG_INF)

    all_vals = torch.cat([fused_d, fused_s], dim=1)
    all_ids = torch.cat([d_idx, sp_docs.to(d_idx.dtype)], dim=1)
    tv, tp = top_k(all_vals, k)
    ids = all_ids.gather(1, tp)
    ids = torch.where(tv > NEG_INF / 2, ids, -1)
    return tv, ids


def hybrid_topk(
    emb: torch.Tensor,          # (N, D)
    queries: torch.Tensor,      # (B, D)
    doc_rows: torch.Tensor,     # (B, L) sorted posting doc ids, or tiled 3-D
    weight_rows: torch.Tensor,  # (B, L) posting weights
    k: int,
    n_docs: int,
    dense_k: int = 128,
    sparse_m: int = 64,
    sparse_weight: float = 0.6,
    recall_target: float = 0.95,
    materialize_bytes: int = 8 * 1024**3,
    max_seg: int = 0,           # max term instances per query
    select_approx: bool = False,
):
    """Hybrid top-k: sparse top-m table, then hybrid_fuse.

    Sparse stage routing, as the reference routes it with "on the TPU" read
    as "tensors on cuda": a tiled 3-D plan, or a plan on cuda at least 2048
    wide, goes to sparse_topm_winners (the window-winners kernel for
    0 < max_seg <= 32, else the segment-winners kernel); any other plan to
    the sparse_topm_from_sorted chain. (The 2048 threshold is the
    reference's TPU tuning.) recall_target and select_approx are accepted
    for the reference's signature and have no effect: every route of the
    port is exact."""
    from anorag_tpu_torch.ops.bm25 import (sparse_topm_from_sorted,
                                           sparse_topm_winners)

    if doc_rows.ndim == 3 or (doc_rows.is_cuda and doc_rows.shape[1] >= 2048):
        sp_vals, sp_docs, sp_max = sparse_topm_winners(
            doc_rows, weight_rows, sparse_m, n_docs, max_seg=max_seg,
            b_valid=queries.shape[0])
    else:
        _, sp_vals, sp_docs, sp_max = sparse_topm_from_sorted(
            doc_rows, weight_rows, sparse_m, n_docs, impl="chain")
    return hybrid_fuse(emb, queries, sp_vals, sp_docs, sp_max, k,
                       n_docs=n_docs, dense_k=dense_k,
                       sparse_weight=sparse_weight,
                       materialize_bytes=materialize_bytes)


def hybrid_topk_bucketed_tiled(
    emb: torch.Tensor,
    queries: torch.Tensor,
    plan_arrays,                # ((a3, w3), ...) tiled plans per length bucket
    inv,                        # (B,) permutation back to input order
    k: int,
    n_docs: int,
    b_valids,                   # per-bucket true batch sizes
    dense_k: int = 128,
    sparse_m: int = 64,
    sparse_weight: float = 0.6,
    recall_target: float = 0.95,
    max_seg: int = 8,
):
    """hybrid_topk with a length-bucketed tiled sparse stage
    (bm25.plan_tiles_bucketed + sparse_topm_winners_bucketed): the same
    window-winners kernel per bucket, so the same results as hybrid_topk
    over the unbucketed tiled plan. recall_target has no effect."""
    from anorag_tpu_torch.ops.bm25 import sparse_topm_winners_bucketed

    sp_vals, sp_docs, sp_max = sparse_topm_winners_bucketed(
        plan_arrays, inv, sparse_m, n_docs, max_seg, b_valids)
    return hybrid_fuse(emb, queries, sp_vals, sp_docs, sp_max, k,
                       n_docs=n_docs, dense_k=dense_k,
                       sparse_weight=sparse_weight)


class BucketedSparsePlan(NamedTuple):
    """Length-bucketed posting plan on the device (make_bucketed_plan)."""
    buckets: tuple          # ((n_valid, doc_rows (Bg, Lg), weight_rows), ...)
    inv: torch.Tensor       # (B,) permutation back to input order
    n_rows: int


def make_bucketed_plan(doc_rows, weight_rows, lens, n_docs: int,
                       groups: int = 4, device=None) -> BucketedSparsePlan:
    """Host prep of the length-bucketed sparse stage: queries sorted by plan
    length and split into `groups` contiguous buckets, each cut to its own
    power-of-two width (at least 128) and padded to the largest bucket's
    row count with all-pad rows, then uploaded once to `device` (the card
    unless the CPU is asked for), so a plan reused across calls is not
    uploaded again."""
    from anorag_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    doc_rows = np.asarray(doc_rows)
    weight_rows = np.asarray(weight_rows)
    lens = np.asarray(lens)
    b = doc_rows.shape[0]
    groups = max(1, min(groups, b))
    order = np.argsort(lens, kind="stable")
    splits = [s for s in np.array_split(order, groups) if len(s)]
    bg = max(len(s) for s in splits)
    buckets = []
    for rows in splits:
        li = max(int(lens[rows].max()), 1)
        li = min(max(128, 1 << (li - 1).bit_length()), doc_rows.shape[1])
        dr = np.full((bg, li), n_docs, doc_rows.dtype)
        wr = np.zeros((bg, li), weight_rows.dtype)
        dr[:len(rows)] = doc_rows[rows, :li]
        wr[:len(rows)] = weight_rows[rows, :li]
        buckets.append((len(rows), torch.from_numpy(dr).to(dev),
                        torch.from_numpy(wr).to(dev)))
    inv = np.empty(b, np.int64)
    inv[np.concatenate(splits)] = np.arange(b)
    return BucketedSparsePlan(tuple(buckets), torch.from_numpy(inv).to(dev), b)


def hybrid_topk_bucketed(
    emb: torch.Tensor,
    queries: torch.Tensor,
    plan: BucketedSparsePlan,
    k: int,
    n_docs: int,
    dense_k: int = 128,
    sparse_m: int = 64,
    sparse_weight: float = 0.6,
    recall_target: float = 0.95,
    materialize_bytes: int = 8 * 1024**3,
):
    """hybrid_topk with a length-bucketed sparse stage: each bucket of
    make_bucketed_plan runs sparse_topm_from_sorted (impl "auto": the
    segment-totals kernel for buckets on the card at least 2048 wide with at
    least 8 rows, the chain otherwise), the (B, m) tables go back to input
    order, and one hybrid_fuse over the whole batch follows. recall_target
    has no effect."""
    from anorag_tpu_torch.ops.bm25 import sparse_topm_from_sorted

    tvs, tds, mxs = [], [], []
    for n_valid, dr, wr in plan.buckets:
        _, tv, td, mx = sparse_topm_from_sorted(dr, wr, sparse_m, n_docs)
        tvs.append(tv[:n_valid])
        tds.append(td[:n_valid])
        mxs.append(mx[:n_valid])
    sp_vals = torch.cat(tvs)[plan.inv]
    sp_docs = torch.cat(tds)[plan.inv]
    sp_max = torch.cat(mxs)[plan.inv]
    return hybrid_fuse(emb, queries, sp_vals, sp_docs, sp_max, k,
                       n_docs=n_docs, dense_k=dense_k,
                       sparse_weight=sparse_weight,
                       materialize_bytes=materialize_bytes)


# ------------------------------------------------------------ dense search
MAX_K = 1024                # the streaming kernel's largest k (csrc kMaxK)


def _sort_topk(vals: torch.Tensor, idx: torch.Tensor, k: int):
    sv, order = top_k(vals, k)
    return sv, idx.gather(1, order)


def _pad_k(vals: torch.Tensor, idx: torch.Tensor, k: int, k_eff: int):
    if k_eff < k:
        vals = torch.nn.functional.pad(vals, (0, k - k_eff), value=NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, k - k_eff), value=-1)
    return vals, idx


def _chunked_topk(score_chunk, n: int, k: int, chunk: int):
    """Exact top-k by (score descending, lower row first) of
    score_chunk(lo, hi) -> (B, hi - lo) f32, over row chunks of the corpus:
    each chunk's own top-k is merged into the running one (running rows are
    lower and come first in the merge, so top_k keeps them first among
    ties). Returns (B, k)
    values and int64 rows."""
    best_v = best_i = None
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        v, i = top_k(score_chunk(lo, hi), min(k, hi - lo))
        i = i + lo
        if best_v is not None:
            v, order = top_k(torch.cat([best_v, v], dim=1), k)
            i = torch.cat([best_i, i], dim=1).gather(1, order)
        best_v, best_i = v, i
    return best_v, best_i


def _bias_scores(q32: torch.Tensor, emb: torch.Tensor, lo: int, hi: int,
                 bias: Optional[torch.Tensor], bias_weight: float):
    """f32 scores of rows [lo, hi), plus bias_weight * bias (multiplied,
    then added, as the reference and the kernel round it)."""
    s = torch.matmul(q32, emb[lo:hi].float().T)
    if bias is not None:
        s = s + bias_weight * bias[:, lo:hi]
    return s


def dense_topk_xla(emb: torch.Tensor, queries: torch.Tensor, k: int,
                   chunk: int = SCAN_CHUNK, bias: Optional[torch.Tensor] = None,
                   bias_weight: float = 1.0):
    """Chunked matmul (+ bias_weight * bias) + exact top-k merge: queries
    in the corpus dtype, f32 scores, bounded O(B * chunk) memory; (B,
    min(k, N)) f32 values and int64 rows. (The reference's approx=True
    takes approx_max_k per chunk on the TPU; the port's chunks are always
    exact, so it has no such argument.)"""
    n = emb.shape[0]
    q32 = queries.to(emb.dtype).float()
    return _chunked_topk(
        lambda lo, hi: _bias_scores(q32, emb, lo, hi, bias, bias_weight),
        n, min(k, n), chunk)


def dense_topk_ref(emb: torch.Tensor, queries: torch.Tensor, k: int,
                   bias: Optional[torch.Tensor] = None, bias_weight: float = 1.0,
                   chunk: int = SCAN_CHUNK):
    """Plain version of dense_topk_kernel: dense_topk_xla, ranked by (score
    descending, lower row first), with int32 rows and -1 where only masked
    rows are left."""
    vals, idx = dense_topk_xla(emb, queries, k, chunk, bias, bias_weight)
    return vals, torch.where(vals > NEG_INF / 2, idx, -1).int()


TOPK_ROWS = 128             # corpus rows of a sub-tile (csrc kRows)
MAX_SPLITS = 256            # sorted partials one merge warp takes (csrc kMaxLists)
# query tile -> the largest k it takes (csrc kWgMaxK, Tile<QT>::kMaxK): the
# 128- and 64-query tiles hold their queries' lists beside the ring
TOPK_TILE_MAX_K = {128: 32, 64: 128, 16: MAX_K}
# From this many queries a bf16 batch takes the 128-query tile or the
# 64-query tile (the largest topk_tiles allows); below, the 16-query tile,
# the memory-bound route, where the larger tile would be mostly padding
# (topk_query_tile).
TOPK_BATCH_FROM = {128: 48, 64: 64}
# Rows that are not 16-byte aligned (vec_ok 0) are staged by plain loads,
# which the 64-query tile shares among 4x the queries: it led the 16-query
# tile from one query up (PERF.md), so it takes them from this many.
TOPK_UNALIGNED_FROM = 1
# The batch route's seed pass scans the first TOPK_SEED_PER_K * k rows (at
# most a sixteenth of the corpus) for each query's k-th best score.
TOPK_SEED_PER_K = 512


def topk_tiles(code: int, k: int, vec: int) -> list:
    """The query tiles the streaming top-k kernel takes at dtype code (0
    bf16, 1 f32), k and vec (1: rows read 16 bytes at a time, vec_ok), in
    ascending order, as csrc bad_tile decides: f32 only 16; bf16 16 to
    MAX_K, 64 to k 128, and 128 (the wgmma route, whose TMA loads need
    16-byte rows) to k 32."""
    if code != 0:
        return [16]
    return [t for t, k_max in sorted(TOPK_TILE_MAX_K.items())
            if k <= k_max and (t != 128 or vec)]


def topk_query_tile(b: int, k: int, code: int, vec: int) -> int:
    """Queries a tile of the streaming top-k kernel for b queries at k, dtype
    code and vec as topk_tiles's: the largest tile topk_tiles allows from
    TOPK_BATCH_FROM's count of queries (TOPK_UNALIGNED_FROM's without
    16-byte rows), else 16 (f32, k above 128, a small batch). The
    thresholds are where the routes cross in side-by-side timings on the
    card (PERF.md)."""
    big = topk_tiles(code, k, vec)[-1]
    if big == 16:
        return 16
    return big if b >= (TOPK_BATCH_FROM[big] if vec else TOPK_UNALIGNED_FROM) else 16


class TopkPlan(NamedTuple):
    """The kernel's units: q_tiles tiles of q_tile queries x splits corpus
    ranges of `per` TOPK_ROWS-row sub-tiles (the last range may be shorter,
    none is empty); unit u is split u // q_tiles of tile u % q_tiles, so
    the tiles of one range run side by side."""
    q_tile: int
    q_tiles: int
    splits: int
    per: int

    @property
    def units(self) -> int:
        return self.q_tiles * self.splits


def topk_work_plan(b: int, n: int, q_tile: int, slots: int) -> TopkPlan:
    """About `slots` units (the CTAs the card holds at once, one wave): the
    corpus's sub-tiles cut into slots // q_tiles splits, at most MAX_SPLITS
    and at most one a sub-tile, of equal whole sub-tiles."""
    n_sub = -(-n // TOPK_ROWS)
    q_tiles = -(-b // q_tile)
    want = max(1, min(MAX_SPLITS, n_sub, slots // q_tiles))
    per = -(-n_sub // want)
    return TopkPlan(q_tile, q_tiles, -(-n_sub // per), per)


def topk_seed_rows(n: int, k: int, q_tile: int) -> int:
    """Rows of the seed pass before a scan with q_tile-query tiles: the
    first TOPK_SEED_PER_K * k rows, at most n // 16, in whole sub-tiles; 0
    (no seed pass) for the 16-query tile or where that leaves fewer than
    max(k, TOPK_ROWS) rows. The seed pass's k-th best score of each query is
    a bar that k rows reach, so the scan keeps nothing below it and merges
    far fewer candidates."""
    rows = min(TOPK_SEED_PER_K * k, n // 16) // TOPK_ROWS * TOPK_ROWS
    return rows if q_tile > 16 and rows >= max(k, TOPK_ROWS) else 0


_topk_lib = None


def _load_topk() -> ctypes.CDLL:
    """csrc/streaming_topk.cu's library, built on first use, its C
    signatures set once."""
    global _topk_lib
    if _topk_lib is None:
        from anorag_tpu_torch import _build

        lib = _build.load("streaming_topk")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.anorag_topk_slots.argtypes = [i, i, i, i, i]
        lib.anorag_topk_slots.restype = i
        lib.anorag_dense_topk.argtypes = [p, p, p, ll, ctypes.c_float, i, p, i, ll,
                                          ll, i, i, i, i, i, i, p, p, p, p, i, p]
        lib.anorag_dense_topk.restype = i
        _topk_lib = lib
    return _topk_lib


@functools.lru_cache(maxsize=None)
def topk_slots(code: int, q_tile: int, k: int, vec: int, device_index: int) -> int:
    """CTAs of the kernel instance (dtype code, q_tile, k, 16-byte rows or
    not) that card device_index holds at once, from the CUDA occupancy
    calculator."""
    n = _load_topk().anorag_topk_slots(code, q_tile, k, vec, device_index)
    if n <= 0:
        raise RuntimeError(f"dense_topk occupancy query failed: CUDA error {-n}")
    return n


def kernel_dtype_code(t: torch.Tensor) -> int:
    """The kernel's dtype code: 0 bf16, 1 f32; TypeError for any other."""
    if t.dtype == torch.bfloat16:
        return 0
    if t.dtype == torch.float32:
        return 1
    raise TypeError(f"the top-k kernels take bf16 or f32 rows, got {t.dtype}")


def check_kernel_operands(what: str, k: int, *tensors: torch.Tensor) -> bool:
    """Raise on operands the kernel does not take; True when all lie on the
    CPU (the plain version runs), False when all lie on one CUDA device."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{what}: k {k} outside [1, {MAX_K}], the streaming "
                         f"top-k kernel's limit")
    if all(t.device.type == "cpu" for t in tensors):
        return True
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{what}: every operand must lie on one CUDA device "
                         f"(or all on the CPU)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: operands must be contiguous")
    return False


def vec_ok(d: int, *tensors: torch.Tensor) -> int:
    """1 when rows of width d can be read 16 bytes at a time."""
    item = tensors[0].element_size()
    return int(d % (16 // item) == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def _scan(emb: torch.Tensor, queries: torch.Tensor, k: int,
          bias: Optional[torch.Tensor], ldb: int, bias_weight: float, q_tile: int,
          seed: Optional[torch.Tensor]):
    """One run of the kernel (phase 1 and the merge) over emb's rows, bias
    rows ldb apart; returns (B, k) values and int32 rows."""
    code = kernel_dtype_code(emb)
    (b, d), n = queries.shape, emb.shape[0]
    dev = emb.device
    vec = vec_ok(d, emb, queries)
    plan = topk_work_plan(b, n, q_tile, topk_slots(code, q_tile, k, vec, dev.index))
    part_v = torch.empty((b, plan.splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, plan.splits, k), dtype=torch.int32, device=dev)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    bias_vec = int(bias is not None and ldb % 2 == 0 and bias.data_ptr() % 8 == 0)
    err = _load_topk().anorag_dense_topk(
        queries.data_ptr(), emb.data_ptr(),
        None if bias is None else bias.data_ptr(), ldb, float(bias_weight), bias_vec,
        None if seed is None else seed.data_ptr(), code, b, n, d, k, vec, q_tile,
        plan.splits, plan.per, part_v.data_ptr(), part_i.data_ptr(),
        vals.data_ptr(), idx.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dense_topk kernel launch failed: CUDA error {err}")
    return vals, idx


def _launch_topk(emb: torch.Tensor, queries: torch.Tensor, k: int,
                 bias: Optional[torch.Tensor], bias_weight: float, q_tile: int,
                 seed_rows: Optional[int] = None):
    """dense_topk_kernel's launch on checked CUDA operands (k <= N) with
    tiles of q_tile queries, after a seed pass over the first seed_rows rows
    (topk_seed_rows's choice when None; 0 for none). dense_topk_kernel
    passes topk_query_tile's tile, chip_smoke.py times both routes through
    here. Counts one launch in dense_topk_kernel.launches."""
    n = emb.shape[0]
    if seed_rows is None:
        seed_rows = topk_seed_rows(n, k, q_tile)
    seed = None
    if seed_rows:
        sv, _ = _scan(emb[:seed_rows], queries, k, bias, n, bias_weight, q_tile, None)
        seed = sv[:, k - 1].contiguous()
    vals, idx = _scan(emb, queries, k, bias, n, bias_weight, q_tile, seed)
    dense_topk_kernel.launches += 1
    return vals, idx


def dense_topk_kernel(emb: torch.Tensor, queries: torch.Tensor, k: int,
                      bias: Optional[torch.Tensor] = None,
                      bias_weight: float = 1.0):
    """Exact streaming top-k of queries @ emb.T (+ bias_weight * bias):
    (B, min(k, N)) f32 values and int32 rows, sorted by (score descending,
    lower row first). emb (N, D) bf16 or f32, queries (B, D) in emb's dtype,
    bias (B, N) f32. CUDA tensors launch csrc/streaming_topk.cu with the
    tile topk_query_tile picks and count one launch in
    dense_topk_kernel.launches; CPU tensors run dense_topk_ref. k above
    MAX_K raises ValueError."""
    if emb.dim() != 2 or queries.dim() != 2 or queries.shape[1] != emb.shape[1]:
        raise ValueError(f"dense_topk_kernel: emb (N, D) and queries (B, D), "
                         f"got {tuple(emb.shape)} and {tuple(queries.shape)}")
    code = kernel_dtype_code(emb)
    if queries.dtype != emb.dtype:
        raise TypeError(f"dense_topk_kernel: queries {queries.dtype} must be in "
                        f"the corpus dtype {emb.dtype}")
    b, n = queries.shape[0], emb.shape[0]
    operands = [emb, queries]
    if bias is not None:
        if bias.dtype != torch.float32:
            raise TypeError(f"dense_topk_kernel: bias must be f32, got {bias.dtype}")
        if tuple(bias.shape) != (b, n):
            raise ValueError(f"dense_topk_kernel: bias of shape {tuple(bias.shape)}, "
                             f"expected {(b, n)}")
        operands.append(bias)
    k_eff = min(k, n)
    if check_kernel_operands("dense_topk_kernel", k_eff, *operands):
        return dense_topk_ref(emb, queries, k_eff, bias, bias_weight)
    vec = vec_ok(emb.shape[1], emb, queries)
    return _launch_topk(emb, queries, k_eff, bias, bias_weight,
                        topk_query_tile(b, k_eff, code, vec))


dense_topk_kernel.launches = 0

METHODS = ("auto", "approx", "exact", "scan", "approx_scan", "exact_smalln",
           "kernel")


def dense_topk(emb, queries, k: int, *, method: str = "auto",
               recall_target: float = 0.95, use_kernel: Optional[bool] = None,
               bias=None, bias_weight: float = 1.0):
    """Top-k inner-product search: (scores (B, k) f32, rows (B, k) int64),
    sorted; k > N pads with (NEG_INF, -1). emb may be bf16; scores are f32.
    bias (B, N), when given, is fused in: score = q.e + bias_weight * bias.

    method, as the reference's, with "on the TPU" read as "emb on cuda":
      auto        -- approx when the (B, N) f32 scores take at most 2 GiB on
                     the card, else approx_scan (kernel with a bias); scan
                     (exact_smalln with a bias) on the CPU;
      approx, exact -- matmul + exact top-k (the reference's approx_max_k
                     is exact on its CPU backend), per SCAN_CHUNK corpus
                     rows with an exact merge, so no (B, N) scores and no
                     f32 copy of the corpus form;
      scan, approx_scan -- the same chunked scan without the bias, as in
                     the reference;
      exact_smalln -- f32 queries and corpus, matmul + top-k;
      kernel      -- the streaming top-k kernel (dense_topk_kernel), the
                     counterpart of method="pallas": no (B, N) scores in
                     device memory, k at most MAX_K.
    use_kernel=True/False, the counterpart of use_pallas, means "kernel" /
    "scan" ("exact_smalln" with a bias). Ties: lower row first.
    recall_target is accepted for the reference's signature and unused:
    every route of the port is exact."""
    emb = torch.as_tensor(emb)
    queries = torch.as_tensor(queries, device=emb.device)
    n, b = emb.shape[0], queries.shape[0]
    k_eff = min(k, n)
    if use_kernel is True:
        method = "kernel"
    elif use_kernel is False:
        method = "scan" if bias is None else "exact_smalln"
    if method == "auto":
        if emb.is_cuda and 4 * b * n <= 2 * 1024**3:
            method = "approx"
        elif emb.is_cuda:
            method = "approx_scan" if bias is None else "kernel"
        else:
            method = "scan" if bias is None else "exact_smalln"
    if method not in METHODS:
        raise ValueError(f"unknown dense_topk method {method!r}; one of {METHODS}")
    if bias is not None:
        bias = torch.as_tensor(bias, dtype=torch.float32, device=emb.device)

    if method in ("approx", "exact", "scan", "approx_scan"):
        # one exact chunked scan; the reference's scan leaves the bias out
        vals, idx = dense_topk_xla(
            emb, queries, k_eff, SCAN_CHUNK,
            bias if method in ("approx", "exact") else None, bias_weight)
    elif method == "exact_smalln":
        scores = torch.matmul(queries.float(), emb.float().T)
        if bias is not None:
            scores = scores + bias_weight * bias
        vals, idx = top_k(scores, k_eff)
    else:
        vals, idx = dense_topk_kernel(emb, queries.to(emb.dtype).contiguous(),
                                      k_eff, bias=bias, bias_weight=bias_weight)
    return _pad_k(vals, idx.long(), k, k_eff)


# ------------------------------------------------------- bucketed winners
BUCKET_BUDGET = 12 * 1024 * 1024     # the reference's VMEM guard, bytes


def bucket_width(b: int, d: int, itemsize: int, w: int, tiles: int, k_eff: int):
    """The reference's width rule (bucket_topk :324-342): w doubles until it
    holds k_eff, then its 12 MiB VMEM guard on the padded shapes (d to 128,
    b to 8, the corpus itemsize) halves `tiles`, then `w` while w > 128 and
    w / 2 still holds k_eff. A TPU budget, kept because W decides which
    bucket each column lands in, so it decides the result. Returns (w,
    tiles)."""
    while w < k_eff:
        w *= 2
    d_pad = _round_up(d, 128)
    b_pad = _round_up(max(b, 8), 8)

    def vmem(w_, t_):
        return (b_pad * d_pad * itemsize + 7 * b_pad * w_ * 4
                + 2 * t_ * w_ * d_pad * itemsize)
    while tiles > 1 and vmem(w, tiles) > BUCKET_BUDGET:
        tiles //= 2
    while w > 128 and w // 2 >= k_eff and vmem(w, tiles) > BUCKET_BUDGET:
        w //= 2
    return w, tiles


def _corpus_rows(emb: torch.Tensor, transposed: bool) -> torch.Tensor:
    """The (N, D) view of a corpus given as (N, D) or, transposed, (D, N):
    a view, never a copy."""
    if emb.dim() != 2:
        raise ValueError(f"the corpus must be 2-D, got {tuple(emb.shape)}")
    return emb.T if transposed else emb


def bucket_winners_ref(emb: torch.Tensor, queries: torch.Tensor, n: int, w: int,
                       transposed: bool = False):
    """Plain version of bucket_winners, the counterpart of the oracle
    _bucket_winners_xla (:273): tile by tile in increasing order, s =
    q . e_tile^T in f32 (bf16 rows widened: the products are exact), columns
    at or past n masked to NEG_INF, then upd = s > winners (strict, so the
    earlier tile keeps a tie), winners = where(upd, s, winners), ids =
    where(upd, base + col, ids); the initial state is (NEG_INF, 0). Returns
    ((B, w) f32, (B, w) int32)."""
    e = _corpus_rows(emb, transposed)
    q32 = queries.to(e.dtype).float()
    b, dev = q32.shape[0], e.device
    wv = torch.full((b, w), NEG_INF, dtype=torch.float32, device=dev)
    wi = torch.zeros((b, w), dtype=torch.int32, device=dev)
    col = torch.arange(w, dtype=torch.int32, device=dev)
    for base in range(0, n, w):
        rows = e[base:min(base + w, n)].float()
        s = torch.full((b, w), NEG_INF, dtype=torch.float32, device=dev)
        s[:, :rows.shape[0]] = torch.matmul(q32, rows.T)
        upd = s > wv
        wv = torch.where(upd, s, wv)
        wi = torch.where(upd, base + col, wi)
    return wv, wi


BUCKET_TILE = 128           # queries and bucket columns of a wgmma unit (csrc kBwTile)


class BucketPlan(NamedTuple):
    """The wgmma route's units: q_tiles tiles of BUCKET_TILE queries x
    c_tiles tiles of BUCKET_TILE bucket columns x splits ranges of `per`
    corpus tiles (W rows each; the last range may be shorter, none is
    empty); unit u is query tile u % q_tiles of (column tile, split)
    u // q_tiles, so the query tiles that read the same corpus rows run side
    by side."""
    q_tiles: int
    c_tiles: int
    splits: int
    per: int

    @property
    def units(self) -> int:
        return self.q_tiles * self.c_tiles * self.splits


def bucket_work_plan(b: int, w: int, n: int, slots: int) -> BucketPlan:
    """About `slots` units (the CTAs the card holds at once, one wave): the
    ceil(n / w) corpus tiles cut into slots // (q_tiles * c_tiles) splits of
    equal whole tiles, at least one and at most one a tile."""
    n_tiles = -(-n // w)
    q_tiles, c_tiles = -(-b // BUCKET_TILE), -(-w // BUCKET_TILE)
    want = max(1, min(n_tiles, slots // (q_tiles * c_tiles)))
    per = -(-n_tiles // want)
    return BucketPlan(q_tiles, c_tiles, -(-n_tiles // per), per)


def bucket_merge_ref(part_v: torch.Tensor, part_i: torch.Tensor):
    """Plain version of bucket_merge: per cell, the largest value over the
    split tables (splits, B, W) by strict > in split order (an earlier split
    keeps a tie) and its row. Returns ((B, W) f32, (B, W) int32)."""
    v, i = part_v[0], part_i[0]
    for s in range(1, part_v.shape[0]):
        upd = part_v[s] > v
        v = torch.where(upd, part_v[s], v)
        i = torch.where(upd, part_i[s], i)
    return v.clone(), i.clone()


_bucket_lib = None


def _load_bucket() -> ctypes.CDLL:
    """csrc/bucket_winners.cu's library, built on first use, its C
    signatures set once."""
    global _bucket_lib
    if _bucket_lib is None:
        from anorag_tpu_torch import _build

        lib = _build.load("bucket_winners")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.anorag_bucket_winners.argtypes = [p, p, ll, ll, i, i, i, ll, ll, i, i,
                                              p, p, i, p]
        lib.anorag_bucket_winners.restype = i
        lib.anorag_bucket_slots.argtypes = [i]
        lib.anorag_bucket_slots.restype = i
        lib.anorag_bucket_winners_wgmma.argtypes = [p, ll, p, ll, ll, ll, i, i, i, i,
                                                    p, p, i, p]
        lib.anorag_bucket_winners_wgmma.restype = i
        lib.anorag_bucket_merge.argtypes = [p, p, ll, i, p, p, i, p]
        lib.anorag_bucket_merge.restype = i
        _bucket_lib = lib
    return _bucket_lib


@functools.lru_cache(maxsize=None)
def bucket_slots(device_index: int) -> int:
    """CTAs of the wgmma route that card device_index holds at once, from
    the CUDA occupancy calculator."""
    n = _load_bucket().anorag_bucket_slots(device_index)
    if n <= 0:
        raise RuntimeError(f"bucket_winners occupancy query failed: CUDA error {-n}")
    return n


def staging_mode(t: torch.Tensor) -> int:
    """How the bucket kernel stages an (rows, D) operand: 0, 16-byte
    cp.async (rows contiguous, D, the row stride and the address 16-byte
    multiples); 1, plain loads along the rows; 2, plain loads down the
    columns (column stride 1 and row stride not: the transposed corpus)."""
    vec = 16 // t.element_size()
    sr, sc = t.stride()
    d = t.shape[1]
    if sc == 1 and d % vec == 0 and sr % vec == 0 and t.data_ptr() % 16 == 0:
        return 0
    return 2 if sr == 1 and sc != 1 else 1


def bucket_route(b: int, n: int, w: int, code: int, e_mode: int, q_mode: int) -> str:
    """The bucket kernel's route for b queries over n rows into w buckets,
    dtype code (0 bf16, 1 f32) and the operands' staging modes: "wgmma" for
    bf16 with 16-byte rows (mode 0: TMA's strides) and w a multiple of
    BUCKET_TILE, at any batch (the route lines on the card put it ahead
    from one query, PERF.md), rows and tile starts below 2^31; "mma" (the
    first kernel: mma.sync for bf16, FMAs for f32) for everything else."""
    if (code == 0 and e_mode == 0 and q_mode == 0 and w % BUCKET_TILE == 0
            and 1 <= n and n + w < 2**31 and b >= 1):
        return "wgmma"
    return "mma"


def bucket_merge(part_v: torch.Tensor, part_i: torch.Tensor):
    """The largest value of each cell over the split tables (splits, B, W),
    strict > in split order, and its row. CUDA tensors launch csrc/
    bucket_winners.cu's merge kernel and count one launch in
    bucket_merge.launches; CPU tensors run bucket_merge_ref. Returns ((B, W)
    f32, (B, W) int32)."""
    if part_v.dim() != 3 or part_i.shape != part_v.shape:
        raise ValueError(f"bucket_merge: (splits, B, W) tables, got "
                         f"{tuple(part_v.shape)} and {tuple(part_i.shape)}")
    if part_v.dtype != torch.float32 or part_i.dtype != torch.int32:
        raise TypeError("bucket_merge: f32 values and int32 rows")
    if part_v.device.type == "cpu" and part_i.device.type == "cpu":
        return bucket_merge_ref(part_v, part_i)
    if not (part_v.is_cuda and part_i.device == part_v.device
            and part_v.is_contiguous() and part_i.is_contiguous()):
        raise ValueError("bucket_merge: contiguous tables on one CUDA device "
                         "(or both on the CPU)")
    splits, b, w = part_v.shape
    dev = part_v.device
    vals = torch.empty((b, w), dtype=torch.float32, device=dev)
    idx = torch.empty((b, w), dtype=torch.int32, device=dev)
    err = _load_bucket().anorag_bucket_merge(
        part_v.data_ptr(), part_i.data_ptr(), b * w, splits, vals.data_ptr(),
        idx.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bucket_merge kernel launch failed: CUDA error {err}")
    bucket_merge.launches += 1
    return vals, idx


bucket_merge.launches = 0


def _launch_bucket(e: torch.Tensor, queries: torch.Tensor, n: int, w: int, route: str):
    """bucket_winners's launch on checked CUDA operands (e the (N, D) view)
    through `route`: bucket_winners passes bucket_route's, chip_smoke.py
    times both routes through here. The wgmma route takes its plan from
    bucket_work_plan, reads the queries in whole BUCKET_TILE-row tiles (a
    zero-filled copy when B is not a multiple) and, with more than one
    split, merges the split tables by bucket_merge. Counts one launch in
    bucket_winners.launches and in bucket_winners.route_launches[route]."""
    lib = _load_bucket()
    b, d = queries.shape
    dev = e.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "wgmma":
        plan = bucket_work_plan(b, w, n, bucket_slots(dev.index))
        q = queries
        if b % BUCKET_TILE:     # whole query tiles: TMA's fill past the end is slower
            q = queries.new_zeros((plan.q_tiles * BUCKET_TILE, d))
            q[:b] = queries
        part_v = torch.empty((plan.splits, b, w), dtype=torch.float32, device=dev)
        part_i = torch.empty((plan.splits, b, w), dtype=torch.int32, device=dev)
        err = lib.anorag_bucket_winners_wgmma(
            q.data_ptr(), q.shape[0], e.data_ptr(), e.stride(0), b, n, d, w, plan.splits,
            plan.per, part_v.data_ptr(), part_i.data_ptr(), dev.index, stream)
    elif route == "mma":
        part_v = torch.empty((1, b, w), dtype=torch.float32, device=dev)
        part_i = torch.empty((1, b, w), dtype=torch.int32, device=dev)
        err = lib.anorag_bucket_winners(
            queries.data_ptr(), e.data_ptr(), e.stride(0), e.stride(1),
            staging_mode(e), staging_mode(queries), kernel_dtype_code(e), b, n, d, w,
            part_v.data_ptr(), part_i.data_ptr(), dev.index, stream)
    else:
        raise ValueError(f"bucket_winners: unknown route {route!r}")
    if err != 0:
        raise RuntimeError(f"bucket_winners kernel ({route} route) launch failed: "
                           f"CUDA error {err}")
    bucket_winners.launches += 1
    bucket_winners.route_launches[route] += 1
    if part_v.shape[0] > 1:
        return bucket_merge(part_v, part_i)
    return part_v[0], part_i[0]


def bucket_winners(emb: torch.Tensor, queries: torch.Tensor, n: int, w: int,
                   transposed: bool = False):
    """Bucketed winners of queries @ emb[:n].T: for each query and bucket c
    in [0, w), the largest f32 score among corpus rows r < n with r mod w ==
    c and that row (the earliest among exact ties); (NEG_INF, 0) where no
    row falls. emb is (N, D), or (D, N) with transposed, bf16 or f32, any
    strides (read in place, never copied); queries (B, D) contiguous in
    emb's dtype. CUDA tensors launch csrc/bucket_winners.cu through
    bucket_route's route and count one launch in bucket_winners.launches;
    CPU tensors run bucket_winners_ref. Returns ((B, w) f32, (B, w) int32)."""
    e = _corpus_rows(emb, transposed)
    if queries.dim() != 2 or queries.shape[1] != e.shape[1]:
        raise ValueError(f"bucket_winners: queries (B, D) with D = {e.shape[1]}, "
                         f"got {tuple(queries.shape)}")
    code = kernel_dtype_code(e)
    if queries.dtype != e.dtype:
        raise TypeError(f"bucket_winners: queries {queries.dtype} must be in the "
                        f"corpus dtype {e.dtype}")
    if not 0 <= n <= e.shape[0] or n >= 2**31 or w < 1:
        raise ValueError(f"bucket_winners: need 0 <= n <= {e.shape[0]} rows, "
                         f"n < 2^31 and w >= 1; got n {n}, w {w}")
    if e.device.type == "cpu" and queries.device.type == "cpu":
        return bucket_winners_ref(e, queries, n, w)
    if not (e.is_cuda and queries.device == e.device):
        raise ValueError("bucket_winners: corpus and queries must lie on one "
                         "CUDA device (or both on the CPU)")
    if not queries.is_contiguous():
        raise ValueError("bucket_winners: queries must be contiguous")
    route = bucket_route(queries.shape[0], n, w, code, staging_mode(e),
                         staging_mode(queries))
    return _launch_bucket(e, queries, n, w, route)


bucket_winners.launches = 0
bucket_winners.route_launches = {"wgmma": 0, "mma": 0}


def _bucket_finish(wv: torch.Tensor, wi: torch.Tensor, b: int, k: int, k_eff: int):
    """Exact top-k_eff over the winners (lax.top_k's tie rule), their ids,
    -1 where only NEG_INF was left, padded to k with (NEG_INF, -1)."""
    tv, tp = top_k(wv[:b], k_eff)
    ti = wi[:b].gather(1, tp)
    ti = torch.where(tv > NEG_INF / 2, ti, -1)
    return _pad_k(tv, ti, k, k_eff)


def bucket_topk(emb, queries, k: int, w: int = 1024, tiles: int = 1,
                interpret: Optional[bool] = None, use_xla: bool = False,
                transposed: bool = False):
    """Bucketed-winners dense top-k: corpus column c competes in bucket
    c mod W (bucket_winners), then one exact top-k over the W winners; the
    (B, N) scores never form. Approximate by design: two of the true top-k
    share a bucket with probability 1/W per pair, so E[recall@k] ~
    1 - (k-1)/(2W); exact when N <= W. W comes from bucket_width, the
    reference's rule. Queries are cast to the corpus dtype before the
    product. tiles enters only the width rule and interpret nothing: the
    kernel fixes its own tiling. use_xla=True runs the plain version
    bucket_winners_ref (the reference's XLA oracle) wherever the tensors
    lie; otherwise CUDA tensors always launch the kernel. transposed=True
    takes a (D, N) corpus. Returns (values (B, k) f32, ids (B, k) int32),
    sorted; k > N pads with (NEG_INF, -1)."""
    emb = torch.as_tensor(emb)
    queries = torch.as_tensor(queries, device=emb.device)
    n, d = _corpus_rows(emb, transposed).shape
    b = queries.shape[0]
    k_eff = min(k, n)
    w, tiles = bucket_width(b, d, emb.element_size(), w, tiles, k_eff)
    q = queries.to(emb.dtype).contiguous()
    winners = bucket_winners_ref if use_xla else bucket_winners
    wv, wi = winners(emb, q, n, w, transposed=transposed)
    return _bucket_finish(wv, wi, b, k, k_eff)


def dense_topk_np(emb: np.ndarray, queries: np.ndarray, k: int,
                  chunk: int = 2048):
    """Pure-numpy exact top-k (the reference's oracle, ops/topk.py:838),
    query-chunked so the working set stays in cache."""
    emb32 = emb.astype(np.float32, copy=False)
    q32 = np.atleast_2d(queries).astype(np.float32, copy=False)
    k = min(k, emb.shape[0])
    out_v = np.empty((len(q32), k), np.float32)
    out_i = np.empty((len(q32), k), np.int64)
    for lo in range(0, len(q32), chunk):
        hi = min(lo + chunk, len(q32))
        scores = q32[lo:hi] @ emb32.T
        part = np.argpartition(-scores, k - 1, axis=1)[:, :k]
        part_scores = np.take_along_axis(scores, part, axis=1)
        order = np.argsort(-part_scores, axis=1, kind="stable")
        out_v[lo:hi] = np.take_along_axis(part_scores, order, axis=1)
        out_i[lo:hi] = np.take_along_axis(part, order, axis=1)
    return out_v, out_i
