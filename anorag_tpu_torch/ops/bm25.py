"""BM25 sparse stage: host posting plans, the segment-scan and window-winners
kernels, and the scatter scoring path.

Counterpart of anorag_tpu/ops/bm25.py, every function of it. Host numpy:
BM25Postings, build_postings (:41), gather_plan (:79), gather_plan_sorted
(:109), plan_tiles (:465), plan_tiles_bucketed (:605), bm25_scores_np (:845),
FieldWeightedPostings (:876), build_field_weighted (:898). Device:
  * segment_totals and segment_winners -- wrappers of the hand-written CUDA
    kernels in csrc/segment_scan.cu, which replace the Pallas kernels
    _segment_totals_kernel (:184) and _segment_winners_kernel (:287);
    segment_totals_ref and segment_winners_ref are their plain PyTorch
    versions, in the kernels' arithmetic (log-step block scans in the
    reference's order, carried from block to block); segment_tile_plan is
    the row tiles and scratch of both kernels;
  * window_winners -- wrapper of csrc/window_winners.cu, which replaces
    _window_winners_kernel (:404); window_winners_ref is its plain version,
    window_plan the kernel's bucket ranges;
  * _winners_select (:665, exact branch), sparse_topm_winners (:695),
    sparse_topm_winners_bucketed (:639), sparse_topm_from_sorted (:730:
    segment totals, or the XLA chain as torch ops), sparse_lookup_sorted
    (:786), score_from_plan (:803) and bm25_scores (:822).
A CUDA tensor always goes to its kernel (or the wrapper raises); only a CPU
tensor goes to the plain version. Every route is exact, so the reference's
approximate selections (approx_max_k on the TPU) have no counterpart.
Sentinels are the reference's: NEG_INF = -3.0e38, pad doc id = n_docs,
empty slot id = -1.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from anorag_tpu_torch.ops.topk import NEG_INF, top_k

MAX_SEG = 32          # widest window the kernel (and the reference's) takes
SCAN_MAX_BLOCK_L = 1024   # the segment kernels' widest block: a thread each
_SENTINEL = -7        # lookback id before position 0: never a real doc


@dataclass
class BM25Postings:
    """CSC-by-term postings with precomputed Okapi weights."""

    term_offsets: np.ndarray   # (V+1,) int64 into flat arrays
    doc_ids: np.ndarray        # (nnz,) int32
    weights: np.ndarray        # (nnz,) float32
    n_docs: int
    idf: np.ndarray            # (V,) float32

    @property
    def vocab_size(self) -> int:
        return len(self.term_offsets) - 1


def build_postings(
    doc_terms: Sequence[Sequence[int]],
    vocab_size: int,
    k1: float = 1.5,
    b: float = 0.75,
) -> BM25Postings:
    """Weighted postings from integer-tokenized docs (host numpy).

    Vectorized form of the reference's per-posting loop; every weight is
    the same float32 expression evaluated in the same order,
      w = f32(idf[t] * f32(tf*(k1+1))) / (f32(tf) + denom[d]),
      denom[d] = f32(k1) * (f32(1-b) + f32(b) * (len[d] / f32(avgdl))),
    so the arrays equal the reference's bit for bit (tested)."""
    n = len(doc_terms)
    doc_len = np.array([len(d) for d in doc_terms], np.float32)
    avgdl = float(doc_len.mean()) if n else 0.0
    terms = (np.concatenate([np.asarray(d, np.int64) for d in doc_terms])
             if n else np.zeros(0, np.int64))
    docs = np.repeat(np.arange(n, dtype=np.int64), doc_len.astype(np.int64))
    # one entry per (term, doc) pair, term-major then doc ascending: the
    # reference's posting order
    pairs, tf = np.unique(terms * max(n, 1) + docs, return_counts=True)
    p_term, p_doc = pairs // max(n, 1), pairs % max(n, 1)
    df = np.bincount(p_term, minlength=vocab_size).astype(np.int64)
    idf = np.log((n - df + 0.5) / (df + 0.5) + 1.0).astype(np.float32)
    term_offsets = np.zeros(vocab_size + 1, np.int64)
    np.cumsum(df, out=term_offsets[1:])
    if avgdl > 0:
        denom = np.float32(k1) * (np.float32(1.0 - b) + np.float32(b)
                                  * (doc_len / np.float32(avgdl)))
    else:
        denom = np.full(n, k1, np.float32)
    tf_k = (tf * (k1 + 1.0)).astype(np.float32)
    weights = (idf[p_term] * tf_k) / (tf.astype(np.float32) + denom[p_doc])
    return BM25Postings(term_offsets, p_doc.astype(np.int32),
                        weights.astype(np.float32), n, idf)


def _pow2_width(width: int, pad_multiple: int) -> int:
    bucket = pad_multiple
    while bucket < width:
        bucket *= 2
    return bucket


def gather_plan(
    postings: BM25Postings,
    query_terms: Sequence[Sequence[int]],
    pad_multiple: int = 128,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host prep of the scatter path: per query the flat posting indices of
    its terms (a repeated term counts again, as Okapi sums over query
    tokens), padded with -1 to a power-of-two multiple of pad_multiple.
    Returns (gather_idx (B, L) int32, lens (B,) int32)."""
    rows: List[np.ndarray] = []
    off = postings.term_offsets
    for terms in query_terms:
        spans = [np.arange(off[t], off[t + 1], dtype=np.int64)
                 for t in terms if 0 <= t < postings.vocab_size]
        rows.append(np.concatenate(spans) if spans else np.zeros(0, np.int64))
    width = _pow2_width(max((len(r) for r in rows), default=0), pad_multiple)
    out = np.full((len(rows), width), -1, np.int64)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
        lens[i] = len(r)
    return out.astype(np.int32), lens


def gather_plan_sorted(
    postings: BM25Postings,
    query_terms: Sequence[Sequence[int]],
    pad_multiple: int = 128,
    max_df_ratio: float = 0.75,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host prep for scatter-free scoring: per-query posting rows sorted by
    doc id. Terms with document frequency above max_df_ratio * N are left
    out (their idf is tiny, their postings nearly the whole corpus). Width
    is a power-of-two multiple of pad_multiple.

    Returns (doc_rows (B, L) int32 -- doc id per posting, N pad;
             weight_rows (B, L) f32 -- Okapi weight, 0 pad;
             lens (B,) real lengths)."""
    off = postings.term_offsets
    df_cap = max_df_ratio * postings.n_docs
    rows_docs: List[np.ndarray] = []
    rows_w: List[np.ndarray] = []
    for terms in query_terms:
        spans = [np.arange(off[t], off[t + 1], dtype=np.int64)
                 for t in terms
                 if 0 <= t < postings.vocab_size
                 and off[t + 1] - off[t] <= df_cap]
        if spans:
            idx = np.concatenate(spans)
            d = postings.doc_ids[idx]
            w = postings.weights[idx]
            order = np.argsort(d, kind="stable")
            rows_docs.append(d[order])
            rows_w.append(w[order])
        else:
            rows_docs.append(np.zeros(0, np.int32))
            rows_w.append(np.zeros(0, np.float32))
    width = _pow2_width(max((len(r) for r in rows_docs), default=0), pad_multiple)
    b = len(rows_docs)
    doc_rows = np.full((b, width), postings.n_docs, np.int32)
    weight_rows = np.zeros((b, width), np.float32)
    lens = np.zeros(b, np.int32)
    for i, (d, w) in enumerate(zip(rows_docs, rows_w)):
        doc_rows[i, : len(d)] = d
        weight_rows[i, : len(w)] = w
        lens[i] = len(d)
    return doc_rows, weight_rows, lens


def plan_tiles(doc_rows, weight_rows, n_docs: int, block_l: int = 1024,
               block_b: int = 128, round_pow2: bool = False):
    """The reference's L-major re-tiling (L/block_l, B, block_l) of a
    (B, L) plan, with >= 1 trailing pad column. It was a TPU DMA fix; the
    CUDA kernel reads (B, L) directly, and window_winners turns a tiled
    plan back into rows. Returns numpy (a3, w3)."""
    doc_rows = np.asarray(doc_rows)
    weight_rows = np.asarray(weight_rows)
    b, l = doc_rows.shape
    block_b = min(block_b, max(8, -(-b // 8) * 8))
    bp = -(-b // block_b) * block_b
    lp = -(-(l + 1) // block_l) * block_l
    if round_pow2:
        nj_p = 1 << (max(lp // block_l - 1, 0)).bit_length()
        lp = max(nj_p, 1) * block_l
    a = np.full((bp, lp), n_docs, np.int32)
    a[:b, :l] = doc_rows
    w = np.zeros((bp, lp), np.float32)
    w[:b, :l] = weight_rows
    nj = lp // block_l
    a3 = np.ascontiguousarray(a.reshape(bp, nj, block_l).transpose(1, 0, 2))
    w3 = np.ascontiguousarray(w.reshape(bp, nj, block_l).transpose(1, 0, 2))
    return a3, w3


def plan_tiles_bucketed(doc_rows, weight_rows, lens, n_docs: int,
                        groups: int = 2, block_l: int = 1024,
                        block_b: int = 128):
    """Length-bucketed tiled plans: queries sorted by plan length, split
    into `groups` contiguous buckets, each tiled (plan_tiles) at its own
    power-of-two width, so short plans are not scanned at the batch's
    widest. Returns ([(a3, w3, rows_in_bucket), ...], inv (B,) int32),
    where inv maps the buckets' concatenated outputs back to input order."""
    doc_rows = np.asarray(doc_rows)
    weight_rows = np.asarray(weight_rows)
    lens = np.asarray(lens)
    b = doc_rows.shape[0]
    groups = max(1, min(groups, b))
    order = np.argsort(lens, kind="stable")
    splits = [s for s in np.array_split(order, groups) if len(s)]
    plans = []
    for rows in splits:
        li = max(int(lens[rows].max()), 1)
        li = min(doc_rows.shape[1], max(block_l, 1 << (li - 1).bit_length()))
        a3, w3 = plan_tiles(doc_rows[rows, :li], weight_rows[rows, :li],
                            n_docs, block_l=block_l, block_b=block_b)
        plans.append((a3, w3, len(rows)))
    inv = np.empty(b, np.int32)
    inv[np.concatenate(splits)] = np.arange(b, dtype=np.int32)
    return plans, inv


# ------------------------------------------------------------ segment scan
def _log_scan(x: torch.Tensor, op) -> torch.Tensor:
    """Inclusive scan along dim 1 in Hillis-Steele log steps, the order of
    the reference's _prefix_scan (:166): at s = 1, 2, 4, ... < width every
    position j combines with j - s (with 0.0 where j < s)."""
    s = 1
    while s < x.shape[1]:
        x = op(x, torch.nn.functional.pad(x[:, :-s], (s, 0)))
        s *= 2
    return x


def _scan_block_l(l: int, block_l: int) -> int:
    """min(block_l, L): the scan's block width and the winners table's."""
    if l < 1 or not 1 <= block_l <= SCAN_MAX_BLOCK_L:
        raise ValueError(f"segment scan needs L >= 1 and block_l in [1, "
                         f"{SCAN_MAX_BLOCK_L}], got {l} and {block_l}")
    return min(block_l, l)


def _segment_scan_blocks(a: torch.Tensor, w: torch.Tensor, n_docs: int,
                         block_l: int):
    """The segment kernels' scan, block by block, in their arithmetic: per
    block of bl = min(block_l, L) columns (L padded with id n_docs and
    weight 0) the log-step cumsum plus the carried sum, segment ends where
    a[t] != a[t + 1] (-1 past the padded row), the previous end's cumsum
    by a log-step max scan of the end values and the carried previous end,
    and totals = cumsum - previous end. Yields (column offset, ids (B, bl),
    totals (B, bl), valid (B, bl)); valid marks ends of real docs."""
    b, l = a.shape
    bl = _scan_block_l(l, block_l)
    lp = -(-l // bl) * bl
    ap = torch.nn.functional.pad(a, (0, lp - l), value=n_docs)
    wp = torch.nn.functional.pad(w, (0, lp - l))
    nxt = torch.nn.functional.pad(ap[:, 1:], (0, 1), value=-1)
    cs = cp = torch.zeros((b, 1), dtype=torch.float32, device=a.device)
    for lo in range(0, lp, bl):
        ids = ap[:, lo:lo + bl]
        c = _log_scan(wp[:, lo:lo + bl], torch.add) + cs
        is_end = ids != nxt[:, lo:lo + bl]
        cm = _log_scan(torch.where(is_end, c, 0.0), torch.maximum)
        prev = torch.maximum(cp, torch.nn.functional.pad(cm[:, :-1], (1, 0)))
        yield lo, ids, c - prev, is_end & (ids < n_docs)
        cs = c[:, -1:]
        cp = torch.maximum(cp, cm[:, -1:])


def segment_totals_ref(doc_rows: torch.Tensor, weight_rows: torch.Tensor,
                       n_docs: int, block_l: int = 1024):
    """Plain PyTorch version of the segment-totals kernel, on any device:
    (masked (B, L) f32 -- each doc's total at its segment end, NEG_INF
    elsewhere; per-row max (B, 1) f32, at least 0)."""
    b, l = doc_rows.shape
    parts = []
    mx = torch.zeros((b, 1), dtype=torch.float32, device=doc_rows.device)
    for _, _, totals, valid in _segment_scan_blocks(doc_rows, weight_rows,
                                                    n_docs, block_l):
        parts.append(torch.where(valid, totals, NEG_INF))
        mx = torch.maximum(mx, torch.where(valid, totals, 0.0).amax(1, keepdim=True))
    return torch.cat(parts, dim=1)[:, :l], mx


def segment_winners_ref(doc_rows: torch.Tensor, weight_rows: torch.Tensor,
                        n_docs: int, block_l: int = 1024):
    """Plain PyTorch version of the segment-winners kernel, on any device:
    each segment end t competes in bucket t mod bl (bl = min(block_l, L))
    with strict '>', so the earliest position keeps ties. Returns (winner
    values (B, bl) f32, winner doc ids (B, bl) int32, per-row max (B, 1))."""
    b, l = doc_rows.shape
    bl = _scan_block_l(l, block_l)
    dev = doc_rows.device
    wv = torch.full((b, bl), NEG_INF, dtype=torch.float32, device=dev)
    wd = torch.full((b, bl), -1, dtype=torch.int32, device=dev)
    mx = torch.zeros((b, 1), dtype=torch.float32, device=dev)
    for _, ids, totals, valid in _segment_scan_blocks(doc_rows, weight_rows,
                                                      n_docs, block_l):
        tv = torch.where(valid, totals, NEG_INF)
        upd = tv > wv
        wv = torch.where(upd, tv, wv)
        wd = torch.where(upd, ids, wd)
        mx = torch.maximum(mx, torch.where(valid, totals, 0.0).amax(1, keepdim=True))
    return wv, wd, mx


def _check_plan(what: str, a: torch.Tensor, w: torch.Tensor,
                dims: Tuple[int, ...] = (2,)) -> bool:
    """Raise on a plan the kernels do not take; True when both tensors lie
    on the CPU (the plain version runs), False when both lie on one CUDA
    device, contiguous, as int32 ids and f32 weights. dims: the layouts
    taken, (B, L) and for the window kernel also (L / bl, Bp, bl)."""
    if a.dim() not in dims or a.shape != w.shape:
        raise ValueError(f"{what}: doc_rows and weight_rows must be one "
                         f"{' or '.join(f'{d}-D' for d in dims)} shape, got "
                         f"{tuple(a.shape)} and {tuple(w.shape)}")
    if a.device.type == "cpu" and w.device.type == "cpu":
        return True
    if a.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"{what} takes int32 ids and f32 weights, got "
                        f"{a.dtype} and {w.dtype}")
    if not (a.is_cuda and w.is_cuda and a.device == w.device):
        raise ValueError(f"{what}: both plan tensors must be on one CUDA device")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{what}: plan tensors must be contiguous")
    return False


SEGMENT_GROUP_BLOCKS = 8   # csrc/segment_scan.cu's kGroupWarps


class SegmentTilePlan(NamedTuple):
    """The row-tiles segment kernels' work: each row cut into `blocks`
    blocks of bl positions, a tile (one warp's) each; their int64 scratch
    words: a summary and a carry per tile, the tile counter, then the row
    max as B f32 from word mx_word (scratch_words in all for totals). The
    winners kernel takes a row's blocks in `groups` groups of
    SEGMENT_GROUP_BLOCKS; its scratch adds a count of finished groups per
    row (B u32), a key per bucket, (B, bl) from word keys_word, and an id
    table per group, (B, groups, bl) int32 from word ids_word
    (winners_words in all); the launch clears the words before ids_word."""
    bl: int
    blocks: int
    scratch_words: int
    mx_word: int
    groups: int
    keys_word: int
    ids_word: int
    winners_words: int


def segment_tile_plan(b: int, l: int, block_l: int = 1024) -> SegmentTilePlan:
    """The tiles and scratch of csrc/segment_scan.cu's row-tiles kernels for
    a (b, l) plan (the layout anorag_segment_totals and
    anorag_segment_winners read their scratch in)."""
    bl = _scan_block_l(l, block_l)
    blocks = -(-l // bl)
    groups = -(-blocks // SEGMENT_GROUP_BLOCKS)
    mx_word = 2 * b * blocks + 1
    scratch_words = mx_word + -(-b // 2)
    keys_word = scratch_words + -(-b // 2)
    ids_word = keys_word + b * bl
    return SegmentTilePlan(bl, blocks, scratch_words, mx_word, groups, keys_word, ids_word,
                           ids_word + -(-(b * groups * bl) // 2))


_scan_lib = None


def _load_scan() -> ctypes.CDLL:
    """csrc/segment_scan.cu's library, built on first use, its C signatures
    set once."""
    global _scan_lib
    if _scan_lib is None:
        from anorag_tpu_torch import _build

        lib = _build.load("segment_scan")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn in (lib.anorag_segment_totals, lib.anorag_segment_totals_rows):
            fn.argtypes = [p, p, p, p, ll, ll, i, i, i, p]
            fn.restype = i
        for fn in (lib.anorag_segment_winners, lib.anorag_segment_winners_rows):
            fn.argtypes = [p, p, p, p, p, ll, ll, i, i, i, p]
            fn.restype = i
        _scan_lib = lib
    return _scan_lib


def _launch_totals(a: torch.Tensor, w: torch.Tensor, n_docs: int, block_l: int,
                   route: str = "tiles"):
    """Launch a segment-totals kernel on a checked CUDA plan: "tiles" (the
    row tiles, segment_totals' kernel) or "rows" (the first kernel, a CTA a
    row, the yardstick chip_smoke.py times the tiles against). Counts
    nothing."""
    b, l = a.shape
    plan = segment_tile_plan(b, l, block_l)
    dev = a.device
    masked = torch.empty((b, l), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _load_scan()
    if route == "tiles":
        scratch = torch.empty(plan.scratch_words, dtype=torch.int64, device=dev)
        mx = scratch[plan.mx_word:].view(torch.float32)[:b].view(b, 1)
        err = lib.anorag_segment_totals(a.data_ptr(), w.data_ptr(), masked.data_ptr(),
                                        scratch.data_ptr(), b, l, plan.bl, n_docs,
                                        dev.index, stream)
    elif route == "rows":
        mx = torch.empty((b, 1), dtype=torch.float32, device=dev)
        err = lib.anorag_segment_totals_rows(a.data_ptr(), w.data_ptr(),
                                             masked.data_ptr(), mx.data_ptr(), b, l,
                                             plan.bl, n_docs, dev.index, stream)
    else:
        raise ValueError(f"unknown segment_totals route {route!r}")
    if err != 0:
        raise RuntimeError(f"segment_totals kernel launch failed: CUDA error {err}")
    return masked, mx


def segment_totals(doc_rows: torch.Tensor, weight_rows: torch.Tensor,
                   n_docs: int, block_l: int = 1024):
    """Segment totals of a sorted (B, L) posting plan with weights >= 0:
    (masked (B, L) f32 -- each doc's total at its segment end, NEG_INF
    elsewhere; per-row max (B, 1) f32). CUDA tensors launch
    csrc/segment_scan.cu's row-tiles kernel and count one launch in
    segment_totals.launches; CPU tensors run segment_totals_ref."""
    if _check_plan("segment_totals", doc_rows, weight_rows):
        return segment_totals_ref(doc_rows, weight_rows, n_docs, block_l)
    out = _launch_totals(doc_rows, weight_rows, n_docs, block_l)
    segment_totals.launches += 1
    return out


segment_totals.launches = 0


def _launch_segment_winners(a: torch.Tensor, w: torch.Tensor, n_docs: int,
                            block_l: int, route: str = "tiles"):
    """Launch a segment-winners kernel on a checked CUDA plan: "tiles" (the
    row tiles with a per-bucket key merge, segment_winners' kernel) or
    "rows" (the first kernel, a CTA a row, the yardstick chip_smoke.py
    times the tiles against). Counts nothing."""
    b, l = a.shape
    plan = segment_tile_plan(b, l, block_l)
    dev = a.device
    wv = torch.empty((b, plan.bl), dtype=torch.float32, device=dev)
    wd = torch.empty((b, plan.bl), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _load_scan()
    if route == "tiles":
        scratch = torch.empty(plan.winners_words, dtype=torch.int64, device=dev)
        mx = scratch[plan.mx_word:].view(torch.float32)[:b].view(b, 1)
        fn, out = lib.anorag_segment_winners, scratch
    elif route == "rows":
        mx = torch.empty((b, 1), dtype=torch.float32, device=dev)
        fn, out = lib.anorag_segment_winners_rows, mx
    else:
        raise ValueError(f"unknown segment_winners route {route!r}")
    err = fn(a.data_ptr(), w.data_ptr(), wv.data_ptr(), wd.data_ptr(), out.data_ptr(),
             b, l, plan.bl, n_docs, dev.index, stream)
    if err != 0:
        raise RuntimeError(f"segment_winners kernel launch failed: CUDA error {err}")
    return wv, wd, mx


def segment_winners(doc_rows: torch.Tensor, weight_rows: torch.Tensor,
                    n_docs: int, block_l: int = 1024):
    """Segment totals with bucketed winner selection in one pass over a
    sorted (B, L) plan; the (B, L) totals never reach memory. Returns
    (winner values (B, bl) f32, winner doc ids (B, bl) int32, per-row max
    (B, 1) f32), bl = min(block_l, L). CUDA tensors launch
    csrc/segment_scan.cu's row-tiles winners kernel and count one launch in
    segment_winners.launches; CPU tensors run segment_winners_ref."""
    if _check_plan("segment_winners", doc_rows, weight_rows):
        return segment_winners_ref(doc_rows, weight_rows, n_docs, block_l)
    out = _launch_segment_winners(doc_rows, weight_rows, n_docs, block_l)
    segment_winners.launches += 1
    return out


segment_winners.launches = 0


# ------------------------------------------------------------ window winners
def _plan_rows(doc_rows: torch.Tensor, weight_rows: torch.Tensor,
               b_valid: Optional[int]):
    """Both plan layouts as (a (B, L), w (B, L), block_l, n_pos).

    (B, L): the reference's window_winners_pallas -- winners table width
    min(1024, max(L, 256)); positions [1, L] with a virtual pad at L.
    (L/bl, Bp, bl) from plan_tiles: window_winners_tiled -- table width bl;
    the plan already carries its pad column, positions [1, L)."""
    if doc_rows.shape != weight_rows.shape:
        raise ValueError(f"plan shapes differ: {tuple(doc_rows.shape)} vs "
                         f"{tuple(weight_rows.shape)}")
    if doc_rows.ndim == 3:
        nj, bp, bl = doc_rows.shape
        rows = b_valid or bp
        a = doc_rows.permute(1, 0, 2).reshape(bp, nj * bl)[:rows]
        w = weight_rows.permute(1, 0, 2).reshape(bp, nj * bl)[:rows]
        return a, w, bl, nj * bl
    if doc_rows.ndim != 2:
        raise ValueError(f"plan must be 2-D or 3-D, got {doc_rows.ndim}-D")
    l = doc_rows.shape[1]
    return doc_rows, weight_rows, min(1024, max(l, 256)), l + 1


def _check_max_seg(max_seg: int) -> None:
    if not 1 <= max_seg <= MAX_SEG:
        raise ValueError(f"max_seg must be in [1, {MAX_SEG}], got {max_seg}")


def _winners_plain(a: torch.Tensor, w: torch.Tensor, n_docs: int,
                   max_seg: int, block_l: int, n_pos: int):
    b, l = a.shape
    nj = -(-n_pos // block_l)
    width = nj * block_l
    # max_seg lookback columns of sentinel on the left, pad ids on the right
    ap = torch.full((b, max_seg + width), n_docs, dtype=torch.int32,
                    device=a.device)
    ap[:, :max_seg] = _SENTINEL
    ap[:, max_seg:max_seg + l] = a
    wp = torch.zeros((b, max_seg + width), dtype=torch.float32, device=a.device)
    wp[:, max_seg:max_seg + l] = w

    def tap(j):                         # values at positions t - j
        return (ap[:, max_seg - j:max_seg - j + width],
                wp[:, max_seg - j:max_seg - j + width])

    a_1, s = tap(1)
    for j in range(2, max_seg + 1):
        a_j, w_j = tap(j)
        s = s + torch.where(a_j == a_1, w_j, 0.0)
    a_t = ap[:, max_seg:max_seg + width]
    valid = (a_t != a_1) & (a_1 < n_docs) & (a_1 >= 0)
    valid[:, n_pos:] = False
    tv = torch.where(valid, s, NEG_INF).view(b, nj, block_l)
    ids = a_1.reshape(b, nj, block_l)
    wv = torch.full((b, block_l), NEG_INF, dtype=torch.float32, device=a.device)
    wd = torch.full((b, block_l), -1, dtype=torch.int32, device=a.device)
    for j in range(nj):                  # earliest position wins ties
        upd = tv[:, j] > wv
        wv = torch.where(upd, tv[:, j], wv)
        wd = torch.where(upd, ids[:, j], wd)
    mx = torch.where(valid, s, 0.0).amax(dim=1, keepdim=True)
    return wv, wd, mx


def window_winners_ref(doc_rows: torch.Tensor, weight_rows: torch.Tensor,
                       n_docs: int, max_seg: int,
                       b_valid: Optional[int] = None):
    """Plain PyTorch version of the window-winners kernel, on any device:
    returns (winner values (B, block_l) f32, winner doc ids (B, block_l)
    int32, per-row max (B, 1) f32)."""
    _check_max_seg(max_seg)
    a, w, block_l, n_pos = _plan_rows(doc_rows, weight_rows, b_valid)
    return _winners_plain(a, w, n_docs, max_seg, block_l, n_pos)


class WindowPlan(NamedTuple):
    """The staged window-winners kernel's grid: rows x splits CTAs, each a
    range of `range` buckets (a multiple of 4)."""
    range: int
    splits: int


def window_plan(rows: int, block_l: int, n_sm: int = 132) -> WindowPlan:
    """Bucket ranges of csrc/window_winners.cu's staged walk: whole rows
    when rows alone give two CTAs an SM, else each row's block_l buckets
    split in ranges of at least 128 until they do."""
    splits = min(-(-2 * n_sm // max(rows, 1)), max(1, block_l // 128))
    per_split = -(-block_l // splits)
    rng = min(1024, -(-per_split // 4) * 4)
    return WindowPlan(rng, -(-block_l // rng))


def _window_layout(doc_rows: torch.Tensor, b_valid: Optional[int]):
    """(rows, row stride, block stride, positions held, positions walked,
    block_l) of either plan layout, as the staged kernel reads it in place:
    (B, L) -- block_l min(1024, max(L, 256)), positions [1, L] with a
    virtual pad at L; (L/bl, Bp, bl) -- block_l bl, positions [1, L)."""
    if doc_rows.ndim == 3:
        nj, bp, bl = doc_rows.shape
        rows = b_valid or bp
        if not 0 < rows <= bp:
            raise ValueError(f"window_winners: b_valid {b_valid} past the plan's "
                             f"{bp} rows")
        return rows, bl, bp * bl, nj * bl, nj * bl, bl
    b, l = doc_rows.shape
    bl = min(1024, max(l, 256))
    return b, l, bl, l, l + 1, bl


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_winners_lib = None


def _load_winners() -> ctypes.CDLL:
    """The kernel's library, built on first use, its C signatures set once."""
    global _winners_lib
    if _winners_lib is None:
        from anorag_tpu_torch import _build

        lib = _build.load("window_winners")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.anorag_window_winners.argtypes = [p] * 5 + [ll] * 5 + [i] * 6 + [p]
        lib.anorag_window_winners.restype = i
        lib.anorag_window_winners_threads.argtypes = [p] * 6 + [ll] * 3 + [i] * 4 + [p]
        lib.anorag_window_winners_threads.restype = i
        lib.anorag_window_winners_threads_parts.argtypes = [i]
        lib.anorag_window_winners_threads_parts.restype = i
        _winners_lib = lib
    return _winners_lib


def _launch_winners(doc_rows: torch.Tensor, weight_rows: torch.Tensor,
                    n_docs: int, max_seg: int, b_valid: Optional[int] = None,
                    route: str = "staged"):
    """Launch a window-winners kernel on a checked CUDA plan: "staged" (the
    staged walk, window_winners' kernel; either layout in place) or
    "threads" (the first kernel, a thread a bucket, over a (B, L) copy of
    the plan, the yardstick chip_smoke.py times the staged walk against).
    Counts nothing."""
    dev = doc_rows.device
    lib = _load_winners()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows, sb, sj, held, n_pos, block_l = _window_layout(doc_rows, b_valid)
    wv = torch.empty((rows, block_l), dtype=torch.float32, device=dev)
    wd = torch.empty((rows, block_l), dtype=torch.int32, device=dev)
    mx = torch.empty((rows, 1), dtype=torch.float32, device=dev)
    if route == "staged":
        plan = window_plan(rows, block_l, _sm_count(dev.index))
        err = lib.anorag_window_winners(
            doc_rows.data_ptr(), weight_rows.data_ptr(), wv.data_ptr(),
            wd.data_ptr(), mx.data_ptr(), rows, sb, sj, held, n_pos, block_l,
            n_docs, max_seg, plan.range, plan.splits, dev.index, stream)
    elif route == "threads":
        a, w, _, _ = _plan_rows(doc_rows, weight_rows, b_valid)
        a, w = a.contiguous(), w.contiguous()
        if rows > 65535:
            raise ValueError(f"window_winners: at most 65535 rows, got {rows}")
        parts = lib.anorag_window_winners_threads_parts(block_l)
        mx_part = torch.empty((rows, parts), dtype=torch.float32, device=dev)
        err = lib.anorag_window_winners_threads(
            a.data_ptr(), w.data_ptr(), wv.data_ptr(), wd.data_ptr(), mx.data_ptr(),
            mx_part.data_ptr(), rows, a.shape[1], n_pos, block_l, n_docs, max_seg,
            dev.index, stream)
    else:
        raise ValueError(f"unknown window_winners route {route!r}")
    if err != 0:
        raise RuntimeError(f"window_winners kernel launch failed: CUDA error {err}")
    return wv, wd, mx


def window_winners(doc_rows: torch.Tensor, weight_rows: torch.Tensor,
                   n_docs: int, max_seg: int, b_valid: Optional[int] = None):
    """Scan-free BM25 winners over a sorted posting plan, (B, L) or the
    tiled (L/bl, Bp, bl) layout: returns (winner values (B, block_l),
    winner doc ids (B, block_l), per-row max (B, 1)). CUDA tensors run the
    staged kernel on the plan in place and count one launch in
    window_winners.launches; CPU tensors run window_winners_ref."""
    _check_max_seg(max_seg)
    if _check_plan("window_winners", doc_rows, weight_rows, dims=(2, 3)):
        return window_winners_ref(doc_rows, weight_rows, n_docs, max_seg, b_valid)
    out = _launch_winners(doc_rows, weight_rows, n_docs, max_seg, b_valid)
    window_winners.launches += 1
    return out


window_winners.launches = 0


def _winners_select(wv: torch.Tensor, wd: torch.Tensor, mx: torch.Tensor,
                    m: int):
    """Exact top-m over a winners table (the reference's exact branch)."""
    k_eff = min(m, wv.shape[1])
    top_vals, top_pos = top_k(wv, k_eff)
    top_docs = wd.gather(1, top_pos)
    live = top_vals > NEG_INF / 2
    top_docs = torch.where(live, top_docs, -1)
    top_vals = torch.where(live, top_vals, 0.0)
    if k_eff < m:
        top_vals = torch.nn.functional.pad(top_vals, (0, m - k_eff))
        top_docs = torch.nn.functional.pad(top_docs, (0, m - k_eff), value=-1)
    return top_vals, top_docs, mx


def sparse_topm_winners(doc_rows: torch.Tensor, weight_rows: torch.Tensor,
                        m: int, n_docs: int, max_seg: int = 0,
                        b_valid: Optional[int] = None,
                        select_approx: bool = False):
    """BM25 top-m through a winners kernel: (top vals (B, m), top doc ids
    (B, m), per-query max (B, 1)). Routes as the reference does: a tiled
    3-D plan (plan_tiles) takes the window-winners kernel and needs
    0 < max_seg <= 32; a (B, L) plan takes it for 0 < max_seg <= 32 and the
    segment-winners kernel otherwise. select_approx is accepted for the
    reference's signature and has no effect: the selection is always the
    exact top-m."""
    if doc_rows.ndim == 3 and not 0 < max_seg <= MAX_SEG:
        raise ValueError(f"a tiled plan needs the window-winners kernel, "
                         f"0 < max_seg <= {MAX_SEG}; got max_seg {max_seg}")
    if doc_rows.ndim == 3 or 0 < max_seg <= MAX_SEG:
        wv, wd, mx = window_winners(doc_rows, weight_rows, n_docs, max_seg,
                                    b_valid=b_valid)
    else:
        wv, wd, mx = segment_winners(doc_rows, weight_rows, n_docs)
    return _winners_select(wv, wd, mx, m)


def sparse_topm_winners_bucketed(plan_arrays, inv: torch.Tensor, m: int,
                                 n_docs: int, max_seg: int, b_valids):
    """Length-bucketed winners over plan_tiles_bucketed's buckets: the
    window-winners kernel and the exact top-m per bucket, concatenated and
    put back in input order by inv. The same results as
    sparse_topm_winners over the unsplit tiled plan."""
    tvs, tds, mxs = [], [], []
    for (a3, w3), bv in zip(plan_arrays, b_valids):
        tv, td, mx = sparse_topm_winners(a3, w3, m, n_docs, max_seg=max_seg,
                                         b_valid=bv)
        tvs.append(tv)
        tds.append(td)
        mxs.append(mx)
    inv = torch.as_tensor(inv, device=tvs[0].device).long()
    return (torch.cat(tvs)[inv], torch.cat(tds)[inv], torch.cat(mxs)[inv])


def _cumsum_rows(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    """Inclusive f32 cumsum along dim 1 in the order XLA's CPU backend uses
    for jnp.cumsum (blocks of 16 summed left to right, block totals scanned
    recursively, prefixes added back), so totals that are differences of
    cumsums match the reference bit for bit rather than to a few ulps of
    the row sum."""
    b, n = x.shape
    if n <= base:
        cols = [x[:, 0]]
        for i in range(1, n):
            cols.append(cols[-1] + x[:, i])
        return torch.stack(cols, dim=1)
    nb = -(-n // base)
    blocks = torch.nn.functional.pad(x, (0, nb * base - n)).view(b, nb, base)
    cols = [blocks[..., 0]]
    for i in range(1, base):
        cols.append(cols[-1] + blocks[..., i])
    inner = torch.stack(cols, dim=-1)
    prefix = _cumsum_rows(inner[..., -1], base)
    excl = torch.nn.functional.pad(prefix[:, :-1], (1, 0))
    return (inner + excl[..., None]).reshape(b, nb * base)[:, :n]


SPARSE_IMPLS = {"auto": "auto", "kernel": "kernel", "pallas": "kernel",
                "chain": "chain", "xla": "chain"}


def sparse_topm_from_sorted(doc_rows: torch.Tensor, weight_rows: torch.Tensor,
                            m: int, n_docs: int, impl: str = "auto"):
    """Scatter-free BM25 top-m over a sorted (B, L) plan: per-segment totals
    at segment ends, then the exact top-m. Returns (seg_totals (B, L) --
    each doc's total at its segment end, NEG_INF elsewhere; top vals
    (B, m); top doc ids (B, m); per-query max (B, 1)).

    impl: "kernel" -- segment_totals (the CUDA kernel on the card; log-step
    block scans); "chain" -- the reference's unfused chain (global cumsum in
    XLA's CPU order, segment ends, cummax forward fill), bit-equal to its
    impl="xla"; "auto" -- "kernel" for CUDA tensors with L >= 2048 and
    B >= 8, else "chain" (the reference's rule, "on the TPU" read as "on the
    card"). The reference's names "pallas" and "xla" name the same two
    routes."""
    if impl not in SPARSE_IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {tuple(SPARSE_IMPLS)}")
    impl = SPARSE_IMPLS[impl]
    b, l = doc_rows.shape
    if impl == "auto":
        impl = "kernel" if doc_rows.is_cuda and l >= 2048 and b >= 8 else "chain"
    if impl == "kernel":
        masked, mx = segment_totals(doc_rows, weight_rows, n_docs)
    else:
        masked, mx = _segment_totals_chain(doc_rows, weight_rows, n_docs)
    k_eff = min(m, l)
    top_vals, top_pos = top_k(masked, k_eff)
    top_docs = doc_rows.gather(1, top_pos)
    live = top_vals > NEG_INF / 2
    top_docs = torch.where(live, top_docs, -1)
    top_vals = torch.where(live, top_vals, 0.0)
    if k_eff < m:
        top_vals = torch.nn.functional.pad(top_vals, (0, m - k_eff))
        top_docs = torch.nn.functional.pad(top_docs, (0, m - k_eff), value=-1)
    return masked, top_vals, top_docs, mx


def _segment_totals_chain(doc_rows: torch.Tensor, weight_rows: torch.Tensor,
                          n_docs: int):
    """The reference's XLA chain: (masked (B, L), mx (B, 1))."""
    b = doc_rows.shape[0]
    c = _cumsum_rows(weight_rows)
    nxt = torch.cat([doc_rows[:, 1:],
                     torch.full((b, 1), -1, dtype=doc_rows.dtype,
                                device=doc_rows.device)], dim=1)
    is_end = doc_rows != nxt
    end_c = torch.where(is_end, c, 0.0)
    prev_end_c = torch.nn.functional.pad(
        torch.cummax(end_c, dim=1).values[:, :-1], (1, 0))
    totals = c - prev_end_c
    valid_end = is_end & (doc_rows < n_docs)
    masked = torch.where(valid_end, totals, NEG_INF)
    mx = torch.where(valid_end, totals, 0.0).amax(dim=1, keepdim=True)
    return masked, mx


def sparse_lookup_sorted(doc_rows: torch.Tensor, seg_totals: torch.Tensor,
                         query_docs: torch.Tensor) -> torch.Tensor:
    """BM25 scores (B, K) of arbitrary docs query_docs (B, K), by binary
    search of each sorted plan row: the total at the doc's segment end, 0
    when the doc has no postings in the row."""
    q = torch.as_tensor(query_docs, device=doc_rows.device).to(doc_rows.dtype)
    pos = torch.searchsorted(doc_rows.contiguous(), q.contiguous(), right=True) - 1
    pos = pos.clamp(0, doc_rows.shape[1] - 1)
    hit = doc_rows.gather(1, pos) == q
    return torch.where(hit, seg_totals.gather(1, pos), 0.0)


# ------------------------------------------------------------ scatter path
def score_from_plan(doc_ids: torch.Tensor, weights: torch.Tensor,
                    gather_idx: torch.Tensor, n_docs: int) -> torch.Tensor:
    """Gather the plan's postings and scatter-add them into (B, n_docs)
    score rows; -1 plan slots land in an overflow column that is dropped."""
    valid = gather_idx >= 0
    safe = gather_idx.clamp_min(0).long()
    w = torch.where(valid, weights[safe], 0.0)
    d = torch.where(valid, doc_ids[safe].long(), n_docs)
    out = torch.zeros((gather_idx.shape[0], n_docs + 1), dtype=torch.float32,
                      device=gather_idx.device)
    return out.scatter_add_(1, d, w)[:, :n_docs]


def bm25_scores(postings: BM25Postings, query_terms: Sequence[Sequence[int]],
                normalize: bool = False, device=None) -> np.ndarray:
    """Full Okapi scores (B, N) f32 as numpy: the plan on the host, the
    scatter on `device` (the card unless the CPU is asked for).
    normalize=True divides each row by its max (rows with max 0 stay 0)."""
    from anorag_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    gi, _ = gather_plan(postings, query_terms)
    scores = score_from_plan(torch.from_numpy(postings.doc_ids).to(dev),
                             torch.from_numpy(postings.weights).to(dev),
                             torch.from_numpy(gi).to(dev),
                             postings.n_docs).cpu().numpy()
    if normalize:
        mx = scores.max(axis=1, keepdims=True)
        scores = np.where(mx > 0, scores / np.maximum(mx, 1e-30), 0.0)
    return scores


def bm25_scores_np(doc_terms: Sequence[Sequence[int]],
                   query_terms: Sequence[Sequence[int]],
                   k1: float = 1.5, b: float = 0.75) -> np.ndarray:
    """Exact-Okapi numpy oracle, in float64, returned as (B, N) f32."""
    from collections import Counter

    n = len(doc_terms)
    doc_len = np.array([len(d) for d in doc_terms], np.float64)
    avgdl = doc_len.mean() if n else 0.0
    counters = [Counter(d) for d in doc_terms]
    df = Counter()
    for c in counters:
        df.update(c.keys())
    out = np.zeros((len(query_terms), n), np.float64)
    for qi, terms in enumerate(query_terms):
        for t in terms:
            if t not in df:
                continue
            idf = np.log((n - df[t] + 0.5) / (df[t] + 0.5) + 1.0)
            for d_idx, c in enumerate(counters):
                tf = c.get(t, 0)
                if tf:
                    denom = tf + k1 * (1 - b + b * doc_len[d_idx] / avgdl)
                    out[qi, d_idx] += idf * tf * (k1 + 1) / denom
    return out.astype(np.float32)


@dataclass
class FieldWeightedPostings:
    """Per-field postings: score = sum over fields of field weight x the
    field's BM25 (each field with its own lengths, avgdl and idf)."""

    fields: List[str]
    field_weights: np.ndarray            # (F,)
    postings: List[BM25Postings]

    def score(self, query_terms: Sequence[Sequence[int]],
              normalize: bool = False, device=None) -> np.ndarray:
        total = None
        for fw, p in zip(self.field_weights, self.postings):
            s = bm25_scores(p, query_terms, device=device) * fw
            total = s if total is None else total + s
        if normalize and total is not None:
            mx = total.max(axis=1, keepdims=True)
            total = np.where(mx > 0, total / np.maximum(mx, 1e-30), 0.0)
        return total


def build_field_weighted(field_doc_terms: dict, vocab_size: int,
                         field_weights: Optional[dict] = None,
                         k1: float = 1.5, b: float = 0.75) -> FieldWeightedPostings:
    field_weights = field_weights or {"title": 2.0, "entities": 1.5, "content": 1.0}
    fields = [f for f in field_weights if f in field_doc_terms]
    return FieldWeightedPostings(
        fields=fields,
        field_weights=np.array([field_weights[f] for f in fields], np.float32),
        postings=[build_postings(field_doc_terms[f], vocab_size, k1=k1, b=b)
                  for f in fields],
    )
