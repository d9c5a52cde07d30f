"""BM25 sparse stage: host posting plans and the window-winners kernel.

Counterpart of anorag_tpu/ops/bm25.py. Host numpy: BM25Postings,
build_postings (:41), gather_plan_sorted (:109), plan_tiles (:465). Device:
  * window_winners -- wrapper of the hand-written CUDA kernel
    csrc/window_winners.cu, which replaces the Pallas kernel
    _window_winners_kernel (:404); window_winners_ref is its plain PyTorch
    version with the same buckets, tie rule and sentinels. A CUDA tensor
    always goes to the kernel (or the wrapper raises); only a CPU tensor
    goes to the plain version;
  * _winners_select (:665, exact branch) and sparse_topm_winners (:695);
  * sparse_topm_from_sorted (:730), the XLA chain as torch ops.
Sentinels are the reference's: NEG_INF = -3.0e38, pad doc id = n_docs,
empty slot id = -1.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from anorag_tpu_torch.ops.topk import NEG_INF, top_k

MAX_SEG = 32          # widest window the kernel (and the reference's) takes
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
    width = max((len(r) for r in rows_docs), default=0)
    bucket = pad_multiple
    while bucket < width:
        bucket *= 2
    width = bucket
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


_winners_lib = None


def _load_winners() -> ctypes.CDLL:
    """The kernel's library, built on first use, its C signatures set once."""
    global _winners_lib
    if _winners_lib is None:
        from anorag_tpu_torch import _build

        lib = _build.load("window_winners")
        lib.anorag_window_winners.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.anorag_window_winners.restype = ctypes.c_int
        lib.anorag_window_winners_parts.argtypes = [ctypes.c_int]
        lib.anorag_window_winners_parts.restype = ctypes.c_int
        _winners_lib = lib
    return _winners_lib


def _launch_winners(a: torch.Tensor, w: torch.Tensor, n_docs: int,
                    max_seg: int, block_l: int, n_pos: int):
    if a.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"window_winners takes int32 ids and f32 weights, got "
                        f"{a.dtype} and {w.dtype}")
    if not (a.is_cuda and w.is_cuda and a.device == w.device):
        raise ValueError("window_winners: both plan tensors must be on one "
                         "CUDA device")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("window_winners: plan tensors must be contiguous")
    b, l = a.shape
    if b > 65535:
        raise ValueError(f"window_winners: at most 65535 rows, got {b}")
    lib = _load_winners()
    parts = lib.anorag_window_winners_parts(block_l)
    dev = a.device
    wv = torch.empty((b, block_l), dtype=torch.float32, device=dev)
    wd = torch.empty((b, block_l), dtype=torch.int32, device=dev)
    mx = torch.empty((b, 1), dtype=torch.float32, device=dev)
    mx_part = torch.empty((b, parts), dtype=torch.float32, device=dev)
    err = lib.anorag_window_winners(
        a.data_ptr(), w.data_ptr(), wv.data_ptr(), wd.data_ptr(), mx.data_ptr(),
        mx_part.data_ptr(), b, l, n_pos, block_l, n_docs, max_seg, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window_winners kernel launch failed: CUDA error {err}")
    window_winners.launches += 1
    return wv, wd, mx


def window_winners(doc_rows: torch.Tensor, weight_rows: torch.Tensor,
                   n_docs: int, max_seg: int, b_valid: Optional[int] = None):
    """Scan-free BM25 winners over a sorted posting plan, (B, L) or the
    tiled (L/bl, Bp, bl) layout: returns (winner values (B, block_l),
    winner doc ids (B, block_l), per-row max (B, 1)). CUDA tensors run the
    CUDA kernel and count one launch in window_winners.launches; CPU tensors
    run window_winners_ref."""
    _check_max_seg(max_seg)
    a, w, block_l, n_pos = _plan_rows(doc_rows, weight_rows, b_valid)
    if a.device.type == "cpu" and w.device.type == "cpu":
        return _winners_plain(a, w, n_docs, max_seg, block_l, n_pos)
    return _launch_winners(a, w, n_docs, max_seg, block_l, n_pos)


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
                        m: int, n_docs: int, max_seg: int,
                        b_valid: Optional[int] = None):
    """BM25 top-m via the window-winners kernel: (top vals (B, m), top doc
    ids (B, m), per-query max (B, 1)). max_seg outside [1, 32] needs the
    segment-scan winners kernel (anorag_tpu/ops/bm25.py:287), which is not
    ported yet (ROADMAP, queue 2)."""
    if not 0 < max_seg <= MAX_SEG:
        raise NotImplementedError(
            "sparse_topm_winners with max_seg outside [1, 32] needs the "
            "segment-scan winners kernel, not ported yet (ROADMAP queue 2)")
    wv, wd, mx = window_winners(doc_rows, weight_rows, n_docs, max_seg,
                                b_valid=b_valid)
    return _winners_select(wv, wd, mx, m)


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


def sparse_topm_from_sorted(doc_rows: torch.Tensor, weight_rows: torch.Tensor,
                            m: int, n_docs: int):
    """Scatter-free BM25 top-m by cumsum + segment ends + cummax forward
    fill (the reference's XLA chain). Returns (seg_totals (B, L) -- total
    at each segment end, NEG_INF elsewhere; top vals (B, m); top doc ids
    (B, m); per-query max (B, 1))."""
    b, l = doc_rows.shape
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
