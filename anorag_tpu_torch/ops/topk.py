"""Hybrid dense + BM25 top-k by candidate-union fusion.

Counterpart of anorag_tpu/ops/topk.py: NEG_INF (:32), hybrid_topk (:562)
and hybrid_fuse (:750). The dense candidates are an f32 matmul followed by
an exact top-k (the reference's approx_max_k is exact on the CPU backend
the tests compare against); this matmul is outside any Pallas kernel in the
reference and stays torch.matmul here.
"""
from __future__ import annotations

import torch

NEG_INF = -3.0e38


def top_k(x: torch.Tensor, k: int):
    """lax.top_k along the last dim: values descending, ties to the lower
    index (a stable sort), exact membership at the k-th value."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dense_candidates(emb: torch.Tensor, queries: torch.Tensor, k: int,
                      chunk_rows: int):
    """Exact top-k of queries @ emb.T, in f32 (bf16 inputs are widened, so
    products are exact and sums f32, as preferred_element_type=f32 gives),
    over corpus chunks of at most chunk_rows rows. torch.topk picks the
    members; ties inside the result are then ordered by index."""
    n = emb.shape[0]
    q = queries.float()
    vals, idx = [], []
    for lo in range(0, n, chunk_rows):
        scores = torch.matmul(q, emb[lo:lo + chunk_rows].float().T)
        v, i = torch.topk(scores, min(k, scores.shape[1]), dim=1)
        vals.append(v)
        idx.append(i + lo)
    v, i = torch.cat(vals, dim=1), torch.cat(idx, dim=1)
    i, order = torch.sort(i, dim=1)                  # ties -> lower index
    v = v.gather(1, order)
    v, order = top_k(v, k)
    return v, i.gather(1, order)


def hybrid_fuse(
    emb: torch.Tensor,          # (N, D)
    queries: torch.Tensor,      # (B, D)
    sp_vals: torch.Tensor,      # (B, M) BM25 top-m values (0 for invalid)
    sp_docs: torch.Tensor,      # (B, M) doc ids (-1 invalid)
    sp_max: torch.Tensor,       # (B, 1) per-query max BM25
    k: int,
    n_docs: int,
    dense_k: int = 128,
    sparse_weight: float = 0.6,
    materialize_bytes: int = 8 * 1024**3,
):
    """Dense candidates + candidate-union fusion given the sparse top-m
    tables: final = dense + sparse_weight * bm25 / max_bm25 over the union
    of the dense top-dense_k and the sparse top-m. A dense candidate outside
    the sparse top-m scores 0 on the sparse side (the reference's documented
    approximation, ops/topk.py:596-598). Returns (scores (B, k), ids (B, k))
    sorted descending; id -1 pads."""
    b = queries.shape[0]
    inv_max = torch.where(sp_max > 0, 1.0 / sp_max.clamp_min(1e-30), 0.0)
    chunk_rows = max(1, min(n_docs, materialize_bytes // max(4 * b, 1)))
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
    materialize_bytes: int = 8 * 1024**3,
    max_seg: int = 0,           # max term instances per query
):
    """Hybrid top-k: sparse top-m table, then hybrid_fuse.

    Sparse stage routing, as the reference routes it with "on the TPU" read
    as "tensors on cuda": a tiled 3-D plan, or a plan on cuda at least 2048
    wide with 0 < max_seg <= 32, goes to the window-winners kernel; any
    other plan to the sparse_topm_from_sorted chain. (The 2048 threshold is
    the reference's TPU tuning.)"""
    from anorag_tpu_torch.ops.bm25 import (MAX_SEG, sparse_topm_from_sorted,
                                           sparse_topm_winners)

    if doc_rows.ndim == 3 or (doc_rows.is_cuda and doc_rows.shape[1] >= 2048
                              and 0 < max_seg <= MAX_SEG):
        sp_vals, sp_docs, sp_max = sparse_topm_winners(
            doc_rows, weight_rows, sparse_m, n_docs, max_seg=max_seg,
            b_valid=queries.shape[0])
    else:
        _, sp_vals, sp_docs, sp_max = sparse_topm_from_sorted(
            doc_rows, weight_rows, sparse_m, n_docs)
    return hybrid_fuse(emb, queries, sp_vals, sp_docs, sp_max, k,
                       n_docs=n_docs, dense_k=dense_k,
                       sparse_weight=sparse_weight,
                       materialize_bytes=materialize_bytes)
