"""Sharded dense and hybrid search: shard-local top-k, then a merge.

Counterpart of anorag_tpu/parallel/sharded_search.py. The corpus (N, D) is
row-sharded over the mesh's 'data' axis (mesh.shard_rows); each shard's
body runs on its own device, and its (scores, global ids) pairs are
gathered on the mesh's first device in shard order and re-topk'd: a
k-sized gather instead of an N-sized one. The reference's all_gather is
that gather and its psum a sum there.

Semantics, as the reference's: global ids are base + local row;
k_local = min(k, rows_per_shard); pads are (NEG_INF, -1); the merge is a
top-k over the S * k candidates in shard order, so ties go to the lower
id. One difference by design: make_sharded_topk leaves the pad rows out
before the shard-local top-k, where the reference masks them after it, so
that a pad row (score 0) cannot take the slot of a real row that scores
below 0 (the reference's make_sharded_hybrid_* already mask first).

A shard-local dense top-k runs dense_topk over the shard's real rows with
the index's use_kernel (True: the streaming top-k kernel, one launch a
shard); a shard with no real rows launches nothing and gives pads.
"""
from __future__ import annotations

import copy
from typing import Callable, List, Optional, Sequence

import torch

from anorag_tpu_torch.ops.topk import (NEG_INF, SCAN_CHUNK, _dense_candidates, _pad_k,
                                       dense_topk, top_k)
from anorag_tpu_torch.parallel.mesh import DATA_AXIS, Mesh


def _shard_spans(shards: Sequence[torch.Tensor], n_total: int):
    """(shard, base, real rows) of each shard."""
    rows = shards[0].shape[0]
    return [(s, i * rows, max(0, min(rows, n_total - i * rows)))
            for i, s in enumerate(shards)]


def _merge(mesh: Mesh, vals: List[torch.Tensor], ids: List[torch.Tensor], k: int):
    """Each shard's (B, k) candidates gathered on the mesh's first device in
    shard order, then the top-k of the (B, S * k) table."""
    dev = mesh.first_device
    all_v = torch.cat([v.to(dev) for v in vals], dim=1)
    all_i = torch.cat([i.to(dev) for i in ids], dim=1)
    mv, mi = top_k(all_v, k)
    return mv, all_i.gather(1, mi)


def make_sharded_topk(mesh: Mesh, k: int, n_total: int,
                      use_kernel: Optional[bool] = None):
    """(emb_shards, queries (B, D)) -> (vals (B, k) f32, ids (B, k) int64),
    ids global rows, on the mesh's first device. emb_shards is
    shard_rows' list; queries go to each shard in the corpus dtype. Rows >=
    n_total are left out before each shard's top-k."""
    n_shards = mesh.shape[DATA_AXIS]

    def search(emb_shards: Sequence[torch.Tensor], queries) -> tuple:
        if len(emb_shards) != n_shards:
            raise ValueError(f"{len(emb_shards)} shards on a mesh of {n_shards}")
        queries = torch.as_tensor(queries)
        b = queries.shape[0]
        vals, ids = [], []
        for shard, base, real in _shard_spans(emb_shards, n_total):
            if real:
                k_local = min(k, shard.shape[0])
                v, i = dense_topk(shard[:real], queries.to(shard.device, shard.dtype),
                                  k_local, use_kernel=use_kernel)
                v, i = _pad_k(v, torch.where(i >= 0, i + base, -1), k, k_local)
            else:
                v = torch.full((b, k), NEG_INF, device=shard.device)
                i = torch.full((b, k), -1, dtype=torch.long, device=shard.device)
            vals.append(v)
            ids.append(i)
        return _merge(mesh, vals, ids, k)

    return search


def sharded_topk(mesh: Mesh, emb_sharded, queries, k: int, n_total: int,
                 use_kernel: Optional[bool] = None):
    return make_sharded_topk(mesh, k, n_total, use_kernel)(emb_sharded, queries)


def make_sharded_hybrid_topk(mesh: Mesh, k: int, n_total: int,
                             bias_weight: float = 0.6):
    """Hybrid variant: (emb_shards, bias (B, N_pad), queries (B, D)) ->
    (vals, ids). The sparse score matrix is split by columns in lockstep
    with the corpus rows; every shard fuses its slice (f32 queries against
    f32-widened rows, + bias_weight * bias) and masks its pad rows, then
    the per-shard top-k merge as in make_sharded_topk."""

    def search(emb_shards: Sequence[torch.Tensor], bias, queries) -> tuple:
        queries = torch.as_tensor(queries)
        bias = torch.as_tensor(bias)
        vals, ids = [], []
        for shard, base, real in _shard_spans(emb_shards, n_total):
            dev, rows = shard.device, shard.shape[0]
            k_local = min(k, rows)
            scores = torch.matmul(queries.to(dev, torch.float32), shard.float().T)
            scores = scores + bias_weight * bias[:, base:base + rows].to(dev, torch.float32)
            scores[:, real:] = NEG_INF
            v, i = top_k(scores, k_local)
            v, i = _pad_k(v, i + base, k, k_local)
            vals.append(v)
            ids.append(i)
        return _merge(mesh, vals, ids, k)

    return search


def make_sharded_hybrid_union_topk(
    mesh: Mesh,
    k: int,
    n_total: int,
    dense_k: int = 128,
    sparse_m: int = 64,
    sparse_weight: float = 0.6,
    recall_target: float = 0.95,
):
    """Sharded candidate-union hybrid search, the sharded form of
    ops.topk.hybrid_topk (the same fusion semantics).

    Corpus rows ride the 'data' axis; the (B, L) sorted BM25 posting plan is
    small and read once, on the mesh's first device
    (ops.bm25.sparse_topm_from_sorted: the segment-totals kernel on the card
    at L >= 2048 and B >= 8). Per shard: the exact top-dense_k dense
    candidates of its real rows (ops.topk._dense_candidates, f32 queries
    against f32-widened rows, as hybrid_fuse scans them) and the dense
    cross-scores of the sparse candidates it owns. Gathered on the first
    device: the cross-scores summed over the shards (the reference's psum),
    the dense candidates in shard order, deduplicated against the sparse
    table; the final union top-k is taken there. recall_target is accepted
    for the reference's signature and has no effect: every route is exact.

    Returns (emb_shards, queries (B, D), doc_rows (B, L), weight_rows
    (B, L)) -> (vals (B, k), ids (B, k)), ids global rows, -1 padded.
    """
    from anorag_tpu_torch.ops.bm25 import sparse_topm_from_sorted

    def search(emb_shards: Sequence[torch.Tensor], queries, doc_rows, weight_rows):
        dev0 = mesh.first_device
        queries = torch.as_tensor(queries).to(dev0, torch.float32)
        _, sp_vals, sp_docs, sp_max = sparse_topm_from_sorted(
            torch.as_tensor(doc_rows).to(dev0), torch.as_tensor(weight_rows).to(dev0),
            sparse_m, n_total)
        sp_docs = sp_docs.long()
        inv_max = torch.where(sp_max > 0, 1.0 / sp_max.clamp_min(1e-30), 0.0)
        b = queries.shape[0]
        chunk_rows = max(1, min(SCAN_CHUNK, 8 * 1024**3 // max(4 * b, 1)))
        sp_dense = torch.zeros(sp_docs.shape, dtype=torch.float32, device=dev0)
        all_v, all_i = [], []
        for shard, base, real in _shard_spans(emb_shards, n_total):
            dev, rows = shard.device, shard.shape[0]
            q = queries.to(dev)
            k_local = min(dense_k, rows)
            if real:
                d_vals, d_pos = _dense_candidates(shard[:real], q, k_local, chunk_rows)
                d_vals, d_pos = _pad_k(d_vals, d_pos, k_local, d_pos.shape[1])
            else:
                d_vals = torch.full((b, k_local), NEG_INF, device=dev)
                d_pos = torch.full((b, k_local), -1, dtype=torch.long, device=dev)
            d_idx = torch.where(d_vals > NEG_INF / 2, base + d_pos, -1)
            # this shard's slice of the sparse candidates' dense cross-scores
            docs = sp_docs.to(dev)
            local = docs - base
            owned = (local >= 0) & (local < real)
            rows_of = shard[local.clamp(0, max(real - 1, 0))].float()      # (B, M, D)
            cross = torch.einsum("bmd,bd->bm", rows_of, q)
            sp_dense += torch.where(owned, cross, 0.0).to(dev0)
            # BM25 score of the local dense candidates: equality match
            # against the sparse top-m table
            eq = d_idx[:, :, None] == docs[:, None, :]
            d_sparse = torch.where(eq, sp_vals.to(dev)[:, None, :], 0.0).sum(dim=-1)
            fused_d = d_vals + sparse_weight * d_sparse * inv_max.to(dev)
            all_v.append(fused_d.to(dev0))
            all_i.append(d_idx.to(dev0))
        all_fd = torch.cat(all_v, dim=1)
        all_di = torch.cat(all_i, dim=1)
        fused_s = sp_dense + sparse_weight * sp_vals * inv_max
        dup = (sp_docs[:, :, None] == all_di[:, None, :]).any(dim=-1)
        fused_s = torch.where((sp_docs >= 0) & ~dup, fused_s, NEG_INF)
        av = torch.cat([all_fd, fused_s], dim=1)
        ai = torch.cat([all_di, sp_docs], dim=1)
        tv, tp = top_k(av, k)
        ids = ai.gather(1, tp)
        return tv, torch.where(tv > NEG_INF / 2, ids, -1)

    return search


def make_sharded_encode(mesh: Mesh, encode_fn: Callable):
    """Data-parallel batched encoding: encode(params, token_ids, mask) splits
    the (B, L) token batch over the 'data' shards, copies `params` (an
    nn.Module, such as models.encoder.Encoder) once to each distinct shard
    device it is not on, runs encode_fn(params, ids, mask) for each shard
    on its device and concatenates the results, in batch order, on the
    mesh's first device."""
    devices = mesh.shard_devices()

    def encode(params: torch.nn.Module, token_ids, mask) -> torch.Tensor:
        ids = torch.as_tensor(token_ids)
        m = torch.as_tensor(mask)
        home = next(params.parameters()).device
        copies = {dev: params if dev == home else copy.deepcopy(params).to(dev)
                  for dev in dict.fromkeys(devices)}
        outs = [encode_fn(copies[dev], i.to(dev), mm.to(dev))
                for dev, i, mm in zip(devices, torch.tensor_split(ids, len(devices)),
                                      torch.tensor_split(m, len(devices)))
                if i.shape[0]]
        return torch.cat([o.to(mesh.first_device) for o in outs])

    return encode
