"""VectorIndex: the dense corpus on the device, Flat and IVFFlat.

Counterpart of anorag_tpu/index/vector_index.py: the constructor, _preprocess
(:122), add (:131), _effective_nlist (:138), _effective_type (:146), the
Flat and IVFFlat branches of _materialize (:164, :214-217), search (:221),
the Flat and IVFFlat branches of search_arrays (:238, :256-259, :309-313),
reconstruct (:344), flat_device_emb (:347), optimize_search_params (:359)
and measure_recall (:373). IVFFlat below ivf_min_corpus rows searches
Flat, as in the reference. The constructor takes every option of the
reference's; IVFPQ, LSH, HNSW, a mesh and save / load are not ported yet
(ROADMAP: alternative indexes, the sharded branch) and raise
NotImplementedError.

The normalized f32 rows stay on the host, where the reference keeps
_emb_f32; the device holds the storage-dtype copy (Flat: original order,
IVF: cluster sorted). Copies are made in row chunks, so no second
corpus-sized temporary forms beside them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from anorag_tpu_torch.device import DeviceLike, resolve_device
from anorag_tpu_torch.ops.ivf import build_ivf, ivf_search, tune_nprobe
from anorag_tpu_torch.ops.topk import dense_topk, dense_topk_np

_ROW_CHUNK = 1 << 18
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP: alternative indexes -- IVFPQ, "
        f"SQ, LSH, HNSW); the port serves Flat and IVFFlat")


class VectorIndex:
    def __init__(
        self,
        dimension: int = 1024,
        index_type: str = "IVFFlat",
        metric: str = "cosine",
        nlist: int = 20,
        nprobe: int = 4,
        storage_dtype: str = "bfloat16",
        use_kernel: Optional[bool] = None,
        ivf_min_corpus: int = 5_000_000,
        recall_target: float = 0.95,
        mesh=None,
        pq_m: int = 0,
        pq_rerank: int = 0,
        pq_impl: str = "sketch",
        lsh_bits: int = 0,
        hnsw_m: int = 16,
        ef_construction: int = 200,
        ef_search: int = 0,
        device: DeviceLike = None,
    ):
        if index_type not in ("Flat", "IVFFlat"):
            raise _not_ported(f"index type {index_type!r}")
        if mesh is not None:
            raise NotImplementedError(
                "a mesh (corpus rows sharded over devices) is not ported yet "
                "(ROADMAP: the sharded branch)")
        if storage_dtype not in _DTYPES:
            raise ValueError(f"storage_dtype {storage_dtype!r}; one of {tuple(_DTYPES)}")
        self.dimension = dimension
        self.index_type = index_type
        # Below this size IVFFlat searches Flat, as the reference does (its
        # reason was measured on a TPU: large batches union most clusters).
        self.ivf_min_corpus = ivf_min_corpus
        self.metric = metric
        self.nlist = nlist
        self.nprobe = nprobe
        self.storage_dtype = storage_dtype
        # True: the streaming top-k kernel for Flat (None/False: the plain
        # chunked scan); IVFFlat always scans with the IVF kernel on the
        # card, and False there names the numpy oracle, which takes CPU
        # tensors only. Counterpart of use_pallas.
        self.use_kernel = use_kernel
        # recall_target is accepted for the reference's signature and
        # unused: every search route of the port is exact.
        self.mesh = mesh
        # The options of IVFPQ, LSH and HNSW: stored and unused by Flat and
        # IVFFlat, as in the reference.
        self.pq_m = pq_m
        self.pq_rerank = pq_rerank
        self.pq_impl = pq_impl
        self.lsh_bits = lsh_bits
        self.hnsw_m = hnsw_m
        self.ef_construction = ef_construction
        self.ef_search = ef_search
        self.device = resolve_device(device)
        if index_type == "IVFFlat" and use_kernel is False and self.device.type != "cpu":
            raise ValueError("IVFFlat with use_kernel=False: the numpy IVF "
                             "oracle takes CPU tensors only; on the card the "
                             "IVF scan kernel always runs")
        self._emb_f32: Optional[torch.Tensor] = None   # host, original order
        self._device_emb: Optional[torch.Tensor] = None  # flat, or IVF sorted
        self._flat_cache: Optional[torch.Tensor] = None
        self._layout = None
        self._dirty = False

    # ----------------------------------------------------------- building
    @property
    def ntotal(self) -> int:
        return 0 if self._emb_f32 is None else self._emb_f32.shape[0]

    @property
    def _dtype(self) -> torch.dtype:
        return _DTYPES[self.storage_dtype]

    def _preprocess(self, vecs) -> torch.Tensor:
        """f32 rows on the index's device; L2-normalized under the cosine
        metric, so that the inner product is the cosine."""
        vecs = torch.as_tensor(vecs, dtype=torch.float32, device=self.device)
        if self.metric == "cosine":
            norms = torch.linalg.vector_norm(vecs, dim=1, keepdim=True)
            vecs = vecs / norms.clamp_min(1e-12)
        return vecs

    def add(self, vectors) -> None:
        """Append rows (numpy or a tensor on any device), normalized on the
        index's device chunk by chunk into the host copy."""
        vectors = torch.as_tensor(vectors)
        if vectors.dim() != 2 or vectors.shape[1] != self.dimension:
            raise ValueError(f"vectors of shape {tuple(vectors.shape)}, index of "
                             f"width {self.dimension}")
        host = torch.empty(vectors.shape, dtype=torch.float32)
        for lo in range(0, vectors.shape[0], _ROW_CHUNK):
            host[lo:lo + _ROW_CHUNK] = self._preprocess(
                vectors[lo:lo + _ROW_CHUNK]).cpu()
        self._emb_f32 = host if self._emb_f32 is None else torch.cat([self._emb_f32, host])
        self._dirty = True
        self._flat_cache = None

    def _effective_nlist(self, n: int) -> int:
        # shrink nlist when training data is scarce (reference :138-143)
        nlist = self.nlist
        while nlist > 1 and n < 2 * nlist:
            nlist //= 2
        return max(1, nlist)

    @property
    def _effective_type(self) -> str:
        if self.index_type == "IVFFlat" and self.ntotal < self.ivf_min_corpus:
            return "Flat"
        return self.index_type

    def _to_device(self, dtype: torch.dtype) -> torch.Tensor:
        """The host rows on the device in `dtype`, copied chunk by chunk."""
        out = torch.empty(self._emb_f32.shape, dtype=dtype, device=self.device)
        for lo in range(0, self.ntotal, _ROW_CHUNK):
            out[lo:lo + _ROW_CHUNK] = self._emb_f32[lo:lo + _ROW_CHUNK].to(
                self.device).to(dtype)
        return out

    def _materialize(self) -> None:
        if not self._dirty or self._emb_f32 is None:
            return
        self._device_emb = None
        if self._effective_type == "Flat":
            self._device_emb = self._to_device(self._dtype)
            self._layout = None
        else:
            # k-means needs the f32 rows on the device; they go when the
            # sorted storage-dtype copy is made
            emb32 = self._to_device(torch.float32)
            self._layout, self._device_emb = build_ivf(
                emb32, nlist=self._effective_nlist(self.ntotal), dtype=self._dtype)
            del emb32
        self._dirty = False

    # ------------------------------------------------------------- search
    def search(self, queries, top_k: int = 10,
               nprobe: Optional[int] = None) -> List[List[Dict[str, Any]]]:
        """Row dicts {index, score, rank, similarity} per query; `index` -1
        rows (fewer than k valid hits) are dropped."""
        scores, idx = self.search_arrays(queries, top_k, nprobe)
        out: List[List[Dict[str, Any]]] = []
        for qi in range(len(scores)):
            rows = []
            for rank in range(scores.shape[1]):
                i = int(idx[qi, rank])
                if i < 0:
                    continue
                s = float(scores[qi, rank])
                rows.append({"index": i, "score": s, "rank": rank, "similarity": s})
            out.append(rows)
        return out

    def search_arrays(self, queries, top_k: int, nprobe: Optional[int] = None):
        """(scores (B, k) f32, rows (B, k) int64 with -1 padding), numpy."""
        if self.ntotal == 0:
            b = torch.atleast_2d(torch.as_tensor(queries)).shape[0]
            return (np.full((b, top_k), -np.inf, np.float32),
                    np.full((b, top_k), -1, np.int64))
        self._materialize()
        q = self._preprocess(torch.atleast_2d(torch.as_tensor(queries)))
        if self._effective_type == "Flat":
            vals, idx = dense_topk(self._device_emb, q.to(self._device_emb.dtype),
                                   top_k, use_kernel=self.use_kernel)
            return vals.cpu().numpy(), idx.cpu().numpy().astype(np.int64)
        vals, idx = ivf_search(self._layout, self._device_emb, q, top_k,
                               nprobe=nprobe or self.nprobe,
                               use_kernel=self.use_kernel)
        return vals, idx.astype(np.int64)

    def reconstruct(self, i: int) -> np.ndarray:
        return self._emb_f32[i].numpy()

    def flat_device_emb(self) -> torch.Tensor:
        """(N, D) device rows in ORIGINAL order (the IVF layout is cluster
        sorted; callers indexing by corpus row need this view). For IVF it
        is a further storage-dtype copy, made on first use."""
        self._materialize()
        if self._effective_type == "Flat":
            return self._device_emb
        if self._flat_cache is None:
            self._flat_cache = self._to_device(self._dtype)
        return self._flat_cache

    # ------------------------------------------------------------- tuning
    def optimize_search_params(self, sample_queries, top_k: int = 10,
                               target_recall: float = 0.9) -> int:
        """Sweep nprobe to the smallest value reaching target recall."""
        if self._effective_type != "IVFFlat" or self.ntotal == 0:
            return self.nprobe
        self._materialize()
        q = self._preprocess(torch.atleast_2d(torch.as_tensor(sample_queries))).cpu().numpy()
        self.nprobe = tune_nprobe(
            self._layout, self._device_emb, self._emb_f32.numpy(), q,
            k=top_k, target_recall=target_recall, use_kernel=self.use_kernel)
        return self.nprobe

    def measure_recall(self, sample_queries, top_k: int = 10) -> float:
        """Mean recall@top_k of search_arrays against exact numpy search."""
        q = self._preprocess(torch.atleast_2d(torch.as_tensor(sample_queries))).cpu().numpy()
        _, exact = dense_topk_np(self._emb_f32.numpy(), q, top_k)
        _, got = self.search_arrays(q, top_k)
        return float(np.mean([
            len(set(got[i]) & set(exact[i])) / top_k for i in range(len(q))
        ]))
