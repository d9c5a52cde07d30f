"""VectorIndex: the dense ANN index on the device.

Counterpart of anorag_tpu/index/vector_index.py, every index type: Flat,
IVFFlat (below ivf_min_corpus rows it searches Flat, as in the reference),
IVFPQ (the compressed scan for corpora beyond device memory: pq_impl
'sketch', the rotated int8 codes of ops/sq.py, the default, or 'codebook',
the PQ codes of ops/pq.py; either refined exactly against the host rows),
its alias PQ, LSH (the +-1 sign sketch of ops/lsh.py, refined on the device
when the rows fit in 4 GiB of bf16, else on the host) and HNSW (the native
C++ graph, native/anorag_native.cpp, on the host; Flat when the native
runtime cannot be built, as in the reference). save (:382) and load (:422)
write and read the reference's files (<path>.npz with the normalized f32
rows, the codebooks, rotation, planes and the HNSW graph;
<stem>_metadata.json), so either package reads the other's. With a mesh
(parallel/mesh.py) Flat rows are sharded over its 'data' axis and search
takes the shard-local top-k and merge of parallel/sharded_search.py; the
other types stay on the index's device, as in the reference.

The normalized f32 rows stay on the host, where the reference keeps
_emb_f32; the device holds the storage-dtype copy (Flat: original order,
IVF: cluster sorted) or the codes. Copies are made in row chunks, so no
second corpus-sized temporary forms beside them.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from anorag_tpu_torch import native
from anorag_tpu_torch.device import DeviceLike, resolve_device
from anorag_tpu_torch.ops.ivf import build_ivf, ivf_search, tune_nprobe
from anorag_tpu_torch.ops.lsh import encode_lsh, lsh_search, train_lsh
from anorag_tpu_torch.ops.pq import encode_pq, pad_results, pq_search, train_pq
from anorag_tpu_torch.ops.sq import encode_sq, sq_search, train_sq
from anorag_tpu_torch.ops.topk import dense_topk, dense_topk_np
from anorag_tpu_torch.utils.logging import get_logger

logger = get_logger("anorag.index")

_ROW_CHUNK = 1 << 18
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
INDEX_TYPES = ("Flat", "IVFFlat", "IVFPQ", "LSH", "HNSW")
DEVICE_REFINE_BYTES = 4 * 1024**3   # LSH refines on the device up to this bf16 copy


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
        if index_type == "PQ":
            index_type = "IVFPQ"
        if index_type == "HNSW" and not native.available():
            logger.info("HNSW needs the native runtime; degrading to Flat")
            index_type = "Flat"
        if index_type not in INDEX_TYPES:
            raise ValueError(f"index_type {index_type!r}; one of {INDEX_TYPES} or PQ")
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
        # A mesh shards Flat rows over its 'data' axis (is_sharded); the
        # searchers built for it are cached by shape until the next add.
        self.mesh = mesh
        self._sharded_fns: Dict[Any, Any] = {}
        # IVFPQ: the codes are the only corpus-sized device residency. pq_m
        # 0 = auto (D/8 code bytes a row), pq_rerank 0 = auto (the refine
        # pool of search_arrays); impl 'sketch' (ops/sq.py) or 'codebook'
        # (ops/pq.py). LSH: lsh_bits 0 = D bits. HNSW: the native graph's
        # degree and beam widths, ef_search 0 = max(64, 4k).
        if pq_impl not in ("sketch", "codebook"):
            raise ValueError(f"pq_impl {pq_impl!r}; one of ('sketch', 'codebook')")
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
        self._shards: Optional[List[torch.Tensor]] = None  # sharded Flat rows
        self._flat_cache: Optional[torch.Tensor] = None
        self._layout = None
        self._pq_codebooks: Optional[np.ndarray] = None
        self._pq_codes: Optional[torch.Tensor] = None
        self._sq_rotation: Optional[np.ndarray] = None
        self._sq_codes: Optional[torch.Tensor] = None
        self._sq_scales: Optional[torch.Tensor] = None
        self._lsh_planes: Optional[np.ndarray] = None
        self._lsh_planes_dev: Optional[torch.Tensor] = None
        self._lsh_codes: Optional[torch.Tensor] = None
        self._hnsw = None
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

    def _pq_m_auto(self) -> int:
        if self.pq_m:
            return self.pq_m
        d = self.dimension
        for sub in (8, 4, 2, 1):
            if d % sub == 0:
                return d // sub
        return d

    def _candidates(self, top_k: int) -> int:
        """The refine pool of IVFPQ and LSH: it grows with the corpus (the
        reference measured recall@10 0.46-0.61 at 2,000,000 rows in a fixed
        pool of 100), n / 500 capped at max(1024, 4k)."""
        return self.pq_rerank or min(max(4 * top_k, self.ntotal // 500, 64),
                                     max(1024, 4 * top_k))

    def _to_device(self, dtype: torch.dtype) -> torch.Tensor:
        """The host rows on the device in `dtype`, copied chunk by chunk."""
        out = torch.empty(self._emb_f32.shape, dtype=dtype, device=self.device)
        for lo in range(0, self.ntotal, _ROW_CHUNK):
            out[lo:lo + _ROW_CHUNK] = self._emb_f32[lo:lo + _ROW_CHUNK].to(
                self.device).to(dtype)
        return out

    @property
    def is_sharded(self) -> bool:
        return self.mesh is not None and self._effective_type == "Flat"

    def _materialize(self) -> None:
        if not self._dirty or self._emb_f32 is None:
            return
        self._device_emb = None
        self._shards = None
        self._layout = None
        kind = self._effective_type
        if self.is_sharded:
            from anorag_tpu_torch.parallel.mesh import shard_rows

            self._shards, _ = shard_rows(self.mesh, self._emb_f32, dtype=self._dtype)
            self._sharded_fns.clear()
        elif kind == "Flat":
            self._device_emb = self._to_device(self._dtype)
        elif kind == "IVFPQ" and self.pq_impl == "codebook":
            if self._pq_codebooks is None:
                self._pq_codebooks = train_pq(self._emb_f32, self._pq_m_auto(),
                                              device=self.device)
            self._pq_codes = encode_pq(self._emb_f32, self._pq_codebooks,
                                       device=self.device)
        elif kind == "IVFPQ":
            if self._sq_rotation is None:
                self._sq_rotation = train_sq(self._emb_f32, self._pq_m_auto())
            self._sq_codes, self._sq_scales = encode_sq(
                self._emb_f32, self._sq_rotation, device=self.device)
        elif kind == "LSH":
            if self._lsh_planes is None:
                self._lsh_planes = train_lsh(self.dimension,
                                             self.lsh_bits or self.dimension)
            self._lsh_planes_dev = torch.from_numpy(self._lsh_planes).to(self.device)
            self._lsh_codes = encode_lsh(self._emb_f32, self._lsh_planes,
                                         device=self.device)
        elif kind == "HNSW":
            self._hnsw = native.HNSWNative(
                self._emb_f32.numpy(), m=self.hnsw_m,
                ef_construction=self.ef_construction)
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
        kind = self._effective_type
        if self.is_sharded:
            vals, idx = self._sharded_dense_fn(min(top_k, self.ntotal))(self._shards, q)
            vals, idx = pad_results(vals.cpu().numpy(), idx.cpu().numpy(), top_k)
            return vals, idx
        if kind == "Flat":
            vals, idx = dense_topk(self._device_emb, q.to(self._device_emb.dtype),
                                   top_k, use_kernel=self.use_kernel)
            return vals.cpu().numpy(), idx.cpu().numpy().astype(np.int64)
        if kind == "IVFPQ" and self.pq_impl == "codebook":
            vals, idx = pq_search(self._pq_codes, self._pq_codebooks, q, top_k,
                                  emb_host=self._emb_f32,
                                  candidates=self._candidates(top_k))
            return vals, idx.astype(np.int64)
        if kind == "IVFPQ":
            vals, idx = sq_search(self._sq_codes, self._sq_scales, self._sq_rotation,
                                  q, top_k, emb_host=self._emb_f32,
                                  candidates=self._candidates(top_k))
            return vals, idx.astype(np.int64)
        if kind == "LSH":
            # exact refine on the device when the bf16 rows fit in 4 GiB;
            # beyond that only the codes live there and the host rows refine
            small = self.ntotal * self.dimension * 2 <= DEVICE_REFINE_BYTES
            vals, idx = lsh_search(self._lsh_codes, self._lsh_planes_dev, q, top_k,
                                   emb_host=self._emb_f32,
                                   emb_dev=self.flat_device_emb() if small else None,
                                   candidates=self._candidates(top_k))
            return vals, idx.astype(np.int64)
        if kind == "HNSW":
            ef = self.ef_search or max(64, 4 * top_k)
            vals, idx = self._hnsw.search(q.cpu().numpy(), min(top_k, self.ntotal),
                                          ef_search=ef)
            return pad_results(vals, idx.astype(np.int64), top_k)
        vals, idx = ivf_search(self._layout, self._device_emb, q, top_k,
                               nprobe=nprobe or self.nprobe,
                               use_kernel=self.use_kernel)
        return vals, idx.astype(np.int64)

    def _sharded_dense_fn(self, k_eff: int):
        """The cached shard-local top-k + merge for this (k, N)."""
        key = ("dense", k_eff, self.ntotal)
        fn = self._sharded_fns.get(key)
        if fn is None:
            from anorag_tpu_torch.parallel.sharded_search import make_sharded_topk

            fn = make_sharded_topk(self.mesh, k_eff, self.ntotal, self.use_kernel)
            self._sharded_fns[key] = fn
        return fn

    def sharded_hybrid_fn(self, k_eff: int, dense_k: int, sparse_m: int,
                          sparse_weight: float, recall_target: float = 0.95):
        """The cached sharded candidate-union hybrid searcher, called as
        fn(self.sharded_rows(), queries, doc_rows, weight_rows).
        recall_target is accepted for the reference's signature and has no
        effect: every route is exact."""
        key = ("hybrid", k_eff, dense_k, sparse_m, sparse_weight,
               recall_target, self.ntotal)
        fn = self._sharded_fns.get(key)
        if fn is None:
            from anorag_tpu_torch.parallel.sharded_search import (
                make_sharded_hybrid_union_topk)

            fn = make_sharded_hybrid_union_topk(
                self.mesh, k_eff, self.ntotal, dense_k=dense_k,
                sparse_m=sparse_m, sparse_weight=sparse_weight,
                recall_target=recall_target)
            self._sharded_fns[key] = fn
        return fn

    def sharded_rows(self) -> List[torch.Tensor]:
        """The row shards of a sharded index (mesh.shard_rows' list, in the
        storage dtype, pad rows 0)."""
        self._materialize()
        return self._shards

    def reconstruct(self, i: int) -> np.ndarray:
        return self._emb_f32[i].numpy()

    def flat_device_emb(self) -> torch.Tensor:
        """(N, D) device rows in ORIGINAL order (the IVF layout is cluster
        sorted; callers indexing by corpus row need this view). For IVF it
        is a further storage-dtype copy, made on first use; for a sharded
        index, the real rows of its shards gathered on the index's device,
        made on each call."""
        self._materialize()
        if self.is_sharded:
            return torch.cat([s.to(self.device) for s in self._shards])[:self.ntotal]
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

    # -------------------------------------------------------- persistence
    def save(self, path) -> None:
        """<path>.npz holds the normalized f32 rows (empty: (0, dimension)),
        the trained codebooks, rotation or planes, and HNSW's graph (its
        parallel build's links vary with thread interleaving, so a rebuild
        would not give the saved index's results); <stem>_metadata.json the
        options, as the reference writes them."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        arrays = {"embeddings": (np.zeros((0, self.dimension), np.float32)
                                 if self._emb_f32 is None else self._emb_f32.numpy())}
        for name in ("pq_codebooks", "sq_rotation", "lsh_planes"):
            if getattr(self, f"_{name}") is not None:
                arrays[name] = getattr(self, f"_{name}")
        if self._effective_type == "HNSW" and self._emb_f32 is not None:
            self._materialize()
            g = self._hnsw.export_graph()
            arrays.update(hnsw_meta=g["meta"], hnsw_node_level=g["node_level"],
                          hnsw_links=g["links"])
        np.savez_compressed(str(path.with_suffix(".npz")), **arrays)
        meta = {
            "dimension": self.dimension,
            "index_type": self.index_type,
            "metric": self.metric,
            "nlist": self.nlist,
            "nprobe": self.nprobe,
            "ntotal": self.ntotal,
            "storage_dtype": self.storage_dtype,
            "pq_m": self.pq_m,
            "pq_rerank": self.pq_rerank,
            "pq_impl": self.pq_impl,
            "lsh_bits": self.lsh_bits,
            "hnsw_m": self.hnsw_m,
            "ef_construction": self.ef_construction,
            "ef_search": self.ef_search,
        }
        with open(path.with_name(path.stem + "_metadata.json"), "w") as fh:
            json.dump(meta, fh, indent=2)

    @classmethod
    def load(cls, path, use_kernel: Optional[bool] = None, *,
             device: DeviceLike = None) -> "VectorIndex":
        """The index that save wrote at `path`, on `device`; its rows are
        taken as saved (already normalized), with the saved codebooks,
        rotation or planes, and HNSW's saved graph imported, not rebuilt."""
        path = Path(path)
        with open(path.with_name(path.stem + "_metadata.json")) as fh:
            meta = json.load(fh)
        idx = cls(
            dimension=meta["dimension"], index_type=meta["index_type"],
            metric=meta["metric"], nlist=meta["nlist"], nprobe=meta["nprobe"],
            storage_dtype=meta.get("storage_dtype", "bfloat16"), use_kernel=use_kernel,
            pq_m=meta.get("pq_m", 0), pq_rerank=meta.get("pq_rerank", 0),
            pq_impl=meta.get("pq_impl", "sketch"),
            lsh_bits=meta.get("lsh_bits", 0), hnsw_m=meta.get("hnsw_m", 16),
            ef_construction=meta.get("ef_construction", 200),
            ef_search=meta.get("ef_search", 0), device=device,
        )
        with np.load(str(path.with_suffix(".npz"))) as data:
            arrays = {name: data[name] for name in data.files}
        for name in ("pq_codebooks", "sq_rotation", "lsh_planes"):
            if name in arrays:
                setattr(idx, f"_{name}", arrays[name])
        emb = arrays["embeddings"]
        if len(emb):
            idx._emb_f32 = torch.from_numpy(np.ascontiguousarray(emb, np.float32))
            idx._dirty = True
            if "hnsw_meta" in arrays and idx._effective_type == "HNSW":
                idx._hnsw = native.HNSWNative.from_graph(idx._emb_f32.numpy(), {
                    "meta": arrays["hnsw_meta"],
                    "node_level": arrays["hnsw_node_level"],
                    "links": arrays["hnsw_links"]})
                idx._dirty = False
        return idx

