"""Counterpart of anorag_tpu/native.py,
copied as it is with its imports renamed to anorag_tpu_torch.

ctypes bindings for the native host runtime (native/anorag_native.cpp).

The C++ library owns the host-side hot loops: corpus tokenization + BM25
postings construction (the reference leans on rank_bm25/FAISS C++ for this,
SURVEY.md §2.11) and Levenshtein matching. Auto-builds with `make` on first
use; every entry point has a pure-Python fallback, so the framework works
without a compiler.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from anorag_tpu_torch.utils.logging import get_logger

logger = get_logger("anorag.native")

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libanorag_native.so"
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                       capture_output=True, timeout=120)
        return _LIB_PATH.exists()
    except Exception as e:
        logger.info("native build unavailable: %s", e)
        return False


def load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    if not _LIB_PATH.exists() and not _build():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.anorag_bm25_build.restype = ctypes.c_void_p
        lib.anorag_bm25_build.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        ]
        for fn in ("anorag_bm25_vocab_size", "anorag_bm25_nnz",
                   "anorag_bm25_vocab_blob_size"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.anorag_bm25_export.restype = None
        lib.anorag_bm25_export.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_char_p,
        ]
        lib.anorag_bm25_free.restype = None
        lib.anorag_bm25_free.argtypes = [ctypes.c_void_p]
        lib.anorag_levenshtein_ratio.restype = ctypes.c_double
        lib.anorag_levenshtein_ratio.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.anorag_tokenize_count.restype = ctypes.c_int64
        lib.anorag_tokenize_count.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.anorag_hnsw_build.restype = ctypes.c_void_p
        lib.anorag_hnsw_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
        ]
        lib.anorag_hnsw_search.restype = None
        lib.anorag_hnsw_search.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.anorag_hnsw_size.restype = ctypes.c_int64
        lib.anorag_hnsw_size.argtypes = [ctypes.c_void_p]
        lib.anorag_hnsw_links_size.restype = ctypes.c_int64
        lib.anorag_hnsw_links_size.argtypes = [ctypes.c_void_p]
        lib.anorag_hnsw_export.restype = None
        lib.anorag_hnsw_export.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.anorag_hnsw_import.restype = ctypes.c_void_p
        lib.anorag_hnsw_import.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
        ]
        lib.anorag_hnsw_free.restype = None
        lib.anorag_hnsw_free.argtypes = [ctypes.c_void_p]
        lib.anorag_pathrank.restype = None
        lib.anorag_pathrank.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        logger.info("native runtime loaded: %s", _LIB_PATH)
    except Exception as e:
        logger.info("native runtime load failed: %s", e)
    return _lib


def available() -> bool:
    return load() is not None


def build_postings_native(
    texts: List[str], k1: float = 1.5, b: float = 0.75
) -> Optional[Tuple["BM25Postings", Dict[str, int]]]:
    """Build BM25 postings + vocab from raw texts in C++.

    Returns None when the native library is unavailable. The weights are
    bit-compatible with anorag_tpu_torch.ops.bm25.build_postings over the same
    tokenizer (C++ tokenizes bytes; pure-ASCII corpora match exactly).
    """
    lib = load()
    if lib is None:
        return None
    from anorag_tpu_torch.ops.bm25 import BM25Postings

    blobs = [t.encode("utf-8") for t in texts]
    corpus = b"".join(blobs)
    offsets = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum([len(x) for x in blobs], out=offsets[1:])

    handle = lib.anorag_bm25_build(
        corpus, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(texts), k1, b,
    )
    try:
        vocab_size = lib.anorag_bm25_vocab_size(handle)
        nnz = lib.anorag_bm25_nnz(handle)
        blob_size = lib.anorag_bm25_vocab_blob_size(handle)
        term_offsets = np.zeros(vocab_size + 1, np.int64)
        doc_ids = np.zeros(max(nnz, 1), np.int32)
        weights = np.zeros(max(nnz, 1), np.float32)
        idf = np.zeros(max(vocab_size, 1), np.float32)
        vocab_blob = ctypes.create_string_buffer(max(int(blob_size), 1))
        lib.anorag_bm25_export(
            handle,
            term_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            doc_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            weights.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            idf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            vocab_blob,
        )
    finally:
        lib.anorag_bm25_free(handle)

    terms = vocab_blob.raw[:blob_size].split(b"\0")[:-1] if blob_size else []
    vocab = {t.decode("utf-8", "replace"): i for i, t in enumerate(terms)}
    postings = BM25Postings(
        term_offsets=term_offsets,
        doc_ids=doc_ids[:nnz],
        weights=weights[:nnz],
        n_docs=len(texts),
        idf=idf[:vocab_size],
    )
    return postings, vocab


def pathrank_native(
    src, dst, cand, n_nodes: int, n_cands: int, q_ents,
    k_hop: int = 2, max_len: int = 3, per_pair_cap: int = 8,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """PathAwareRanker graph features in C++: (expanded (n_nodes,) bool,
    contributing (n_cands,) int32). None when the library is unavailable.
    Semantics match the Python EntityGraph bit-for-bit (tested)."""
    lib = load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    cand = np.ascontiguousarray(cand, np.int32)
    q = np.ascontiguousarray(q_ents, np.int32)
    expanded = np.zeros(max(int(n_nodes), 1), np.uint8)
    contributing = np.zeros(max(int(n_cands), 1), np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.anorag_pathrank(
        src.ctypes.data_as(i32p), dst.ctypes.data_as(i32p),
        cand.ctypes.data_as(i32p), len(src), int(n_nodes), int(n_cands),
        q.ctypes.data_as(i32p), len(q),
        int(k_hop), int(max_len), int(per_pair_cap),
        expanded.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        contributing.ctypes.data_as(i32p),
    )
    return expanded[: n_nodes].astype(bool), contributing[: n_cands]


class HNSWNative:
    """Owning wrapper over the C++ HNSW graph (build once, search many).

    Inner-product similarity — callers normalize rows for cosine. The
    LEVEL structure is seed-deterministic, but the parallel build's link
    sets (n >= 20k rows on multi-core hosts) vary with thread interleaving
    — so persistence serializes the adjacency lists (export_graph /
    from_graph) instead of rebuilding from embeddings: a reloaded index
    returns bit-identical results to the one that was saved.
    """

    def __init__(self, emb: np.ndarray, m: int = 16,
                 ef_construction: int = 200, seed: int = 0,
                 _handle=None):
        lib = load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        emb = np.ascontiguousarray(emb, np.float32)
        self._lib = lib
        self.n, self.d = emb.shape
        if _handle is not None:
            self._handle = _handle
            return
        self._handle = lib.anorag_hnsw_build(
            emb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.n, self.d, int(m), int(ef_construction), int(seed),
        )

    def export_graph(self) -> Dict[str, np.ndarray]:
        """Serialize the graph: {'meta' (8,) i64, 'node_level' (n,) i32,
        'links' (blob,) i32} — with the embeddings, enough to reconstruct
        the exact index (from_graph)."""
        blob_len = int(self._lib.anorag_hnsw_links_size(self._handle))
        meta = np.zeros(8, np.int64)
        node_level = np.zeros(self.n, np.int32)
        links = np.zeros(max(blob_len, 1), np.int32)
        self._lib.anorag_hnsw_export(
            self._handle,
            meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            node_level.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            links.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return {"meta": meta, "node_level": node_level, "links": links[:blob_len]}

    @classmethod
    def from_graph(cls, emb: np.ndarray, graph: Dict[str, np.ndarray]) -> "HNSWNative":
        """Reconstruct an index from export_graph() output + the embeddings."""
        lib = load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        emb = np.ascontiguousarray(emb, np.float32)
        meta = np.ascontiguousarray(graph["meta"], np.int64)
        node_level = np.ascontiguousarray(graph["node_level"], np.int32)
        links = np.ascontiguousarray(graph["links"], np.int32)
        if links.size == 0:
            links = np.zeros(1, np.int32)
        handle = lib.anorag_hnsw_import(
            emb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            node_level.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            links.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            int(np.ascontiguousarray(graph["links"], np.int32).size),
        )
        if not handle:
            raise ValueError("corrupt HNSW graph blob")
        return cls(emb, _handle=handle)

    def search(self, queries: np.ndarray, k: int,
               ef_search: int = 64) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (B,k) f32, indices (B,k) i32; -1/-inf padding)."""
        q = np.ascontiguousarray(np.atleast_2d(queries), np.float32)
        assert q.shape[1] == self.d, (q.shape, self.d)
        k = int(k)
        scores = np.empty((len(q), k), np.float32)
        idx = np.empty((len(q), k), np.int32)
        self._lib.anorag_hnsw_search(
            self._handle,
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(q),
            k, int(ef_search),
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        scores[idx < 0] = -np.inf
        return scores, idx

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.anorag_hnsw_free(handle)
            self._handle = None


def levenshtein_ratio_native(a: str, b: str) -> Optional[float]:
    lib = load()
    if lib is None:
        return None
    ab, bb = a.encode("utf-8"), b.encode("utf-8")
    return float(lib.anorag_levenshtein_ratio(ab, len(ab), bb, len(bb)))
