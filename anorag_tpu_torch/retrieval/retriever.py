"""VectorRetriever: dense search and batched hybrid dense + BM25 search
over notes.

Counterpart of anorag_tpu/retrieval/retriever.py, every name of it:
MISS_PENALTY, ENTITY_BOOST, PREDICATE_BOOST and OVERFETCH (:27-30),
__init__ (:34), build_index (:64) and _rebuild (:74), search (:84),
retrieve (:116), hybrid_search (:181), hybrid_search_dispatch (:196) and
hybrid_search_finalize (:259), with the same dense_k / sparse_m rule, the
same max_seg rule and the same sparse routing (ops/topk.hybrid_topk); the
lexical and namespace fallbacks (:280-307), add_notes / remove_notes /
update_note (:310-340), save / load (:343-369), which write and read the
reference's files, and optimize_retrieval_params (:372). The embeddings
are kept as a tensor without a copy (the device rows the encoder made, or
those a caller passed); the rows that add_notes and update_note write are
f32, as the reference's. search and retrieve go through
VectorIndex.search_arrays: Flat (the streaming top-k kernel with
use_kernel=True) or IVFFlat (the IVF scan kernel). With a mesh
(parallel/mesh.py) the index shards Flat rows over its 'data' axis: search
takes the shard-local top-k and merge, and the hybrid search the sharded
candidate union of parallel/sharded_search.py (reference :227-234).
Dispatch only enqueues device work; finalize waits for it and builds the
note rows, so a caller can overlap one batch's host work with the next
batch's device work.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from anorag_tpu_torch.index.bm25_index import BM25Index
from anorag_tpu_torch.index.vector_index import VectorIndex
from anorag_tpu_torch.models.embedding_manager import EmbeddingManager
from anorag_tpu_torch.ops.bm25 import MAX_SEG, gather_plan_sorted
from anorag_tpu_torch.ops.topk import hybrid_topk
from anorag_tpu_torch.utils.file_io import read_json, write_json
from anorag_tpu_torch.utils.logging import get_logger

logger = get_logger("anorag.retrieval")

MISS_PENALTY = 0.6
ENTITY_BOOST = 1.2
PREDICATE_BOOST = 1.15
OVERFETCH = 3


@dataclass
class HybridBatch:
    """Everything hybrid_topk takes for one batch of queries."""
    queries: List[str]
    q_emb: torch.Tensor          # (B, D) in the corpus storage dtype; f32 if sharded
    doc_rows: torch.Tensor       # (B, L) int32 sorted posting doc ids
    weight_rows: torch.Tensor    # (B, L) f32 posting weights
    k: int
    dense_k: int
    sparse_m: int
    max_seg: int
    lens: np.ndarray             # (B,) real plan lengths (make_bucketed_plan)


def max_seg_for(q_terms: Sequence[Sequence[int]]) -> int:
    """The longest query's term count, rounded up to a power of two and
    capped at 32 (0 for no terms). A doc matched by more than 32 query-term
    instances has its window total cut: the reference's behaviour, kept for
    parity (ROADMAP, faults of the reference)."""
    n = max((len(t) for t in q_terms), default=0)
    return min(1 << max(n - 1, 0).bit_length(), MAX_SEG) if n else 0


class VectorRetriever:
    def __init__(
        self,
        embedding_manager: EmbeddingManager,
        dimension: int = 1024,
        index_type: str = "IVFFlat",
        similarity_threshold: float = 0.5,
        top_k: int = 20,
        nlist: int = 20,
        nprobe: int = 4,
        use_kernel: Optional[bool] = None,
        recall_target: float = 0.95,
        mesh=None,
        index_params: Optional[Dict[str, Any]] = None,
    ):
        self.em = embedding_manager
        self.device = embedding_manager.device
        self.dimension = dimension          # the width of an empty index
        self.index_type = index_type
        self.similarity_threshold = similarity_threshold
        self.top_k = top_k
        # recall_target is accepted for the reference's signature and
        # unused: every search route of the port is exact. index_params
        # (pq_*, lsh_bits, hnsw_m, ef_*) and mesh go to VectorIndex, which
        # takes them as the reference's does.
        self._index_kw = dict(nlist=nlist, nprobe=nprobe, use_kernel=use_kernel,
                              mesh=mesh, **(index_params or {}))
        self.notes: List[Dict[str, Any]] = []
        self.embeddings: Optional[torch.Tensor] = None
        self.index: Optional[VectorIndex] = None
        self._lexical: Optional[BM25Index] = None

    # ------------------------------------------------------------- build
    def build_index(self, notes: Sequence[Dict[str, Any]],
                    embeddings=None) -> None:
        """Index notes; `embeddings` (N, D), numpy or a tensor, skips
        encoding them."""
        self.notes = list(notes)
        self.embeddings = torch.as_tensor(
            self.em.encode_atomic_notes(self.notes) if embeddings is None
            else embeddings)
        self._rebuild()

    def _rebuild(self) -> None:
        self.index = VectorIndex(
            dimension=self.embeddings.shape[1] if len(self.notes) else self.dimension,
            index_type=self.index_type, device=self.device, **self._index_kw)
        if len(self.notes):
            self.index.add(self.embeddings)
        self._lexical = (BM25Index(self.notes, device=self.device)
                         if self.notes else None)

    # ------------------------------------------------------------- search
    def search(self, queries: Sequence[str], top_k: Optional[int] = None,
               threshold: Optional[float] = None) -> List[List[Dict[str, Any]]]:
        """Per query: notes with retrieval_info, filtered by threshold."""
        if not self.notes:
            return [[] for _ in queries]
        top_k = top_k or self.top_k
        threshold = self.similarity_threshold if threshold is None else threshold
        q_emb = self.em.encode_queries(list(queries))
        scores, idx = self.index.search_arrays(q_emb, top_k)
        out: List[List[Dict[str, Any]]] = []
        for qi, query in enumerate(queries):
            rows = []
            for rank in range(scores.shape[1]):
                i = int(idx[qi, rank])
                s = float(scores[qi, rank])
                if i < 0 or s < threshold:
                    continue
                note = dict(self.notes[i])
                note["retrieval_info"] = {
                    "similarity": s, "rank": rank, "query": query, "method": "dense",
                }
                note["similarity"] = s
                note["final_score"] = s
                rows.append(note)
            out.append(rows)
        return out

    def retrieve(
        self,
        query: str,
        top_k: Optional[int] = None,
        filter_fn: Optional[Callable[[Dict[str, Any]], bool]] = None,
        must_have_terms: Sequence[str] = (),
        boost_entities: Sequence[str] = (),
        boost_predicates: Sequence[str] = (),
        threshold: Optional[float] = None,
    ) -> List[Dict[str, Any]]:
        """4-stage enhanced retrieval: over-fetch, filter, adjust, cut."""
        if not self.notes:
            return []
        top_k = top_k or self.top_k
        threshold = self.similarity_threshold if threshold is None else threshold

        # stage 1: over-fetch
        q_emb = self.em.encode_queries([query])
        fetch = min(top_k * OVERFETCH, len(self.notes))
        scores, idx = self.index.search_arrays(q_emb, fetch)
        cands: List[Dict[str, Any]] = []
        for rank in range(scores.shape[1]):
            i = int(idx[0, rank])
            if i < 0:
                continue
            note = dict(self.notes[i])
            note["similarity"] = float(scores[0, rank])
            cands.append(note)

        # stage 2: filter
        if filter_fn:
            cands = [c for c in cands if filter_fn(c)]

        # stage 3: score adjustments (vectorized over the pool)
        if cands:
            sims = np.array([c["similarity"] for c in cands], np.float32)
            if must_have_terms:
                terms = [t.lower() for t in must_have_terms]
                has = np.array([
                    all(t in f"{c.get('title','')} {c.get('content','')}".lower()
                        for t in terms)
                    for c in cands
                ])
                sims = np.where(has, sims, sims * MISS_PENALTY)
            if boost_entities:
                be = set(e.lower() for e in boost_entities)
                hit = np.array([
                    bool(be & set(str(e).lower() for e in (c.get("entities") or [])))
                    for c in cands
                ])
                sims = np.where(hit, sims * ENTITY_BOOST, sims)
            if boost_predicates:
                bp = [p.lower() for p in boost_predicates]
                hit = np.array([
                    any(p in (c.get("content") or "").lower() for p in bp)
                    for c in cands
                ])
                sims = np.where(hit, sims * PREDICATE_BOOST, sims)
            for c, s in zip(cands, sims):
                c["adjusted_score"] = float(s)
                c["final_score"] = float(s)

        # stage 4: threshold + sort + cut
        cands = [c for c in cands if c.get("adjusted_score", 0.0) >= threshold]
        cands.sort(key=lambda c: -c["adjusted_score"])
        return cands[:top_k]

    def query_terms(self, queries: Sequence[str]) -> List[List[int]]:
        return [self._lexical.query_terms(q) for q in queries]

    def prepare(self, queries: Sequence[str],
                top_k: Optional[int] = None) -> HybridBatch:
        """Encode the queries and build their BM25 plan on the device."""
        queries = list(queries)
        top_k = top_k or self.top_k
        n = len(self.notes)
        q_emb = self.em.encode_queries(queries)
        q_terms = self.query_terms(queries)
        doc_rows, weight_rows, lens = gather_plan_sorted(self._lexical.postings,
                                                         q_terms)
        q_emb = self.index._preprocess(q_emb)
        k_eff = min(top_k, n)
        return HybridBatch(
            queries=queries,
            # the sharded union takes f32 queries against widened rows
            q_emb=q_emb if self.index.is_sharded else q_emb.to(self.index._dtype),
            doc_rows=torch.from_numpy(doc_rows).to(self.device),
            weight_rows=torch.from_numpy(weight_rows).to(self.device),
            k=k_eff,
            dense_k=min(max(4 * k_eff, 32), n),
            # sparse depth matches dense (the reference's operating point)
            sparse_m=min(max(4 * k_eff, 32), n),
            max_seg=max_seg_for(q_terms),
            lens=lens)

    def search_batch(self, batch: HybridBatch, sparse_weight: float = 0.6):
        """Enqueue hybrid_topk for a prepared batch: (scores, ids) (B, k).
        A sharded index (corpus rows on the mesh's 'data' axis) takes the
        sharded candidate union over the untiled (B, L) plan instead, before
        hybrid_topk's window or segment routing."""
        if self.index.is_sharded:
            fn = self.index.sharded_hybrid_fn(batch.k, batch.dense_k, batch.sparse_m,
                                              sparse_weight)
            return fn(self.index.sharded_rows(), batch.q_emb, batch.doc_rows,
                      batch.weight_rows)
        return hybrid_topk(
            self.index.flat_device_emb(), batch.q_emb, batch.doc_rows,
            batch.weight_rows, batch.k, n_docs=len(self.notes),
            dense_k=batch.dense_k, sparse_m=batch.sparse_m,
            sparse_weight=sparse_weight, max_seg=batch.max_seg)

    def hybrid_search(self, queries: Sequence[str], top_k: Optional[int] = None,
                      sparse_weight: float = 0.6,
                      recall_target: float = 0.95) -> List[List[Dict[str, Any]]]:
        """Batched dense + BM25 hybrid search: per query, the fused top-k
        notes with final_score and retrieval_info."""
        return self.hybrid_search_finalize(self.hybrid_search_dispatch(
            queries, top_k=top_k, sparse_weight=sparse_weight,
            recall_target=recall_target))

    def hybrid_search_dispatch(self, queries: Sequence[str],
                               top_k: Optional[int] = None,
                               sparse_weight: float = 0.6,
                               recall_target: float = 0.95):
        """Enqueue the device pass without waiting; returns a handle for
        hybrid_search_finalize. recall_target is accepted for the
        reference's signature and has no effect: every route is exact."""
        if not self.notes:
            return ("empty", list(queries))
        batch = self.prepare(queries, top_k)
        vals, ids = self.search_batch(batch, sparse_weight)
        return ("pending", batch.queries, vals, ids)

    def hybrid_search_finalize(self, handle) -> List[List[Dict[str, Any]]]:
        """Wait for a dispatched search and build the note rows."""
        if handle[0] == "empty":
            return [[] for _ in handle[1]]
        _, queries, vals, ids = handle
        vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
        out: List[List[Dict[str, Any]]] = []
        for qi, query in enumerate(queries):
            rows = []
            for rank in range(vals.shape[1]):
                i = int(ids[qi, rank])
                if i < 0:
                    continue
                note = dict(self.notes[i])
                note["final_score"] = float(vals[qi, rank])
                note["retrieval_info"] = {"method": "hybrid", "rank": rank,
                                          "query": query}
                note["retrieval_method"] = "hybrid"
                rows.append(note)
            out.append(rows)
        return out

    def _lexical_terms(self, query: str) -> List[int]:
        return self._lexical.query_terms(query) if self._lexical else []

    def lexical_fallback_search(self, query: str, top_k: int = 20) -> List[Dict[str, Any]]:
        """Sparse fallback when dense retrieval returns nothing usable."""
        if not self._lexical:
            return []
        s, idx = self._lexical.topk(query, k=top_k)
        out = []
        for score, i in zip(s, idx):
            if score <= 0:
                continue
            note = dict(self.notes[int(i)])
            note["similarity"] = float(score)
            note["final_score"] = float(score)
            note["retrieval_info"] = {"method": "lexical_fallback"}
            out.append(note)
        return out

    def search_with_namespace_fallback(self, query: str, namespace: Optional[str],
                                       top_k: int = 20) -> List[Dict[str, Any]]:
        """Dense search filtered to a doc namespace; lexical fallback within
        the namespace when empty."""
        in_ns = (lambda c: namespace is None or str(c.get("doc_id")) == str(namespace))
        res = self.retrieve(query, top_k=top_k, filter_fn=in_ns, threshold=0.0)
        if not res:
            res = [c for c in self.lexical_fallback_search(query, top_k * 2)
                   if in_ns(c)][:top_k]
        return res

    # -------------------------------------------------------- incremental
    def add_notes(self, new_notes: Sequence[Dict[str, Any]]) -> None:
        if not new_notes:
            return
        new_emb = self.em.encode_atomic_notes(list(new_notes))
        self.notes.extend(new_notes)
        self.embeddings = (
            new_emb if self.embeddings is None
            else torch.cat([self.embeddings.float(),
                            new_emb.to(self.embeddings.device)])
        )
        self._rebuild()

    def remove_notes(self, note_ids: Sequence[str]) -> int:
        drop = set(note_ids)
        keep = [i for i, n in enumerate(self.notes) if n.get("note_id") not in drop]
        removed = len(self.notes) - len(keep)
        self.notes = [self.notes[i] for i in keep]
        if self.embeddings is not None:
            rows = torch.tensor(keep, dtype=torch.long, device=self.embeddings.device)
            self.embeddings = self.embeddings[rows]
        self._rebuild()
        return removed

    def update_note(self, note: Dict[str, Any]) -> bool:
        nid = note.get("note_id")
        for i, n in enumerate(self.notes):
            if n.get("note_id") == nid:
                self.notes[i] = dict(note)
                self.embeddings = self.embeddings.float().clone()
                self.embeddings[i] = self.em.encode_atomic_notes([note])[0].to(
                    self.embeddings.device)
                self._rebuild()
                return True
        return False

    # -------------------------------------------------------- persistence
    def save(self, data_dir) -> None:
        d = Path(data_dir)
        d.mkdir(parents=True, exist_ok=True)
        write_json(d / "atomic_notes.json", self.notes)
        np.savez_compressed(d / "note_embeddings.npz",
                            embeddings=self.embeddings.float().cpu().numpy())
        write_json(d / "id_mappings.json",
                   {n.get("note_id"): i for i, n in enumerate(self.notes)})
        write_json(d / "model_signature.json", self.em.model_signature())

    def load(self, data_dir, check_signature: bool = True) -> bool:
        d = Path(data_dir)
        if not (d / "atomic_notes.json").exists():
            return False
        sig_path = d / "model_signature.json"
        if check_signature and sig_path.exists():
            if not self.em.check_signature(read_json(sig_path)):
                logger.warning("model signature mismatch; refusing stale index at %s", d)
                return False
        self.notes = read_json(d / "atomic_notes.json")
        with np.load(d / "note_embeddings.npz") as z:
            self.embeddings = torch.from_numpy(z["embeddings"]).to(self.device)
        self._rebuild()
        return True


def optimize_retrieval_params(
    retriever: VectorRetriever,
    dev_queries: Sequence[str],
    gold_note_ids: Sequence[Sequence[str]],
    top_k_grid: Sequence[int] = (5, 10, 20),
    threshold_grid: Sequence[float] = (0.0, 0.2, 0.35, 0.5),
) -> Dict[str, Any]:
    """F1 sweep over (top_k, similarity_threshold) against labeled dev
    queries. Applies the best setting in place."""
    best = {"f1": -1.0, "top_k": retriever.top_k,
            "threshold": retriever.similarity_threshold}
    for tk in top_k_grid:
        for th in threshold_grid:
            f1_sum = 0.0
            for q, gold in zip(dev_queries, gold_note_ids):
                got = {n["note_id"] for n in
                       retriever.retrieve(q, top_k=tk, threshold=th)}
                gset = set(gold)
                if not got and not gset:
                    f1_sum += 1.0
                    continue
                if not got or not gset:
                    continue
                overlap = len(got & gset)
                if overlap:
                    p = overlap / len(got)
                    r = overlap / len(gset)
                    f1_sum += 2 * p * r / (p + r)
            f1 = f1_sum / max(len(dev_queries), 1)
            if f1 > best["f1"]:
                best = {"f1": f1, "top_k": tk, "threshold": th}
    retriever.top_k = best["top_k"]
    retriever.similarity_threshold = best["threshold"]
    logger.info("retrieval params tuned: %s", best)
    return best
