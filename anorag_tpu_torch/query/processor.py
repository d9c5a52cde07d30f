"""QueryProcessor for the port: the batched hybrid query.

Counterpart of anorag_tpu/query/processor.py's constructor (:97-135),
process_batch (:337) and filter_notes_by_namespace (:87), without the LLM
and graph arguments. process_batch returns, per query, the retrieval rows
of hybrid_search_finalize kept by the dataset guard, as the reference's
_assemble_batch (:357) filters them first. The answer stages the reference
then runs on those rows (evidence rerank, EFSA, context packing, answer
selection) and the per-query process() pipeline are not ported yet
(ROADMAP, queue 1).
The retriever is built with the reference's dense-search settings
(index type, nlist, nprobe, threshold 0; the recall target is left
out, since every search route of the port is exact), so
qp.retriever.retrieve is what the reference's HTTP /search endpoint calls.
The options of the index types not ported (pq_*, lsh_bits, hnsw_m, ef_*)
are not passed on.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from anorag_tpu_torch.config import as_config
from anorag_tpu_torch.device import DeviceLike, resolve_device
from anorag_tpu_torch.models.embedding_manager import EmbeddingManager
from anorag_tpu_torch.retrieval.retriever import VectorRetriever
from anorag_tpu_torch.validators.note_validator import normalize_note


def filter_notes_by_namespace(candidates: List[Dict[str, Any]],
                              namespace: Optional[str]) -> List[Dict[str, Any]]:
    """Dataset guard: keep candidates from the active dataset namespace
    (a note without one counts as in it); no namespace keeps all."""
    if not namespace:
        return candidates
    return [c for c in candidates
            if str(c.get("namespace", c.get("dataset", namespace))) == str(namespace)]


class QueryProcessor:
    def __init__(
        self,
        atomic_notes: Sequence[Dict[str, Any]],
        embeddings=None,
        cfg: Any = None,
        device: DeviceLike = None,
        embedding_manager: Optional[EmbeddingManager] = None,
    ):
        self.cfg = as_config(cfg)
        self.device = resolve_device(device)
        if str(self.cfg.get("tpu.sharded_search", "auto")).lower() == "on":
            raise NotImplementedError(
                "sharded search across devices is not ported yet (ROADMAP: "
                "the sharded branch)")
        self.notes = [normalize_note(n) for n in atomic_notes]
        self.em = embedding_manager or EmbeddingManager(self.cfg, self.device)
        vs = self.cfg.get("vector_store", {}) or {}
        self.retriever = VectorRetriever(
            embedding_manager=self.em,
            index_type=vs.get("index_type", "IVFFlat"),
            similarity_threshold=0.0,
            top_k=vs.get("top_k", 20),
            nlist=self.cfg.get("vector_store.nlist",
                               self.cfg.get("tpu.ivf.nlist", 20)),
            nprobe=self.cfg.get("tpu.ivf.nprobe", 4),
        )
        self.retriever.build_index(self.notes, embeddings)

    def default_top_k(self) -> int:
        return self.cfg.get("context.max_notes_for_llm", 20)

    def process_batch(self, queries: Sequence[str], dataset: Optional[str] = None,
                      top_k: Optional[int] = None) -> List[List[Dict[str, Any]]]:
        """One device pass for the whole batch: per query, the fused top-k
        notes (dense + BM25 candidate union) of the dataset namespace
        `dataset` (all when None): the top_k are retrieved, then filtered."""
        handle = self.retriever.hybrid_search_dispatch(
            list(queries), top_k=top_k or self.default_top_k())
        return self._assemble_batch(self.retriever.hybrid_search_finalize(handle),
                                    queries, dataset)

    def _assemble_batch(self, batches: List[List[Dict[str, Any]]],
                        queries: Sequence[str],
                        dataset: Optional[str]) -> List[List[Dict[str, Any]]]:
        """Each query's retrieval rows through the dataset guard, the first
        step of the reference's _assemble_batch (:357); the answer stages
        after it are not ported."""
        return [filter_notes_by_namespace(rows, dataset) for rows in batches]
