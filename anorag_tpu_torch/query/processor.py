"""QueryProcessor for the port: the batched hybrid query.

Counterpart of anorag_tpu/query/processor.py's constructor (:97-135) and
process_batch (:337), without the LLM and graph arguments. process_batch
returns, per query, the retrieval rows of hybrid_search_finalize. The
answer stages the reference runs on those rows (_assemble_batch :357:
evidence rerank, EFSA, context packing, answer selection) and the
per-query process() pipeline are not ported yet (ROADMAP, queue 1).
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

    def process_batch(self, queries: Sequence[str],
                      top_k: Optional[int] = None) -> List[List[Dict[str, Any]]]:
        """One device pass for the whole batch: per query, the fused top-k
        notes (dense + BM25 candidate union)."""
        return self.retriever.hybrid_search(
            list(queries), top_k=top_k or self.default_top_k())
