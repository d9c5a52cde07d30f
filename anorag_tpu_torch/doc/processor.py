"""DocumentProcessor: the 5-step offline pipeline with per-artifact caching.

Counterpart of anorag_tpu/doc/processor.py, copied with its imports
renamed, except that DocumentProcessor takes the device (keyword only; the
card unless the caller asks for the CPU) and passes it to the
EmbeddingManager, TopicClustering, RelationExtractor and GraphBuilder it
constructs. The note embeddings stay an f32 tensor on that device between
the stages (a cache hit loads embeddings.npy there); embeddings.npy holds
them as the f32 numpy array the reference writes.

Parity target: upstream doc/document_processor.py:64-264 —
  (1) chunk -> chunks.jsonl; (2) LLM atomic notes -> atomic_notes.json;
  (3) embeddings -> embeddings.npy; (4) clustering -> clustering.json;
  (5) graph build -> graph.json (+ graph.graphml); then the
ConsistencyChecker gate, processing stats, and result.json. Each step is
cached with config-hash + input-hash staleness (ArtifactStore), mirroring
the reference's per-step cache-skip and IncrementalProcessor plan.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from anorag_tpu_torch.config import config as global_config
from anorag_tpu_torch.device import DeviceLike, resolve_device
from anorag_tpu_torch.doc.chunker import DocumentChunker
from anorag_tpu_torch.doc.clustering import TopicClustering
from anorag_tpu_torch.doc.consistency import ConsistencyChecker
from anorag_tpu_torch.doc.incremental import IncrementalProcessor
from anorag_tpu_torch.graph.builder import GraphBuilder
from anorag_tpu_torch.graph.exporter import export_graphml
from anorag_tpu_torch.index.store import ArtifactStore
from anorag_tpu_torch.llm.note_generator import resolve_note_abbreviations
from anorag_tpu_torch.models.embedding_manager import EmbeddingManager
from anorag_tpu_torch.utils.file_io import read_json, write_json, write_jsonl
from anorag_tpu_torch.utils.logging import get_logger, log_performance

logger = get_logger("anorag.doc")


class DocumentProcessor:
    def __init__(
        self,
        output_dir: str | Path,
        llm: Optional[Any] = None,
        cfg: Optional[Any] = None,
        embedding_manager: Optional[EmbeddingManager] = None,
        note_generator: Optional[Any] = None,
        *,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg or global_config
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.store = ArtifactStore(self.output_dir)
        self.incremental = IncrementalProcessor(self.output_dir / ".cache")
        ch = self.cfg.get("chunking", {}) or {}
        self.chunker = DocumentChunker(
            max_chunk_chars=ch.get("max_chunk_chars", 512),
            overlap_chars=ch.get("overlap_chars", 0),
            min_chunk_chars=ch.get("min_chunk_chars", 20),
            strategy=ch.get("strategy", "sentence"),
        )
        self.em = embedding_manager or EmbeddingManager(cfg=self.cfg, device=self.device)
        self.llm = llm
        self._note_generator = note_generator
        cl = self.cfg.get("clustering", {}) or {}
        self.clustering = TopicClustering(
            method=cl.get("method", "kmeans"),
            n_clusters=cl.get("n_clusters", 0),
            max_clusters=cl.get("max_clusters", 20),
            min_samples=cl.get("min_samples", 3),
            eps=cl.get("eps", None),
            device=self.device,
        )
        gcfg = self.cfg.get("graph.pagerank", {}) or {}
        rx = self.cfg.get("graph.relation_extraction", {}) or {}
        ere = self.cfg.get("enhanced_relation_extraction", {}) or {}
        # LLM pairwise relation window (ref graph/relation_extractor.py
        # :186-238), gated exactly like the reference: config toggle AND a
        # live LLM. Both the canonical and the legacy key enable it.
        use_llm_rel = bool(rx.get("enable_llm_relations")
                           or ere.get("use_llm_extraction")) and llm is not None
        from anorag_tpu_torch.graph.relation_extractor import RelationExtractor

        extractor = RelationExtractor(
            semantic_threshold=rx.get("semantic_similarity_threshold", 0.7),
            max_semantic_edges_per_note=rx.get("max_semantic_edges_per_note", 5),
            max_edges_per_note=rx.get("max_edges_per_note", 20),
            llm=llm if use_llm_rel else None,
            llm_window=int(rx.get("llm_window", 10)),
            device=self.device,
        )
        self.graph_builder = GraphBuilder(
            extractor=extractor,
            pagerank_alpha=gcfg.get("alpha", 0.85),
            pagerank_iters=gcfg.get("iters", 30),
            device=self.device,
        )
        self.checker = ConsistencyChecker()

    @property
    def note_generator(self):
        if self._note_generator is None:
            ang = self.cfg.get("atomic_note_generation", {}) or {}
            if self.llm is None or not self.cfg.get("notes_llm.use_llm",
                                                    True):
                # notes_llm.use_llm=false: rule-built KB even when an LLM
                # is configured (the LLM still serves the ANSWER path) —
                # the deployment mode where note extraction quality is
                # measured-better than the available model's
                self._note_generator = _RuleNoteGenerator(self.cfg)
            elif ang.get("parallel_enabled"):
                from anorag_tpu_torch.llm.parallel_note_gen import ParallelTaskAtomicNoteGenerator

                self._note_generator = ParallelTaskAtomicNoteGenerator(
                    [self.llm], self.cfg,
                    allocation_method=(ang.get("task_division") or {}).get(
                        "allocation_method", "round_robin"),
                )
            else:
                from anorag_tpu_torch.llm.note_generator import AtomicNoteGenerator

                self._note_generator = AtomicNoteGenerator(self.llm, self.cfg)
        return self._note_generator

    # ----------------------------------------------------------------- run
    @log_performance
    def process_documents(
        self,
        file_paths: Optional[Sequence[str]] = None,
        documents: Optional[Sequence[Dict[str, Any]]] = None,
        force_reprocess: bool = False,
    ) -> Dict[str, Any]:
        t0 = time.perf_counter()
        stats: Dict[str, Any] = {}
        pipeline_cfg = {
            "chunking": self.cfg.get("chunking", {}),
            "embedding": self.em.model_signature(),
            "clustering": self.cfg.get("clustering", {}),
            "graph": self.cfg.get("graph", {}),
        }
        if file_paths:
            plan = self.incremental.get_processing_plan(file_paths, force=force_reprocess)
            input_hash = "|".join(sorted(plan["_hashes"].values()))
        else:
            import hashlib, json as _json

            input_hash = hashlib.sha1(
                _json.dumps(documents or [], sort_keys=True, default=str).encode()
            ).hexdigest()
            plan = None

        # [1] chunking ----------------------------------------------------
        def build_chunks():
            chunks: List[Dict[str, Any]] = []
            if file_paths:
                for p in file_paths:
                    chunks.extend(self.chunker.chunk_file(p))
            for d in documents or []:
                chunks.extend(self.chunker.chunk_document(d))
            return chunks

        chunks = self.store.cached(
            "chunks", pipeline_cfg, input_hash,
            build=build_chunks,
            save=lambda c: write_jsonl(self.output_dir / "chunks.jsonl", c),
            load=lambda: _load_jsonl(self.output_dir / "chunks.jsonl"),
            force=force_reprocess,
        )
        stats["n_chunks"] = len(chunks)

        # [2] atomic notes --------------------------------------------------
        notes = self.store.cached(
            "atomic_notes", pipeline_cfg, input_hash,
            build=lambda: resolve_note_abbreviations(
                self.note_generator.generate_atomic_notes(chunks)),
            save=lambda n: write_json(self.output_dir / "atomic_notes.json", n),
            load=lambda: read_json(self.output_dir / "atomic_notes.json"),
            force=force_reprocess,
        )
        stats["n_notes"] = len(notes)

        # [3] embeddings -----------------------------------------------------
        def build_embeddings():
            return self.em.encode_atomic_notes(notes)

        embeddings = self.store.cached(
            "embeddings", pipeline_cfg, input_hash,
            build=build_embeddings,
            save=lambda e: np.save(self.output_dir / "embeddings.npy",
                                   e.float().cpu().numpy()),
            load=lambda: torch.from_numpy(
                np.load(self.output_dir / "embeddings.npy")).to(self.device),
            force=force_reprocess,
        )
        stats["embedding_shape"] = list(embeddings.shape)

        # [4] clustering ------------------------------------------------------
        clustering = self.store.cached(
            "clustering", pipeline_cfg, input_hash,
            build=lambda: self.clustering.cluster_notes(notes, embeddings),
            save=lambda c: write_json(self.output_dir / "clustering.json", c),
            load=lambda: read_json(self.output_dir / "clustering.json"),
            force=force_reprocess,
        )
        stats["n_clusters"] = clustering.get("n_clusters", 0)

        # [5] graph -------------------------------------------------------------
        def build_graph():
            topic_groups = [p["note_ids"] for p in clustering.get("topic_pools", [])]
            gi, metrics = self.graph_builder.build_graph_with_metrics(
                notes, embeddings, topic_groups)
            gi.save(self.output_dir / "graph.json")
            export_graphml(gi, self.output_dir / "graph.graphml")
            data = GraphBuilder.to_graph_data(gi)
            data["metrics"] = metrics
            return data

        graph_data = self.store.cached(
            "graph", pipeline_cfg, input_hash,
            build=build_graph,
            save=lambda g: None,  # build_graph already persisted
            load=lambda: read_json(self.output_dir / "graph.json"),
            force=force_reprocess,
        )
        stats["n_edges"] = len(graph_data.get("links", []))
        stats["graph_metrics"] = graph_data.get("metrics", {})

        # consistency gate -------------------------------------------------------
        report = self.checker.check_consistency(
            notes, embeddings, graph_data, clustering
        )
        write_json(self.output_dir / "consistency_report.json", report)
        if not report["consistent"]:
            logger.warning("consistency issues: %s", report["issues"][:3])

        if plan is not None:
            self.incremental.commit(plan["_hashes"])

        stats["elapsed_s"] = time.perf_counter() - t0
        result = {
            "atomic_notes": notes,
            "embeddings_path": str(self.output_dir / "embeddings.npy"),
            "topic_pools": clustering.get("topic_pools", []),
            "graph_data": graph_data,
            "graph_file": str(self.output_dir / "graph.json"),
            "consistency": report,
            "processing_stats": stats,
        }
        write_json(self.output_dir / "result.json",
                   {k: v for k, v in result.items() if k not in ("atomic_notes", "graph_data")})
        return result


class _RuleNoteGenerator:
    """LLM-free note generation: rule fallback path of AtomicNoteGenerator."""

    def __init__(self, cfg):
        from anorag_tpu_torch.llm.note_generator import AtomicNoteGenerator

        class _NullLLM:
            def generate(self, *a, **kw):
                raise RuntimeError("no LLM configured")

        self._gen = AtomicNoteGenerator(_NullLLM(), cfg)
        # the per-paragraph quota (notes_llm.limit, default 1) guards
        # against LLM over-generation; rule notes are one-per-sentence
        # atomic facts, and capping them drops relation triples the note
        # graph needs (measured: every born_in edge vanished, so the
        # rel-chain selector could not answer 2-hop born questions)
        self._gen.quota_per_bucket = max(self._gen.quota_per_bucket, 8)

    def generate_atomic_notes(self, chunks):
        # corpus-level entity-type registry first (utils/semtype.py): the
        # rule path depends on it for type-signature triple orientation
        # and work-page pronoun coref
        self._gen._build_type_registry(chunks)
        out = []
        for chunk in chunks:
            sentences = chunk.get("sentences") or []
            raw = self._gen._rule_fallback(chunk.get("text") or "",
                                           sentences,
                                           title=str(chunk.get("title")
                                                     or ""))
            out.extend(self._gen._post_process(raw, chunk))
        self._gen.maybe_evaluate_coverage(chunks, out)
        return out


def _load_jsonl(path: Path) -> List[Dict[str, Any]]:
    from anorag_tpu_torch.utils.file_io import read_jsonl

    return read_jsonl(path)
