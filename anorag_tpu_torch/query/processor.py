"""QueryProcessor for the port: text in, answers out, through the batched
served path and the per-query pipeline.

Counterpart of anorag_tpu/query/processor.py: the constructor (:97-274),
_load_calibration (:276-307), the per-query pipeline process (:326) with
_process_traditional and its stages (:434-766), _bm25_namespace_fallback
(:772), _write_final_recall (:1009) and the sub-question path (:1027-1060);
process_batch (:337), _assemble_batch (:357), process_stream (:376-429),
filter_notes_by_namespace (:87), _is_polar_question (:83) and the answer
stages (:768-1006): _post_select_processing, the two coverage gates,
_answer and _answer_stages.

process(query, dataset, qid) runs the reference's twelve stages: dense
recall, the dataset guard, the v2 fusion of dense and BM25 scores, the
two-hop bridge expansion over the entity index, cluster suppression when
configured, the path-aware rerank, the recall optimizer, graph expansion
(MultiHopQueryProcessor's reasoning paths over the note graph, built here
or loaded from graph_file), the multi-hop safety net, the dispatcher (or
the scheduler), the BM25 fallback, the answer stages and the audit file.
The note graph is built on the processor's device: its semantic edges are
a self-join of the corpus through the streaming top-k kernel on the card
(graph/relation_extractor.py), PageRank runs there too.

The processor keeps one f32 copy of the corpus embeddings on its device,
as given (no copy when they are an f32 tensor there already): the
gathered cosines of the fusion stage, the cluster suppression, the
sub-question path and the note graph (GraphIndex.embeddings, the same
tensor) read it there, and only the few rows or scores they need come
back to the host. The fusion stage and the graph take their cosines from
ops.graph.cosines, whose row norms are computed once for that tensor.

The retriever is built with the reference's dense-search settings
(index type, nlist, nprobe, threshold 0; the recall target is left
out, since every search route of the port is exact), so
qp.retriever.retrieve is what the reference's HTTP /search endpoint calls;
the index options of vector_store (pq_*, lsh_bits, hnsw_m, ef_*) are
passed on as the reference passes them.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from anorag_tpu_torch.answer.answer_selector import answer_question
from anorag_tpu_torch.answer.comparative import (answer_exact_math,
                                                 coerce_state_answer)
from anorag_tpu_torch.answer.efsa import (efsa_answer_with_fallback,
                                          extract_bridge_info_from_candidates)
from anorag_tpu_torch.answer.evidence_rerank import EvidenceReranker
from anorag_tpu_torch.answer.final_answer import generate_final_answer
from anorag_tpu_torch.answer.path_validator import PathValidator
from anorag_tpu_torch.answer.support_fill import fill_support_idxs_noid
from anorag_tpu_torch.answer.verifier import AnswerVerifier
from anorag_tpu_torch.config import as_config
from anorag_tpu_torch.context.dispatcher import ContextDispatcher
from anorag_tpu_torch.context.packer import ContextPacker
from anorag_tpu_torch.context.scheduler import MultiHopContextScheduler
from anorag_tpu_torch.device import DeviceLike, resolve_device
from anorag_tpu_torch.graph.multi_hop import MultiHopQueryProcessor
from anorag_tpu_torch.graph.note_graph import NoteGraph
from anorag_tpu_torch.index.bm25_index import BM25Index
from anorag_tpu_torch.index.entity_index import EntityInvertedIndex
from anorag_tpu_torch.models.embedding_manager import EmbeddingManager
from anorag_tpu_torch.ops.graph import cosines
from anorag_tpu_torch.query.evidence_merger import EvidenceMerger
from anorag_tpu_torch.query.subquestion import SubQuestionPlanner
from anorag_tpu_torch.retrieval.diversity import DiversityScheduler
from anorag_tpu_torch.retrieval.path_aware_ranker import PathAwareRanker
from anorag_tpu_torch.retrieval.recall_optimizer import EnhancedRecallOptimizer
from anorag_tpu_torch.retrieval.reranker import ListwiseReranker, fuse_scores, sort_desc
from anorag_tpu_torch.retrieval.retriever import VectorRetriever
from anorag_tpu_torch.support.k_estimator import KEstimator
from anorag_tpu_torch.utils.file_io import jsonl_sha1, read_jsonl, write_jsonl
from anorag_tpu_torch.utils.logging import StructuredLogger, get_logger, log_performance
from anorag_tpu_torch.utils.text import extract_entities_fallback, tokenize_no_stop
from anorag_tpu_torch.validators.note_validator import normalize_note

logger = get_logger("anorag.query")

# polar (yes/no) question shape: leads with an auxiliary and carries no
# wh-word — such questions may only be answered yes/no/insufficient
_POLAR_LEAD = re.compile(
    r"^(?:does|do|did|is|are|was|were|has|have|had|can|could|will|would|"
    r"should|must)\b", re.IGNORECASE)
_WH_WORD = re.compile(
    r"\b(?:who|whom|whose|what|which|where|when|why|how)\b", re.IGNORECASE)


def _is_polar_question(q: str) -> bool:
    q = (q or "").strip()
    return bool(_POLAR_LEAD.match(q)) and not _WH_WORD.search(q)


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
        graph_file: Optional[str] = None,
        llm: Optional[Any] = None,
        cfg: Any = None,
        embedding_manager: Optional[EmbeddingManager] = None,
        work_dir: Optional[str] = None,
        *,
        device: DeviceLike = None,
    ):
        self.cfg = as_config(cfg)
        self.device = resolve_device(device)
        self.llm = llm
        self.work_dir = Path(work_dir) if work_dir else None
        self.notes = [normalize_note(n) for n in atomic_notes]

        # --- dense retrieval -------------------------------------------------
        vs = self.cfg.get("vector_store", {}) or {}
        self.em = embedding_manager or EmbeddingManager(self.cfg, self.device)
        # shard the corpus over the product mesh when more than one GPU is
        # attached, or over this device with tpu.sharded_search: on
        from anorag_tpu_torch.parallel.runtime import product_mesh

        self.mesh = product_mesh(self.cfg, self.device)
        self.retriever = VectorRetriever(
            embedding_manager=self.em,
            mesh=self.mesh,
            index_type=vs.get("index_type", "IVFFlat"),
            similarity_threshold=0.0,
            top_k=vs.get("top_k", 20),
            nlist=self.cfg.get("vector_store.nlist",
                               self.cfg.get("tpu.ivf.nlist", 20)),
            nprobe=self.cfg.get("tpu.ivf.nprobe", 4),
            index_params={k: vs[k] for k in (
                "pq_m", "pq_rerank", "pq_impl", "lsh_bits", "hnsw_m",
                "ef_construction", "ef_search") if k in vs},
        )
        emb = (self.em.encode_atomic_notes(self.notes) if embeddings is None
               else embeddings)
        self.retriever.build_index(self.notes, emb)
        # the one f32 copy of the corpus the per-query stages read
        self.embeddings = torch.as_tensor(emb).to(self.device, torch.float32)
        self._idx_of_cache = None      # note_id -> row (static notes)

        # --- sparse ----------------------------------------------------------
        bm = self.cfg.get("hybrid_search.bm25", {}) or {}
        self.bm25 = BM25Index(self.notes, text_field=bm.get("corpus_field", "title_raw_span"),
                              k1=bm.get("k1", 1.2), b=bm.get("b", 0.75),
                              device=self.device)

        # --- graph -----------------------------------------------------------
        self.multi_hop_enabled = bool(self.cfg.get("retrieval.multi_hop.enabled", True))
        mh_kwargs = {
            "max_hops": self.cfg.get("retrieval.multi_hop.max_hops", 3),
            "max_paths": self.cfg.get("retrieval.multi_hop.max_paths", 10),
            "min_path_score": self.cfg.get("retrieval.multi_hop.min_path_score", 0.3),
            "min_path_score_floor": self.cfg.get("retrieval.multi_hop.min_path_score_floor", 0.1),
            "min_path_score_step": self.cfg.get("retrieval.multi_hop.min_path_score_step", 0.05),
            "path_diversity_threshold": self.cfg.get(
                "retrieval.multi_hop.path_diversity_threshold", 0.7),
            "max_initial_candidates": self.cfg.get(
                "retrieval.multi_hop.max_initial_candidates", 20),
        }
        self.multi_hop = MultiHopQueryProcessor(
            notes=self.notes, embeddings=self.embeddings, graph_file=graph_file,
            retriever_kwargs=mh_kwargs, device=self.device,
        ) if self.multi_hop_enabled else None

        # literal-keyed note graph for the relation-chain answer selector
        self.note_graph = NoteGraph.from_config(self.cfg)
        self.note_graph.add_notes(self.notes)

        # --- entity inverted index --------------------------------------------
        self.entity_index = EntityInvertedIndex()
        self.entity_index.build_index(self.notes, extract_from_text=False)

        # --- stages & helpers ---------------------------------------------------
        hs = self.cfg.get("hybrid_search", {}) or {}
        self.fusion_dense_w = (hs.get("linear") or {}).get("vector_weight", 1.0)
        self.fusion_sparse_w = 0.6   # the v2 fusion constant
        lf = hs.get("lexical_fallback") or {}
        self.lexical_fallback_enabled = lf.get("enabled", True)
        self.miss_penalty = lf.get("miss_penalty", 0.6)
        self.noise_threshold = lf.get("noise_threshold", 0.20)
        self.section_filtering_enabled = (hs.get("section_filtering") or {}).get("enabled", True)
        th = hs.get("two_hop_expansion") or {}
        self.two_hop_enabled = th.get("enabled", True)
        self.two_hop_top_m = th.get("top_m_candidates", 20)
        self.two_hop_max_second = th.get("max_second_hop_candidates", 15)
        safety = self.cfg.get("safety", {}) or {}
        self.per_hop_keep_top_m = safety.get("per_hop_keep_top_m", 5)
        self.lower_threshold = safety.get("lower_threshold", 0.1)
        cluster = safety.get("cluster") or {}
        self.cluster_suppress_enabled = cluster.get("enabled", False)
        self.cluster_cos_threshold = cluster.get("cos_threshold", 0.85)
        self.keep_per_cluster = cluster.get("keep_per_cluster", 3)
        self.candidate_pool = self.cfg.get("retrieval.candidate_pool", 50)

        self.path_ranker = PathAwareRanker() if self.cfg.get("path_aware.enabled", True) else None
        ro_cfg = self.cfg.get("recall_optimizer", {}) or {}
        self.recall_optimizer = EnhancedRecallOptimizer(
            retrieve_fn=lambda q: self.retriever.retrieve(q, top_k=10, threshold=0.0),
            multi_hop_enabled=bool(ro_cfg.get("multi_hop_enabled", False)),
            max_hops=int(ro_cfg.get("max_hops", 3)),
            hop_similarity_threshold=float(
                ro_cfg.get("hop_similarity_threshold", 0.15)),
            comprehensive_rerank=bool(
                ro_cfg.get("comprehensive_rerank", False)))
        self.reranker = (
            ListwiseReranker(max_candidates=self.cfg.get("rerank.listt5_input_topk", 24),
                             backend=self.cfg.get("rerank.backend", "lexical"),
                             checkpoint=self.cfg.get("rerank.checkpoint", None),
                             embedding_manager=self.em, device=self.device)
            if self.cfg.get("rerank.enabled", False) else None
        )
        self.dispatcher_enabled = bool(self.cfg.get("context_dispatcher.enabled", True))
        gar = None
        use_graph_aware = bool(self.cfg.get("context_dispatcher.use_graph_aware", False)
                               or self.cfg.get("retrieval.use_graph_rerank", False))
        if use_graph_aware and self.multi_hop is not None:
            from anorag_tpu_torch.graph.graph_retrieval import GraphAwareRetrieval

            gar = GraphAwareRetrieval(
                self.multi_hop.graph_index,
                radius=self.cfg.get("retrieval.subgraph_radius", 2),
                edge_threshold=self.cfg.get("retrieval.edge_thresh", 0.35),
                alpha=self.cfg.get("retrieval.alpha", 0.5),
                beta=self.cfg.get("retrieval.beta", 0.3),
                gamma=self.cfg.get("retrieval.gamma", 0.2),
                length_penalty=self.cfg.get("retrieval.lambda_len", 0.05),
                overlap_penalty=self.cfg.get("retrieval.overlap_thresh", 0.5),
            )
            self.cfg.set("context_dispatcher.use_graph_aware", True)
            self.cfg.set("context_dispatcher.token_budget",
                         self.cfg.get("retrieval.token_budget", 1800))
        self.dispatcher = ContextDispatcher.from_config(self.cfg, graph_aware_retrieval=gar)
        self.scheduler = MultiHopContextScheduler(
            max_notes=self.cfg.get("context.max_notes_for_llm", 20),
            hop_decay=self.cfg.get("hybrid_search.multi_hop.hop_decay", 0.85),
        )
        self.diversity = DiversityScheduler()
        self.evidence_reranker = EvidenceReranker(self.cfg.get("evidence_rerank", {}) or {})
        self.path_validator = PathValidator(
            rel_chains=self.cfg.get("answering.rel_chains", []),
            allow_partial=self.cfg.get("validator.allow_partial", True),
        )
        self.verifier = AnswerVerifier()
        # structured answer-first packing is the default, with legacy
        # fallback inside pack_context on any structured-path error
        from anorag_tpu_torch.context.structure_pack import StructurePacker

        use_structure = not bool(self.cfg.get("context.use_legacy_packing", False))
        self.qa_scorer = None
        structure_packer = None
        if use_structure:
            from anorag_tpu_torch.reasoning.qa_coverage import QACoverageScorer

            self.qa_scorer = QACoverageScorer()
            structure_packer = StructurePacker(
                token_budget=self.cfg.get("context.max_tokens") or 1800,
                qa_scorer=self.qa_scorer,
            )
        self.packer = ContextPacker(max_tokens=self.cfg.get("context.max_tokens"),
                                    k_estimator=KEstimator(),
                                    use_structure=use_structure,
                                    structure_packer=structure_packer)
        self.subq_planner = SubQuestionPlanner(llm)
        self.evidence_merger = EvidenceMerger(
            strategy=self.cfg.get("query.merge_strategy", "weighted"))
        self.answer_selector_enabled = bool(self.cfg.get("answer_selector.enabled", True))
        self.answer_selector_before_llm = bool(
            self.cfg.get("answer_selector.apply_before_llm", True))
        self._load_calibration()
        self.metrics = StructuredLogger(
            "anorag.metrics",
            sink_path=str(self.work_dir / "retrieval_metrics.jsonl") if self.work_dir else None,
        )

    def _load_calibration(self) -> None:
        """Ingest calibration.json (training/calibrate.py output): listwise
        fusion weight, span-picker weights."""
        path = self.cfg.get("calibration.path", "") or ""
        if not path or not Path(path).exists():
            return
        try:
            from anorag_tpu_torch.utils.file_io import read_json

            cal = read_json(path)
            comps = cal.get("components", cal)
            lw = (comps.get("listwise") or {}).get("listt5_weight")
            if lw is not None:
                self.cfg.set("calibration.listt5_weight", float(lw))
            lfw = comps.get("learned_fusion") or {}
            if "dense_weight" in lfw:
                self.fusion_dense_w = float(lfw["dense_weight"])
            if "bm25_weight" in lfw:
                self.fusion_sparse_w = float(lfw["bm25_weight"])
            ke = (comps.get("k_estimator") or {}).get("complexity_per_k")
            if ke is not None:
                self.packer.k_estimator.thresholds["complexity_per_k"] = float(ke)
            # trained answer-path heads: verifier entailment head + nested
            # span picker head + the structure packer's QA coverage head
            self.verifier.load_calibration(comps)
            if self.qa_scorer is not None:
                self.qa_scorer.load_calibration(comps)
            logger.info("calibration loaded from %s", path)
        except Exception as e:
            logger.warning("calibration load failed: %s", e)

    def default_top_k(self) -> int:
        return self.cfg.get("context.max_notes_for_llm", 20)

    # ======================================================================
    # entry
    # ======================================================================
    def process_batch(self, queries: Sequence[str], dataset: Optional[str] = None,
                      top_k: Optional[int] = None) -> List[Dict[str, Any]]:
        """One device pass answers the whole batch's retrieval (the fused
        dense + BM25 candidate union of the top_k notes), then the host
        answer stages run per query on the rows of the dataset namespace
        `dataset` (all when None)."""
        handle = self.retriever.hybrid_search_dispatch(
            list(queries), top_k=top_k or self.default_top_k())
        return self._assemble_batch(self.retriever.hybrid_search_finalize(handle),
                                    queries, dataset)

    def _assemble_batch(self, batches: List[List[Dict[str, Any]]],
                        queries: Sequence[str],
                        dataset: Optional[str]) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for query, selected in zip(queries, batches):
            selected = filter_notes_by_namespace(selected, dataset)
            selected = self._post_select_processing(selected, selected, query)
            payload = self._answer(query, selected, selected, [])
            out.append({
                "query": query,
                "answer": payload["answer"],
                "predicted_answer": payload["answer"],
                "predicted_support_idxs": payload["support_idxs"],
                "predicted_answerable": payload["answerable"],
                "answer_method": payload["method"],
                "notes": selected,
            })
        return out

    def process_stream(self, batches: Iterable[Sequence[str]],
                       dataset: Optional[str] = None,
                       top_k: Optional[int] = None,
                       depth: int = 3,
                       prefetch: Optional[int] = None):
        """Pipelined batched answering with several device batches in
        flight: a producer thread encodes and dispatches up to `depth`
        batches' searches (CUDA work is asynchronous, so the card computes
        while the host works) into a bounded queue; the calling thread
        drains it in order, waiting for batch i's results and running its
        host answer stages while the batches after it compute. Per-batch
        stage timings (dispatch / device wait / host) go to the metrics
        sink as `serving_stage_times`. Yields one result list per input
        batch, in order."""
        import queue as _queue
        import threading
        import time as _time

        if prefetch is not None:   # back-compat alias
            depth = prefetch
        top_k = top_k or self.default_top_k()
        q: _queue.Queue = _queue.Queue(maxsize=max(1, depth))
        _STOP = object()

        def producer():
            try:
                for batch in batches:
                    t0 = _time.perf_counter()
                    handle = self.retriever.hybrid_search_dispatch(
                        list(batch), top_k=top_k)
                    q.put((handle, list(batch), _time.perf_counter() - t0))
            finally:
                q.put(_STOP)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        while True:
            item = q.get()
            if item is _STOP:
                break
            handle, batch, dispatch_s = item
            t1 = _time.perf_counter()
            rows = self.retriever.hybrid_search_finalize(handle)
            t2 = _time.perf_counter()
            out = self._assemble_batch(rows, batch, dataset)
            t3 = _time.perf_counter()
            self.metrics.log(
                "serving_stage_times", batch=len(batch),
                dispatch_ms=round(dispatch_s * 1e3, 2),
                device_wait_ms=round((t2 - t1) * 1e3, 2),
                host_ms=round((t3 - t2) * 1e3, 2),
            )
            yield out
        th.join()

    # ======================================================================
    # the per-query pipeline
    # ======================================================================
    @log_performance
    def _note_idx_map(self) -> Dict[str, int]:
        """note_id -> row, built once (notes are static)."""
        if self._idx_of_cache is None:
            self._idx_of_cache = {n["note_id"]: i for i, n in enumerate(self.notes)}
        return self._idx_of_cache

    def _query_embedding(self, query: str) -> np.ndarray:
        """The query's (D,) f32 embedding as the reference has it (numpy)."""
        return self.em.encode_queries([query])[0].float().cpu().numpy()

    def _rows(self, rows: Sequence[int]) -> torch.Tensor:
        """Embedding rows, gathered on the device."""
        return self.embeddings[torch.as_tensor(np.asarray(rows, np.int64),
                                               device=self.device)]

    def process(self, query: str, dataset: Optional[str] = None,
                qid: Optional[str] = None) -> Dict[str, Any]:
        """One query through the full pipeline (the reference's stages 1-12):
        the answer dict of process_batch plus candidate_notes, context and
        trace."""
        # canonicalize paraphrased surfaces (meta preambles, synonym
        # vocabulary) before ANY stage parses the question — entity spans
        # are never rewritten so retrieval keys stay intact
        from anorag_tpu_torch.utils.lexnorm import normalize_question
        query = normalize_question(query)
        if self.cfg.get("query.use_subquestion_decomposition", False):
            return self._process_with_subquestion_decomposition(query, dataset, qid)
        return self._process_traditional(query, dataset, qid)

    def _process_traditional(self, query: str, dataset: Optional[str] = None,
                             qid: Optional[str] = None) -> Dict[str, Any]:
        trace: Dict[str, Any] = {"query": query, "qid": qid}

        # [1] dense recall (embed_topk_hop1 pool)
        dense = self.retriever.search(
            [query],
            top_k=self.cfg.get("retrieval.embed_topk_hop1",
                               self.cfg.get("vector_store.top_k", 20)),
            threshold=0.0)[0]
        # [2] namespace stage 1
        dense = filter_notes_by_namespace(dense, dataset)
        trace["n_dense"] = len(dense)

        # BM25 recall pool (bm25_topk_hop1)
        bm25_scores, bm25_idx = self.bm25.topk(
            query, k=min(self.cfg.get("retrieval.bm25_topk_hop1", 40), len(self.notes)))
        sparse_pool = []
        for s, i in zip(bm25_scores, bm25_idx):
            if s <= 0:
                continue
            note = dict(self.notes[int(i)])
            note["sparse_score"] = float(s)
            sparse_pool.append(note)
        candidates = self._union(dense, sparse_pool)

        # [3] enhanced hybrid v2
        candidates = self._enhanced_hybrid_search_v2(query, candidates)
        trace["n_fused"] = len(candidates)

        # [4] two-hop expansion
        bridge_entities: List[str] = []
        if self.two_hop_enabled and candidates:
            candidates, bridge_entities = self._two_hop_expansion(query, candidates)
        trace["bridge_entities"] = bridge_entities

        # cluster suppression
        if self.cluster_suppress_enabled:
            candidates = self._cluster_suppress(candidates)

        # [5] path-aware rerank
        if self.path_ranker and candidates:
            candidates = self.path_ranker.rerank_candidates(query, candidates)

        # [6] recall optimization
        candidates = self.recall_optimizer.optimize_recall(query, candidates,
                                                           top_k=self.candidate_pool)

        # [7] graph expansion
        if self.multi_hop is not None and candidates:
            q_emb = self._query_embedding(query)
            g_notes, _ = self.multi_hop.retrieve(
                query_emb=q_emb,
                top_k=self.cfg.get("retrieval.graph.expand_top_m", 20),
                keywords=tokenize_no_stop(query)[:8],
                entities=extract_entities_fallback(query),
            )
            candidates = self._union(candidates, filter_notes_by_namespace(g_notes, dataset))

        # [8] multi-hop safety net
        candidates = self._filter_with_multihop_safety(candidates)
        trace["n_after_safety"] = len(candidates)

        # [9] dispatch / schedule + post-select
        if self.dispatcher_enabled:
            selected = self.dispatcher.dispatch(candidates, query)
        else:
            selected = self.scheduler.schedule_for_multi_hop(
                candidates, bridge_entity=bridge_entities[0] if bridge_entities else None)
        selected = self._post_select_processing(selected, candidates, query)

        # [10] namespace stage 4 + bm25 fallback
        selected = filter_notes_by_namespace(selected, dataset)
        if not selected:
            selected = self._bm25_namespace_fallback(query, dataset)
        if not selected and self.cfg.get("hybrid_search.fallback.query_rewrite_enabled", True):
            # last-resort rewrite + dense retry
            from anorag_tpu_torch.retrieval.query_planner import LLMBasedRewriter

            rewritten = LLMBasedRewriter(
                self.llm.generate if self.llm else None
            ).rewrite_query(query, extract_entities_fallback(query))
            if rewritten != query:
                selected = self.retriever.retrieve(rewritten, top_k=10, threshold=0.0)
                trace["rewritten_query"] = rewritten
        trace["n_selected"] = len(selected)

        # [11] answer
        answer_payload = self._answer(query, selected, candidates, bridge_entities)

        # [12] audit
        audit = self._write_final_recall(selected, qid)
        trace.update(audit)
        self.metrics.log_retrieval_metrics(
            qid=qid, n_dense=trace.get("n_dense"), n_fused=trace.get("n_fused"),
            n_after_safety=trace.get("n_after_safety"), n_selected=len(selected),
            bridges=len(bridge_entities), method=answer_payload["method"],
        )

        return {
            "query": query,
            "answer": answer_payload["answer"],
            "predicted_answer": answer_payload["answer"],
            "predicted_support_idxs": answer_payload["support_idxs"],
            "predicted_answerable": answer_payload["answerable"],
            "answer_method": answer_payload["method"],
            "notes": selected,
            "candidate_notes": candidates,
            "context": answer_payload.get("context", ""),
            "trace": trace,
        }

    # ------------------------------------------------------------ stages
    @staticmethod
    def _union(a: List[Dict[str, Any]], b: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        seen = {n.get("note_id") for n in a}
        out = list(a)
        for n in b:
            if n.get("note_id") not in seen:
                out.append(n)
                seen.add(n.get("note_id"))
        return out

    def _enhanced_hybrid_search_v2(
        self,
        query: str,
        candidates: List[Dict[str, Any]],
        must_have_terms: Optional[Sequence[str]] = None,
        boost_entities: Optional[Sequence[str]] = None,
        boost_predicates: Optional[Sequence[str]] = None,
    ) -> List[Dict[str, Any]]:
        """final_base = 1.0*dense + 0.6*sparse with penalties/boosts; zero
        scores are filtered; optional listwise rerank on the head. The
        dense cosines of the candidates that carry none are one gathered
        matvec on the device with the corpus's cached row norms
        (ops.graph.cosines)."""
        if not candidates:
            return []
        idx_of = self._note_idx_map()
        rows = np.array([idx_of.get(c.get("note_id"), -1) for c in candidates],
                        np.int64)
        dense = np.zeros(len(candidates), np.float32)
        if self.embeddings is not None:
            need = np.array(["similarity" not in c for c in candidates]) & (rows >= 0)
            if need.any():
                q = self.em.encode_queries([query])[0]
                dense[need] = cosines(self.embeddings, q, rows[need]).cpu().numpy()
        for j, c in enumerate(candidates):
            if "similarity" in c:
                dense[j] = float(c["similarity"])
        all_sparse = self.bm25.scores([query], normalize=True)[0] if len(self.notes) else np.zeros(0)
        sparse = np.array([
            float(c.get("sparse_score", all_sparse[i] if i >= 0 else 0.0))
            for c, i in zip(candidates, rows)
        ], np.float32)

        final = self.fusion_dense_w * dense + self.fusion_sparse_w * sparse
        if self.section_filtering_enabled:
            final = final * self._section_penalties(query, candidates)
        if self.lexical_fallback_enabled and must_have_terms:
            has = self._satisfies_terms(candidates, must_have_terms)
            final = np.where(has, final, final * self.miss_penalty)
        else:
            has = np.zeros(len(candidates), bool)
        final = np.where((final < self.noise_threshold) & ~has, 0.0, final)
        if boost_entities:
            be = {e.lower() for e in boost_entities}
            hit = np.array([
                bool(be & {str(e).lower() for e in (c.get("entities") or [])})
                for c in candidates])
            final = np.where(hit, final * 1.2, final)
        if boost_predicates:
            bp = [p.lower() for p in boost_predicates]
            hit = np.array([any(p in (c.get("content") or "").lower() for p in bp)
                            for c in candidates])
            final = np.where(hit, final * 1.15, final)

        out = []
        for c, f, d, s in zip(candidates, final, dense, sparse):
            if f <= 0:
                continue
            m = dict(c)
            m["final_base_score"] = float(f)
            m["final_score"] = float(f)
            m["dense_score"] = float(d)
            m["sparse_score"] = float(s)
            out.append(m)
        out.sort(key=lambda c: -c["final_base_score"])

        if self.reranker and out:
            topk = self.cfg.get("rerank.listt5_input_topk", 24)
            head = out[:topk]
            scores = self.reranker.score(query, head)
            fused = sort_desc(fuse_scores(head, scores,
                                          {"listt5_weight": self.cfg.get(
                                              "calibration.listt5_weight", 0.35)}),
                              "fused_score")
            keep = self.cfg.get("rerank.keep_after_listt5", 16)
            out = fused[:keep] + out[topk:]
        return out

    def _section_penalties(self, query: str, candidates) -> np.ndarray:
        """Main-entity-related section filter: candidates whose title shares
        nothing with the query's entities get a soft penalty."""
        q_ents = {e.lower() for e in extract_entities_fallback(query)}
        q_toks = set(tokenize_no_stop(query))
        out = np.ones(len(candidates), np.float32)
        if not q_ents and not q_toks:
            return out
        for j, c in enumerate(candidates):
            title_toks = set(tokenize_no_stop(c.get("title") or ""))
            ents = {str(e).lower() for e in (c.get("entities") or [])}
            related = bool(title_toks & q_toks) or bool(ents & q_ents)
            if not related:
                out[j] = 0.85
        return out

    @staticmethod
    def _satisfies_terms(candidates, terms) -> np.ndarray:
        t = [x.lower() for x in terms]
        return np.array([
            all(x in f"{c.get('title','')} {c.get('content','')}".lower() for x in t)
            for c in candidates
        ])

    # two-hop ---------------------------------------------------------------
    def _extract_entities_from_candidates(self, candidates, top_m: int) -> List[str]:
        """Bridge candidates ordered by the RANK of the best candidate that
        carries them (ties by frequency): raw frequency alone promotes
        distractor entities over the true bridge in the top-ranked hop-1
        note."""
        first_rank: Dict[str, int] = {}
        counts: Dict[str, int] = {}
        for rank, c in enumerate(candidates[:top_m]):
            for e in c.get("entities") or []:
                e = str(e)
                first_rank.setdefault(e, rank)
                counts[e] = counts.get(e, 0) + 1
        return sorted(counts, key=lambda e: (first_rank[e], -counts[e]))[:10]

    def _two_hop_expansion(self, query, candidates):
        candidate_bridges = self._extract_entities_from_candidates(candidates, self.two_hop_top_m)
        q_ents = {e.lower() for e in extract_entities_fallback(query)}
        candidate_bridges = [b for b in candidate_bridges if b.lower() not in q_ents][:5]
        added: List[Dict[str, Any]] = []
        bridges: List[str] = []   # only bridges that actually mediated an expansion
        have = {c.get("note_id") for c in candidates}
        idx_of = self._note_idx_map()
        for b in candidate_bridges:
            pool_ids = self.entity_index.lookup(b, fuzzy=False)
            # an entity that links 2+ notes mediates a path even when its
            # hop-2 notes were already recalled directly — record it so the
            # answer stage's bridge/path reasoning sees the true bridge
            if len(pool_ids) >= 2 and b not in bridges:
                bridges.append(b)
            pool_notes = []
            for nid in pool_ids:
                if nid in have:
                    continue
                i = idx_of.get(nid)
                if i is not None:
                    pool_notes.append(dict(self.notes[i]))
            if not pool_notes:  # fallback: dense retrieval on bridge+query
                pool_notes = [
                    n for n in self.retriever.retrieve(f"{b} {query}", top_k=5, threshold=0.0)
                    if n.get("note_id") not in have
                ]
            # rescore second-hop pool against "bridge + query"
            if pool_notes:
                scored = self._enhanced_hybrid_search_v2(f"{b} {query}", pool_notes)
                hop2 = scored[: self.two_hop_max_second]
                if hop2 and b not in bridges:
                    bridges.append(b)
                for n in hop2:
                    n["hop_no"] = 2
                    n["bridge_entity"] = b
                    n["bridge_path"] = [b]
                    n["retrieval_method"] = "prf_bridge"
                    n["final_score"] = float(n.get("final_base_score", 0.0)) * 0.8
                    added.append(n)
                    have.add(n.get("note_id"))
        return candidates + added, bridges

    def _cluster_suppress(self, candidates):
        """Near-duplicate suppression: within cosine >= threshold clusters,
        keep the top `keep_per_cluster`. The candidates' rows are gathered
        and their cosines taken on the device."""
        if len(candidates) < 2 or self.embeddings is None:
            return candidates
        idx_of = self._note_idx_map()
        rows = np.array([idx_of.get(c.get("note_id"), -1) for c in candidates], np.int64)
        emb = torch.where(torch.as_tensor(rows >= 0, device=self.device)[:, None],
                          self._rows(np.maximum(rows, 0)), 0.0)
        emb = emb / torch.linalg.vector_norm(emb, dim=1, keepdim=True).clamp_min(1e-9)
        sims = (emb @ emb.T).cpu().numpy()
        kept: List[int] = []
        owners: List[int] = []   # cluster representatives only — a kept
        # MEMBER must not own later candidates (it has no count entry;
        # chaining through members also lets a cluster grow unboundedly)
        cluster_count: Dict[int, int] = {}
        for j in range(len(candidates)):
            owner = next((k for k in owners if sims[j, k] >= self.cluster_cos_threshold), None)
            if owner is None:
                kept.append(j)
                owners.append(j)
                cluster_count[j] = 1
            elif cluster_count[owner] < self.keep_per_cluster:
                kept.append(j)
                cluster_count[owner] += 1
        return [candidates[j] for j in sorted(kept)]

    def _filter_with_multihop_safety(self, candidates):
        """Per-hop top-M keepalive + lower threshold for the rest."""
        by_hop: Dict[int, List[Dict[str, Any]]] = {}
        for c in candidates:
            by_hop.setdefault(int(c.get("hop_no", 1)), []).append(c)
        kept = []
        for hop, group in by_hop.items():
            group.sort(key=lambda c: -float(c.get("final_score", 0.0)))
            kept.extend(group[: self.per_hop_keep_top_m])
            kept.extend(
                c for c in group[self.per_hop_keep_top_m:]
                if float(c.get("final_score", 0.0)) >= self.lower_threshold
            )
        kept.sort(key=lambda c: -float(c.get("final_score", 0.0)))
        return kept

    def _bm25_namespace_fallback(self, query, dataset):
        s, idx = self.bm25.topk(query, k=10)
        out = []
        for score, i in zip(s, idx):
            if score <= 0:
                continue
            n = dict(self.notes[int(i)])
            n["final_score"] = float(score)
            n["retrieval_method"] = "bm25"
            out.append(n)
        return filter_notes_by_namespace(out, dataset)

    # ======================================================================
    # answer stages
    # ======================================================================
    def _post_select_processing(self, selected, candidates, query):
        selected = self.evidence_reranker.rerank(selected, query)
        return self.path_validator.ensure_valid_bundle(selected, candidates, query)

    @staticmethod
    def _question_subject_covered(query: str, selected) -> bool:
        """Unanswerable gate signal: does ANY extracted question entity
        surface in the selected evidence? An entity is covered by a full
        word-boundary phrase match or by a strict majority of its tokens
        within one entity surface — liberal coverage so the gate fires only
        when the KB plainly knows nothing about the question's subject."""
        ents = [e for e in extract_entities_fallback(query) if len(e) >= 4]
        if not ents:
            return True        # nothing to check: assume answerable
        texts = [f"{n.get('title','')} {n.get('content','')}".lower()
                 for n in selected]
        blob = " \n ".join(texts)
        # partial-token coverage is judged against single ENTITY surfaces,
        # not raw text: two different entities' fragments must not cover
        # one question entity between them
        surfaces = set()
        for n in selected:
            if n.get("title"):
                surfaces.add(str(n["title"]).lower())
            for s in (n.get("entities") or []):
                surfaces.add(str(s).lower())
        for e in ents:
            el = e.lower()
            if re.search(r"\b" + re.escape(el) + r"\b", blob):
                return True
            toks = [t for t in el.split() if len(t) >= 3]
            if toks:
                for surf in surfaces:
                    hits = sum(1 for t in toks
                               if re.search(r"\b" + re.escape(t) + r"\b",
                                            surf))
                    # strict majority within ONE entity surface: a shared
                    # suffix word alone ("... Horizon") must not count a
                    # 2-token ghost entity as covered
                    if hits * 2 > len(toks) or hits == len(toks):
                        return True
        return False

    # verb stems (first 6 chars) that some relation lexicon or paraphrase
    # bank covers — their facts may be stated through cue paraphrases the
    # stem test would miss, so the relation gate never fires on them
    _KNOWN_REL_STEMS = {
        "perfor", "record", "releas", "sang", "sung", "founde", "establ",
        "starte", "create", "formed", "direct", "marrie", "wed", "born",
        "joined", "issued", "reissu", "credit", "locate", "publis",
        "made", "built", "wrote", "writte", "member",
    }

    def _question_relation_covered(self, query: str, selected) -> bool:
        m = re.match(r"\s*who\s+([a-z]+ed)\b", (query or "").lower())
        if not m:
            return True
        stem = m.group(1)[:6]
        if any(stem.startswith(k[:6]) or k.startswith(stem)
               for k in self._KNOWN_REL_STEMS):
            return True
        blob = " ".join(f"{n.get('title', '')} {n.get('content', '')}"
                        for n in selected).lower()
        return stem[:5] in blob

    def _answer(self, query, selected, candidates, bridge_entities) -> Dict[str, Any]:
        out = self._answer_stages(query, selected, candidates, bridge_entities)
        # polar-question guard, as a post-filter: a yes/no-shaped question
        # is never answered with an entity span. The selector, EFSA and LLM
        # paths still run (an LLM can answer a polar question the exact-math
        # stages declined); only non-polar outputs become insufficient.
        if _is_polar_question(query):
            ans = re.sub(r"[.!?\s]+$", "", str(out.get("answer") or "")).strip().lower()
            if ans not in ("yes", "no", "insufficient information"):
                return {"answer": "insufficient information", "support_idxs": [],
                        "answerable": False, "method": "polar_gate",
                        "context": out.get("context", "")}
            out["answer"] = ans  # canonical lowercase yes/no
        return out

    def _answer_stages(self, query, selected, candidates, bridge_entities) -> Dict[str, Any]:
        context, support = self.packer.pack_context(selected, query)
        # (a0) exact math (comparative / temporal diff / yes-no / label-set
        # superlative / count) precedes the relation-chain selector and the
        # unanswerable gates: it resolves from the full note graph, so a
        # result is answerable by construction
        if self.cfg.get("answering.comparative.enabled", True):
            comp = answer_exact_math(query, self.note_graph, selected)
        else:
            comp = None
        if not comp:
            # unanswerable gate: when no question entity surfaces anywhere
            # in the evidence, answering would only hallucinate a
            # distractor
            if (self.cfg.get("answering.unanswerable_gate", True) and selected
                    and not self._question_subject_covered(query, selected)):
                return {"answer": "insufficient information",
                        "support_idxs": [],
                        "answerable": False, "method": "unanswerable_gate",
                        "context": context}
            # relation-coverage gate: "Who <verb>ed X?" whose verb is
            # outside every relation lexicon and whose stem appears nowhere
            # in the evidence: the asked relation is never stated
            if (self.cfg.get("answering.unanswerable_gate", True) and selected
                    and not self._question_relation_covered(query, selected)):
                return {"answer": "insufficient information",
                        "support_idxs": [],
                        "answerable": False, "method": "relation_gate",
                        "context": context}
        if comp:
            sup = comp["support_idxs"] or fill_support_idxs_noid(
                comp["answer"], selected, existing_idxs=[], query=query)
            return {"answer": comp["answer"], "support_idxs": sup,
                    "answerable": True, "method": comp["method"],
                    "context": context}
        # (a) relation-chain selector
        if self.answer_selector_enabled and self.answer_selector_before_llm:
            sel = answer_question(
                query, self.note_graph,
                anchor_top_k=self.cfg.get("answer_selector.anchor_top_k", 5),
                rel_chains=self.cfg.get("answering.rel_chains", []),
                relax_last_hop=self.cfg.get("answering.relax_last_hop", []),
                max_hops=self.cfg.get("multi_hop.max_hops", 4),
                beam_size=self.cfg.get("multi_hop.beam_size", 8),
                branch=self.cfg.get("multi_hop.branch_factor", 6),
            )
            if sel:
                id_to_note = {n["note_id"]: n for n in self.notes}
                chain_notes = [id_to_note[nid] for nid in sel["support_note_ids"]
                               if nid in id_to_note]
                # every hop of the resolved chain IS support — intermediate
                # hops carry neither the answer nor a question entity, so
                # the repair heuristics alone would drop them
                seed = [p for n in chain_notes
                        for p in (n.get("paragraph_idxs") or [])]
                ans, geo_sup = coerce_state_answer(
                    query, sel["answer"], self.note_graph, selected)
                sup = fill_support_idxs_noid(
                    ans, chain_notes or selected,
                    existing_idxs=list(dict.fromkeys(seed + geo_sup)),
                    query=query)
                return {"answer": ans, "support_idxs": sup,
                        "answerable": True, "method": "answer_selector",
                        "context": context}
        # (b) EFSA
        bridge, path_entities = extract_bridge_info_from_candidates(selected)
        # a ranked bridge list from the caller leads (the batched path has
        # none)
        bridge = (bridge_entities[0] if bridge_entities else None) or bridge
        # single-relation questions have no intermediate: the "bridge" may
        # BE the answer, so EFSA must not exclude it
        from anorag_tpu_torch.answer.answer_selector import (has_nested_hop_shape,
                                                             relation_cue_count)

        # multi-hop shape = >=2 lexicon cues OR structural nesting ('of the
        # X of Y')
        if bridge and relation_cue_count(query) < 2 and not has_nested_hop_shape(query):
            bridge = None
        efsa_ans, efsa_sup, efsa_score = efsa_answer_with_fallback(
            selected, query, bridge, path_entities,
            topN=self.cfg.get("context.max_notes_for_llm", 20),
            exclude_entities=extract_entities_fallback(query),
            who_person_boost=self.cfg.get("hybrid_search.answer_bias.who_person_boost", 1.10),
            type_gate=bool(self.cfg.get("hybrid_search.answer_bias.type_gate", True)),
            subject_cooc_boost=float(self.cfg.get(
                "hybrid_search.answer_bias.subject_cooc_boost", 1.0)),
        )
        efsa_threshold = self.cfg.get("answering.efsa_hint.threshold", 0.70)
        if self.llm is None:
            if efsa_ans is not None:
                efsa_ans, geo_sup = coerce_state_answer(
                    query, efsa_ans, self.note_graph, selected)
                sup = fill_support_idxs_noid(
                    efsa_ans or "", selected,
                    existing_idxs=[s for s in efsa_sup
                                   if isinstance(s, int)] + geo_sup,
                    query=query)
                verified = self.verifier.finalize_answer(query, efsa_ans, context)
                return {"answer": verified["answer"], "support_idxs": sup,
                        "answerable": True, "method": "efsa", "context": context}
            return {"answer": "insufficient information", "support_idxs": [],
                    "answerable": False, "method": "none", "context": context}
        if efsa_ans is not None and efsa_score >= efsa_threshold and not \
                self.cfg.get("answering.final_evidence_first", True):
            sup = [s for s in efsa_sup if isinstance(s, int)] or support
            return {"answer": efsa_ans, "support_idxs": sup, "answerable": True,
                    "method": "efsa", "context": context}
        # (c) LLM generation (evidence-first), EFSA answer as noisy hint
        hint = efsa_ans if self.cfg.get("answering.efsa_hint.enabled", True) else None
        gen = generate_final_answer(
            self.llm, query, selected, efsa_hint=hint,
            require_verbatim_spans=self.cfg.get("answering.require_verbatim_spans", True),
            force_insufficient_if_no_spans=self.cfg.get(
                "answering.force_insufficient_if_no_spans", True),
            max_retries=self.cfg.get("retry.max_times", 1),
        )
        answer = gen["answer"]
        answerable = not gen["insufficient"]
        if not answerable and efsa_ans is not None:
            answer, answerable = efsa_ans, True  # EFSA rescue
        sup = fill_support_idxs_noid(answer, selected,
                                     existing_idxs=gen["support_idxs"], query=query)
        return {"answer": answer, "support_idxs": sup, "answerable": answerable,
                "method": "llm", "context": gen["context"]}

    # audit -----------------------------------------------------------------------
    def _write_final_recall(self, selected, qid) -> Dict[str, Any]:
        if not self.work_dir:
            return {}
        self.work_dir.mkdir(parents=True, exist_ok=True)
        path = self.work_dir / "final_recall.jsonl"
        rows = [
            {k: v for k, v in n.items() if not isinstance(v, (np.ndarray,))}
            for n in selected
        ]
        write_jsonl(path, rows)
        sha_written = jsonl_sha1(rows)
        sha_read = jsonl_sha1(read_jsonl(path))
        assert sha_written == sha_read, "final_recall.jsonl readback mismatch"
        return {"final_recall_path": str(path), "final_recall_sha1": sha_written}

    # ======================================================================
    # sub-question decomposition path
    # ======================================================================
    def _process_with_subquestion_decomposition(self, query, dataset=None, qid=None):
        subs = self.subq_planner.plan(query)
        per_sub: Dict[str, List[Dict[str, Any]]] = {}
        for sq in subs:
            res = self._process_traditional(sq, dataset, qid=None)
            per_sub[sq] = res["notes"]
        q_emb = self._query_embedding(query)
        # the merged notes' rows, gathered on the device in one call
        idx_of = self._note_idx_map()
        ids = list(dict.fromkeys(
            n["note_id"] for notes in per_sub.values() for n in notes
            if idx_of.get(n.get("note_id")) is not None))
        note_embs = {}
        if ids and self.embeddings is not None:
            rows = self._rows([idx_of[nid] for nid in ids]).cpu().numpy()
            note_embs = dict(zip(ids, rows))
        merged = self.evidence_merger.merge_evidence(
            per_sub, query_emb=q_emb, note_embeddings=note_embs,
            top_k=self.cfg.get("context.max_notes_for_llm", 20),
        )
        bridge_entities: List[str] = []
        answer_payload = self._answer(query, merged, merged, bridge_entities)
        audit = self._write_final_recall(merged, qid)
        return {
            "query": query,
            "answer": answer_payload["answer"],
            "predicted_answer": answer_payload["answer"],
            "predicted_support_idxs": answer_payload["support_idxs"],
            "predicted_answerable": answer_payload["answerable"],
            "answer_method": answer_payload["method"],
            "notes": merged,
            "candidate_notes": merged,
            "sub_questions": subs,
            "merge_stats": self.evidence_merger.last_stats,
            "trace": {"qid": qid, **audit},
        }
