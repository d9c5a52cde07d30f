"""QueryProcessor for the port: the batched served path, text in and
answers out.

Counterpart of anorag_tpu/query/processor.py: the constructor (:97-274)
with what the batched path builds, _load_calibration (:276-307),
process_batch (:337), _assemble_batch (:357), process_stream (:376-429),
filter_notes_by_namespace (:87), _is_polar_question (:83) and the answer
stages (:768-1006): _post_select_processing, the two coverage gates,
_answer and _answer_stages. Each query's retrieval rows go through the
dataset guard, the evidence rerank and the path validator, then exact
math, the unanswerable and relation gates, the relation-chain selector,
EFSA and, when an LLM client is given, evidence-first generation.

The per-query process() pipeline (two-hop expansion, graph expansion,
path rerank, the dispatcher) is not ported yet, nor the graph it reads:
a graph_file raises NotImplementedError, as sharded search does.
The retriever is built with the reference's dense-search settings
(index type, nlist, nprobe, threshold 0; the recall target is left
out, since every search route of the port is exact), so
qp.retriever.retrieve is what the reference's HTTP /search endpoint calls.
The options of the index types not ported (pq_*, lsh_bits, hnsw_m, ef_*)
are not passed on.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence

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
from anorag_tpu_torch.context.packer import ContextPacker
from anorag_tpu_torch.device import DeviceLike, resolve_device
from anorag_tpu_torch.graph.note_graph import NoteGraph
from anorag_tpu_torch.models.embedding_manager import EmbeddingManager
from anorag_tpu_torch.retrieval.retriever import VectorRetriever
from anorag_tpu_torch.support.k_estimator import KEstimator
from anorag_tpu_torch.utils.logging import StructuredLogger, get_logger
from anorag_tpu_torch.utils.text import extract_entities_fallback
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
        if str(self.cfg.get("tpu.sharded_search", "auto")).lower() == "on":
            raise NotImplementedError(
                "sharded search across devices is not ported yet (ROADMAP: "
                "the sharded branch)")
        if graph_file:
            raise NotImplementedError(
                "graph_file feeds the per-query graph pipeline (process()), "
                "which is not ported yet (ROADMAP, queue 1)")
        self.llm = llm
        self.work_dir = Path(work_dir) if work_dir else None
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

        # literal-keyed note graph for the relation-chain answer selector
        self.note_graph = NoteGraph.from_config(self.cfg)
        self.note_graph.add_notes(self.notes)

        # the fusion weights of process(); calibration may set them
        hs = self.cfg.get("hybrid_search", {}) or {}
        self.fusion_dense_w = (hs.get("linear") or {}).get("vector_weight", 1.0)
        self.fusion_sparse_w = 0.6

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
