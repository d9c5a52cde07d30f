"""Counterpart of anorag_tpu/pipeline_musique.py, copied with its imports
renamed, except that process_musique_item and MusiqueProcessor take the
device (keyword only; the card unless the caller asks for the CPU) and pass
it to the DocumentProcessor and QueryProcessor of each item. The worker
threads share one EmbeddingManager and one LLM when the caller passes them
(main_musique.py does).

MuSiQue batch pipeline: per-item KB build + query + resume.

Parity target: upstream main_musique.py — per item: paragraphs ->
DocumentProcessor (fresh KB) -> QueryProcessor.process(question)
(:207-405); dataset loop with ThreadPool workers, a per-item timeout guard,
real-time jsonl appends, and continue-mode resume that skips ids already in
the output (:407-633). Optional Chain-of-Retrieval preprocessing
(--enable-cor, :246-259).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor, TimeoutError as FutTimeout, as_completed
from pathlib import Path
from typing import Any, Dict, List, Sequence

from anorag_tpu_torch.config import config as global_config
from anorag_tpu_torch.device import DeviceLike
from anorag_tpu_torch.doc.processor import DocumentProcessor
from anorag_tpu_torch.query.processor import QueryProcessor
from anorag_tpu_torch.utils.file_io import append_jsonl, read_jsonl, write_jsonl
from anorag_tpu_torch.utils.logging import get_logger

logger = get_logger("anorag.musique")


def musique_item_to_document(item: Dict[str, Any]) -> Dict[str, Any]:
    """One MuSiQue item -> one document payload with indexed paragraphs."""
    return {
        "id": str(item.get("id", "item")),
        "title": str(item.get("id", "")),
        "paragraphs": item.get("paragraphs") or [],
    }


def process_musique_item(
    item: Dict[str, Any],
    work_dir: str | Path,
    llm=None,
    cfg=None,
    embedding_manager=None,
    enable_cor: bool = False,
    *,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    cfg = cfg or global_config
    work_dir = Path(work_dir)
    dp = DocumentProcessor(work_dir / "kb", llm=llm, cfg=cfg,
                           embedding_manager=embedding_manager, device=device)
    kb = dp.process_documents(documents=[musique_item_to_document(item)])
    notes = kb["atomic_notes"]

    import numpy as np

    embeddings = np.load(kb["embeddings_path"]) if notes else None

    if enable_cor and notes:
        from anorag_tpu_torch.graph.note_graph import NoteGraph
        from anorag_tpu_torch.llm.cor_controller import chain_of_retrieval

        ng = NoteGraph.from_config(cfg)
        ng.add_notes(notes)
        cor_cfg = cfg.get("cor", {}) or {}
        cor = chain_of_retrieval(
            item.get("question", ""), ng,
            max_rounds=cor_cfg.get("max_rounds", 3),
            budget=cor_cfg.get("budget", 64),
            confidence_tau=cor_cfg.get("confidence_tau", 0.8),
        )
        logger.info("CoR: %d notes, coverage %.2f (%s)",
                    len(cor["notes"]), cor["coverage"], cor["stopped_reason"])

    qp = QueryProcessor(notes, embeddings=embeddings,
                        graph_file=kb.get("graph_file"),
                        llm=llm, cfg=cfg, embedding_manager=embedding_manager,
                        work_dir=str(work_dir), device=device)
    res = qp.process(item.get("question", ""), qid=str(item.get("id", "")))
    # per-item recall audit artifacts (parity: main_musique.py:357-372)
    def _slim(n):
        return {k: n.get(k) for k in (
            "note_id", "title", "final_score", "paragraph_idxs",
            "retrieval_method", "hop_no", "bridge_entity")}
    write_jsonl(Path(work_dir) / "atomic_notes_recall.jsonl",
                [_slim(n) for n in res.get("candidate_notes", [])])
    write_jsonl(Path(work_dir) / "selected_atomic_notes.jsonl",
                [_slim(n) for n in res.get("notes", [])])
    return {
        "id": item.get("id"),
        "predicted_answer": res["predicted_answer"],
        "predicted_support_idxs": res["predicted_support_idxs"],
        "predicted_answerable": res["predicted_answerable"],
        "answer_method": res.get("answer_method"),
    }


class MusiqueProcessor:
    def __init__(self, work_dir: str | Path, llm=None, cfg=None,
                 embedding_manager=None, max_workers: int = 2,
                 item_timeout: float = 300.0, enable_cor: bool = False, *,
                 device: DeviceLike = None):
        self.work_dir = Path(work_dir)
        self.work_dir.mkdir(parents=True, exist_ok=True)
        self.llm = llm
        self.cfg = cfg or global_config
        self.em = embedding_manager
        self.max_workers = max_workers
        self.item_timeout = item_timeout
        self.enable_cor = enable_cor
        self.device = device

    def process_dataset(
        self,
        items: Sequence[Dict[str, Any]],
        output_path: str | Path,
        resume: bool = True,
    ) -> List[Dict[str, Any]]:
        output_path = Path(output_path)
        done_ids = set()
        results: List[Dict[str, Any]] = []
        if resume and output_path.exists():
            results = read_jsonl(output_path)
            done_ids = {str(r.get("id")) for r in results}
            logger.info("resume: %d items already done", len(done_ids))
        todo = [it for it in items if str(it.get("id")) not in done_ids]

        def run(it: Dict[str, Any]) -> Dict[str, Any]:
            try:
                return process_musique_item(
                    it, self.work_dir / str(it.get("id")),
                    llm=self.llm, cfg=self.cfg, embedding_manager=self.em,
                    enable_cor=self.enable_cor, device=self.device,
                )
            except Exception as e:
                logger.warning("item %s failed: %s", it.get("id"), e)
                return {"id": it.get("id"), "predicted_answer": "",
                        "predicted_support_idxs": [], "predicted_answerable": False,
                        "error": str(e)}

        with ThreadPoolExecutor(max_workers=self.max_workers) as ex:
            futs = {ex.submit(run, it): it for it in todo}
            for f in as_completed(futs):
                it = futs[f]
                try:
                    row = f.result(timeout=self.item_timeout)
                except FutTimeout:
                    row = {"id": it.get("id"), "predicted_answer": "",
                           "predicted_support_idxs": [], "predicted_answerable": False,
                           "error": "timeout"}
                results.append(row)
                append_jsonl(output_path, row)   # real-time append
        return results
