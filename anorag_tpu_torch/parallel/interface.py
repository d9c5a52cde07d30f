"""ParallelInterface: facade + concrete task processors.

Counterpart of anorag_tpu/parallel/interface.py, copied with its imports
renamed, except that the processors that build a knowledge base take the
device (keyword only; the card unless the caller asks for the CPU) and pass
it to the DocumentProcessor or process_musique_item they run:
DocumentTaskProcessor (a DocumentProcessor per file, into
<output_root>/<file stem>), QueryTaskProcessor (QueryProcessor.process
against a shared knowledge base), MusiqueTaskProcessor (the full per-item
pipeline) and the `create_parallel_interface` factory.

Each document or MuSiQue task builds its own DocumentProcessor and, with no
embedding_manager given, its own encoder; tasks on worker threads share the
device's default stream.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Sequence

from anorag_tpu_torch.device import DeviceLike
from anorag_tpu_torch.parallel.engine import ParallelEngine, ParallelTask, Strategy, TaskProcessor


class DocumentTaskProcessor(TaskProcessor):
    name = "document"
    task_types = ("document",)

    def __init__(self, output_root: str | Path, llm=None, cfg=None, embedding_manager=None,
                 *, device: DeviceLike = None):
        self.output_root = Path(output_root)
        self.llm = llm
        self.cfg = cfg
        self.em = embedding_manager
        self.device = device

    def process_single_task(self, task: ParallelTask) -> Dict[str, Any]:
        from anorag_tpu_torch.doc.processor import DocumentProcessor

        file_path = str(task.data)
        out_dir = self.output_root / Path(file_path).stem
        dp = DocumentProcessor(out_dir, llm=self.llm, cfg=self.cfg,
                               embedding_manager=self.em, device=self.device)
        return dp.process_documents(file_paths=[file_path])

    def aggregate_results(self, results: List[Any]) -> Dict[str, Any]:
        notes = []
        for r in results:
            if isinstance(r, dict):
                notes.extend(r.get("atomic_notes", []))
        return {"atomic_notes": notes, "n_runs": len(results)}


class QueryTaskProcessor(TaskProcessor):
    name = "query"
    task_types = ("query",)

    def __init__(self, query_processor):
        self.qp = query_processor

    def process_single_task(self, task: ParallelTask) -> Dict[str, Any]:
        data = task.data if isinstance(task.data, dict) else {"query": task.data}
        return self.qp.process(data["query"], dataset=data.get("dataset"),
                               qid=data.get("qid"))


class MusiqueTaskProcessor(TaskProcessor):
    """Full per-item pipeline: build a fresh KB from the item's paragraphs,
    then answer its question (the reference's per-item flow,
    main_musique.py:207-405)."""

    name = "musique"
    task_types = ("musique",)

    def __init__(self, work_root: str | Path, llm=None, cfg=None,
                 embedding_manager=None, *, device: DeviceLike = None):
        self.work_root = Path(work_root)
        self.llm = llm
        self.cfg = cfg
        self.em = embedding_manager
        self.device = device

    def process_single_task(self, task: ParallelTask) -> Dict[str, Any]:
        from anorag_tpu_torch.pipeline_musique import process_musique_item

        return process_musique_item(
            task.data, self.work_root / str(task.task_id),
            llm=self.llm, cfg=self.cfg, embedding_manager=self.em,
            device=self.device,
        )


class ParallelInterface:
    def __init__(self, engine: ParallelEngine):
        self.engine = engine

    def process_documents(self, file_paths: Sequence[str]) -> Dict[str, Any]:
        tasks = [ParallelTask(str(i), "document", p) for i, p in enumerate(file_paths)]
        done = self.engine.process_tasks(tasks)
        proc = next(p for p in self.engine.processors if "document" in p.task_types)
        return {
            "results": proc.aggregate_results([t.result for t in done if t.error is None]),
            "errors": [{"task": t.task_id, "error": t.error} for t in done if t.error],
            "stats": self.engine.stats,
        }

    def process_queries(self, queries: Sequence[Any]) -> List[Dict[str, Any]]:
        tasks = [ParallelTask(str(i), "query", q) for i, q in enumerate(queries)]
        done = self.engine.process_tasks(tasks)
        return [t.result if t.error is None else {"error": t.error} for t in done]

    def process_musique_dataset(self, items: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
        tasks = [
            ParallelTask(str(it.get("id", i)), "musique", it)
            for i, it in enumerate(items)
        ]
        done = self.engine.process_tasks(tasks)
        return [t.result if t.error is None else
                {"id": t.task_id, "error": t.error} for t in done]


def create_parallel_interface(
    mode: str = "musique",
    work_dir: str | Path = "./result/parallel",
    llm=None,
    cfg=None,
    embedding_manager=None,
    query_processor=None,
    workers: int = 4,
    strategy: str = "hybrid",
    n_processors: int = 1,
    *,
    device: DeviceLike = None,
) -> ParallelInterface:
    procs: List[TaskProcessor] = []
    for _ in range(max(1, n_processors)):
        if mode == "document":
            procs.append(DocumentTaskProcessor(work_dir, llm, cfg, embedding_manager,
                                               device=device))
        elif mode == "query":
            assert query_processor is not None
            procs.append(QueryTaskProcessor(query_processor))
        else:
            procs.append(MusiqueTaskProcessor(work_dir, llm, cfg, embedding_manager,
                                              device=device))
    engine = ParallelEngine(procs, max_workers=workers, strategy=Strategy(strategy))
    return ParallelInterface(engine)
