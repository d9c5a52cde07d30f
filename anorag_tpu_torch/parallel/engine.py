"""ParallelEngine: generic task-parallel execution over processors.

Counterpart of anorag_tpu/parallel/engine.py, copied: strategies
DATA_REPLICATION (the same task to every processor, first success wins),
DATA_SPLITTING (tasks round-robin over the processors), TASK_DISTRIBUTION
(route by task type), HYBRID (auto-select: several types -> distribution,
>= 6 tasks -> splitting, else replication); ThreadPool workers; throughput
stats.

This is host-side orchestration of LLM-bound work: device parallelism
lives in anorag_tpu_torch.parallel.mesh / sharded_search.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Sequence


class Strategy(str, Enum):
    DATA_REPLICATION = "copy"
    DATA_SPLITTING = "split"
    TASK_DISTRIBUTION = "dispatch"
    HYBRID = "hybrid"


@dataclass
class ParallelTask:
    task_id: str
    task_type: str
    data: Any
    result: Any = None
    error: Optional[str] = None
    elapsed: float = 0.0


class TaskProcessor:
    """One worker backend (usually wrapping one LLM endpoint / pipeline)."""

    name = "processor"
    task_types: Sequence[str] = ()

    def process_single_task(self, task: ParallelTask) -> Any:
        raise NotImplementedError

    def aggregate_results(self, results: List[Any]) -> Any:
        return results


@dataclass
class ParallelStats:
    tasks_done: int = 0
    tasks_failed: int = 0
    total_time: float = 0.0
    wall_time: float = 0.0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def update(self, elapsed: float, ok: bool) -> None:
        with self._lock:
            self.tasks_done += ok
            self.tasks_failed += not ok
            self.total_time += elapsed

    @property
    def throughput(self) -> float:
        return self.tasks_done / self.wall_time if self.wall_time > 0 else 0.0

    @property
    def avg_latency(self) -> float:
        return self.total_time / max(self.tasks_done + self.tasks_failed, 1)


class ParallelEngine:
    def __init__(self, processors: Sequence[TaskProcessor], max_workers: int = 4,
                 strategy: Strategy | str = Strategy.HYBRID):
        assert processors
        self.processors = list(processors)
        self.max_workers = max_workers
        self.strategy = Strategy(strategy)
        self.stats = ParallelStats()

    # ---------------------------------------------------------- selection
    def _select_strategy(self, tasks: Sequence[ParallelTask]) -> Strategy:
        if self.strategy != Strategy.HYBRID:
            return self.strategy
        types = {t.task_type for t in tasks}
        if len(types) > 1 and len(self.processors) > 1:
            return Strategy.TASK_DISTRIBUTION
        if len(tasks) >= 6:
            return Strategy.DATA_SPLITTING
        return Strategy.DATA_REPLICATION

    # ------------------------------------------------------------- running
    def process_tasks(self, tasks: Sequence[ParallelTask]) -> List[ParallelTask]:
        t0 = time.perf_counter()
        strategy = self._select_strategy(tasks)
        if strategy == Strategy.DATA_SPLITTING:
            out = self._run_splitting(tasks)
        elif strategy == Strategy.TASK_DISTRIBUTION:
            out = self._run_distribution(tasks)
        else:
            out = self._run_replication(tasks)
        self.stats.wall_time += time.perf_counter() - t0
        return out

    def _run_one(self, proc: TaskProcessor, task: ParallelTask) -> ParallelTask:
        t0 = time.perf_counter()
        try:
            task.result = proc.process_single_task(task)
            ok = True
        except Exception as e:
            task.error = str(e)
            ok = False
        task.elapsed = time.perf_counter() - t0
        self.stats.update(task.elapsed, ok)
        return task

    def _run_splitting(self, tasks) -> List[ParallelTask]:
        """Round-robin shard tasks across processors, thread-parallel."""
        with ThreadPoolExecutor(max_workers=self.max_workers) as ex:
            futs = [
                ex.submit(self._run_one, self.processors[i % len(self.processors)], t)
                for i, t in enumerate(tasks)
            ]
            return [f.result() for f in futs]

    def _run_distribution(self, tasks) -> List[ParallelTask]:
        """Route each task to a processor that declares its task_type."""
        def pick(task: ParallelTask) -> TaskProcessor:
            for p in self.processors:
                if task.task_type in (p.task_types or ()):
                    return p
            return self.processors[0]

        with ThreadPoolExecutor(max_workers=self.max_workers) as ex:
            futs = [ex.submit(self._run_one, pick(t), t) for t in tasks]
            return [f.result() for f in futs]

    def _run_replication(self, tasks) -> List[ParallelTask]:
        """Every processor runs every task; first success wins per task."""
        out: List[ParallelTask] = []
        for t in tasks:
            winner: Optional[ParallelTask] = None
            with ThreadPoolExecutor(max_workers=len(self.processors)) as ex:
                futs = [
                    ex.submit(self._run_one, p,
                              ParallelTask(t.task_id, t.task_type, t.data))
                    for p in self.processors
                ]
                for f in as_completed(futs):
                    cand = f.result()
                    if cand.error is None and winner is None:
                        winner = cand
            out.append(winner or ParallelTask(t.task_id, t.task_type, t.data,
                                              error="all processors failed"))
        return out
