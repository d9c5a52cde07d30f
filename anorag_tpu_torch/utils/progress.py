"""Counterpart of anorag_tpu/utils/progress.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Progress tracking: JSONL progress records + simple console progress.

Parity target: upstream utils/progress_tracker.py (JSONLProgressTracker
used by DocumentProcessor) — one JSON line per step with timing, resumable
state inspection.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Any, Iterable, Iterator, Optional, TypeVar

from anorag_tpu_torch.utils.file_io import append_jsonl, read_jsonl

T = TypeVar("T")


class JSONLProgressTracker:
    def __init__(self, path: str | Path, task: str = "task"):
        self.path = Path(path)
        self.task = task
        self._t0 = time.time()

    def log_step(self, step: str, **fields: Any) -> None:
        append_jsonl(self.path, {
            "task": self.task, "step": step, "ts": time.time(),
            "elapsed_s": time.time() - self._t0, **fields,
        })

    def completed_steps(self) -> list:
        if not self.path.exists():
            return []
        return [r.get("step") for r in read_jsonl(self.path)]

    def is_done(self, step: str) -> bool:
        return step in self.completed_steps()


def progress(iterable: Iterable[T], total: Optional[int] = None,
             desc: str = "", every: int = 50,
             stream=sys.stderr) -> Iterator[T]:
    """tqdm-free progress iterator (logs every `every` items)."""
    t0 = time.time()
    n = 0
    for item in iterable:
        yield item
        n += 1
        if n % every == 0:
            rate = n / max(time.time() - t0, 1e-9)
            tot = f"/{total}" if total else ""
            print(f"{desc} {n}{tot} ({rate:.1f}/s)", file=stream)
