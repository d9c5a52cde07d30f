"""Counterpart of anorag_tpu/utils/batch_processor.py, copied with its
imports renamed, except device_memory_stats, which reads torch.cuda's
memory statistics for each visible card where the reference asks
jax.local_devices().

BatchProcessor: adaptive batching with device-memory monitoring.

Parity target: upstream utils/batch_processor.py (CUDA memory polling
:20-42) — memory stats come from torch.cuda for each card; batch
size halves on OOM-looking failures and recovers gradually.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, TypeVar

from anorag_tpu_torch.utils.logging import get_logger

logger = get_logger("anorag.batch")

T = TypeVar("T")
R = TypeVar("R")


def device_memory_stats() -> Dict[str, Any]:
    """Per-device memory stats when the backend exposes them: for each
    visible card the bytes its allocator holds and the card's total memory
    (torch.cuda.mem_get_info); {} on the CPU."""
    try:
        import torch

        if not torch.cuda.is_available():
            return {}
        out = {}
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i) or {}
            out[f"cuda:{i}"] = {
                "bytes_in_use": stats.get("allocated_bytes.all.current"),
                "bytes_limit": torch.cuda.mem_get_info(i)[1],
            }
        return out
    except Exception:
        return {}


class BatchProcessor:
    def __init__(self, batch_size: int = 64, min_batch_size: int = 1,
                 grow_after: int = 4):
        self.batch_size = batch_size
        self.initial_batch_size = batch_size
        self.min_batch_size = min_batch_size
        self.grow_after = grow_after
        self._ok_streak = 0

    def process(self, items: Sequence[T],
                fn: Callable[[List[T]], List[R]]) -> List[R]:
        """Apply fn to batches; halve the batch size on resource errors."""
        out: List[R] = []
        i = 0
        while i < len(items):
            bs = self.batch_size
            batch = list(items[i : i + bs])
            try:
                out.extend(fn(batch))
                i += len(batch)
                self._ok_streak += 1
                if (self._ok_streak >= self.grow_after
                        and self.batch_size < self.initial_batch_size):
                    self.batch_size = min(self.batch_size * 2, self.initial_batch_size)
                    self._ok_streak = 0
            except (MemoryError, RuntimeError) as e:
                if self.batch_size <= self.min_batch_size:
                    raise
                self.batch_size = max(self.min_batch_size, self.batch_size // 2)
                self._ok_streak = 0
                logger.warning("batch failed (%s); retrying at batch_size=%d",
                               type(e).__name__, self.batch_size)
        return out
