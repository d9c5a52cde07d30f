"""Counterpart of anorag_tpu/utils/logging.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Logging + lightweight performance tracing.

Replaces the reference's loguru usage with stdlib logging plus a structured
JSON logger and a `@log_performance` wall-time decorator
(upstream utils/logging_utils.py:12-158). `profile_trace` wraps
`torch.profiler.record_function` (the reference's wraps jax.profiler's
trace annotations): the one function that differs from the copy.
"""
from __future__ import annotations

import contextlib
import functools
import json
import logging
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

_FMT = "%(asctime)s | %(levelname)-7s | %(name)s | %(message)s"


def get_logger(name: str = "anorag") -> logging.Logger:
    """Named logger emitting through ROOT handlers only (a handler on the
    named logger would double-print once setup_logging adds root handlers)."""
    root = logging.getLogger()
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FMT))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
    return logging.getLogger(name)


logger = get_logger()


def setup_logging(log_file: Optional[str] = None, level: int = logging.INFO) -> None:
    root = logging.getLogger()
    root.setLevel(level)
    fmt = logging.Formatter(_FMT)
    if not any(isinstance(h, logging.StreamHandler) for h in root.handlers):
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(fmt)
        root.addHandler(sh)
    if log_file:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_file, encoding="utf-8")
        fh.setFormatter(fmt)
        root.addHandler(fh)


class StructuredLogger:
    """Key-value JSON record logger for retrieval metrics."""

    def __init__(self, name: str = "anorag.metrics", sink_path: Optional[str] = None):
        self._logger = get_logger(name)
        self._sink = Path(sink_path) if sink_path else None
        if self._sink:
            self._sink.parent.mkdir(parents=True, exist_ok=True)

    def log(self, event: str, **fields: Any) -> None:
        rec = {"event": event, "ts": time.time(), **fields}
        line = json.dumps(rec, ensure_ascii=False, default=str)
        self._logger.info(line)
        if self._sink:
            with open(self._sink, "a", encoding="utf-8") as fh:
                fh.write(line + "\n")

    def log_retrieval_metrics(self, **fields: Any) -> None:
        self.log("retrieval_metrics", **fields)

    def log_diversity_metrics(self, **fields: Any) -> None:
        self.log("diversity_metrics", **fields)

    def log_path_aware_metrics(self, **fields: Any) -> None:
        self.log("path_aware_metrics", **fields)


_PERF: Dict[str, Dict[str, float]] = {}


def log_performance(fn: Callable) -> Callable:
    """Record wall-time per call; aggregate stats in `perf_stats()`."""

    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            st = _PERF.setdefault(fn.__qualname__, {"calls": 0, "total_s": 0.0, "max_s": 0.0})
            st["calls"] += 1
            st["total_s"] += dt
            st["max_s"] = max(st["max_s"], dt)

    return wrapper


def perf_stats() -> Dict[str, Dict[str, float]]:
    return {k: dict(v) for k, v in _PERF.items()}


def reset_perf_stats() -> None:
    _PERF.clear()


@contextlib.contextmanager
def profile_trace(name: str):
    """torch.profiler range when available, no-op otherwise (the
    reference's is a jax.profiler trace annotation)."""
    try:
        import torch.profiler as tprof

        with tprof.record_function(name):
            yield
    except Exception:
        yield


@contextlib.contextmanager
def timed(name: str, sink: Optional[Dict[str, float]] = None):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + dt
    else:
        logger.debug("%s took %.4fs", name, dt)
