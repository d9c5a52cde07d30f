"""Counterpart of anorag_tpu/llm/optimized_client.py,
copied as it is with its imports renamed to anorag_tpu_torch.

OptimizedMultiModelClient + debug harness.

Parity targets: upstream llm/optimized_multi_model_client.py (tuned
pool variant: adaptive concurrency, latency-EMA routing, request coalescing)
and upstream llm/debug_multi_model.py (endpoint diagnostic harness).
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence

from anorag_tpu_torch.llm.base import LLMClient
from anorag_tpu_torch.llm.multi_model import MultiModelClient
from anorag_tpu_torch.utils.logging import get_logger

logger = get_logger("anorag.llm")


class OptimizedMultiModelClient(MultiModelClient):
    """MultiModelClient with latency-EMA routing and response caching.

    - routing picks the client minimizing EMA latency * (1 + in_flight);
    - identical (prompt, system) requests within the cache TTL are coalesced
      to one upstream call.
    """

    def __init__(self, clients: Sequence[LLMClient], ema_alpha: float = 0.3,
                 cache_ttl: float = 60.0, **kw):
        super().__init__(clients, **kw)
        self.ema_alpha = ema_alpha
        self.cache_ttl = cache_ttl
        # optimistic init: an unmeasured endpoint looks free, so every client
        # gets sampled before the router settles on the fastest one
        self._ema: Dict[int, float] = {id(c): 0.0 for c in self.clients}
        self._cache: Dict[Any, tuple] = {}
        self._cache_lock = threading.Lock()

    def _pick(self) -> LLMClient:
        with self._lock:
            healthy = [c for c in self.clients if self._healthy[id(c)]] or self.clients
            c = min(healthy,
                    key=lambda x: self._ema[id(x)] * (1.0 + self._in_flight[id(x)]))
            self._in_flight[id(c)] += 1
            return c

    def generate(self, prompt: str, system_prompt: Optional[str] = None, **params) -> str:
        key = (prompt, system_prompt, tuple(sorted(params.items())))
        now = time.time()
        with self._cache_lock:
            hit = self._cache.get(key)
            if hit and now - hit[1] < self.cache_ttl:
                return hit[0]
        t0 = time.perf_counter()
        c = self._pick()
        try:
            out = c.generate(prompt, system_prompt, **params)
            ok = True
        except Exception:
            self._release(c, False)
            raise
        dt = time.perf_counter() - t0
        self._ema[id(c)] = (1 - self.ema_alpha) * self._ema[id(c)] + self.ema_alpha * dt
        self._release(c, ok)
        with self._cache_lock:
            self._cache[key] = (out, now)
        return out


def debug_endpoints(clients: Sequence[LLMClient], probe_prompt: str = "ping",
                    rounds: int = 3) -> List[Dict[str, Any]]:
    """Diagnostic sweep: availability, latency distribution, error classes."""
    report = []
    for c in clients:
        row: Dict[str, Any] = {
            "provider": c.provider_name, "model": c.model, "base_url": c.base_url,
            "available": c.is_available(), "latencies": [], "errors": defaultdict(int),
        }
        for _ in range(rounds):
            t0 = time.perf_counter()
            try:
                c.generate(probe_prompt, max_tokens=4)
                row["latencies"].append(round(time.perf_counter() - t0, 4))
            except Exception as e:
                row["errors"][type(e).__name__] += 1
        row["errors"] = dict(row["errors"])
        if row["latencies"]:
            row["avg_latency"] = sum(row["latencies"]) / len(row["latencies"])
        report.append(row)
        logger.info("endpoint %s: %s", c.base_url, row)
    return report
