"""Counterpart of anorag_tpu/llm/multi_model.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Multi-endpoint pooling, task classification, hybrid dispatch.

Parity targets: upstream llm/multi_model_client.py —
  * MultiModelClient: endpoint pool with load-balancing strategies, health
    checking, retry, concurrent batch execution (:149-846);
  * TaskClassifier: keyword/length/complexity routing of "light" vs "heavy"
    tasks (:843-963);
  * HybridLLMDispatcher: singleton routing light tasks to Ollama and heavy
    tasks (incl. atomic-note JSON) to the LM Studio pool, with task_division
    and competitive modes (:964-1278).
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Any, Dict, List, Optional, Sequence

from anorag_tpu_torch.llm.base import LLMClient
from anorag_tpu_torch.llm.clients import LMStudioClient, OllamaClient
from anorag_tpu_torch.utils.logging import get_logger

logger = get_logger("anorag.llm")


class MultiModelClient:
    """Pool of LLM clients with health tracking + balanced dispatch."""

    def __init__(self, clients: Sequence[LLMClient], strategy: str = "least_loaded",
                 max_retries: int = 1, health_check_interval: float = 0.0):
        assert clients, "need at least one client"
        self.clients = list(clients)
        self.strategy = strategy
        self.max_retries = max_retries
        self._lock = threading.Lock()
        self._rr = 0
        self._in_flight = {id(c): 0 for c in self.clients}
        self._healthy = {id(c): True for c in self.clients}
        self._stop_health = threading.Event()
        self._health_thread = None
        if health_check_interval > 0:
            self._health_thread = threading.Thread(
                target=self._health_loop, args=(health_check_interval,), daemon=True
            )
            self._health_thread.start()

    # ---------------------------------------------------------- selection
    def _pick(self) -> LLMClient:
        with self._lock:
            healthy = [c for c in self.clients if self._healthy[id(c)]] or self.clients
            if self.strategy == "round_robin":
                c = healthy[self._rr % len(healthy)]
                self._rr += 1
            elif self.strategy == "fastest":
                c = min(healthy, key=lambda x: x.avg_response_time)
            else:  # least_loaded
                c = min(healthy, key=lambda x: self._in_flight[id(x)])
            self._in_flight[id(c)] += 1
            return c

    def _release(self, c: LLMClient, ok: bool) -> None:
        with self._lock:
            self._in_flight[id(c)] -= 1
            if not ok:
                self._healthy[id(c)] = False

    def _health_loop(self, interval: float) -> None:
        while not self._stop_health.wait(interval):
            for c in self.clients:
                self._healthy[id(c)] = c.is_available()

    def close(self) -> None:
        self._stop_health.set()

    # ---------------------------------------------------------- generation
    def generate(self, prompt: str, system_prompt: Optional[str] = None, **params) -> str:
        last_err: Optional[Exception] = None
        for _ in range(self.max_retries + 1):
            c = self._pick()
            try:
                out = c.generate(prompt, system_prompt, **params)
                self._release(c, True)
                return out
            except Exception as e:
                last_err = e
                self._release(c, False)
        raise last_err  # type: ignore[misc]

    def batch_generate(self, prompts: List[str], system_prompt: Optional[str] = None,
                       max_workers: int = 4, **params) -> List[str]:
        out = [""] * len(prompts)
        with ThreadPoolExecutor(max_workers=max_workers) as ex:
            futs = {
                ex.submit(self.generate, p, system_prompt, **params): i
                for i, p in enumerate(prompts)
            }
            for f in as_completed(futs):
                i = futs[f]
                try:
                    out[i] = f.result()
                except Exception as e:
                    logger.warning("batch item %d failed: %s", i, e)
        return out

    def pool_stats(self) -> List[Dict[str, Any]]:
        return [
            {
                "provider": c.provider_name, "model": c.model,
                "calls": c.stats["calls"], "errors": c.stats["errors"],
                "avg_time": c.avg_response_time, "healthy": self._healthy[id(c)],
            }
            for c in self.clients
        ]


# ---------------------------------------------------------------- classifier
HEAVY_KEYWORDS = ("json", "atomic note", "extract", "analyze", "summarize", "decompose")
LIGHT_KEYWORDS = ("yes or no", "classify", "rewrite", "translate", "ping")


class TaskClassifier:
    """Light tasks -> fast endpoint; heavy tasks -> strong endpoint."""

    def __init__(self, heavy_length: int = 600):
        self.heavy_length = heavy_length

    def classify_task(self, prompt: str, task_type: Optional[str] = None) -> str:
        if task_type in ("atomic_note", "final_answer", "relation_extraction"):
            return "heavy"
        if task_type in ("rewrite", "classify", "health"):
            return "light"
        low = (prompt or "").lower()
        if any(k in low for k in HEAVY_KEYWORDS):
            return "heavy"
        if any(k in low for k in LIGHT_KEYWORDS):
            return "light"
        return "heavy" if len(prompt or "") >= self.heavy_length else "light"


class HybridLLMDispatcher:
    """Routes by task class; singleton like the reference (:964-1278)."""

    _instance: Optional["HybridLLMDispatcher"] = None
    _lock = threading.Lock()

    def __init__(self, light_client: Optional[LLMClient] = None,
                 heavy_client: Optional[Any] = None,
                 mode: str = "task_division",
                 classifier: Optional[TaskClassifier] = None):
        self.light = light_client
        self.heavy = heavy_client
        self.mode = mode
        self.classifier = classifier or TaskClassifier()
        self.stats = {"light": 0, "heavy": 0}

    @classmethod
    def from_config(cls, config, transport=None) -> "HybridLLMDispatcher":
        h = config.get("llm.hybrid_llm", {}) or {}
        lt = h.get("light_tasks", {}) or {}
        ht = h.get("heavy_tasks", {}) or {}
        light = OllamaClient(
            base_url=lt.get("base_url", "http://localhost:11434"),
            model=lt.get("model", "qwen2.5:latest"),
            timeout=lt.get("timeout", 30), transport=transport,
        )
        heavy_pool = [
            LMStudioClient(
                base_url=ht.get("base_url", "http://localhost:1234/v1"),
                model=ht.get("model", "openai/gpt-oss-20b"),
                timeout=ht.get("timeout", 60), transport=transport,
            )
            for _ in range(int(ht.get("instances", 1)))
        ]
        return cls(light, MultiModelClient(heavy_pool), mode=h.get("mode", "task_division"))

    @classmethod
    def get_instance(cls, config=None, transport=None) -> "HybridLLMDispatcher":
        with cls._lock:
            if cls._instance is None:
                from anorag_tpu_torch.config import config as global_cfg

                cls._instance = cls.from_config(config or global_cfg, transport)
            return cls._instance

    @classmethod
    def reset_instance(cls) -> None:
        with cls._lock:
            cls._instance = None

    # ------------------------------------------------------------ dispatch
    def generate(self, prompt: str, system_prompt: Optional[str] = None,
                 task_type: Optional[str] = None, **params) -> str:
        if self.mode == "competitive" and self.light and self.heavy:
            return self._competitive(prompt, system_prompt, **params)
        klass = self.classifier.classify_task(prompt, task_type)
        self.stats[klass] += 1
        primary = self.light if klass == "light" else self.heavy
        fallback = self.heavy if klass == "light" else self.light
        try:
            if primary is not None:
                return primary.generate(prompt, system_prompt, **params)
        except Exception as e:
            logger.warning("%s route failed (%s); falling back", klass, e)
        if fallback is not None:
            return fallback.generate(prompt, system_prompt, **params)
        raise RuntimeError("no usable LLM endpoint")

    def _competitive(self, prompt, system_prompt, **params) -> str:
        """Fastest non-empty answer wins."""
        with ThreadPoolExecutor(max_workers=2) as ex:
            futs = [
                ex.submit(c.generate, prompt, system_prompt, **params)
                for c in (self.light, self.heavy) if c is not None
            ]
            for f in as_completed(futs):
                try:
                    out = f.result()
                    if out:
                        return out
                except Exception:
                    continue
        return ""

    def process_batch(self, prompts: List[str], system_prompt: Optional[str] = None,
                      task_type: Optional[str] = None, max_workers: int = 4,
                      **params) -> List[str]:
        out = [""] * len(prompts)
        with ThreadPoolExecutor(max_workers=max_workers) as ex:
            futs = {
                ex.submit(self.generate, p, system_prompt, task_type, **params): i
                for i, p in enumerate(prompts)
            }
            for f in as_completed(futs):
                try:
                    out[futs[f]] = f.result()
                except Exception:
                    pass
        return out
