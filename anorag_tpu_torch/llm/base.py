"""Counterpart of anorag_tpu/llm/base.py,
copied as it is with its imports renamed to anorag_tpu_torch.

LLM provider base: HTTP transport, response cleaning, health checks.

Parity targets: the provider-client layer of the reference
(upstream llm/ollama_client.py, lmstudio_client.py,
openai_client.py) — blocking HTTP with timeouts, think-tag/control-char
response cleaning, health probing, and retry. Transport is injectable so
every client is testable without a server.
"""
from __future__ import annotations

import json
import re
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional

from anorag_tpu_torch.utils.logging import get_logger

logger = get_logger("anorag.llm")

Transport = Callable[[str, Dict[str, Any], float], Dict[str, Any]]

_THINK_RE = re.compile(r"<think>.*?</think>\s*", re.DOTALL)
_CTRL_RE = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f]")


def http_json_transport(url: str, payload: Dict[str, Any], timeout: float) -> Dict[str, Any]:
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def clean_response(text: str) -> str:
    text = _THINK_RE.sub("", text or "")
    text = _CTRL_RE.sub("", text)
    return text.strip()


class LLMClient:
    """Base interface all providers implement."""

    provider_name = "base"

    def __init__(self, base_url: str, model: str, timeout: float = 30.0,
                 transport: Optional[Transport] = None):
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.timeout = timeout
        self.transport = transport or http_json_transport
        self.stats = {"calls": 0, "errors": 0, "total_time": 0.0}

    # -- to implement ------------------------------------------------------
    def _request(self, prompt: str, system_prompt: Optional[str], **params) -> str:
        raise NotImplementedError

    def health_payload(self) -> tuple[str, Dict[str, Any]]:
        raise NotImplementedError

    # -- shared ------------------------------------------------------------
    def generate(self, prompt: str, system_prompt: Optional[str] = None, **params) -> str:
        t0 = time.perf_counter()
        self.stats["calls"] += 1
        try:
            out = clean_response(self._request(prompt, system_prompt, **params))
            return out
        except Exception as e:
            self.stats["errors"] += 1
            logger.warning("%s generate failed: %s", self.provider_name, e)
            raise
        finally:
            self.stats["total_time"] += time.perf_counter() - t0

    def batch_generate(self, prompts: List[str], system_prompt: Optional[str] = None,
                       **params) -> List[str]:
        out = []
        for p in prompts:
            try:
                out.append(self.generate(p, system_prompt, **params))
            except Exception:
                out.append("")
        return out

    def is_available(self) -> bool:
        try:
            url, payload = self.health_payload()
            self.transport(url, payload, min(self.timeout, 5.0))
            return True
        except Exception:
            return False

    @property
    def avg_response_time(self) -> float:
        return self.stats["total_time"] / max(self.stats["calls"], 1)

    @property
    def error_rate(self) -> float:
        return self.stats["errors"] / max(self.stats["calls"], 1)


def with_retry(fn: Callable[[], str], max_times: int = 1, backoff: float = 0.5) -> str:
    """Generic retry wrapper (parity: upstream llm/retry_middleware.py)."""
    last: Optional[Exception] = None
    for attempt in range(max_times + 1):
        try:
            return fn()
        except Exception as e:
            last = e
            if attempt < max_times:
                time.sleep(backoff * (2 ** attempt))
    raise last  # type: ignore[misc]
