"""Counterpart of anorag_tpu/llm/clients.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Concrete provider clients: Ollama, LM Studio (OpenAI-compatible, with
multi-instance load balancing), OpenAI.

Parity targets: upstream llm/ollama_client.py:18-377,
lmstudio_client.py:24-484 (LMStudioInstance pool + least-loaded dispatch),
openai_client.py:17-297.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from anorag_tpu_torch.llm.base import LLMClient, Transport, get_logger

logger = get_logger("anorag.llm")


class OllamaClient(LLMClient):
    provider_name = "ollama"

    def __init__(self, base_url: str = "http://localhost:11434",
                 model: str = "qwen2.5:latest", timeout: float = 30.0,
                 transport: Optional[Transport] = None):
        super().__init__(base_url, model, timeout, transport)

    def _request(self, prompt, system_prompt, **params) -> str:
        payload: Dict[str, Any] = {
            "model": self.model,
            "prompt": prompt,
            "stream": False,
            "options": {
                "temperature": params.get("temperature", 0.1),
                "top_p": params.get("top_p", 0.9),
                "num_predict": params.get("max_tokens", 512),
            },
        }
        if system_prompt:
            payload["system"] = system_prompt
        if params.get("stop"):
            payload["options"]["stop"] = list(params["stop"])
        resp = self.transport(f"{self.base_url}/api/generate", payload, self.timeout)
        return str(resp.get("response", ""))

    def health_payload(self):
        return f"{self.base_url}/api/generate", {
            "model": self.model, "prompt": "ping", "stream": False,
            "options": {"num_predict": 1},
        }


class _OpenAICompatible(LLMClient):
    """chat-completions protocol shared by LM Studio and OpenAI."""

    def __init__(self, base_url: str, model: str, timeout: float = 60.0,
                 api_key: str = "", transport: Optional[Transport] = None):
        super().__init__(base_url, model, timeout, transport)
        self.api_key = api_key

    def _request(self, prompt, system_prompt, **params) -> str:
        messages = []
        if system_prompt:
            messages.append({"role": "system", "content": system_prompt})
        messages.append({"role": "user", "content": prompt})
        payload: Dict[str, Any] = {
            "model": self.model,
            "messages": messages,
            "temperature": params.get("temperature", 0.1),
            "max_tokens": params.get("max_tokens", 512),
        }
        if params.get("stop"):
            payload["stop"] = list(params["stop"])
        resp = self.transport(f"{self.base_url}/chat/completions", payload, self.timeout)
        choices = resp.get("choices") or []
        if not choices:
            return ""
        msg = choices[0].get("message") or {}
        return str(msg.get("content", ""))

    def health_payload(self):
        return f"{self.base_url}/chat/completions", {
            "model": self.model, "messages": [{"role": "user", "content": "ping"}],
            "max_tokens": 1,
        }


class LMStudioClient(_OpenAICompatible):
    """LM Studio with an instance pool: generate() picks the least-loaded
    healthy instance (reference lmstudio_client.py:24-484)."""

    provider_name = "lmstudio"

    def __init__(self, base_url: str = "http://localhost:1234/v1",
                 model: str = "qwen2.5-7b-instruct", timeout: float = 60.0,
                 instances: int = 1, port_stride: int = 1,
                 transport: Optional[Transport] = None):
        super().__init__(base_url, model, timeout, transport=transport)
        self._lock = threading.Lock()
        self.instances: List[Dict[str, Any]] = []
        for i in range(max(1, instances)):
            url = base_url if i == 0 else self._offset_port(base_url, i * port_stride)
            self.instances.append({"url": url.rstrip("/"), "in_flight": 0,
                                   "calls": 0, "errors": 0})

    @staticmethod
    def _offset_port(url: str, offset: int) -> str:
        import re

        def bump(m):
            return f":{int(m.group(1)) + offset}"

        return re.sub(r":(\d+)", bump, url, count=1)

    def _pick(self) -> Dict[str, Any]:
        with self._lock:
            inst = min(self.instances, key=lambda x: (x["in_flight"], x["errors"], x["calls"]))
            inst["in_flight"] += 1
            inst["calls"] += 1
            return inst

    def _request(self, prompt, system_prompt, **params) -> str:
        inst = self._pick()
        base = self.base_url
        try:
            self.base_url = inst["url"]
            return super()._request(prompt, system_prompt, **params)
        except Exception:
            with self._lock:
                inst["errors"] += 1
            raise
        finally:
            self.base_url = base
            with self._lock:
                inst["in_flight"] -= 1

    def instance_stats(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(i) for i in self.instances]


class OpenAIClient(_OpenAICompatible):
    provider_name = "openai"

    def __init__(self, base_url: str = "https://api.openai.com/v1",
                 model: str = "gpt-3.5-turbo", timeout: float = 60.0,
                 api_key: str = "", transport: Optional[Transport] = None):
        super().__init__(base_url, model, timeout, api_key, transport)

    def _request(self, prompt, system_prompt, **params) -> str:
        # inject auth header via a wrapping transport
        if self.api_key:
            inner = self.transport

            def authed(url, payload, timeout):
                import json as _json
                import urllib.request as _rq

                req = _rq.Request(
                    url, data=_json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json",
                             "Authorization": f"Bearer {self.api_key}"},
                    method="POST",
                )
                with _rq.urlopen(req, timeout=timeout) as resp:
                    return _json.loads(resp.read().decode())

            self.transport, saved = authed, inner
            try:
                return super()._request(prompt, system_prompt, **params)
            finally:
                self.transport = saved
        return super()._request(prompt, system_prompt, **params)
