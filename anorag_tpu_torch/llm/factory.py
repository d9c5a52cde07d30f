"""Counterpart of anorag_tpu/llm/factory.py,
copied with its imports renamed to anorag_tpu_torch. Two parts differ:
create_from_config takes a keyword-only `device` and passes it to the
in-process provider, and the provider registered as "jax" (the name every
config gives it) is the port's decoder on torch,
llm/decoder_client.py::DecoderLLMClient.

LLMFactory: provider registry + availability-ranked creation.

Parity target: upstream llm/factory.py:12-207.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from anorag_tpu_torch.llm.base import LLMClient
from anorag_tpu_torch.llm.clients import LMStudioClient, OllamaClient, OpenAIClient
from anorag_tpu_torch.utils.logging import get_logger

logger = get_logger("anorag.llm")


class LLMFactory:
    _registry: Dict[str, Callable[..., LLMClient]] = {}

    @classmethod
    def register(cls, name: str, ctor: Callable[..., LLMClient]) -> None:
        cls._registry[name] = ctor

    @classmethod
    def providers(cls) -> List[str]:
        return sorted(cls._registry)

    @classmethod
    def create_provider(cls, name: str, cfg: Optional[Dict[str, Any]] = None,
                        **kw) -> LLMClient:
        cfg = dict(cfg or {})
        cfg.update(kw)
        ctor = cls._registry.get(name)
        if ctor is None:
            raise ValueError(f"unknown LLM provider: {name} (have {cls.providers()})")
        return ctor(**cfg)

    @classmethod
    def create_from_config(cls, config, *, device=None) -> LLMClient:
        llm_cfg = config.get("llm", {}) or {}
        name = llm_cfg.get("provider", "openai")
        provider_cfg = dict(llm_cfg.get(name, {}) or {})
        provider_cfg.setdefault("model", llm_cfg.get("model"))
        allowed = ("base_url", "model", "timeout", "api_key")
        if name == "jax":  # in-process provider: decoding knobs, no api_key
            allowed = ("base_url", "model", "timeout", "temperature",
                       "prompt_bucket", "max_batch", "device")
            provider_cfg["device"] = device
        provider_cfg = {k: v for k, v in provider_cfg.items() if v is not None
                        and k in allowed}
        return cls.create_provider(name, provider_cfg)

    @classmethod
    def rank_available(cls, candidates: List[LLMClient]) -> List[LLMClient]:
        """Available providers first, then by error rate and latency."""
        scored = []
        for c in candidates:
            ok = c.is_available()
            scored.append((not ok, c.error_rate, c.avg_response_time, c))
        scored.sort(key=lambda t: t[:3])
        return [c for *_, c in scored]


def _make_jax_client(**cfg):
    from anorag_tpu_torch.llm.decoder_client import DecoderLLMClient

    return DecoderLLMClient(**cfg)


LLMFactory.register("ollama", OllamaClient)
LLMFactory.register("lmstudio", LMStudioClient)
LLMFactory.register("openai", OpenAIClient)
LLMFactory.register("jax", _make_jax_client)
