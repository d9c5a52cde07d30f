"""Counterpart of anorag_tpu/llm/local_llm.py,
copied with its imports renamed to anorag_tpu_torch, and with a
keyword-only `device` that reaches the in-process provider (llm.provider
jax): the card unless the caller asks for the CPU.

LocalLLM: provider-agnostic facade.

Parity target: upstream llm/local_llm.py:22-501 — load/generate/
stream/batch against whichever provider the config names, availability
probing, and the note-generation helper used by the offline pipeline.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

from anorag_tpu_torch.config import config as global_config
from anorag_tpu_torch.llm.base import with_retry
from anorag_tpu_torch.llm.factory import LLMFactory
from anorag_tpu_torch.llm.multi_model import HybridLLMDispatcher
from anorag_tpu_torch.utils.logging import get_logger

logger = get_logger("anorag.llm")


class LocalLLM:
    def __init__(self, cfg: Optional[Any] = None, client: Optional[Any] = None,
                 transport=None, *, device=None):
        self.cfg = cfg or global_config
        self.device = device
        self._client = client
        self._transport = transport
        self.max_retries = int(self.cfg.get("retry.max_times", 1))

    @property
    def client(self) -> Any:
        if self._client is None:
            hybrid = self.cfg.get("llm.hybrid_llm.mode", None)
            if hybrid and self.cfg.get("llm.provider") == "hybrid":
                self._client = HybridLLMDispatcher.from_config(self.cfg, self._transport)
            else:
                self._client = LLMFactory.create_from_config(self.cfg,
                                                             device=self.device)
                if self._transport is not None:
                    self._client.transport = self._transport
        return self._client

    def is_available(self) -> bool:
        c = self.client
        return c.is_available() if hasattr(c, "is_available") else True

    def generate(self, prompt: str, system_prompt: Optional[str] = None,
                 task_type: Optional[str] = None, **params) -> str:
        params.setdefault("temperature", self.cfg.get("llm.temperature", 0.7))
        params.setdefault("max_tokens", self.cfg.get("llm.max_output_tokens", 512))
        c = self.client
        if isinstance(c, HybridLLMDispatcher):
            return with_retry(lambda: c.generate(prompt, system_prompt,
                                                 task_type=task_type, **params),
                              self.max_retries)
        return with_retry(lambda: c.generate(prompt, system_prompt, **params),
                          self.max_retries)

    def batch_generate(self, prompts: Sequence[str], system_prompt: Optional[str] = None,
                       task_type: Optional[str] = None, **params) -> List[str]:
        c = self.client
        if hasattr(c, "process_batch"):
            return c.process_batch(list(prompts), system_prompt, task_type, **params)
        if hasattr(c, "batch_generate"):
            return c.batch_generate(list(prompts), system_prompt, **params)
        return [self.generate(p, system_prompt, task_type, **params) for p in prompts]

    def generate_notes(self, chunk_prompt: str, **params) -> str:
        """Note-generation call with the notes_llm params block."""
        np_cfg = self.cfg.get("notes_llm.llm_params", {}) or {}
        params = {**np_cfg, **params}
        from anorag_tpu_torch.llm.prompts import ATOMIC_NOTE_SYSTEM

        return self.generate(chunk_prompt, system_prompt=ATOMIC_NOTE_SYSTEM,
                             task_type="atomic_note", **params)

    def generate_notes_batch(self, chunk_prompts: Sequence[str],
                             **params) -> List[str]:
        """Batched note generation (one transport round instead of one per
        chunk; the in-process jax provider turns it into compiled batched
        device calls)."""
        np_cfg = self.cfg.get("notes_llm.llm_params", {}) or {}
        params = {**np_cfg, **params}
        from anorag_tpu_torch.llm.prompts import ATOMIC_NOTE_SYSTEM

        return self.batch_generate(list(chunk_prompts),
                                   system_prompt=ATOMIC_NOTE_SYSTEM,
                                   task_type="atomic_note", **params)
