"""In-process LLM provider: the framework's decoder LM on the card.

Counterpart of anorag_tpu/llm/jax_client.py (JaxLLMClient, render_prompt).
It loads a checkpoint of models/decoder_lm.py (params.npz + config.json)
and serves generate / batch_generate as calls of the port's torch decoder,
batch_generate one batched call a max_batch slice. The factory registers
it under the reference's provider name, "jax", which every config names
(`llm.provider: jax`, `llm.jax.model: <checkpoint dir>`).

Decoding is greedy by default: the in-repo checkpoints are distilled
byte-level models whose operating point is deterministic JSON emission;
per-call sampling temperature is accepted but only honored when the
provider was constructed with `temperature > 0`.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

from anorag_tpu_torch.device import DeviceLike, resolve_device
from anorag_tpu_torch.llm.base import LLMClient
from anorag_tpu_torch.utils.logging import get_logger

logger = get_logger("anorag.llm")

# bytes-per-token inflation: callers budget in (word-ish) tokens, the
# decoder generates bytes
_BYTES_PER_TOKEN = 4


def render_prompt(prompt: str, system_prompt: Optional[str] = None) -> str:
    """The single prompt surface shared by training and serving.

    The system prompt's first line is kept as a task tag (it differs per
    task and is cheap in bytes); the full system text is dropped: the
    distilled model learns the task contract from the data, not the
    instructions.
    """
    tag = (system_prompt or "").strip().split("\n", 1)[0][:96]
    return f"### task: {tag}\n{prompt}\n### reply:\n"


class DecoderLLMClient(LLMClient):
    provider_name = "jax"

    def __init__(self, model: str = "checkpoints/note_lm", base_url: str = "",
                 timeout: float = 300.0, transport=None,
                 temperature: float = 0.0, prompt_bucket: int = 256,
                 max_batch: int = 8, *, device: DeviceLike = "cuda"):
        super().__init__(base_url or "in-process", model, timeout,
                         transport=transport or (lambda u, p, t: {}))
        self.temperature = float(temperature)
        self.prompt_bucket = int(prompt_bucket)
        self.max_batch = int(max_batch)
        self.device = resolve_device(device)
        self._lm = None

    # ------------------------------------------------------------- model
    def _ensure_lm(self):
        if self._lm is None:
            from anorag_tpu_torch.models.decoder_lm import DecoderLM, load_lm
            params, cfg = load_lm(self.model, device=self.device)
            self._lm = DecoderLM(params, cfg, prompt_bucket=self.prompt_bucket)
            logger.info("decoder llm loaded on %s: %s (%d layers, %d hidden, "
                        "max_len %d)", self.device, self.model, cfg.num_layers,
                        cfg.hidden_size, cfg.max_len)
        return self._lm

    def _max_new(self, params: Dict[str, Any]) -> int:
        toks = int(params.get("max_tokens") or 512)
        return max(64, toks * _BYTES_PER_TOKEN)

    def _temp(self, params: Dict[str, Any]) -> float:
        if self.temperature <= 0.0:
            return 0.0
        return float(params.get("temperature", self.temperature))

    # --------------------------------------------------------- interface
    def _request(self, prompt: str, system_prompt: Optional[str],
                 **params) -> str:
        lm = self._ensure_lm()
        return lm.generate([render_prompt(prompt, system_prompt)],
                           max_new=self._max_new(params),
                           temperature=self._temp(params))[0]

    def batch_generate(self, prompts: List[str],
                       system_prompt: Optional[str] = None,
                       **params) -> List[str]:
        """One batched decoder call per max_batch slice."""
        if not prompts:
            return []
        lm = self._ensure_lm()
        rendered = [render_prompt(p, system_prompt) for p in prompts]
        out: List[str] = []
        for i in range(0, len(rendered), self.max_batch):
            chunk = rendered[i:i + self.max_batch]
            try:
                self.stats["calls"] += len(chunk)
                out.extend(lm.generate(chunk, max_new=self._max_new(params),
                                       temperature=self._temp(params)))
            except Exception as e:
                self.stats["errors"] += len(chunk)
                logger.warning("decoder batch_generate failed: %s", e)
                out.extend([""] * len(chunk))
        return out

    def health_payload(self):  # pragma: no cover - is_available overridden
        raise NotImplementedError

    def is_available(self) -> bool:
        p = Path(self.model)
        return (p / "params.npz").exists() and (p / "config.json").exists()
