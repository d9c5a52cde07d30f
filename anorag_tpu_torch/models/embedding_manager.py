"""EmbeddingManager: text -> vectors for the port.

Counterpart of anorag_tpu/models/embedding_manager.py (encode_texts,
encode_atomic_notes, encode_queries :134-165). Backends:
  * 'torch' -- the transformer encoder (models/encoder.py); it replaces the
    reference's default 'jax' backend. Weights are drawn from a seeded
    torch.Generator unless a state_dict is loaded (load_encoder_state);
  * 'hash' -- the deterministic feature-hash embedder (host numpy).
Unlike the reference this is a plain object, not a process-wide singleton.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Mapping, Optional, Sequence

import torch

from anorag_tpu_torch.config import as_config
from anorag_tpu_torch.device import DeviceLike, resolve_device
from anorag_tpu_torch.models.encoder import Encoder, EncoderConfig
from anorag_tpu_torch.models.hash_embedder import HashEmbedder
from anorag_tpu_torch.models.tokenizer import get_tokenizer
from anorag_tpu_torch.utils.text import note_embedding_text

class EmbeddingManager:
    def __init__(self, cfg: Any = None, device: DeviceLike = None, seed: int = 0):
        self.cfg = as_config(cfg)
        self.device = resolve_device(device)
        self.seed = seed
        emb = self.cfg.get("embedding")
        self.backend = emb.get("backend", "torch")
        if self.backend not in ("torch", "hash"):
            raise ValueError(f"unknown embedding backend {self.backend!r}")
        self.dim = emb.get("dim", 1024)
        self.batch_size = emb.get("batch_size", 64)
        self.max_length = emb.get("max_length", 512)
        self.normalize = emb.get("normalize", True)
        self.query_prefix = emb.get("query_prefix", "")
        self.include_entities = emb.get("include_entities", True)
        self._encoder: Optional[Encoder] = None
        self._tokenizer = None
        self._hash: Optional[HashEmbedder] = None
        self._lock = threading.Lock()

    # ----------------------------------------------------------- backends
    def _ensure_backend(self) -> None:
        with self._lock:
            if self.backend == "hash":
                if self._hash is None:
                    self._hash = HashEmbedder(dim=self.dim)
            elif self._encoder is None:
                enc_cfg = dict(self.cfg.get("encoder"))
                enc_cfg.setdefault("hidden_size", self.dim)
                cfg = EncoderConfig.from_config(enc_cfg)
                gen = torch.Generator(device=self.device).manual_seed(self.seed)
                self._encoder = Encoder(cfg, self.device).init_random(gen)
                self._tokenizer = get_tokenizer(cfg.vocab_size, self.max_length)

    def load_encoder_state(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Replace the encoder weights, e.g. with params_from_jax output."""
        if self.backend == "hash":
            raise ValueError("the hash backend has no weights")
        self._ensure_backend()
        self._encoder.load_state_dict(dict(state_dict))

    # ------------------------------------------------------------ encoding
    def encode_texts(self, texts: Sequence[str]) -> torch.Tensor:
        """Batched text -> (N, dim) f32 embeddings on self.device."""
        if not len(texts):
            return torch.zeros((0, self.dim), dtype=torch.float32, device=self.device)
        self._ensure_backend()
        if self.backend == "hash":
            out = self._hash.encode(list(texts), normalize=self.normalize)
            return torch.from_numpy(out).to(self.device)
        outs = []
        for i in range(0, len(texts), self.batch_size):
            ids, mask = self._tokenizer.encode_batch(
                list(texts[i:i + self.batch_size]), self.max_length)
            outs.append(self._encoder(
                torch.from_numpy(ids).to(self.device, torch.long),
                torch.from_numpy(mask).to(self.device)))
        return torch.cat(outs, dim=0)

    def encode_atomic_notes(self, notes: Sequence[Dict[str, Any]]) -> torch.Tensor:
        return self.encode_texts([
            note_embedding_text(n, include_entities=self.include_entities)
            for n in notes])

    def encode_queries(self, queries: Sequence[str]) -> torch.Tensor:
        return self.encode_texts(
            [f"{self.query_prefix}{q}" if self.query_prefix else q for q in queries])
