"""Counterpart of anorag_tpu/index/embedding_strategy.py, copied with its
imports renamed to anorag_tpu_torch, except for the encoder's model:
JaxEmbeddingModel keeps the reference's name and EmbeddingConfig its
signature, but builds the port's EmbeddingManager from the port's Config
on the device it is given (keyword only; the card unless the caller asks
for the CPU), with backend "jax" read as the port's transformer encoder
("torch"), and returns numpy rows, as the protocol says;
create_embedding_model passes the device on.

Embedding strategy: versioned embedding configs + index version registry.

Parity target: upstream vector_store/embedding_strategy.py:42-360 —
an EmbeddingConfig captures the identity of an embedding space (model, dim,
normalization, prefix); an IndexVersion registry binds built index artifacts
to the config hash that produced them so stale spaces are never mixed;
EmbeddingModel implementations are pluggable (jax encoder / hash).
"""
from __future__ import annotations

import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Protocol, Sequence

import numpy as np

from anorag_tpu_torch.utils.file_io import config_hash, read_json, write_json


@dataclass(frozen=True)
class EmbeddingConfig:
    model_name: str = "BAAI/bge-m3"
    backend: str = "jax"            # jax | hash
    dim: int = 1024
    max_length: int = 512
    normalize: bool = True
    query_prefix: str = ""
    version: str = "v1"

    @property
    def signature(self) -> str:
        return config_hash(asdict(self))


class EmbeddingModel(Protocol):
    def encode(self, texts: Sequence[str]) -> np.ndarray: ...


class HashEmbeddingModel:
    def __init__(self, cfg: EmbeddingConfig):
        from anorag_tpu_torch.models.hash_embedder import HashEmbedder

        self.cfg = cfg
        self._impl = HashEmbedder(dim=cfg.dim)

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        return self._impl.encode(list(texts), normalize=self.cfg.normalize)


class JaxEmbeddingModel:
    def __init__(self, cfg: EmbeddingConfig, manager=None, *, device=None):
        from anorag_tpu_torch.config import Config
        from anorag_tpu_torch.models.embedding_manager import EmbeddingManager

        self.cfg = cfg
        if manager is None:
            loader = Config()
            loader.set("embedding.backend",
                       "torch" if cfg.backend == "jax" else cfg.backend)
            loader.set("embedding.dim", cfg.dim)
            loader.set("embedding.model_name", cfg.model_name)
            loader.set("embedding.max_length", cfg.max_length)
            manager = EmbeddingManager(cfg=loader, device=device)
        self._em = manager

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        return self._em.encode_texts(list(texts)).cpu().numpy()


def create_embedding_model(cfg: EmbeddingConfig, *, device=None) -> EmbeddingModel:
    if cfg.backend == "hash":
        return HashEmbeddingModel(cfg)
    return JaxEmbeddingModel(cfg, device=device)


class IndexVersionRegistry:
    """Binds index artifacts to the embedding config that produced them."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._versions: List[Dict[str, Any]] = (
            read_json(self.path) if self.path.exists() else []
        )

    def register(self, cfg: EmbeddingConfig, artifact_path: str,
                 n_vectors: int) -> Dict[str, Any]:
        entry = {
            "signature": cfg.signature,
            "config": asdict(cfg),
            "artifact_path": artifact_path,
            "n_vectors": n_vectors,
            "created_at": time.time(),
        }
        self._versions.append(entry)
        write_json(self.path, self._versions)
        return entry

    def current(self) -> Optional[Dict[str, Any]]:
        return self._versions[-1] if self._versions else None

    def find(self, cfg: EmbeddingConfig) -> Optional[Dict[str, Any]]:
        sig = cfg.signature
        for e in reversed(self._versions):
            if e["signature"] == sig:
                return e
        return None

    def is_compatible(self, cfg: EmbeddingConfig) -> bool:
        cur = self.current()
        return bool(cur and cur["signature"] == cfg.signature)
