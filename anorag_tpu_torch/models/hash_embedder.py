"""Deterministic feature-hash embedder (weight-free), copied from
anorag_tpu/models/hash_embedder.py: each token selects a fixed
pseudo-random direction seeded by a stable hash, and a text embeds to the
L2-normalized sum. Host numpy, bit-identical to the reference."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from anorag_tpu_torch.models.tokenizer import stable_hash
from anorag_tpu_torch.utils.text import tokenize


class HashEmbedder:
    def __init__(self, dim: int = 1024, seed: int = 0, ngrams: int = 2):
        self.dim = dim
        self.seed = seed
        self.ngrams = ngrams

    def _token_vec(self, token: str) -> np.ndarray:
        rng = np.random.default_rng((stable_hash(token) ^ self.seed) & 0xFFFFFFFFFFFFFFFF)
        return rng.standard_normal(self.dim).astype(np.float32)

    def encode(self, texts: Sequence[str], normalize: bool = True) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        cache: dict = {}
        for i, t in enumerate(texts):
            toks = tokenize(t)
            grams: List[str] = list(toks)
            if self.ngrams >= 2:
                grams += [f"{a}_{b}" for a, b in zip(toks, toks[1:])]
            for g in grams:
                v = cache.get(g)
                if v is None:
                    v = self._token_vec(g)
                    cache[g] = v
                out[i] += v
        if normalize:
            norms = np.linalg.norm(out, axis=1, keepdims=True)
            out = np.where(norms > 0, out / np.maximum(norms, 1e-9), out)
        return out
