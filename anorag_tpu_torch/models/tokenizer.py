"""Hash tokenizer: words hashed into a fixed vocabulary.

Copied from anorag_tpu/models/tokenizer.py (HashTokenizer). get_tokenizer
ends there on both the TPU host and the GPU host, since neither has a
locally cached HuggingFace tokenizer; HFTokenizer is not ported yet.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

import numpy as np

from anorag_tpu_torch.utils.text import tokenize

CLS_ID = 0
SEP_ID = 1
PAD_ID = 2
_RESERVED = 3


def stable_hash(s: str) -> int:
    return int.from_bytes(hashlib.blake2b(s.encode("utf-8"), digest_size=8).digest(), "little")


class HashTokenizer:
    """word -> stable hash bucket in [RESERVED, vocab_size)."""

    def __init__(self, vocab_size: int = 250002, max_length: int = 512):
        self.vocab_size = vocab_size
        self.max_length = max_length

    def token_ids(self, text: str) -> List[int]:
        span = self.vocab_size - _RESERVED
        return [_RESERVED + (stable_hash(w) % span) for w in tokenize(text)]

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        max_length = max_length or self.max_length
        return [CLS_ID] + self.token_ids(text)[: max_length - 2] + [SEP_ID]

    def encode_batch(
        self, texts: Sequence[str], max_length: Optional[int] = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (token_ids (B, L) i32 padded, attention mask (B, L) i32);
        L is the batch's longest sequence rounded up to a multiple of 128."""
        max_length = max_length or self.max_length
        encoded = [self.encode(t, max_length) for t in texts]
        width = max(len(e) for e in encoded) if encoded else 1
        width = min(max_length, ((width + 127) // 128) * 128)
        ids = np.full((len(encoded), width), PAD_ID, np.int32)
        mask = np.zeros((len(encoded), width), np.int32)
        for i, e in enumerate(encoded):
            e = e[:width]
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return ids, mask


def get_tokenizer(vocab_size: int = 250002, max_length: int = 512) -> HashTokenizer:
    return HashTokenizer(vocab_size, max_length)
