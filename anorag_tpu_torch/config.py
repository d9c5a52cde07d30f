"""Configuration for the port: the keys its slice reads, with defaults.

Counterpart of the subset of anorag_tpu/config/defaults.py that the batched
hybrid query and the dense search read. A config is a nested dict (for example one loaded from
the repo's YAML files); `Config` merges it over these defaults and answers
dotted lookups, as anorag_tpu's ConfigLoader.get does.
"""
from __future__ import annotations

import copy
from typing import Any, Mapping, Optional

DEFAULTS = {
    "embedding": {
        "model_name": "BAAI/bge-m3",
        "batch_size": 64,
        "max_length": 512,
        "normalize": True,
        "dim": 1024,
        # torch = the transformer encoder (models/encoder.py);
        # hash = the deterministic feature-hash embedder.
        "backend": "torch",
        "query_prefix": "",
        "include_entities": True,
    },
    "encoder": {
        "vocab_size": 250002,
        "hidden_size": 1024,
        "num_layers": 24,
        "num_heads": 16,
        "intermediate_size": 4096,
        "max_position": 512,
        "pooling": "cls",
        "dtype": "bfloat16",
    },
    "vector_store": {"top_k": 20, "index_type": "IVFFlat"},
    "context": {"max_notes_for_llm": 20},
    "tpu": {
        "sharded_search": "auto",
        "ivf": {"nlist": 20, "nprobe": 4, "kmeans_iters": 15},
    },
}


def _merge(base: dict, over: Mapping) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


class Config:
    def __init__(self, overrides: Optional[Mapping] = None):
        self._d = _merge(DEFAULTS, overrides or {})

    def get(self, dotted: str, default: Any = None) -> Any:
        node: Any = self._d
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return copy.deepcopy(node) if isinstance(node, (dict, list)) else node


def as_config(cfg: Any) -> Config:
    return cfg if isinstance(cfg, Config) else Config(cfg)
