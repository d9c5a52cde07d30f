"""Configuration for the port: the keys its slices read, with defaults.

Counterpart of the subset of anorag_tpu/config/defaults.py that the batched
hybrid query, the dense search, the answer stages, the per-query pipeline
(QueryProcessor.process) and the HTTP server read.
A config is a nested dict (for example one loaded from the repo's YAML
files); `Config` merges it over these defaults and answers dotted lookups
and sets, as anorag_tpu's ConfigLoader.get and set do.
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
    "context": {"max_notes_for_llm": 20, "max_tokens": None,
                "use_legacy_packing": False},
    # the answer stages (query/processor.py _answer_stages)
    "graph": {"edge": {"key_match_weight": 1.5, "type_compat_weight": 1.0,
                       "same_paragraph_bonus": 0.3}},
    "note_keys": {"default_rel": "related_to"},
    "multi_hop": {"max_hops": 4, "beam_size": 8, "branch_factor": 6},
    "answering": {
        "rel_chains": [["performed_by", "spouse_of"]],
        "relax_last_hop": ["spouse_of|partner_of"],
        "efsa_hint": {"enabled": True, "threshold": 0.70},
        "final_evidence_first": True,
        "require_verbatim_spans": True,
        "force_insufficient_if_no_spans": True,
    },
    "retry": {"max_times": 1},
    "validator": {"allow_partial": True},
    "answer_selector": {"enabled": True, "anchor_top_k": 5, "apply_before_llm": True},
    "hybrid_search": {
        "linear": {"vector_weight": 1.0},
        "answer_bias": {"who_person_boost": 1.10, "type_gate": True,
                        "subject_cooc_boost": 1.0},
        # the per-query pipeline (query/processor.py _process_traditional)
        "bm25": {"k1": 1.2, "b": 0.75, "corpus_field": "title_raw_span"},
        "fallback": {"query_rewrite_enabled": True},
        "two_hop_expansion": {"enabled": True, "top_m_candidates": 20,
                              "max_second_hop_candidates": 15},
        "section_filtering": {"enabled": True},
        "lexical_fallback": {"enabled": True, "miss_penalty": 0.6,
                             "noise_threshold": 0.20},
        "multi_hop": {"hop_decay": 0.85},
    },
    "retrieval": {
        "candidate_pool": 50,
        "bm25_topk_hop1": 40,
        "embed_topk_hop1": 30,
        "use_graph_rerank": False,
        "subgraph_radius": 2,
        "edge_thresh": 0.35,
        "overlap_thresh": 0.5,
        "token_budget": 1800,
        "alpha": 0.5,
        "beta": 0.3,
        "gamma": 0.2,
        "lambda_len": 0.05,
        "graph": {"expand_top_m": 20},
        "multi_hop": {
            "enabled": True,
            "max_hops": 4,
            "max_paths": 10,
            "min_path_score": 0.3,
            "min_path_score_floor": 0.1,
            "min_path_score_step": 0.05,
            "path_diversity_threshold": 0.7,
            "max_initial_candidates": 20,
        },
    },
    "path_aware": {"enabled": True},
    "recall_optimizer": {"multi_hop_enabled": False, "max_hops": 3,
                         "hop_similarity_threshold": 0.15,
                         "comprehensive_rerank": False},
    "rerank": {"listt5_input_topk": 24, "keep_after_listt5": 16, "enabled": False},
    "context_dispatcher": {
        "enabled": True,
        "final_semantic_count": 8,
        "final_graph_count": 5,
        "bridge_policy": "keepalive",
        "bridge_boost_epsilon": 0.02,
        "debug_log": True,
        "use_graph_aware": False,
        "token_budget": 1800,
    },
    "safety": {
        "per_hop_keep_top_m": 5,
        "lower_threshold": 0.1,
        "cluster": {"enabled": False, "cos_threshold": 0.85, "keep_per_cluster": 3},
    },
    "query": {"use_subquestion_decomposition": False, "merge_strategy": "weighted"},
    "evidence_rerank": {
        "enable": True,
        "w_album": 0.5,
        "w_song": -0.3,
        "w_supporting": 0.4,
        "w_q_performer_album": 0.3,
        "album_tokens": ["(album)", " album"],
        "song_tokens": ["(song)", " single", "(film)"],
        "support_flag_keys": ["is_supporting", "supporting"],
        "query_performer_terms": ["performer", "singer", "vocalist"],
        "query_album_terms": ["album", "record", "ep"],
    },
    "calibration": {"listt5_weight": 0.35, "path": ""},
    # the HTTP server (serve.py): the ServingEngine's sub-batch and depth
    "serving": {"stream_batch": 64, "stream_depth": 3},
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

    def set(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self._d
        for part in parts[:-1]:
            if not isinstance(node.get(part), dict):
                node[part] = {}
            node = node[part]
        node[parts[-1]] = value


def as_config(cfg: Any) -> Config:
    return cfg if isinstance(cfg, Config) else Config(cfg)
