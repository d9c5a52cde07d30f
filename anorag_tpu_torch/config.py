"""Configuration for the port: the keys its slices read, with defaults.

Counterpart of the subset of anorag_tpu/config/defaults.py that the batched
hybrid query, the dense search, the answer stages, the per-query pipeline
(QueryProcessor.process), the LLM layer (llm/), the HTTP servers and the
offline knowledge-base build (doc/processor.py, the note generators, main.py)
read.
A config is a nested dict (for example one loaded from the repo's YAML
files); `Config` merges it over these defaults and answers dotted lookups
and sets, as anorag_tpu's ConfigLoader.get and set do. `config` is the
module's default instance, the counterpart of anorag_tpu.config.config,
which the LLM layer falls back to when given no config; it holds the
defaults alone (the reference's also reads config.yaml from the working
directory).
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
                       "same_paragraph_bonus": 0.3},
              # the note graph's build (doc/processor.py)
              "relation_extraction": {"semantic_similarity_threshold": 0.7,
                                      "max_semantic_edges_per_note": 5,
                                      "enable_llm_relations": False, "llm_window": 10,
                                      "max_edges_per_note": 20},
              "pagerank": {"alpha": 0.85, "iters": 30}},
    "note_keys": {
        "rel_lexicon": {
            "performed_by": ["performed by", "the performer is", "sung by", "sings",
                             "album by", "record by", "recorded the album",
                             "由", "演奏", "演出"],
            "spouse_of": ["spouse", "partner", "married to", "married", "wife",
                          "husband", " wed ", "配偶", "伴侣", "结婚"],
            "born_in": ["born in", "was born", "birthplace", "native of", "hails from",
                        "出生于", "出生在"],
            "released_in": ["released in", "released", "came out in", "came out on",
                            "put out in", "put out on", "发行于", "发行在", "发布于"],
            "member_of": ["member of", "joined", "成员", "属于"],
            "founded_by": ["founded by", "founded", "established by", "established",
                           "started by", "创立", "成立", "创办"],
            "located_in": ["located in", "capital of", "is a city in", "is a town in",
                           "位于"],
            "directed_by": ["directed by", "directed", "执导", "导演"],
        },
        "type_hints": {"album": ["(album)", "专辑"], "song": ["(song)", "歌曲"],
                       "film": ["(film)", "电影"],
                       "person": ["(person)", "Dr.", "先生", "女士"]},
        "relation_type_map": {
            "performed_by": {"head": "song", "tail": "person"},
            "released_in": {"head": "album", "tail": "year"},
            "born_in": {"head": "person", "tail": "place"},
            "spouse_of": {"head": "person", "tail": "person"},
            "member_of": {"head": "person", "tail": "organization"},
        },
        "fallback_splitters": [" is ", " was ", " were ", " by ", " in ", " of ",
                               "于", "在"],
        "default_rel": "related_to",
        "normalize": {"strip_quotes": True, "collapse_space": True, "lower": False},
    },
    # the offline knowledge-base build (doc/processor.py and what it runs)
    "system": {"device": "cuda"},
    "storage": {
        "work_dir": "./result/work",
        "vector_index_path": "./result/vector_index",
        "embedding_cache_path": "./result/embedding_cache",
        "vector_store_path": "./result/vector_store",
        "processed_docs_path": "./result/processed_docs",
        "result_root": "./result",
    },
    "chunking": {"strategy": "sentence", "max_chunk_chars": 512, "overlap_chars": 0,
                 "min_chunk_chars": 20},
    "clustering": {"method": "kmeans", "n_clusters": 0, "max_clusters": 20,
                   "min_samples": 3, "eps": None},
    "enhanced_relation_extraction": {
        "use_llm_extraction": False, "use_fast_model": True, "enable_topic_groups": True,
        "enable_reasoning_paths": False, "lightweight_relations": {},
        "consistency_check": {}},
    "atomic_note_generation": {
        "parallel_enabled": False,
        "parallel_strategy": "task_division",
        "task_division": {"enabled": True, "allocation_method": "round_robin",
                          "enable_fallback": True, "fallback_timeout": 10},
        "ollama": {"model": "qwen2.5:latest", "base_url": "http://localhost:11434",
                   "timeout": 30, "temperature": 0.1, "max_async": 4},
        "lmstudio": {"model": "qwen2.5-7b-instruct",
                     "base_url": "http://localhost:1234/v1", "timeout": 60,
                     "temperature": 0.1},
        "monitoring": {"enabled": True, "log_stats": True, "export_metrics": False},
    },
    "notes_llm": {
        "use_llm": True,
        "use_v2_schema": True,
        "stream_early_stop": True,
        "sentinel_char": "~",
        "enable_fast_path": True,
        "retry_once_on_parse_error": True,
        "shorten_on_retry_chars": 1000,
        "min_chars": 20,
        "max_chars": 400,
        "min_salience": 0.3,
        "max_notes_per_chunk": 12,
        "max_note_chars": 200,
        "enable_rule_fallback": True,
        "grounding": {"enabled": True, "min_entity_len": 3,
                      "repair": {"enabled": True, "min_ratio": 0.66,
                                 "augment_uncovered": True, "retry": True}},
        "entities_fallback": {"enabled": True, "min_len": 2,
                              "types": ["PERSON", "ORG", "GPE", "WORK_OF_ART", "EVENT"]},
        "limit": {"strategy": "bucketed",
                  "bucket": {"by": "paragraph_idx", "quota_per_bucket": 1}},
        "llm_params": {"temperature": 0, "top_p": 0, "max_tokens": 128,
                       "stop": ["\n\n", "~"]},
    },
    "quality_filter": {"require_entities": False, "min_chars": 20, "min_salience": 0.3},
    "note_completeness": {
        "require_sentence_terminal": True,
        "allowed_sentence_terminals": [".", "!", "?"],
        "min_word_count_en": 4,
        "min_char_count_zh": 8,
        "verb_patterns_en": [],
        "verb_patterns_zh": [],
        "bad_starts_en": [],
        "bad_starts_zh": [],
        "require_entities": False,
    },
    "note_quality": {
        "related_notes": {"enabled": False, "similarity_threshold": 0.75,
                          "max_related_notes": 5},
        "noise_filter": {"enabled": False, "usefulness_threshold": 0.65,
                         "min_content_length": 20},
    },
    "evaluation": {
        "coverage_thresholds": {"warning": 0.7, "critical": 0.5},
        "coverage_report_path": "debug/coverage_report.json",
        "coverage": {"enabled": False, "threshold": 0.6, "min_sentence_tokens": 6,
                     "critical_threshold": 0.5,
                     "report_path": "debug/coverage_report.json",
                     "missing_sentences_path": "debug/missing_sentences.jsonl"},
    },
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
    # the LLM layer (llm/local_llm.py, llm/factory.py, llm/multi_model.py)
    "llm": {
        "provider": "openai",
        "model": "gpt-3.5-turbo",
        "temperature": 0.7,
        "max_output_tokens": 512,
        "openai": {"api_key": "", "base_url": "https://api.openai.com/v1"},
        "ollama": {"base_url": "http://localhost:11434", "model": "qwen2.5:latest",
                   "timeout": 30},
        "lmstudio": {"base_url": "http://localhost:1234/v1"},
        "local_model": {"temperature": 0.7, "max_tokens": 512},
        "hybrid_llm": {
            "mode": "task_division",
            "light_tasks": {
                "provider": "ollama",
                "model": "qwen2.5:latest",
                "base_url": "http://localhost:11434",
                "timeout": 30,
                "max_async": 4,
                "num_ctx": 4096,
                "temperature": 0.1,
            },
            "heavy_tasks": {
                "provider": "lmstudio",
                "model": "openai/gpt-oss-20b",
                "base_url": "http://localhost:1234/v1",
                "instances": 2,
                "timeout": 60,
            },
        },
    },
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


config = Config()
