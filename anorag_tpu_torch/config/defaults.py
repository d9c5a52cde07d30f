"""Complete default configuration skeleton of the port.

Counterpart of anorag_tpu/config/defaults.py: the same keys and values
(configs written for the reference work here), except the two that name
the port's own device and encoder backend, listed in PORT_VALUES. The
`tpu` section keeps its name; the port reads its sharded_search,
mesh.model_parallel_size and ivf keys.
"""
from __future__ import annotations

import copy
from typing import Any, Dict


def _d(**kw: Any) -> Dict[str, Any]:
    return dict(**kw)


DEFAULT_CONFIG: Dict[str, Any] = {
    # ---------------------------------------------------------------- system
    "system": {"project_name": "anorag-tpu", "seed": 42, "device": "cuda"},
    # New: TPU execution parameters (mesh + kernels). No reference analogue.
    "tpu": {
        "mesh": {
            # data = corpus/batch sharding axis, model = tensor-parallel axis.
            "data_axis": "data",
            "model_axis": "model",
            "model_parallel_size": 1,  # 1 => pure data parallel
        },
        # auto => row-shard the corpus + run sharded hybrid search whenever
        # more than one device is attached; on forces a (possibly 1-device)
        # mesh; off pins every search single-device.
        "sharded_search": "auto",
        "compute_dtype": "bfloat16",
        "compilation_cache_dir": "~/.cache/anorag_jax",
        "accum_dtype": "float32",
        "kernels": {
            # Fused dense top-k kernel
            "topk_block_rows": 1024,   # corpus rows scanned per grid step
            "recall_target": 0.95,     # approx_max_k recall (dense search)
            "topk_interpret": "auto",  # auto|true|false: pallas interpret mode
            "use_pallas": "auto",      # auto => pallas on TPU, XLA elsewhere
        },
        "ivf": {
            "nlist": 20,
            "nprobe": 4,
            "kmeans_iters": 15,
        },
        "bm25_device": {
            "enabled": True,
            "max_query_terms": 32,
            "postings_pad_multiple": 128,
        },
    },
    # -------------------------------------------------------------- document
    "document": {"chunk_size": 256, "overlap": 32},
    "chunking": {
        "strategy": "sentence",          # sentence | paragraph | event_aware
        "max_chunk_chars": 512,
        "overlap_chars": 0,
        "min_chunk_chars": 20,
    },
    # ------------------------------------------------------------- embedding
    "embedding": {
        "model_name": "BAAI/bge-m3",
        "batch_size": 64,
        "max_length": 512,
        "normalize": True,
        "dim": 1024,
        # hash = deterministic feature-hash embedder (no weights, for tests
        # and LLM-free corpora); torch = the transformer encoder (the
        # reference's jax, which the port also reads as torch).
        "backend": "torch",
        "query_prefix": "",
        "include_entities": True,
    },
    "encoder": {
        # Architecture of the JAX encoder ("bge-m3 class" = XLM-R large).
        "vocab_size": 250002,
        "hidden_size": 1024,
        "num_layers": 24,
        "num_heads": 16,
        "intermediate_size": 4096,
        "max_position": 512,
        "pooling": "cls",          # cls | mean
        "dtype": "bfloat16",
    },
    # --------------------------------------------------------------- note keys
    "note_keys": {
        # CJK cue surfaces restored for reference parity (the reference
        # ships zh cues beside its multilingual bge-m3 embedder,
        # config_loader.py:17-45); exact-cue matching is substring-based
        # so they work unsegmented
        "rel_lexicon": {
            "performed_by": ["performed by", "the performer is", "sung by",
                             "sings", "album by", "record by",
                             "recorded the album", "由", "演奏", "演出"],
            "spouse_of": ["spouse", "partner", "married to", "married",
                          "wife", "husband", " wed ", "配偶", "伴侣",
                          "结婚"],
            "born_in": ["born in", "was born", "birthplace", "native of",
                        "hails from", "出生于", "出生在"],
            "released_in": ["released in", "released", "came out in",
                            "came out on", "put out in", "put out on",
                            "发行于", "发行在", "发布于"],
            "member_of": ["member of", "joined", "成员", "属于"],
            "founded_by": ["founded by", "founded", "established by",
                           "established", "started by", "创立", "成立",
                           "创办"],
            "located_in": ["located in", "capital of", "is a city in",
                           "is a town in", "位于"],
            "directed_by": ["directed by", "directed", "执导", "导演"],
        },
        "type_hints": {
            "album": ["(album)", "专辑"],
            "song": ["(song)", "歌曲"],
            "film": ["(film)", "电影"],
            "person": ["(person)", "Dr.", "先生", "女士"],
        },
        "relation_type_map": {
            "performed_by": {"head": "song", "tail": "person"},
            "released_in": {"head": "album", "tail": "year"},
            "born_in": {"head": "person", "tail": "place"},
            "spouse_of": {"head": "person", "tail": "person"},
            "member_of": {"head": "person", "tail": "organization"},
        },
        "fallback_splitters": [" is ", " was ", " were ", " by ", " in ",
                               " of ", "于", "在"],
        "default_rel": "related_to",
        "normalize": {"strip_quotes": True, "collapse_space": True, "lower": False},
    },
    # ------------------------------------------------------------------ graph
    "graph": {
        "edge": {
            "base_weight": 0.0,
            "key_match_weight": 1.5,
            "type_compat_weight": 1.0,
            "same_paragraph_bonus": 0.3,
            "same_title_bonus": 0.2,
        },
        "relation_extraction": {
            "semantic_similarity_threshold": 0.7,
            "max_semantic_edges_per_note": 5,
            "enable_llm_relations": False,
            "llm_window": 10,
            "max_edges_per_note": 20,
        },
        "pagerank": {"alpha": 0.85, "iters": 30},
    },
    "multi_hop": {
        "max_hops": 4,
        "beam_size": 8,
        "branch_factor": 6,
    },
    # -------------------------------------------------------------- answering
    "answering": {
        "rel_chains": [["performed_by", "spouse_of"]],
        "relax_last_hop": ["spouse_of|partner_of"],
        "strict_person": {"enabled": True},
        "efsa_hint": {"enabled": True, "threshold": 0.70, "multi_candidate": 2},
        "final_evidence_first": True,
        "require_verbatim_spans": True,
        "force_insufficient_if_no_spans": True,
    },
    "retry": {"max_times": 1},
    "validator": {"allow_partial": True},
    "answer_selector": {
        "enabled": True,
        "anchor_top_k": 5,
        "use_candidate_pool": True,
        "apply_before_llm": True,
    },
    # ---------------------------------------------------------------- storage
    "storage": {
        "work_dir": "./result/work",
        "vector_index_path": "./result/vector_index",
        "embedding_cache_path": "./result/embedding_cache",
        "vector_store_path": "./result/vector_store",
        "processed_docs_path": "./result/processed_docs",
        "result_root": "./result",
    },
    "model_path": "./models/default_model",
    "parallel_strategy": "thread",
    # -------------------------------------------------------------------- llm
    "llm": {
        "provider": "openai",
        "model": "gpt-3.5-turbo",
        "temperature": 0.7,
        "max_output_tokens": 512,
        "openai": {"api_key": "", "base_url": "https://api.openai.com/v1"},
        "ollama": {"base_url": "http://localhost:11434", "model": "qwen2.5:latest", "timeout": 30},
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
    # ------------------------------------------------------ component configs
    "diversity_scheduler_config_file": "./config/diversity_scheduler.yaml",
    "path_aware_ranker_config_file": "./config/path_aware_ranker.yaml",
    "retrieval_guardrail_config_file": "./config/retrieval_guardrail.yaml",
    "entity_predicate_normalizer_config_file": "./config/entity_predicate_normalizer.yaml",
    "embedding_strategy_config_file": "./config/embedding_strategy.yaml",
    # -------------------------------------------------------------- retrieval
    "retrieval": {
        "candidate_pool": 50,
        # per-hop recall pool sizes (reference config.yaml retrieval block)
        "bm25_topk_hop1": 40,
        "embed_topk_hop1": 30,
        "bm25_topk_hop2": 12,
        "embed_topk_hop2": 8,
        "query_rewrites_hop1": 2,
        "title_dedup": True,
        "entity_norm_dedup": True,
        "min_per_subq": 1,
        "json_parsing": {
            "max_retries": 3,
            "enable_smart_fallback": True,
            "fallback_message": "Unable to extract a meaningful answer from the provided context",
        },
        "performance": {
            "max_fallback_per_step": 8,
            "max_graph_expansion": 15,
            "max_entity_lookup": 12,
            "fallback_timeout_ms": 1000,
            "max_total_fallback": 10,
        },
        # graph-aware two-stage rerank (GraphAwareRetrieval params)
        "use_graph_rerank": False,
        "seeds_semantic": 50,
        "seeds_bm25": 30,
        "subgraph_radius": 2,
        "edge_thresh": 0.35,
        "k_paths": 20,
        "pick_paths": 4,
        "overlap_thresh": 0.5,
        "token_budget": 1800,
        "alpha": 0.5,
        "beta": 0.3,
        "gamma": 0.2,
        "rho": 0.25,
        "lambda_len": 0.05,
        "query_mode": "auto",
        "expansion": {
            "max_neighbors_hop1": 3,
            "max_neighbors_hop2": 2,
            "degree_cap": 50,
        },
        "rerank": {
            "cross_encoder": "",
            "final_topk": 15,
            "margin_threshold": 0.15,
            "diversity_by_title": True,
            "use_listt5": False,
            "listt5_model": "castorini/doc2query-t5-large-list",
            "listt5_input_topk": 50,
            "keep_after_listt5": 25,
            "max_seq_len": 2048,
            "batch_size": 4,
        },
        "context": {
            "max_tokens": 1800,
            "per_title_max": 1,
            "per_entity_sentences": 2,
            "evidence_first": True,
        },
        "bridge_aware": {
            "hop2_query": "{bridge_entity} {question_subgoal}",
            "require_bridge_hit": True,
        },
        "hybrid": {
            "enabled": True,
            "fusion_method": "linear",
            "weights": {"dense": 1.0, "bm25": 0.5, "graph": 0.5, "path": 0.1},
            "rrf_k": 60,
            "second_hop_safety": {},
            "multi_hop": {},
            "answer_bias": {},
        },
        "bm25": {"k1": 1.2, "b": 0.75, "text_field": "title_raw_span"},
        "graph": {"enabled": True, "k_hop": 2, "expand_top_m": 20},
        "multi_hop": {
            "enabled": True,
            "strategy": "hybrid",
            "max_hops": 4,
            "max_paths": 10,
            "min_path_score": 0.3,
            "min_path_score_floor": 0.1,
            "min_path_score_step": 0.05,
            "path_diversity_threshold": 0.7,
            "max_initial_candidates": 20,
            "top_k_seed": {"enabled": False, "seed_count": 5, "fallback_to_entity": True},
            "entity_extraction": {"enabled": True, "max_entities": 10},
            "hybrid_mode": {
                "primary_strategy": "entity_extraction",
                "fallback_strategy": "top_k_seed",
                "switch_threshold": 3,
            },
        },
    },
    "path_aware": {"enabled": True, "min_path_score": 0.3},
    # recall-optimizer sub-stages (parity: enhanced_recall_optimizer.py
    # :448-540 multi-hop decomposition + :542 comprehensive rerank); both
    # off by default — the tuned pipeline ordering stays authoritative,
    # flip on per-dataset
    "recall_optimizer": {
        "multi_hop_enabled": False,
        "max_hops": 3,
        "hop_similarity_threshold": 0.15,
        "comprehensive_rerank": False,
    },
    # ----------------------------------------------------------- hybrid search
    "hybrid_search": {
        "enabled": True,
        "fusion_method": "linear",
        "prf_bridge": {"enabled": True, "first_hop_topk": 2, "prf_topk": 20},
        "linear": {"vector_weight": 1.0, "bm25_weight": 0.5, "path_weight": 0.1},
        "rrf": {"k": 60, "vector_weight": 1.0, "bm25_weight": 1.0, "path_weight": 1.0},
        "weights": {"dense": 1.0, "bm25": 0.5, "graph": 0.5, "path": 0.1},
        "bm25": {"k1": 1.2, "b": 0.75, "corpus_field": "title_raw_span"},
        "path_aware": {"enabled": True},
        "retrieval_guardrail": {
            "enabled": True,
            "must_have_terms": {},
            "boost_entities": {},
            "boost_predicates": {},
            "predicate_mappings": {},
        },
        "fallback": {
            "enabled": True,
            "sparse_boost_factor": 1.5,
            "query_rewrite_enabled": True,
            "max_retries": 2,
        },
        "two_hop_expansion": {
            "enabled": True,
            "top_m_candidates": 20,
            "entity_extraction_method": "rule_based",
            "target_predicates": [
                "founded_by", "located_in", "member_of",
                "works_for", "part_of", "instance_of",
            ],
            "max_second_hop_candidates": 15,
            "merge_strategy": "weighted",
        },
        "section_filtering": {
            "enabled": True,
            "filter_rule": "main_entity_related",
            "fallback_to_lexical": True,
        },
        "lexical_fallback": {
            "enabled": True,
            "must_have_terms_sources": ["main_entity", "predicate_stems"],
            "miss_penalty": 0.6,
            "blacklist_penalty": 0.5,
            "noise_threshold": 0.20,
        },
        "namespace_filtering": {
            "enabled": True,
            "stages": ["initial_recall", "post_fusion", "post_two_hop", "final_scheduling"],
            "same_namespace_bm25_fallback": True,
            "strict_mode": True,
        },
        "multi_hop": {
            "max_hops": 4,
            "beam_width": 8,
            "per_hop_keep_top_m": 5,
            "focused_weight_by_hop": {1: 0.30, 2: 0.25, 3: 0.20, 4: 0.15},
            "hop_decay": 0.85,
            "lower_threshold": 0.10,
        },
        # who_person_boost: ref answer_bias; type_gate + subject_cooc_boost:
        # wh-type answer gating and question-subject co-occurrence evidence
        # (answer/efsa.py — lifted synthetic-200 EM substantially)
        "answer_bias": {"who_person_boost": 1.10, "type_gate": True,
                        "subject_cooc_boost": 1.0},
        "cluster_suppression": {"enabled": False, "cos_threshold": 0.9, "keep_per_cluster": 2},
        "features": {},
        "fusion": {},
        "rerank": {},
        "safety": {},
    },
    # -------------------------------------------------------------- dispatcher
    "dispatcher": {
        "final_semantic_count": 8,
        "final_graph_count": 5,
        "bridge_policy": "keepalive",
        "bridge_boost_epsilon": 0.02,
        "debug_log": True,
        "enabled": True,
        "k_hop": 2,
    },
    "context_dispatcher": {
        "enabled": True,
        "k_hop": 2,
        "final_semantic_count": 8,
        "final_graph_count": 5,
        "bridge_policy": "keepalive",
        "bridge_boost_epsilon": 0.02,
        "debug_log": True,
        "use_graph_aware": False,
        "token_budget": 1800,
    },
    "guardrail": {"enabled": True, "min_results": 1, "min_score": 0.0, "timeout_seconds": 30},
    # --------------------------------------------------- atomic note generation
    "atomic_note_generation": {
        "parallel_enabled": False,
        "parallel_strategy": "task_division",
        "task_division": {
            "enabled": True,
            "allocation_method": "round_robin",
            "enable_fallback": True,
            "fallback_timeout": 10,
        },
        "ollama": {
            "model": "qwen2.5:latest",
            "base_url": "http://localhost:11434",
            "timeout": 30,
            "temperature": 0.1,
            "max_async": 4,
        },
        "lmstudio": {
            "model": "qwen2.5-7b-instruct",
            "base_url": "http://localhost:1234/v1",
            "timeout": 60,
            "temperature": 0.1,
        },
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
        "grounding": {
            "enabled": True, "min_entity_len": 3,
            # repair-and-retry instead of reject-to-rule-notes: snap
            # corrupted surfaces to source, regenerate once, patch
            # coverage holes extractively (note_generator._repair_notes)
            "repair": {"enabled": True, "min_ratio": 0.66,
                       "augment_uncovered": True, "retry": True},
        },
        "entities_fallback": {
            "enabled": True,
            "min_len": 2,
            "types": ["PERSON", "ORG", "GPE", "WORK_OF_ART", "EVENT"],
        },
        "limit": {
            "strategy": "bucketed",
            "bucket": {"by": "paragraph_idx", "quota_per_bucket": 1},
        },
        "llm_params": {"temperature": 0, "top_p": 0, "max_tokens": 128, "stop": ["\n\n", "~"]},
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
    # --------------------------------------------------------- evidence rerank
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
    # ------------------------------------------------------------- vector store
    "vector_store": {
        "top_k": 20,
        "similarity_threshold": 0.5,
        "batch_size": 32,
        "dimension": 1024,
        # Flat | IVFFlat | IVFPQ (rotated-int8 sketch or codebook PQ) |
        # LSH (±1 sign-sketch MXU scan) | HNSW (native C++ graph)
        "index_type": "IVFFlat",
        "similarity_metric": "cosine",
        "nlist": 20,
        "pq_m": 0,            # IVFPQ code bytes/row; 0 = auto (D/8)
        "pq_rerank": 0,       # exact-refine pool; 0 = auto (n/500 capped)
        "pq_impl": "sketch",  # sketch (ops/sq.py) | codebook (ops/pq.py)
        "lsh_bits": 0,        # 0 = auto (D bits, FAISS IndexLSH default)
        "hnsw_m": 16,
        "ef_construction": 200,
        "ef_search": 0,       # 0 = auto (max(64, 4k))
    },
    "safety": {
        "per_hop_keep_top_m": 5,
        "lower_threshold": 0.1,
        "cluster": {"enabled": False, "cos_threshold": 0.85, "keep_per_cluster": 3},
    },
    # use_legacy_packing False => answer-first StructurePacker (reference
    # default, context/packer.py:30) with legacy fallback on errors
    # HTTP serving (serve.py): batches larger than stream_batch run the
    # pipelined process_stream path with stream_depth device batches in
    # flight (device dispatch of batch i+1 overlaps host stages of batch i)
    "serving": {"stream_batch": 64, "stream_depth": 3},
    "context": {"max_notes_for_llm": 20, "max_tokens": None,
                "use_legacy_packing": False},
    "ranking": {"dense_weight": 0.7, "bm25_weight": 0.3, "hop_decay": 0.8},
    # Listwise rerank stage (ref retrieval/listt5_reranker.py): backend
    # 'lexical' = overlap heuristic, 'jax' = trained cross-encoder
    # (models/cross_encoder.py); checkpoint = orbax dir of trained weights.
    "rerank": {
        "enabled": False,
        "backend": "lexical",
        "checkpoint": None,
        "listt5_input_topk": 24,
    },
    # ------------------------------------------------------------- subquestion
    "query": {
        "use_subquestion_decomposition": False,
        "merge_strategy": "weighted",
    },
    "cor": {
        "enabled": False,
        "max_rounds": 3,
        "confidence_tau": 0.8,
        "budget": 64,
        "tau_conf": 0.80,
        "eps_cov": 0.05,
        "hard_ce_cap": 250,
        "k0": 40,
        "beam_width": 8,
        "neighbor_cap": 8,
        "bi_top_m": 60,
        "ce_top_n": 20,
    },
    "calibration": {
        "listt5_weight": 0.35,
        "listt5_temperature": 1.0,
        "bm25": {},
        "graph": {},
        "multi_hop": {},
        "path": "",
    },
    "rerank": {"listt5_input_topk": 24, "keep_after_listt5": 16, "enabled": False},
    "clustering": {
        "method": "kmeans",       # kmeans | dbscan | hdbscan (density path)
        "n_clusters": 0,           # 0 => auto (elbow)
        "max_clusters": 20,
        "min_samples": 3,          # density: core-point threshold
        "eps": None,               # density: None => k-distance knee auto-eps
    },
    "eval": {"dataset": "musique", "timeout_seconds": 300},
    "scheduler": {"coverage_guard": True},
    "feature_switches": {
        "stable_note_id": {
            "enabled": True,
            "use_content_hash": True,
            "fallback_to_index": True,
        },
    },
    "notes_prompt": {
        "element_conservation": True,
        "enumeration_split": True,
        "enforce_entity_slot": True,
        "preserve_relationships": True,
    },
    "note_recovery": {
        "enable": True,
        "jaccard_threshold": 0.6,
        "merge_threshold": 0.35,
        "max_merge_tokens": 30,
        "max_new_notes": 3,
    },
    "evaluation": {
        "coverage_thresholds": {"warning": 0.7, "critical": 0.5},
        "coverage_report_path": "debug/coverage_report.json",
        # note source-coverage eval (ref utils/note_coverage_eval.py:46):
        # per-chunk sentence coverage report + missing-sentence dump
        "coverage": {
            "enabled": False,
            "threshold": 0.6,
            "min_sentence_tokens": 6,
            "critical_threshold": 0.5,
            "report_path": "debug/coverage_report.json",
            "missing_sentences_path": "debug/missing_sentences.jsonl",
        },
    },
    # note-quality post-passes on the enhanced generator (ref
    # utils/note_similarity.py + utils/enhanced_noise_filter.py)
    "note_quality": {
        "related_notes": {"enabled": False, "similarity_threshold": 0.75,
                          "max_related_notes": 5},
        "noise_filter": {"enabled": False, "usefulness_threshold": 0.65,
                         "min_content_length": 20},
    },
    "enhanced_relation_extraction": {
        "use_llm_extraction": False,
        "use_fast_model": True,
        "enable_topic_groups": True,
        "enable_reasoning_paths": False,
        "lightweight_relations": {},
        "consistency_check": {},
    },
}

DEPRECATED_KEYS = {
    "dispatcher": "context_dispatcher",
    "hybrid_search.linear.vector_weight": "hybrid_search.weights.dense",
}

# Legacy <-> new alias pairs that are kept in sync after merge, mirroring the
# reference's `_synchronize_aliases` behavior
# (upstream config/config_loader.py:487).
ALIAS_PAIRS = [
    ("dispatcher", "context_dispatcher"),
    ("retrieval.hybrid", "hybrid_search"),
    ("retrieval.bm25", "hybrid_search.bm25"),
    ("retrieval.multi_hop.max_hops", "multi_hop.max_hops"),
    ("hybrid_search.multi_hop.per_hop_keep_top_m", "safety.per_hop_keep_top_m"),
    ("hybrid_search.multi_hop.lower_threshold", "safety.lower_threshold"),
]

# The only defaults that differ from the reference's: the port runs on the
# card (cuda; a config's tpu or gpu names it too, cpu only when asked) and
# encodes with its torch encoder.
PORT_VALUES = {"system.device": "cuda", "embedding.backend": "torch"}


def default_config() -> Dict[str, Any]:
    """A fresh deep copy of the defaults skeleton."""
    return copy.deepcopy(DEFAULT_CONFIG)
