"""The port's answer stages against anorag_tpu's, on the CPU.

The host modules of the answer stages are copies of the reference's with
their imports renamed: their ASTs are held equal to the originals'. The
batched served path (process_batch, process_stream) runs in both packages
on the same notes (tests/test_torch_slice.py's _notes plus the multi-hop
KB) with the hash embedder: answers, support idxs, answerability and the
answer method must be exactly equal, the notes equal ids in equal order
with scores to 1e-5; with no LLM, with a stub LLM, with a calibration
file, and filtered to a dataset. Also k_hop_distances and KEstimator, the
answer stages' config defaults, and no machine path in the port.
"""
import ast
import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anorag_tpu.config import ConfigLoader
from anorag_tpu.ops.graph import k_hop_distances as j_k_hop_distances
from anorag_tpu.query.processor import QueryProcessor as JQueryProcessor
from anorag_tpu.support.k_estimator import KEstimator as JKEstimator
from anorag_tpu_torch.config import Config
from anorag_tpu_torch.ops.graph import k_hop_distances
from anorag_tpu_torch.query.processor import QueryProcessor
from anorag_tpu_torch.support.k_estimator import KEstimator
from anorag_tpu_torch.testing import KB_QUESTIONS, kb_notes

from test_query_processor import MockLLM, _kb_notes
from test_torch_slice import _WORDS, QUERIES, _loader, _notes, assert_same_answers

ROOT = Path(__file__).resolve().parents[1]
_HOME_PATH = re.compile(r"/(?:root|home)/")

# ------------------------------------------------- copied host modules
COPIED = ("utils/text.py utils/semtype.py utils/lexnorm.py utils/logging.py "
          "utils/file_io.py utils/json_parser.py graph/note_graph.py "
          "graph/beam_search.py retrieval/path_aware_ranker.py "
          "reasoning/qa_coverage.py support/k_estimator.py "
          "context/structure_pack.py context/packer.py answer/evidence_rerank.py "
          "answer/path_validator.py answer/support_fill.py answer/comparative.py "
          "answer/answer_selector.py answer/span_picker.py answer/verifier.py "
          "answer/efsa.py validators/final_answer_validator.py llm/prompts.py "
          "answer/final_answer.py native.py graph/quality.py index/entity_index.py "
          "context/dispatcher.py context/scheduler.py retrieval/recall_optimizer.py "
          "retrieval/diversity.py retrieval/query_planner.py query/subquestion.py "
          "query/evidence_merger.py retrieval/reranker.py graph/retriever.py "
          "graph/relation_extractor.py graph/graph_index.py graph/builder.py "
          "graph/multi_hop.py graph/graph_retrieval.py").split()

# module paths the port imports from instead of the reference's package
# __init__ re-exports (the port's package __init__ files stay empty)
_MODULE_MAP = {("anorag_tpu.validators", "validate_final_answer"):
               "anorag_tpu_torch.validators.final_answer_validator"}

# Parts of a copy that differ from the original by design, with the
# reason; everything else in the module is equal, the other top-level
# imports too. A name is a function (by qualified name) or a module-level
# constant, in both modules (then they must differ) or in one only (added
# or dropped), or a top-level import statement as ast.unparse writes it
# (the original's with its names mapped to the port's), in one module only.
_DEVICE = "takes the device (keyword only) and passes it on"
_TORCH = {"import torch": "the port's tensors"}
_DEVICE_HELPERS = {"from anorag_tpu_torch.device import DeviceLike, resolve_device":
                   "the device helpers"}
_JNP = {"import jax.numpy as jnp": "jax.numpy, which torch replaces"}
DIFFERS = {
    "utils/logging.py": {"profile_trace": "a torch.profiler range in place of "
                                          "jax.profiler's trace annotation"},
    "support/k_estimator.py": {"KEstimator.graph_distance":
                               "calls the port's torch k_hop_distances"},
    "graph/retriever.py": {"GraphRetriever._initial_candidates":
                           "one matvec on the device with cached row norms "
                           "(GraphIndex.cosines) in place of normalizing the "
                           "whole corpus on the host for every query; equal "
                           "up to rounding"},
    "retrieval/reranker.py": {"ListwiseReranker.__init__": _DEVICE,
                              "ListwiseReranker._get_cross_encoder":
                                  "builds the port's cross-encoder on that device"},
    "graph/relation_extractor.py": {
        **_TORCH, **_DEVICE_HELPERS,
        "SEMANTIC_HOST_ROWS": "the host route's row limit, named",
        "SEMANTIC_QUERY_CHUNK": "the queries of one top-k kernel launch",
        "RelationExtractor.__init__": _DEVICE,
        "RelationExtractor._semantic_similarity": "the device route is the "
            "streaming top-k kernel on the card (dense_topk(..., "
            "method='kernel')), chosen by _host_route",
        "RelationExtractor._host_route": "the reference's numpy-or-device rule "
                                         "with the extractor's device",
        "RelationExtractor._device_topk": "the self-join on the device in "
                                          "query chunks"},
    "graph/graph_index.py": {
        **_TORCH, **_DEVICE_HELPERS, **_JNP,
        "from anorag_tpu_torch.ops.graph import CSRGraph, build_csr, pagerank":
            "the original's import, which the next replaces",
        "from anorag_tpu_torch.ops.graph import CSRGraph, build_csr, cosines, pagerank":
            "ops.graph.cosines as well",
        "GraphIndex.__init__": _DEVICE,
        "GraphIndex.build_index": "keeps the embeddings as an f32 tensor on "
                                  "the device and runs PageRank there",
        "GraphIndex.save": "writes the embedding tensor back as numpy",
        "GraphIndex.cosines": "the port's cosine scores on the device "
                              "(ops.graph.cosines)"},
    "graph/builder.py": {**_DEVICE_HELPERS,
                         "GraphBuilder.__init__": _DEVICE,
                         "GraphBuilder.build_graph": _DEVICE},
    "graph/multi_hop.py": {**_TORCH, **_DEVICE_HELPERS,
                           "MultiHopQueryProcessor.__init__": _DEVICE + "; the "
                           "embeddings stay an f32 tensor"},
    "graph/graph_retrieval.py": {
        **_TORCH, **_JNP,
        "GraphAwareRetrieval.subgraph_nodes": "the thresholded relaxation on "
                                              "the graph's device tensors",
        "GraphAwareRetrieval.generate_and_select_paths": "the endpoints' "
            "similarities in one GraphIndex.cosines call on the device"},
}


def _rename(name):
    return "anorag_tpu_torch" + name[len("anorag_tpu"):] \
        if name == "anorag_tpu" or name.startswith("anorag_tpu.") else name


def _normalized(path: Path, original: bool):
    """The module's AST without docstrings, with the reference's import
    names mapped to the port's, and its functions by qualified name."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef)) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        if original and isinstance(node, ast.ImportFrom) and node.module:
            names = tuple(a.name for a in node.names)
            node.module = _MODULE_MAP.get((node.module, *names), _rename(node.module))
        if original and isinstance(node, ast.Import):
            for a in node.names:
                a.name = _rename(a.name)
    funcs = {}

    def walk(body, prefix):
        for i, node in enumerate(body):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                funcs[prefix + node.name] = (body, i)
            elif isinstance(node, ast.ClassDef):
                funcs[prefix + node.name] = (body, i)
                walk(node.body, prefix + node.name + ".")

    walk(tree.body, "")
    for i, node in enumerate(tree.body):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            funcs[node.targets[0].id] = (tree.body, i)
        if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            funcs[node.target.id] = (tree.body, i)
    return tree, funcs


def _imports(tree):
    return [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_the_original(rel):
    assert_copy_equal(rel, DIFFERS.get(rel, {}))


def assert_copy_equal(rel, differs):
    """The port's `rel` equals anorag_tpu's `rel` apart from `differs` (see
    DIFFERS)."""
    ref, ref_funcs = _normalized(ROOT / "anorag_tpu" / rel, original=True)
    port, port_funcs = _normalized(ROOT / "anorag_tpu_torch" / rel, original=False)
    drop = []
    for name in differs:
        if name.startswith(("import ", "from ")):
            have = [(tree.body, tree.body.index(n)) for tree in (ref, port)
                    for n in _imports(tree) if ast.unparse(n) == name]
            assert len(have) == 1, f"{rel}: {name!r} is in {len(have)} modules, not one"
            drop += have
            continue
        have = [funcs[name] for funcs in (ref_funcs, port_funcs) if name in funcs]
        assert have, f"{rel}: {name} is in neither module"
        if len(have) == 1:          # added or dropped
            drop.append(have[0])
            continue
        (rb, ri), (pb, pi) = have
        assert ast.dump(rb[ri]) != ast.dump(pb[pi]), f"{rel}: {name} no longer differs"
        rb[ri] = pb[pi] = ast.Pass()
    for body, i in sorted(drop, key=lambda bi: -bi[1]):
        del body[i]
    assert ast.dump(port) == ast.dump(ref), rel


def test_every_port_module_with_an_original_is_a_copy_or_a_rewrite():
    """A port file named as a reference file is either a copy held above
    or one of the port's own rewrites, listed here."""
    from test_torch_config import CONFIG_COPIED
    from test_torch_fusion import FUSION_COPIED
    from test_torch_llm import LLM_COPIED
    from test_torch_musique import MUSIQUE_COPIED
    from test_torch_offline import OFFLINE_COPIED
    from test_torch_parallel_engine import PARALLEL_COPIED
    from test_torch_training_cli import TRAINING_COPIED

    rewritten = {"device.py", "serving.py", "models/decoder_lm.py",
                 "query/processor.py", "retrieval/retriever.py", "ops/bm25.py",
                 "ops/topk.py", "ops/ivf.py", "ops/kmeans.py", "ops/graph.py",
                 "index/bm25_index.py", "index/vector_index.py",
                 "models/embedding_manager.py", "models/encoder.py",
                 "models/hash_embedder.py", "models/tokenizer.py",
                 "ops/pq.py", "ops/sq.py", "ops/lsh.py", "ops/fusion.py",
                 "models/cross_encoder.py", "models/hf_loader.py", "models/train.py",
                 "parallel/mesh.py", "parallel/runtime.py", "parallel/sharded_search.py"}
    both = {str(p.relative_to(ROOT / "anorag_tpu_torch"))
            for p in (ROOT / "anorag_tpu_torch").rglob("*.py")
            if p.name != "__init__.py"}
    both = {p for p in both if (ROOT / "anorag_tpu" / p).exists()}
    assert both == (set(COPIED) | set(LLM_COPIED) | set(OFFLINE_COPIED)
                    | set(CONFIG_COPIED) | set(MUSIQUE_COPIED) | set(FUSION_COPIED)
                    | set(TRAINING_COPIED) | set(PARALLEL_COPIED) | rewritten)


def test_copied_package_inits_are_empty():
    """Apart from llm/ and retrieval/, whose __init__ files re-export the
    reference's names (tests/test_torch_llm.py, tests/test_torch_fusion.py)."""
    for rel in {str(Path(r).parent) for r in COPIED} - {".", "llm", "retrieval"}:
        init = ROOT / "anorag_tpu_torch" / rel / "__init__.py"
        assert init.exists() and init.read_text() == "", rel


@pytest.mark.parametrize("path", sorted((ROOT / "anorag_tpu_torch").rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_names_no_machine_path(path):
    """No home directory of a machine (the originals' docstrings cite the
    upstream sources by such paths; the copies do not)."""
    assert not _HOME_PATH.search(path.read_text())


# ------------------------------------------------- process_batch parity
POLAR = "Does Aurora Lane have a spouse?"
UNANSWERABLE = "Who produced Silent River?"
# a shared suffix word alone does not cover a question entity
GHOST = "Who is the spouse of the performer of Ghostly Horizon?"


def _zipf_like(n=6, seed=5):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(_WORDS, int(rng.integers(3, 9)))) for _ in range(n)]


ALL_QUERIES = [q for q, *_ in KB_QUESTIONS] + [POLAR, UNANSWERABLE, GHOST] + QUERIES \
    + _zipf_like()


def _corpus():
    return _notes() + kb_notes()


def _pair(llm=None, corpus=None, **overrides):
    loader = _loader(**overrides)
    corpus = corpus or _corpus()
    jqp = JQueryProcessor(corpus, cfg=loader, llm=llm and llm())
    qp = QueryProcessor(corpus, None, None, llm and llm(), loader.as_dict(), device="cpu")
    return jqp, qp


@pytest.fixture(scope="module")
def answered():
    jqp, qp = _pair()
    return jqp.process_batch(ALL_QUERIES), qp.process_batch(ALL_QUERIES)


def test_kb_notes_are_the_reference_tests_kb():
    assert kb_notes() == _kb_notes()


@pytest.mark.parametrize("i", range(len(ALL_QUERIES)), ids=lambda i: ALL_QUERIES[i][:40])
def test_process_batch_answers_equal_the_reference(answered, i):
    want, got = answered
    assert_same_answers([got[i]], [want[i]])


@pytest.mark.parametrize("question,answer,method,answerable", KB_QUESTIONS)
def test_kb_questions_get_the_reference_tests_answers(answered, question, answer,
                                                      method, answerable):
    got = answered[1][ALL_QUERIES.index(question)]
    assert got["answer"] == answer and got["predicted_answerable"] is answerable
    assert method is None or got["answer_method"] == method


def test_the_queries_reach_every_answer_stage(answered):
    methods = {r["answer_method"] for r in answered[1]}
    assert {"answer_selector", "efsa", "unanswerable_gate", "polar_gate",
            "relation_gate"} <= methods


@pytest.mark.parametrize("selector", [True, False])
def test_process_batch_with_a_stub_llm_equals_the_reference(selector):
    jqp, qp = _pair(llm=MockLLM, **{"answer_selector.enabled": selector})
    queries = ["Who is the spouse of Aurora Lane?"] + [q for q, *_ in KB_QUESTIONS] \
        + [QUERIES[0], QUERIES[2]]
    want, got = jqp.process_batch(queries), qp.process_batch(queries)
    assert_same_answers(got, want)
    assert got[0]["answer"] == "Chris Reed"
    assert [r["answer_method"] == "llm" for r in got[:2]] == [not selector] * 2
    assert len(qp.llm.calls) == len(jqp.llm.calls) > 0


def _calibration(tmp_path, qp):
    """A calibration file with every component _load_calibration reads,
    its heads seeded at the port's feature widths."""
    rng = np.random.default_rng(3)
    v = qp.verifier
    widths = {"verifier": len(v.features("Who is A?", "A", "A is.")),
              "span_picker": len(v.span_picker.features("Who is A?", "A", "entity",
                                                        "A is.", 0.0)),
              "qa_coverage": len(qp.qa_scorer.features("Who is A?", "A is."))}
    comps = {name: {"w": rng.normal(size=n).round(3).tolist(), "b": 0.1}
             for name, n in widths.items()}
    comps["listwise"] = {"listt5_weight": 0.5}
    comps["learned_fusion"] = {"dense_weight": 0.8, "bm25_weight": 0.4}
    comps["k_estimator"] = {"complexity_per_k": 0.75}
    path = tmp_path / "calibration.json"
    path.write_text(json.dumps({"components": comps}))
    return path, comps


def test_process_batch_with_a_calibration_equals_the_reference(tmp_path):
    _, plain = _pair()
    path, comps = _calibration(tmp_path, plain)
    jqp, qp = _pair(**{"calibration.path": str(path)})
    np.testing.assert_array_equal(qp.verifier.w, np.float32(comps["verifier"]["w"]))
    np.testing.assert_array_equal(qp.verifier.span_picker.w, np.float32(comps["span_picker"]["w"]))
    np.testing.assert_array_equal(qp.qa_scorer.w, np.float32(comps["qa_coverage"]["w"]))
    assert (qp.fusion_dense_w, qp.fusion_sparse_w) == (jqp.fusion_dense_w,
                                                       jqp.fusion_sparse_w) == (0.8, 0.4)
    assert qp.packer.k_estimator.thresholds == jqp.packer.k_estimator.thresholds
    assert qp.cfg.get("calibration.listt5_weight") == 0.5
    assert_same_answers(qp.process_batch(ALL_QUERIES), jqp.process_batch(ALL_QUERIES))


def test_process_batch_filters_by_dataset_as_the_reference_does():
    corpus = _corpus()
    for i, n in enumerate(corpus):
        if i % 3 == 0:
            n["namespace"] = "ds1"
        elif i % 3 == 1:
            n["dataset"] = "ds2"
    jqp, qp = _pair(corpus=corpus)
    for ds in ("ds1", "ds2", None):
        got = qp.process_batch(ALL_QUERIES, ds)
        assert_same_answers(got, jqp.process_batch(ALL_QUERIES, ds))
    assert all(n.get("namespace", "ds1") == "ds1" and "dataset" not in n
               for r in qp.process_batch(ALL_QUERIES, "ds1") for n in r["notes"])


def test_process_stream_equals_the_reference_and_process_batch():
    jqp, qp = _pair()
    batches = [ALL_QUERIES[i:i + 4] for i in range(0, len(ALL_QUERIES), 4)]
    got = [r for out in qp.process_stream(batches, depth=2) for r in out]
    want = [r for out in jqp.process_stream(batches, depth=2) for r in out]
    assert_same_answers(got, want)
    assert_same_answers(got, [r for b in batches for r in qp.process_batch(b)], atol=0)
    top5 = [r for out in qp.process_stream(batches[:2], top_k=5, prefetch=1) for r in out]
    assert_same_answers(top5, [r for b in batches[:2] for r in qp.process_batch(b, top_k=5)],
                        atol=0)


# ------------------------------------------------- graph distance
@pytest.mark.parametrize("seed", range(8))
def test_k_hop_distances_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    n, width = int(rng.integers(2, 60)), int(rng.integers(1, 7))
    nbr = rng.integers(-1, n, (n, width)).astype(np.int32)
    w = (rng.random((n, width)) * 3).astype(np.float32)
    seed_mask = rng.random(n) < 0.15
    k = int(rng.integers(0, 6))
    jd, jh = j_k_hop_distances(jnp.asarray(nbr), jnp.asarray(w), jnp.asarray(seed_mask),
                               k_hops=k)
    td, th = k_hop_distances(torch.from_numpy(nbr), torch.from_numpy(w),
                             torch.from_numpy(seed_mask), k)
    assert td.dtype == torch.float32 and th.dtype == torch.int32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


def test_k_estimator_equals_the_reference(answered):
    j, t = JKEstimator(), KEstimator()
    hits = 0
    for row, q in zip(answered[1], ALL_QUERIES):
        notes = row["notes"]
        for cands in (notes, notes[:4], list(reversed(notes))):
            assert t.graph_distance(q, cands) == j.graph_distance(q, cands), q
            assert t.estimate_K_from_candidates(q, cands) == \
                j.estimate_K_from_candidates(q, cands), q
            hits += t.graph_distance(q, cands) is not None
    assert hits > 0


# ------------------------------------------------- config defaults
ANSWER_KEYS = (
    "answering.rel_chains", "answering.relax_last_hop", "answering.efsa_hint.enabled",
    "answering.efsa_hint.threshold", "answering.final_evidence_first",
    "answering.require_verbatim_spans", "answering.force_insufficient_if_no_spans",
    "answering.comparative.enabled", "answering.unanswerable_gate",
    "answer_selector.enabled", "answer_selector.apply_before_llm",
    "answer_selector.anchor_top_k", "multi_hop.max_hops", "multi_hop.beam_size",
    "multi_hop.branch_factor", "validator.allow_partial", "evidence_rerank",
    "hybrid_search.answer_bias.who_person_boost", "hybrid_search.answer_bias.type_gate",
    "hybrid_search.answer_bias.subject_cooc_boost", "hybrid_search.linear.vector_weight",
    "context.max_tokens", "context.use_legacy_packing", "context.max_notes_for_llm",
    "calibration.path", "calibration.listt5_weight", "serving.stream_batch",
    "serving.stream_depth", "serving.host_workers", "retry.max_times",
    "graph.edge.key_match_weight", "graph.edge.type_compat_weight",
    "graph.edge.same_paragraph_bonus", "note_keys.default_rel",
)


@pytest.mark.parametrize("key", ANSWER_KEYS)
def test_config_defaults_equal_the_reference(key):
    assert Config().get(key) == ConfigLoader(auto_load=False).get(key)


def test_config_set():
    cfg = Config({"answering": {"efsa_hint": {"threshold": 0.5}}})
    cfg.set("calibration.listt5_weight", 0.25)
    cfg.set("new.branch.leaf", 3)
    assert cfg.get("answering.efsa_hint.threshold") == 0.5
    assert cfg.get("answering.efsa_hint.enabled") is True
    assert (cfg.get("calibration.listt5_weight"), cfg.get("new.branch.leaf")) == (0.25, 3)
    cfg.get("new.branch")["leaf"] = 4
    assert cfg.get("new.branch.leaf") == 3
