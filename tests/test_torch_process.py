"""The port's per-query pipeline (QueryProcessor.process) and its graph
stages against anorag_tpu's, on the CPU.

Both packages run on the same notes (tests/test_torch_slice.py's _notes
plus the multi-hop KB) with the hash embedder. process() must give exactly
the reference's answers, support idxs, answerability and method, and its
notes and candidate notes equal ids in equal order with scores to 1e-5:
with no LLM, with a stub LLM, filtered to a dataset, with a work_dir (the
same final_recall.jsonl), with cluster suppression, on the sub-question
path, with the graph-aware dispatcher and with the listwise rerank. Also
the graph ops on seeded graphs (build_csr, k_hop_frontier and
connected_components exactly, pagerank and k_hop_scores to rtol 1e-6), the
relation extractor's device route against its numpy route on planted
near-duplicates, the graph index against the reference's, a graph file
saved by anorag_tpu loaded through graph_file, and the config defaults the
pipeline reads.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anorag_tpu.config import ConfigLoader
from anorag_tpu.graph.builder import GraphBuilder as JGraphBuilder
from anorag_tpu.graph.graph_index import GraphIndex as JGraphIndex
from anorag_tpu.graph.quality import compute_metrics as j_compute_metrics
from anorag_tpu.graph.relation_extractor import RelationExtractor as JRelationExtractor
from anorag_tpu.models.hash_embedder import HashEmbedder
from anorag_tpu.ops import graph as jgraph
from anorag_tpu.query.processor import QueryProcessor as JQueryProcessor
from anorag_tpu_torch.graph import relation_extractor as trel
from anorag_tpu_torch.graph.builder import GraphBuilder
from anorag_tpu_torch.graph.graph_index import GraphIndex
from anorag_tpu_torch.graph.quality import compute_metrics
from anorag_tpu_torch.ops import graph as tgraph
from anorag_tpu_torch.config import Config
from anorag_tpu_torch.query.processor import QueryProcessor
from anorag_tpu_torch.retrieval.reranker import ListwiseReranker
from anorag_tpu_torch.testing import KB_QUESTIONS, kb_notes, planted_rows

from test_query_processor import MockLLM
from test_torch_answer import ALL_QUERIES
from test_torch_slice import QUERIES, _loader, _notes, _assert_same_rows

ANSWER_FIELDS = ("query", "answer", "predicted_answer", "predicted_support_idxs",
                 "predicted_answerable", "answer_method")
# multi-hop shapes the sub-question planner splits, and the KB questions
SUBQ_QUERIES = ["Who directed Silent River and who founded Nexus Labs?",
                "Who is the spouse of the performer of Blue Horizon?",
                "What is the founder of the company of Nexus Labs?"] + \
    [q for q, *_ in KB_QUESTIONS]


def _corpus():
    return _notes() + kb_notes()


def _pair(llm=None, corpus=None, graph_file=None, work_dirs=(None, None), **overrides):
    loader = _loader(**overrides)
    corpus = corpus or _corpus()
    jqp = JQueryProcessor(corpus, graph_file=graph_file, cfg=loader, llm=llm and llm(),
                          work_dir=work_dirs[0])
    qp = QueryProcessor(corpus, None, graph_file, llm and llm(), loader.as_dict(), None,
                        work_dirs[1], device="cpu")
    return jqp, qp


def assert_same_process(got, want, atol=1e-5):
    """process() results: the same keys, exactly equal answer fields, and
    notes and candidate notes of equal ids in equal order, scores to
    atol."""
    assert set(got) == set(want)
    assert {k: got[k] for k in ANSWER_FIELDS} == {k: want[k] for k in ANSWER_FIELDS}, \
        got["query"]
    _assert_same_rows([got["notes"], got["candidate_notes"]],
                      [want["notes"], want["candidate_notes"]], atol)


def _process_both(jqp, qp, queries, dataset=None):
    for q in queries:
        assert_same_process(qp.process(q, dataset), jqp.process(q, dataset))


@pytest.fixture(scope="module")
def pair():
    return _pair()


# ------------------------------------------------------------ process()
@pytest.mark.parametrize("i", range(len(ALL_QUERIES)), ids=lambda i: ALL_QUERIES[i][:40])
def test_process_equals_the_reference(pair, i):
    jqp, qp = pair
    want, got = jqp.process(ALL_QUERIES[i], qid=f"q{i}"), qp.process(ALL_QUERIES[i], qid=f"q{i}")
    assert_same_process(got, want)
    assert got["trace"] == want["trace"]
    assert got["context"] == want["context"]


@pytest.mark.parametrize("question,answer,method,answerable", KB_QUESTIONS)
def test_process_answers_the_kb_questions(pair, question, answer, method, answerable):
    got = pair[1].process(question)
    assert got["answer"] == answer and got["predicted_answerable"] is answerable
    assert method is None or got["answer_method"] == method


def test_process_reaches_the_graph_stages(pair):
    """The graph expansion, the two-hop bridges and the entity index take
    part: the KB question finds bridges, and the graph's reasoning paths
    (stage 7) give the reference's notes and paths."""
    from anorag_tpu_torch.utils.text import extract_entities_fallback, tokenize_no_stop

    jqp, qp = pair
    q = KB_QUESTIONS[0][0]
    assert qp.process(q)["trace"]["bridge_entities"]
    assert qp.multi_hop.graph_index.graph.n_edges == jqp.multi_hop.graph_index.graph.n_edges > 0
    kw = dict(top_k=20, keywords=tokenize_no_stop(q)[:8],
              entities=extract_entities_fallback(q))
    got, got_paths = qp.multi_hop.retrieve(query_emb=qp._query_embedding(q), **kw)
    want, want_paths = jqp.multi_hop.retrieve(query_emb=jqp.em.encode_queries([q])[0], **kw)
    assert got and all(n["retrieval_method"] == "graph" for n in got)
    assert [n["note_id"] for n in got] == [n["note_id"] for n in want]
    assert [p.nodes for p in got_paths] == [p.nodes for p in want_paths]
    np.testing.assert_allclose([n["graph_score"] for n in got],
                               [n["graph_score"] for n in want], rtol=1e-6)


@pytest.mark.parametrize("selector", [True, False])
def test_process_with_a_stub_llm_equals_the_reference(selector):
    jqp, qp = _pair(llm=MockLLM, **{"answer_selector.enabled": selector})
    queries = ["Who is the spouse of Aurora Lane?", KB_QUESTIONS[0][0], QUERIES[0],
               QUERIES[2]]
    _process_both(jqp, qp, queries)
    assert len(qp.llm.calls) == len(jqp.llm.calls) > 0
    assert [c["prompt"] for c in qp.llm.calls] == [c["prompt"] for c in jqp.llm.calls]
    assert qp.process(queries[0])["answer"] == "Chris Reed"


def test_process_filters_by_dataset_as_the_reference_does():
    corpus = _corpus()
    for i, n in enumerate(corpus):
        if i % 3 == 0:
            n["namespace"] = "ds1"
        elif i % 3 == 1:
            n["dataset"] = "ds2"
    jqp, qp = _pair(corpus=corpus)
    queries = [q for q, *_ in KB_QUESTIONS] + QUERIES[:4]
    for ds in ("ds1", "ds2", "none_such"):
        _process_both(jqp, qp, queries, ds)
    assert all(n.get("namespace", "ds1") == "ds1" and "dataset" not in n
               for q in queries for n in qp.process(q, "ds1")["notes"])


def _same_within(got, want, atol):
    """Equal structure and values, floats to atol."""
    if isinstance(want, float) and isinstance(got, float):
        return abs(got - want) <= atol
    if isinstance(want, dict) and isinstance(got, dict):
        return got.keys() == want.keys() and all(
            _same_within(got[k], want[k], atol) for k in want)
    if isinstance(want, list) and isinstance(got, list):
        return len(got) == len(want) and all(
            _same_within(g, w, atol) for g, w in zip(got, want))
    return got == want


def test_process_with_a_work_dir_writes_the_reference_audit(tmp_path):
    """final_recall.jsonl holds the reference's rows, floats to 1e-5, and
    its SHA1 is the one the port read back. The two files' SHA1s differ:
    the dense search's f32 scores differ from XLA's in the last bit
    (ROADMAP, rounding), and the file holds them."""
    from anorag_tpu_torch.utils.file_io import jsonl_sha1, read_jsonl

    jqp, qp = _pair(work_dirs=(tmp_path / "ref", tmp_path / "port"))
    for i, q in enumerate([KB_QUESTIONS[0][0], QUERIES[3], KB_QUESTIONS[2][0]]):
        want, got = jqp.process(q, qid=f"q{i}"), qp.process(q, qid=f"q{i}")
        assert_same_process(got, want)
        rows = read_jsonl(tmp_path / "port" / "final_recall.jsonl")
        assert _same_within(rows, read_jsonl(tmp_path / "ref" / "final_recall.jsonl"), 1e-5)
        assert [r["note_id"] for r in rows] == [n["note_id"] for n in got["notes"]]
        assert got["trace"]["final_recall_sha1"] == jsonl_sha1(rows)
        assert got["trace"]["final_recall_path"] == str(tmp_path / "port" / "final_recall.jsonl")
    assert (tmp_path / "port" / "retrieval_metrics.jsonl").exists()


@pytest.mark.parametrize("cos", [0.5, 0.85])
def test_process_with_cluster_suppression_equals_the_reference(cos):
    jqp, qp = _pair(**{"safety.cluster.enabled": True, "safety.cluster.cos_threshold": cos,
                       "safety.cluster.keep_per_cluster": 2})
    _process_both(jqp, qp, [q for q, *_ in KB_QUESTIONS] + QUERIES)


def test_process_on_the_subquestion_path_equals_the_reference():
    jqp, qp = _pair(**{"query.use_subquestion_decomposition": True,
                       "query.merge_strategy": "ranked"})
    for q in SUBQ_QUERIES:
        want, got = jqp.process(q), qp.process(q)
        assert_same_process(got, want)
        assert got["sub_questions"] == want["sub_questions"]
        assert got["merge_stats"] == want["merge_stats"]
    assert len(qp.process(SUBQ_QUERIES[0])["sub_questions"]) >= 2


@pytest.mark.parametrize("key", ["context_dispatcher.use_graph_aware",
                                 "retrieval.use_graph_rerank"])
def test_process_with_the_graph_aware_dispatcher_equals_the_reference(key):
    jqp, qp = _pair(**{key: True, "retrieval.edge_thresh": 0.5})
    assert qp.dispatcher.gar is not None and jqp.dispatcher.gar is not None
    _process_both(jqp, qp, [q for q, *_ in KB_QUESTIONS] + QUERIES)
    seeds = list(range(0, 40, 3))
    q = qp._query_embedding(KB_QUESTIONS[0][0])
    got = qp.dispatcher.gar.generate_and_select_paths(seeds, query_emb=q,
                                                      query_entities=["Aurora Lane"])
    want = jqp.dispatcher.gar.generate_and_select_paths(seeds, query_emb=q,
                                                        query_entities=["Aurora Lane"])
    assert [p["note_ids"] for p in got] == [p["note_ids"] for p in want] and got
    np.testing.assert_allclose([p["score"] for p in got], [p["score"] for p in want],
                               rtol=1e-5)


def test_process_with_the_listwise_rerank_equals_the_reference():
    jqp, qp = _pair(**{"rerank.enabled": True})
    _process_both(jqp, qp, [q for q, *_ in KB_QUESTIONS] + QUERIES[:4])
    with pytest.raises(NotImplementedError, match="cross_encoder"):
        ListwiseReranker(backend="jax").score("q", [{"title": "t", "content": "c"}])


def test_process_without_the_graph_equals_the_reference():
    jqp, qp = _pair(**{"retrieval.multi_hop.enabled": False,
                       "context_dispatcher.enabled": False})
    assert qp.multi_hop is None
    _process_both(jqp, qp, [q for q, *_ in KB_QUESTIONS] + QUERIES[:4])


# ------------------------------------------------------------ graph file
def test_graph_file_loads_a_graph_the_reference_saved(tmp_path):
    """A GraphIndex that anorag_tpu built and saved loads in the port
    through graph_file, and process() then equals the reference's."""
    corpus = _corpus()
    emb = HashEmbedder(dim=128).encode([n["content"] for n in corpus])
    JGraphBuilder().build_graph(corpus, emb).save(tmp_path / "graph.json")
    jqp, qp = _pair(graph_file=str(tmp_path / "graph.json"))
    gi, jgi = qp.multi_hop.graph_index, jqp.multi_hop.graph_index
    assert gi.edge_meta == jgi.edge_meta and gi.notes == jgi.notes
    np.testing.assert_array_equal(gi.embeddings.numpy(), jgi.embeddings)
    np.testing.assert_allclose(gi.centrality, jgi.centrality, rtol=1e-6)
    _process_both(jqp, qp, [q for q, *_ in KB_QUESTIONS] + QUERIES[:4])


def test_graph_index_saved_by_the_port_loads_in_the_reference(tmp_path):
    corpus = _corpus()
    emb = HashEmbedder(dim=64).encode([n["content"] for n in corpus])
    gi = GraphBuilder(device="cpu").build_graph(corpus, emb)
    gi.save(tmp_path / "g.json")
    jgi = JGraphIndex.load(tmp_path / "g.json")
    back = GraphIndex.load(tmp_path / "g.json", device="cpu")
    assert back.edge_meta == jgi.edge_meta and back.notes == jgi.notes
    for other in (jgi, back):
        assert _triples(other.edge_meta) == _triples(gi.edge_meta)
        np.testing.assert_array_equal(np.asarray(other.embeddings), gi.embeddings.numpy())
        np.testing.assert_allclose(other.centrality, gi.centrality, rtol=1e-6)
    assert compute_metrics(back) == j_compute_metrics(jgi)


# ------------------------------------------------------------ graph build
@pytest.mark.parametrize("dim", [32, 128])
def test_graph_builder_equals_the_reference(dim):
    corpus = _corpus()
    emb = HashEmbedder(dim=dim).encode([n["content"] for n in corpus])
    groups = [[n["note_id"] for n in corpus[i:i + 9]] for i in range(0, 60, 9)]
    jgi = JGraphBuilder().build_graph(corpus, emb, topic_groups=groups)
    gi = GraphBuilder(device="cpu").build_graph(corpus, torch.from_numpy(emb),
                                                topic_groups=groups)
    assert gi.edge_meta == jgi.edge_meta
    for name in ("indptr", "indices", "weights", "edge_types", "nbr", "nbr_w", "nbr_t"):
        np.testing.assert_array_equal(getattr(gi.graph, name), getattr(jgi.graph, name))
    np.testing.assert_allclose(gi.centrality, jgi.centrality, rtol=1e-6)
    assert gi.embeddings.dtype == torch.float32
    assert compute_metrics(gi) == j_compute_metrics(jgi)
    assert [gi.neighbors(i) for i in range(10)] == [jgi.neighbors(i) for i in range(10)]


def _triples(rels):
    return [(r["source"], r["target"], r["relation_type"]) for r in rels]


@pytest.mark.parametrize("seed", range(3))
def test_relation_extractor_device_route_equals_the_numpy_route(monkeypatch, seed):
    """The route the card takes (dense_topk(..., method="kernel"), its
    plain version dense_topk_ref on CPU tensors) against the numpy route
    and the reference's relations: the 0.7 threshold, the j > i rule and
    the k cap all reached."""
    emb = planted_rows(np.random.default_rng(seed), 96, 48)
    notes = [{"note_id": f"p{i}"} for i in range(len(emb))]
    host = trel.RelationExtractor(device="cpu")
    want = JRelationExtractor()._semantic_similarity(notes, emb)
    got_host = host._semantic_similarity(notes, emb)
    assert got_host == want
    monkeypatch.setattr(trel, "SEMANTIC_QUERY_CHUNK", 32)
    monkeypatch.setattr(trel.RelationExtractor, "_host_route", lambda self, n: False)
    got_dev = trel.RelationExtractor(device="cpu")._semantic_similarity(
        notes, torch.from_numpy(emb))
    assert _triples(got_dev) == _triples(want)
    np.testing.assert_allclose([r["similarity"] for r in got_dev],
                               [r["similarity"] for r in want], rtol=1e-6)
    np.testing.assert_allclose([r["weight"] for r in got_dev],
                               [r["weight"] for r in want], rtol=1e-6)
    pairs = set((r["source"], r["target"]) for r in want)
    assert (5, 70) in pairs and (6, 71) in pairs
    assert (12, 90) not in pairs and (13, 91) not in pairs
    # row 40 has 8 neighbours above the threshold and keeps its top 5
    assert sorted(t for s, t in pairs if s == 40) == [41, 42, 43, 44, 45]
    assert sum(1 for s, t in pairs if 40 <= s <= 48 and 40 <= t <= 48) >= 12
    assert all(s < t for s, t in pairs)


def test_relation_extractor_host_route_rule():
    cpu = trel.RelationExtractor(device="cpu")
    assert cpu._host_route(20_000) and cpu._host_route(23_000)
    assert not cpu._host_route(24_000)
    card = trel.RelationExtractor.__new__(trel.RelationExtractor)
    card.device = torch.device("cuda")
    assert card._host_route(20_000) and not card._host_route(20_001)


# ------------------------------------------------------------ graph ops
def _seeded_graph(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 80))
    m = int(rng.integers(0, 4 * n))
    edges = [(int(rng.integers(n)), int(rng.integers(n)),
              float(np.float32(rng.random() * 2)), int(rng.integers(18)))
             for _ in range(m)]
    max_deg = None if seed % 3 else int(rng.integers(1, 5))
    return n, edges, max_deg, rng


@pytest.mark.parametrize("seed", range(8))
def test_build_csr_equals_the_reference(seed):
    n, edges, max_deg, _ = _seeded_graph(seed)
    got = tgraph.build_csr(n, edges, max_deg, device="cpu")
    want = jgraph.build_csr(n, edges, max_deg)
    for name in ("indptr", "indices", "weights", "edge_types", "nbr", "nbr_w", "nbr_t"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
        assert getattr(got, name).dtype == getattr(want, name).dtype
    assert (got.n_nodes, got.n_edges) == (want.n_nodes, want.n_edges)


@pytest.mark.parametrize("seed", range(8))
def test_pagerank_equals_the_reference(seed):
    n, edges, max_deg, _ = _seeded_graph(seed)
    g = jgraph.build_csr(n, edges, max_deg)
    for alpha, iters in ((0.85, 30), (0.5, 7)):
        want = np.asarray(jgraph.pagerank(jnp.asarray(g.nbr), jnp.asarray(g.nbr_w),
                                          alpha=alpha, iters=iters))
        got = tgraph.pagerank(torch.from_numpy(g.nbr), torch.from_numpy(g.nbr_w),
                              alpha=alpha, iters=iters)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", range(8))
def test_k_hop_scores_frontier_and_components_equal_the_reference(seed):
    n, edges, max_deg, rng = _seeded_graph(seed)
    jg = jgraph.build_csr(n, edges, max_deg)
    tg = tgraph.build_csr(n, edges, max_deg, device="cpu")
    cent = rng.random(n).astype(np.float32)
    seeds = [int(s) for s in rng.integers(-2, n + 2, 4)]
    for k in (0, 1, 2, 4):
        want = jgraph.k_hop_scores(jg, seeds, cent, k_hops=k)
        got = tgraph.k_hop_scores(tg, seeds, cent, k_hops=k)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        mask = rng.random(n) < 0.1
        np.testing.assert_array_equal(
            tgraph.k_hop_frontier(torch.from_numpy(tg.nbr), torch.from_numpy(mask), k).numpy(),
            np.asarray(jgraph.k_hop_frontier(jnp.asarray(jg.nbr), jnp.asarray(mask), k)))
    for iters in (1, 3, 64):
        np.testing.assert_array_equal(tgraph.connected_components(tg, iters),
                                      jgraph.connected_components(jg, iters))
    assert tgraph.k_hop_scores(tg, [-1, n], cent).tolist() == [0.0] * n


def test_path_score_components_equals_the_reference():
    rng = np.random.default_rng(4)
    args = (rng.random((9, 3)).astype(np.float32), rng.integers(0, 4, 9),
            rng.random(9).astype(np.float32), rng.random(9).astype(np.float32))
    np.testing.assert_array_equal(tgraph.path_score_components(*args, alpha=0.4, beta=0.2),
                                  jgraph.path_score_components(*args, alpha=0.4, beta=0.2))


def test_graph_tensors_follow_the_graph_device():
    g = tgraph.build_csr(3, [(0, 1, 0.5, 2)], device="cpu")
    t = g.tensors()
    assert t["nbr"].device.type == "cpu" and t["nbr"].dtype == torch.int64
    assert g.tensors() is t
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tgraph.build_csr(3, [(0, 1, 0.5, 2)]).tensors()
        with pytest.raises(RuntimeError, match="CUDA"):
            GraphIndex()


# ------------------------------------------------------------ config
PROCESS_KEYS = (
    "hybrid_search.bm25.k1", "hybrid_search.bm25.b", "hybrid_search.bm25.corpus_field",
    "hybrid_search.fallback.query_rewrite_enabled",
    "hybrid_search.two_hop_expansion.enabled",
    "hybrid_search.two_hop_expansion.top_m_candidates",
    "hybrid_search.two_hop_expansion.max_second_hop_candidates",
    "hybrid_search.section_filtering.enabled", "hybrid_search.lexical_fallback.enabled",
    "hybrid_search.lexical_fallback.miss_penalty",
    "hybrid_search.lexical_fallback.noise_threshold", "hybrid_search.multi_hop.hop_decay",
    "retrieval.candidate_pool", "retrieval.bm25_topk_hop1", "retrieval.embed_topk_hop1",
    "retrieval.use_graph_rerank", "retrieval.subgraph_radius", "retrieval.edge_thresh",
    "retrieval.overlap_thresh", "retrieval.token_budget", "retrieval.alpha",
    "retrieval.beta", "retrieval.gamma", "retrieval.lambda_len",
    "retrieval.graph.expand_top_m", "retrieval.multi_hop.enabled",
    "retrieval.multi_hop.max_hops", "retrieval.multi_hop.max_paths",
    "retrieval.multi_hop.min_path_score", "retrieval.multi_hop.min_path_score_floor",
    "retrieval.multi_hop.min_path_score_step",
    "retrieval.multi_hop.path_diversity_threshold",
    "retrieval.multi_hop.max_initial_candidates", "path_aware.enabled",
    "recall_optimizer.multi_hop_enabled", "recall_optimizer.max_hops",
    "recall_optimizer.hop_similarity_threshold", "recall_optimizer.comprehensive_rerank",
    "rerank.enabled", "rerank.listt5_input_topk", "rerank.keep_after_listt5",
    "rerank.backend", "rerank.checkpoint", "context_dispatcher.enabled",
    "context_dispatcher.final_semantic_count", "context_dispatcher.final_graph_count",
    "context_dispatcher.bridge_policy", "context_dispatcher.bridge_boost_epsilon",
    "context_dispatcher.debug_log", "context_dispatcher.use_graph_aware",
    "context_dispatcher.token_budget", "safety.per_hop_keep_top_m",
    "safety.lower_threshold", "safety.cluster.enabled", "safety.cluster.cos_threshold",
    "safety.cluster.keep_per_cluster", "query.use_subquestion_decomposition",
    "query.merge_strategy", "vector_store.top_k",
)


@pytest.mark.parametrize("key", PROCESS_KEYS)
def test_process_config_defaults_equal_the_reference(key):
    assert Config().get(key) == ConfigLoader(auto_load=False).get(key)
