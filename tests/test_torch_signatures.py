"""Every parameter of the reference's ported public functions and
constructors exists in the port, under its own name or the port's rename.

Code written for anorag_tpu must run against anorag_tpu_torch unchanged,
so a keyword the reference takes must not raise TypeError in the port. The
lists below are the only exceptions, each with its reason; a listed name
that the port has since taken up fails the test, so the lists stay exact.
"""
import inspect

import numpy as np
import pytest
import torch

import bench as jbench
import serve as jserve
from anorag_tpu.index import bm25_index as jindex
from anorag_tpu.index import vector_index as jvi
from anorag_tpu.ops import bm25 as jbm25
from anorag_tpu.ops import ivf as jivf
from anorag_tpu.ops import topk as jtopk
from anorag_tpu.graph import builder as jbuild
from anorag_tpu.graph import graph_index as jgi
from anorag_tpu.graph import multi_hop as jmh
from anorag_tpu.graph import relation_extractor as jrel
from anorag_tpu.ops import graph as jgraph
from anorag_tpu.query import processor as jproc
from anorag_tpu.retrieval import retriever as jret
from anorag_tpu import serving as jserving
from anorag_tpu_torch import bench as tbench
from anorag_tpu_torch.index import bm25_index as tindex
from anorag_tpu_torch.index import vector_index as tvi
from anorag_tpu_torch.ops import bm25 as tbm25
from anorag_tpu_torch.ops import ivf as tivf
from anorag_tpu_torch.ops import topk as ttopk
from anorag_tpu_torch.graph import builder as tbuild
from anorag_tpu_torch.graph import graph_index as tgi
from anorag_tpu_torch.graph import multi_hop as tmh
from anorag_tpu_torch.graph import relation_extractor as trel
from anorag_tpu_torch.ops import graph as tgraph
from anorag_tpu_torch.query import processor as tproc
from anorag_tpu_torch.retrieval import retriever as tret
from anorag_tpu_torch import serve as tserve
from anorag_tpu_torch import serving as tserving

# The port's names for the reference's.
RENAMES = {"use_pallas": "use_kernel"}   # the kernels are CUDA, not Pallas

# Parameters that only steer a Pallas kernel, by the function that takes
# them: the port's kernels have no interpret mode (on the CPU the plain
# version runs) and fix their own tiling.
_INTERPRET = ("runs a Pallas kernel on the CPU; the port runs the plain "
              "version there")
PALLAS_ONLY = {
    **{(label, "interpret"): _INTERPRET
       for label in ("dense_topk", "ivf_search", "segment_totals",
                     "segment_winners")},
    ("dense_topk", "block_rows"): "corpus rows per Pallas block; the streaming "
                                  "top-k kernel fixes its own 64-row tiles",
    ("segment_totals", "block_b"): "rows per Pallas block; the CUDA segment "
                                   "kernels take one row per thread block",
    ("segment_winners", "block_b"): "the same as for segment_totals",
}

# Parameters the port takes, so that a call written for the reference
# binds the same, but refuses (NotImplementedError) until the stage that
# reads them is ported, by the function that takes them. None is left:
# graph_file, the last, feeds process() since it was ported.
DEFERRED = {}

# (label, reference callable, port callable)
PAIRS = [
    ("VectorIndex.__init__", jvi.VectorIndex.__init__, tvi.VectorIndex.__init__),
    ("VectorRetriever.__init__", jret.VectorRetriever.__init__,
     tret.VectorRetriever.__init__),
    *[(f"VectorRetriever.{m}", getattr(jret.VectorRetriever, m),
       getattr(tret.VectorRetriever, m))
      for m in ("build_index", "search", "retrieve", "hybrid_search",
                "hybrid_search_dispatch", "hybrid_search_finalize")],
    *[(f"QueryProcessor.{m}", getattr(jproc.QueryProcessor, m),
       getattr(tproc.QueryProcessor, m))
      for m in ("__init__", "process", "process_batch", "process_stream")],
    *[(f"{cls}.{m}", getattr(jcls, m), getattr(tcls, m))
      for cls, jcls, tcls in (
          ("GraphIndex", jgi.GraphIndex, tgi.GraphIndex),
          ("GraphBuilder", jbuild.GraphBuilder, tbuild.GraphBuilder),
          ("RelationExtractor", jrel.RelationExtractor, trel.RelationExtractor),
          ("MultiHopQueryProcessor", jmh.MultiHopQueryProcessor,
           tmh.MultiHopQueryProcessor))
      for m in ("__init__", *{"GraphIndex": ("build_index", "save", "load"),
                              "GraphBuilder": ("build_graph",),
                              "RelationExtractor": ("extract_all_relations",),
                              "MultiHopQueryProcessor": ("retrieve",)}[cls])],
    *[(name, getattr(jgraph, name), getattr(tgraph, name))
      for name in ("build_csr", "pagerank", "k_hop_distances", "k_hop_scores",
                   "k_hop_frontier", "connected_components",
                   "path_score_components")],
    *[(f"serve.{name}", getattr(jserve, name), getattr(tserve, name))
      for name in ("build_processor", "make_handler", "main")],
    *[(f"ServingEngine.{m}", getattr(jserving.ServingEngine, m),
       getattr(tserving.ServingEngine, m)) for m in ("__init__", "submit", "process")],
    *[(name, getattr(jtopk, name), getattr(ttopk, name))
      for name in ("dense_topk", "dense_topk_np", "hybrid_topk",
                   "hybrid_fuse", "hybrid_topk_bucketed",
                   "hybrid_topk_bucketed_tiled", "make_bucketed_plan",
                   "bucket_topk")],
    ("ivf_search", jivf.ivf_search, tivf.ivf_search),
    *[(name, getattr(jbm25, name), getattr(tbm25, name))
      for name in ("build_postings", "gather_plan", "gather_plan_sorted",
                   "plan_tiles", "plan_tiles_bucketed", "sparse_topm_winners",
                   "sparse_topm_winners_bucketed", "sparse_topm_from_sorted",
                   "sparse_lookup_sorted", "score_from_plan", "bm25_scores",
                   "bm25_scores_np", "build_field_weighted")],
    ("segment_totals", jbm25.segment_totals_pallas, tbm25.segment_totals),
    ("segment_winners", jbm25.segment_winners_pallas, tbm25.segment_winners),
    ("FieldWeightedPostings.score", jbm25.FieldWeightedPostings.score,
     tbm25.FieldWeightedPostings.score),
    *[(f"BM25Index.{m}", getattr(jindex.BM25Index, m), getattr(tindex.BM25Index, m))
      for m in ("__init__", "query_terms", "scores", "topk")],
    *[(f"FieldWeightedBM25Index.{m}", getattr(jindex.FieldWeightedBM25Index, m),
       getattr(tindex.FieldWeightedBM25Index, m)) for m in ("__init__", "scores")],
    *[(f"Vocab.{m}", getattr(jindex.Vocab, m), getattr(tindex.Vocab, m))
      for m in ("add", "get", "encode")],
    ("note_text", jindex.note_text, tindex.note_text),
    *[(f"bench.{name}", getattr(jbench, name), getattr(tbench, name))
      for name in ("peak_tflops", "make_doc_terms", "make_query_terms",
                   "kernel_parity", "bench_hybrid", "bench_true_device",
                   "bench_encoder", "main")],
]


def _params(fn):
    return [p for p in inspect.signature(fn).parameters if p != "self"]


@pytest.mark.parametrize("label,ref,port", PAIRS, ids=[p[0] for p in PAIRS])
def test_port_takes_every_reference_parameter(label, ref, port):
    have = set(_params(port))
    missing, stale = [], []
    for p in _params(ref):
        name = RENAMES.get(p, p)
        excused = (label, p) in PALLAS_ONLY
        if excused and name in have:
            stale.append(p)
        elif not excused and name not in have:
            missing.append(p)
    assert not missing, f"{label}: the port lacks {missing}"
    assert not stale, f"{label}: the port now takes {stale}; update the lists"


def test_every_listed_exception_is_used():
    ref_params = {(label, p) for label, ref, _ in PAIRS for p in _params(ref)}
    assert set(RENAMES) <= {p for _, p in ref_params}
    assert set(PALLAS_ONLY) <= ref_params and set(DEFERRED) <= ref_params


def test_query_processor_takes_the_reference_parameters_in_order():
    """A positional call written for the reference binds each argument to
    the same parameter in the port; the device comes after them, keyword
    only."""
    ref = _params(jproc.QueryProcessor.__init__)
    port = inspect.signature(tproc.QueryProcessor.__init__).parameters
    assert list(port)[1:len(ref) + 1] == ref
    assert [n for n, p in port.items() if p.kind is p.KEYWORD_ONLY] == ["device"]


def test_deferred_parameters_are_refused():
    """No parameter is deferred any more: graph_file, the last, is taken
    as the reference takes it (a missing file builds the graph)."""
    notes = [{"note_id": "a", "content": "alpha beta"}]
    cfg = {"embedding": {"backend": "hash", "dim": 16}}
    qp = tproc.QueryProcessor(notes, None, "no_such_graph.json", cfg=cfg, device="cpu")
    assert qp.multi_hop.graph_index.notes[0]["note_id"] == "a"
    assert DEFERRED == {}


def test_vector_index_keeps_the_reference_options():
    idx = tvi.VectorIndex(dimension=8, index_type="Flat", pq_m=4, pq_rerank=16,
                          pq_impl="codebook", lsh_bits=64, hnsw_m=32,
                          ef_construction=100, ef_search=50, device="cpu")
    assert (idx.pq_m, idx.pq_rerank, idx.pq_impl, idx.lsh_bits, idx.hnsw_m,
            idx.ef_construction, idx.ef_search) == (4, 16, "codebook", 64, 32, 100, 50)
    rng = np.random.default_rng(0)
    idx.add(rng.standard_normal((20, 8)).astype(np.float32))
    vals, ids = idx.search_arrays(rng.standard_normal((2, 8)).astype(np.float32), 3)
    assert ids.shape == (2, 3)
    with pytest.raises(NotImplementedError, match="mesh"):
        tvi.VectorIndex(dimension=8, index_type="Flat", mesh=object(), device="cpu")
    for kind in ("IVFPQ", "LSH", "HNSW"):
        with pytest.raises(NotImplementedError):
            tvi.VectorIndex(dimension=8, index_type=kind, device="cpu")


def test_retriever_forwards_index_params_and_takes_recall_target():
    from anorag_tpu_torch.models.embedding_manager import EmbeddingManager
    from conftest import make_notes

    em = EmbeddingManager({"embedding": {"backend": "hash", "dim": 32}}, device="cpu")
    r = tret.VectorRetriever(em, index_type="Flat",
                             index_params={"pq_m": 8, "lsh_bits": 16, "hnsw_m": 8,
                                           "ef_search": 20})
    r.build_index(make_notes(12))
    assert (r.index.pq_m, r.index.lsh_bits, r.index.hnsw_m, r.index.ef_search) == \
        (8, 16, 8, 20)
    queries = ["Aurora Lane singer", "Nexus Labs founder"]
    want = r.hybrid_search(queries, top_k=4)
    got = r.hybrid_search(queries, top_k=4, recall_target=0.5)
    assert [[n["note_id"] for n in row] for row in got] == \
        [[n["note_id"] for n in row] for row in want]
    handle = r.hybrid_search_dispatch(queries, top_k=4, recall_target=0.99)
    assert len(r.hybrid_search_finalize(handle)) == 2


def test_select_approx_and_recall_target_change_nothing():
    rng = np.random.default_rng(1)
    emb = torch.from_numpy(rng.standard_normal((50, 16)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))
    a = torch.from_numpy(np.sort(rng.integers(0, 50, (3, 40)), axis=1).astype(np.int32))
    w = torch.from_numpy(rng.random((3, 40)).astype(np.float32) + 0.01)
    base = ttopk.hybrid_topk(emb, q, a, w, 5, 50, dense_k=20, sparse_m=20)
    for kw in ({"select_approx": True}, {"recall_target": 0.5}):
        got = ttopk.hybrid_topk(emb, q, a, w, 5, 50, dense_k=20, sparse_m=20, **kw)
        assert all(torch.equal(x, y) for x, y in zip(got, base))
    s0 = tbm25.sparse_topm_winners(a, w, 8, 50, max_seg=0)
    s1 = tbm25.sparse_topm_winners(a, w, 8, 50, max_seg=0, select_approx=True)
    assert all(torch.equal(x, y) for x, y in zip(s0, s1))
