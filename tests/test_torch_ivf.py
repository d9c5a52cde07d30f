"""The port's k-means, IVF search, VectorIndex (Flat and IVFFlat) and the
VectorRetriever's dense search against anorag_tpu on the CPU, on the same
numpy inputs.

The two packages' device k-means inits draw different random numbers, so
the IVF tests search the layout the reference built, carried across with
ivf_layout_from_numpy; below 4096 rows both packages run the same numpy
k-means and build the same layout themselves. The JAX IVF scan runs its
Pallas kernel in interpret mode, as tests/test_ivf.py runs it. Scores agree
to 1e-5 (f32 sums in another order), rows exactly on tie-free data.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from anorag_tpu.config import ConfigLoader
from anorag_tpu.index.vector_index import VectorIndex as JVectorIndex
from anorag_tpu.ops.ivf import build_ivf as j_build_ivf
from anorag_tpu.ops.ivf import ivf_probe as j_ivf_probe
from anorag_tpu.ops.ivf import ivf_search as j_ivf_search
from anorag_tpu.ops.ivf import select_blocks as j_select_blocks
from anorag_tpu.ops.ivf import tune_nprobe as j_tune_nprobe
from anorag_tpu.ops.kmeans import kmeans_fit as j_kmeans_fit
from anorag_tpu.query.processor import QueryProcessor as JQueryProcessor
from anorag_tpu.retrieval.retriever import VectorRetriever as JVectorRetriever
from anorag_tpu_torch.index.vector_index import VectorIndex
from anorag_tpu_torch.models.embedding_manager import EmbeddingManager
from anorag_tpu_torch.ops import ivf, kmeans
from anorag_tpu_torch.query.processor import QueryProcessor
from anorag_tpu_torch.retrieval.retriever import VectorRetriever
from anorag_tpu_torch.testing import IVF_CASES, clustered_corpus, unit_rows

from conftest import make_notes


def _carried(layout):
    return ivf.ivf_layout_from_numpy(
        layout.centroids, layout.perm, layout.cluster_ids,
        layout.block_first_cluster, layout.block_last_cluster,
        layout.block_rows, layout.n)


def _rows_equal(got, want, atol=1e-5):
    gv, gi = (np.asarray(x) for x in got)
    wv, wi = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(np.isfinite(gv), np.isfinite(wv))
    fin = np.isfinite(wv)
    np.testing.assert_allclose(gv[fin], wv[fin], atol=atol, rtol=0)


# ------------------------------------------------------------------ k-means
@pytest.mark.parametrize("n,k,iters", [(300, 6, 15), (1000, 20, 5), (5, 8, 3)])
def test_kmeans_small_n_matches_reference(n, k, iters):
    x = clustered_corpus(np.random.default_rng(n), n, 24, 6)
    jc, ja = j_kmeans_fit(x, k, iters=iters, seed=2)
    c, a = kmeans.kmeans_fit(torch.from_numpy(x), k, iters=iters, seed=2)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    assert kmeans.kmeans_inertia(x, c, a) == pytest.approx(
        float(np.sum((x - np.asarray(jc)[np.asarray(ja)]) ** 2)), rel=1e-6)


def test_kmeans_lloyd_invariants():
    """Above 4096 rows the port runs Lloyd in torch: every row goes to its
    nearest centroid, a converged centroid is its members' mean, the
    clusters are recovered, and more iterations do not raise the inertia."""
    rng = np.random.default_rng(0)
    n, d, k = 5000, 16, 5
    centers = rng.standard_normal((k, d)) * 4
    labels = rng.integers(0, k, n)
    x = (centers[labels] + rng.standard_normal((n, d)) * 0.3).astype(np.float32)
    c, a = kmeans.kmeans_fit(torch.from_numpy(x), k, iters=20, seed=1)
    assert c.shape == (k, d) and a.shape == (n,) and a.dtype == torch.int32
    dist = ((x[:, None, :] - c.numpy()[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(a.numpy(), dist.argmin(1))
    for j in range(k):
        members = x[a.numpy() == j]
        np.testing.assert_allclose(c[j].numpy(), members.mean(0), atol=1e-4)
    purity = sum(np.bincount(labels[a.numpy() == j]).max()
                 for j in range(k) if (a.numpy() == j).any())
    assert purity / n > 0.95
    c1, a1 = kmeans.kmeans_fit(torch.from_numpy(x), k, iters=1, seed=1)
    assert kmeans.kmeans_inertia(x, c, a) <= kmeans.kmeans_inertia(x, c1, a1) + 1e-3


# ------------------------------------------------------------------- layout
@pytest.mark.parametrize("n,nlist,block_rows", [(600, 6, 128), (1000, 8, 256), (130, 3, 1024)])
def test_layout_from_assign_matches_build_ivf(n, nlist, block_rows):
    x = clustered_corpus(np.random.default_rng(n), n, 32, nlist)
    jlayout, jsorted = j_build_ivf(x, nlist=nlist, block_rows=block_rows)
    jc, ja = j_kmeans_fit(x, nlist, iters=15, seed=0)
    layout, sorted_emb = ivf.ivf_layout_from_assign(
        torch.from_numpy(x), np.asarray(jc), np.asarray(ja), block_rows)
    for name in ("perm", "cluster_ids", "block_first_cluster", "block_last_cluster"):
        np.testing.assert_array_equal(getattr(layout, name), getattr(jlayout, name))
    assert (layout.block_rows, layout.n, layout.num_blocks) == (
        jlayout.block_rows, jlayout.n, jlayout.num_blocks)
    np.testing.assert_array_equal(sorted_emb.numpy(), jsorted)
    # the port's own build runs the same numpy k-means below 4096 rows
    own, own_sorted = ivf.build_ivf(torch.from_numpy(x), nlist=nlist,
                                    block_rows=block_rows)
    np.testing.assert_array_equal(own.perm, jlayout.perm)
    np.testing.assert_array_equal(own_sorted.numpy(), jsorted)


def test_select_blocks_and_probe_match_reference():
    x = clustered_corpus(np.random.default_rng(0), 600, 32, 6)
    jlayout, _ = j_build_ivf(x, nlist=6, block_rows=128)
    layout = _carried(jlayout)
    q = unit_rows(np.random.default_rng(1), 9, 32)
    for nprobe in (1, 2, 6, 9):
        sel = ivf.ivf_probe(layout, torch.from_numpy(q), nprobe)
        np.testing.assert_array_equal(sel.numpy(), j_ivf_probe(jlayout, q, nprobe))
        np.testing.assert_array_equal(ivf.select_blocks(layout, sel.numpy()),
                                      j_select_blocks(jlayout, sel.numpy()))
    np.testing.assert_array_equal(ivf.select_blocks(layout, np.array([[0, 1], [2, 3]])),
                                  j_select_blocks(jlayout, np.array([[0, 1], [2, 3]])))


# ------------------------------------------------------------------- search
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", IVF_CASES, ids=lambda c: "n{}-d{}-nl{}-b{}-np{}-k{}".format(*c))
def test_ivf_search_matches_pallas_interpret(case, dtype):
    """ivf_search through ivf_scan (on the CPU: ivf_scan_ref) against the
    reference's Pallas IVF kernel in interpret mode, on its own layout."""
    n, d, nlist, b, nprobe, k = case
    rng = np.random.default_rng(n + nprobe)
    x = clustered_corpus(rng, n, d, nlist)
    q = unit_rows(rng, b, d)
    jlayout, jsorted = j_build_ivf(x, nlist=nlist, block_rows=128)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = j_ivf_search(jlayout, jnp.asarray(jsorted, jdt), q, k, nprobe=nprobe,
                        use_pallas=True, interpret=True)
    layout = _carried(jlayout)
    sorted_t = torch.from_numpy(jsorted).to(tdt)
    got = ivf.ivf_search(layout, sorted_t, q, k, nprobe=nprobe)
    _rows_equal(got, want)
    # the plain version alone, on sorted positions
    sel = ivf.ivf_probe(layout, torch.from_numpy(q), nprobe)
    blk = ivf.select_blocks(layout, sel.numpy())
    vals, pos = ivf.ivf_scan_ref(torch.from_numpy(q).to(tdt), sorted_t,
                                 torch.from_numpy(layout.cluster_ids), sel,
                                 torch.from_numpy(blk), int((blk >= 0).sum()),
                                 min(k, n), layout.block_rows)
    filled = pos.numpy() >= 0
    np.testing.assert_array_equal(np.where(filled, layout.perm[pos.numpy().clip(0)], -1),
                                  want[1][:, :min(k, n)])


@pytest.mark.parametrize("nprobe", [1, 3])
def test_ivf_search_numpy_route_matches_reference(nprobe):
    x = clustered_corpus(np.random.default_rng(4), 600, 32, 6)
    q = unit_rows(np.random.default_rng(5), 4, 32)
    jlayout, jsorted = j_build_ivf(x, nlist=6, block_rows=128)
    want = j_ivf_search(jlayout, jsorted, q, 10, nprobe=nprobe, use_pallas=False)
    got = ivf.ivf_search(_carried(jlayout), torch.from_numpy(jsorted), q, 10,
                         nprobe=nprobe, use_kernel=False)
    _rows_equal(got, want)


@pytest.mark.parametrize("target", [0.5, 0.9, 1.0])
def test_tune_nprobe_matches_reference(target):
    x = clustered_corpus(np.random.default_rng(6), 400, 32, 8)
    q = unit_rows(np.random.default_rng(7), 8, 32)
    jlayout, jsorted = j_build_ivf(x, nlist=8, block_rows=128)
    want = j_tune_nprobe(jlayout, jsorted, x, q, k=5, target_recall=target,
                         use_pallas=True, interpret=True)
    got = ivf.tune_nprobe(_carried(jlayout), torch.from_numpy(jsorted), x, q, k=5,
                          target_recall=target)
    assert got == want


# ------------------------------------------------------------- VectorIndex
@pytest.mark.parametrize("storage", ["bfloat16", "float32"])
def test_vector_index_ivfflat_matches_reference(storage):
    x = clustered_corpus(np.random.default_rng(8), 700, 32, 6) * 3.0
    q = unit_rows(np.random.default_rng(9), 5, 32)
    kw = dict(dimension=32, index_type="IVFFlat", nlist=6, nprobe=2,
              storage_dtype=storage, ivf_min_corpus=500)
    jidx = JVectorIndex(use_pallas=True, **kw)
    idx = VectorIndex(device="cpu", **kw)
    for index in (jidx, idx):
        index.add(x[:400])
        index.add(x[400:])
    assert idx._effective_type == "IVFFlat" and idx.ntotal == 700
    for nprobe in (None, 1, 6):
        _rows_equal(idx.search_arrays(q, 10, nprobe), jidx.search_arrays(q, 10, nprobe))
    got, want = idx.search(q, 4), jidx.search(q, 4)
    assert [[r["index"] for r in row] for row in got] == [[r["index"] for r in row] for row in want]
    np.testing.assert_array_equal(idx._layout.perm, jidx._layout.perm)
    # flat_device_emb: the storage-dtype rows in ORIGINAL order
    flat = idx.flat_device_emb()
    assert flat.dtype == {"bfloat16": torch.bfloat16, "float32": torch.float32}[storage]
    np.testing.assert_allclose(flat.float().numpy(),
                               np.asarray(jidx.flat_device_emb(), np.float32),
                               atol=1e-7, rtol=0)
    np.testing.assert_allclose(idx.reconstruct(3), jidx.reconstruct(3), atol=1e-7)
    assert idx.measure_recall(q, 5) == pytest.approx(jidx.measure_recall(q, 5))
    assert idx.optimize_search_params(q, 5, 0.95) == jidx.optimize_search_params(q, 5, 0.95)


@pytest.mark.parametrize("use_kernel", [None, True, False])
def test_vector_index_flat_matches_reference(use_kernel):
    x = unit_rows(np.random.default_rng(10), 300, 24) * 2.0
    q = unit_rows(np.random.default_rng(11), 4, 24)
    jidx = JVectorIndex(dimension=24, index_type="Flat", use_pallas=use_kernel)
    idx = VectorIndex(dimension=24, index_type="Flat", use_kernel=use_kernel,
                      device="cpu")
    jidx.add(x)
    idx.add(x)
    for k in (7, 400):
        _rows_equal(idx.search_arrays(q, k), jidx.search_arrays(q, k))
    empty = VectorIndex(dimension=24, index_type="Flat", device="cpu")
    _rows_equal(empty.search_arrays(q, 3), JVectorIndex(24, "Flat").search_arrays(q, 3))


@pytest.mark.parametrize("index_type", ["IVFPQ", "LSH", "HNSW"])
def test_unported_index_types_raise(index_type):
    with pytest.raises(NotImplementedError):
        VectorIndex(dimension=8, index_type=index_type, device="cpu")


# --------------------------------------------------------- VectorRetriever
_WORDS = ("river album film singer founder orbit lantern quartz harbor meadow "
          "violin comet ember glacier pixel saffron tundra falcon marble cedar").split()


def _notes(n_extra=260):
    rng = np.random.default_rng(0)
    notes = make_notes(24)
    for i in range(n_extra):
        words = rng.choice(_WORDS, int(rng.integers(4, 12))).tolist()
        notes.append({"note_id": f"gen_{i}", "title": " ".join(words[:2]).title(),
                      "content": " ".join(words) + f" item {i}.",
                      "entities": [words[0].title()]})
    return notes


def _pair(notes, **kw):
    loader = ConfigLoader(auto_load=False)
    for k, v in {"embedding.backend": "hash", "embedding.dim": 64,
                 "vector_store.index_type": "Flat",
                 "tpu.sharded_search": "off"}.items():
        loader.set(k, v)
    jem = JQueryProcessor(notes[:4], cfg=loader, llm=None).em
    em = EmbeddingManager(loader.as_dict(), device="cpu")
    jr = JVectorRetriever(embedding_manager=jem, **{
        ("use_pallas" if k == "use_kernel" else k): v for k, v in kw.items()})
    r = VectorRetriever(embedding_manager=em, **kw)
    jr.build_index(notes)
    r.build_index(notes)
    return jr, r


QUERIES = ["quartz harbor lantern", "Who founded Nexus Labs?",
           "comet ember glacier falcon marble", "violin meadow river album"]
RETRIEVER_KINDS = {
    "flat": dict(index_type="Flat"),
    "flat-kernel": dict(index_type="Flat", use_kernel=True),
    "ivf": dict(index_type="IVFFlat", nlist=4, nprobe=2,
                index_params={"ivf_min_corpus": 100}),
}


@pytest.mark.parametrize("kind", list(RETRIEVER_KINDS))
def test_retriever_search_matches_reference(kind):
    jr, r = _pair(_notes(), **RETRIEVER_KINDS[kind])
    for threshold in (None, 0.0, 0.2):
        want = jr.search(QUERIES, top_k=8, threshold=threshold)
        got = r.search(QUERIES, top_k=8, threshold=threshold)
        assert [[n["note_id"] for n in row] for row in got] == \
            [[n["note_id"] for n in row] for row in want]
        for grow, wrow in zip(got, want):
            for g, w in zip(grow, wrow):
                assert g["retrieval_info"]["rank"] == w["retrieval_info"]["rank"]
                assert g["similarity"] == pytest.approx(w["similarity"], abs=1e-5)


@pytest.mark.parametrize("kind", list(RETRIEVER_KINDS))
def test_retriever_retrieve_matches_reference(kind):
    jr, r = _pair(_notes(), **RETRIEVER_KINDS[kind])
    calls = [
        dict(),
        dict(top_k=5, threshold=0.0),
        dict(filter_fn=lambda n: "item" in n["content"], threshold=-1.0),
        dict(must_have_terms=["quartz"], threshold=-1.0),
        dict(boost_entities=["Comet", "river"], threshold=-1.0),
        dict(boost_predicates=["harbor", "glacier"], threshold=-1.0),
    ]
    for query in QUERIES:
        for kw in calls:
            want = jr.retrieve(query, **kw)
            got = r.retrieve(query, **kw)
            assert [n["note_id"] for n in got] == [n["note_id"] for n in want], (query, kw)
            np.testing.assert_allclose([n["adjusted_score"] for n in got],
                                       [n["adjusted_score"] for n in want], atol=1e-5)


def test_processor_passes_the_dense_settings():
    cfg = {"embedding": {"backend": "hash", "dim": 32},
           "vector_store": {"nlist": 7}, "tpu": {"ivf": {"nprobe": 3}}}
    qp = QueryProcessor(make_notes(6), cfg=cfg, device="cpu")
    index = qp.retriever.index
    assert (index.index_type, index.nlist, index.nprobe) == ("IVFFlat", 7, 3)
    assert qp.retriever.similarity_threshold == 0.0
    assert qp.retriever.retrieve("Nexus Labs", top_k=3)


def test_entry_points_without_a_device_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        VectorIndex(dimension=8, index_type="IVFFlat")
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryProcessor(make_notes(4), cfg={"embedding": {"backend": "hash"},
                                           "vector_store": {"index_type": "IVFFlat"}})
