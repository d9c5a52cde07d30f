"""The port's VectorIndex for every index type against anorag_tpu's on the
CPU: IVFPQ (pq_impl sketch and codebook), its alias PQ, LSH and HNSW, with
Flat and IVFFlat as before; save in one package and load in the other;
process() through each type on the hash backend.

Both packages train the same codebooks (numpy k-means up to 4096 rows),
rotations and planes (numpy), and HNSW below 20,000 rows builds the same
graph (one thread, deterministic). Search results agree: scores to 1e-6,
rows equal, with two rounding exceptions. The reference's refine against
bf16 device rows (LSH) rounds equal scores apart by a row's position:
there rows are equal outside groups of scores within 1e-6 and as sets
inside them. The codebook's LUT is rounded to bf16 from each package's
own normalized query (numpy and torch norms differ in the last bit), so an
entry at a bf16 rounding boundary lands a bf16 step apart, and rows near
the edge of the candidate pool trade places: the pools must share most of
their rows (a symmetric difference of at most a quarter of the pool), and
the refined rows must be equal once the rows of one pool only are taken
out. ops/pq.py's scan itself is held exactly on shared inputs
(tests/test_torch_pq.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anorag_tpu.index.vector_index import VectorIndex as JVectorIndex
from anorag_tpu.ops import pq as jpq
from anorag_tpu.parallel.mesh import make_mesh as j_make_mesh
from anorag_tpu_torch.ops import pq
from anorag_tpu_torch.index import vector_index as tvi
from anorag_tpu_torch.index.vector_index import VectorIndex
from anorag_tpu_torch.testing import clustered_corpus, unit_rows

from test_torch_process import _pair, _process_both
from test_torch_slice import QUERIES
from test_torch_sq_lsh import assert_rows_equal_but_near_ties
from anorag_tpu_torch.testing import KB_QUESTIONS

D = 64
TYPES = {
    "sketch": dict(index_type="IVFPQ"),
    "codebook": dict(index_type="IVFPQ", pq_impl="codebook", pq_m=16),
    "PQ": dict(index_type="PQ", pq_impl="codebook"),
    "LSH": dict(index_type="LSH"),
    "LSH_bits": dict(index_type="LSH", lsh_bits=48, pq_rerank=40),
    "HNSW": dict(index_type="HNSW", hnsw_m=8, ef_construction=64),
    "HNSW_ef": dict(index_type="HNSW", ef_search=20),
}


def _data(seed=0, n=2500):
    rng = np.random.default_rng(seed)
    x = clustered_corpus(rng, n, D, 12) * rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)
    x[400:430] = x[17]                        # duplicate rows
    return x, unit_rows(rng, 9, D)


def _pools(t, j, q, k):
    """The codebook route's candidate pools in each package."""
    cand = t._candidates(k)
    tq = t._preprocess(torch.from_numpy(q))
    _, tc = pq.pq_topk(t._pq_codes, pq.pq_lut(tq, torch.from_numpy(t._pq_codebooks)),
                       cand)
    jq = jnp.asarray(j._preprocess(q))
    _, jc = jpq.pq_topk(j._pq_codes, jpq.pq_lut(jq, jnp.asarray(j._pq_codebooks)), cand)
    return tc.numpy(), np.asarray(jc)


def _same_codebook(t, j, q, k):
    (gv, gi), (wv, wi) = t.search_arrays(q, k), j.search_arrays(q, k)
    tc, jc = _pools(t, j, q, k)
    for r in range(len(q)):
        only = set(tc[r].tolist()) ^ set(jc[r].tolist())
        assert len(only) <= len(tc[r]) // 4, (r, only)
        keep = [c for c in range(gi.shape[1]) if gi[r, c] not in only]
        kept_w = [c for c in range(wi.shape[1]) if wi[r, c] not in only]
        m = min(len(keep), len(kept_w))          # the rows both pools rank
        assert gi[r, keep[:m]].tolist() == wi[r, kept_w[:m]].tolist()
        np.testing.assert_allclose(gv[r, keep[:m]], wv[r, kept_w[:m]], atol=1e-6)


def _same(got, want, kind):
    (gv, gi), (wv, wi) = got, want
    assert gv.shape == wv.shape and gi.dtype == np.int64
    np.testing.assert_array_equal(np.isfinite(gv), np.isfinite(wv))
    fin = np.isfinite(wv)
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=0, atol=1e-6)
    if kind.startswith("LSH"):
        assert_rows_equal_but_near_ties(gv, gi, wv, wi)
    else:
        np.testing.assert_array_equal(gi, wi)


@pytest.fixture(scope="module", params=list(TYPES))
def built(request):
    kind = request.param
    x, q = _data()
    j = JVectorIndex(dimension=D, **TYPES[kind])
    t = VectorIndex(dimension=D, device="cpu", **TYPES[kind])
    j.add(x)
    t.add(x)
    return kind, j, t, q


def test_every_index_type_equals_the_reference(built):
    kind, j, t, q = built
    assert t.index_type == j.index_type
    for k in (1, 10, 37):
        if kind in ("codebook", "PQ"):
            _same_codebook(t, j, q, k)
        else:
            _same(t.search_arrays(q, k), j.search_arrays(q, k), kind)
    assert [[r["index"] for r in row] for row in t.search(q[:3], 5)] == \
        [[r["index"] for r in row] for row in j.search(q[:3], 5)] or kind.startswith("LSH")
    assert abs(t.measure_recall(q, 10) - j.measure_recall(q, 10)) <= 0.02


def test_the_types_keep_their_codes_on_the_device_side(built):
    """IVFPQ and LSH hold codes and no storage-dtype corpus copy; HNSW
    holds the native graph."""
    kind, _, t, _ = built
    t._materialize()
    assert t._device_emb is None
    if kind == "sketch":
        assert t._sq_codes.dtype == torch.int8 and t._sq_codes.shape == (t.ntotal, D // 8)
    elif kind in ("codebook", "PQ"):
        assert t._pq_codes.dtype == torch.uint8
        assert t._pq_codes.shape == (t.ntotal, t._pq_m_auto())
    elif kind.startswith("LSH"):
        assert set(torch.unique(t._lsh_codes).tolist()) <= {-1, 1}
        assert t._lsh_codes.shape == (t.ntotal, t.lsh_bits or D)
    else:
        assert t._hnsw is not None and t._hnsw.n == t.ntotal


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_save_in_one_package_load_in_the_other(built, tmp_path, direction):
    """Each package reads the other's files: the rows, the codebooks,
    rotation or planes, and HNSW's graph, imported (not rebuilt), give the
    saved index's results."""
    kind, j, t, q = built
    path = tmp_path / "index"
    src, load = ((j, lambda p: VectorIndex.load(p, device="cpu"))
                 if direction == "jax_to_torch" else (t, JVectorIndex.load))
    src.save(path)
    got = load(path)
    with np.load(path.with_suffix(".npz")) as data:
        names = set(data.files)
    if kind == "HNSW" or kind == "HNSW_ef":
        assert {"hnsw_meta", "hnsw_node_level", "hnsw_links"} <= names
        assert got._hnsw is not None and not got._dirty
    if kind == "sketch":
        assert "sq_rotation" in names
    if kind in ("codebook", "PQ"):
        assert "pq_codebooks" in names
    if kind.startswith("LSH"):
        assert "lsh_planes" in names
    _same(got.search_arrays(q, 10), src.search_arrays(q, 10), kind)


@pytest.mark.parametrize("kind", ["HNSW", "HNSW_ef"])
def test_hnsw_below_20000_rows_builds_the_references_graph(kind):
    """Over the same normalized rows (each package normalizes in its own
    last bit) the one-thread build gives the reference's graph exactly."""
    x, q = _data(seed=3, n=3000)
    j = JVectorIndex(dimension=D, **TYPES[kind])
    j.add(x)
    t = VectorIndex(dimension=D, device="cpu", **TYPES[kind])
    t._emb_f32, t._dirty = torch.from_numpy(j._emb_f32.copy()), True
    t._materialize()
    j._materialize()
    g, w = t._hnsw.export_graph(), j._hnsw.export_graph()
    for name in ("meta", "node_level", "links"):
        np.testing.assert_array_equal(g[name], w[name])
    _same(t.search_arrays(q, 10), j.search_arrays(q, 10), kind)


def test_pq_alias_and_options():
    idx = VectorIndex(dimension=D, index_type="PQ", device="cpu")
    assert idx.index_type == "IVFPQ" and idx._pq_m_auto() == D // 8
    assert VectorIndex(dimension=30, pq_m=0, device="cpu")._pq_m_auto() == 15
    assert VectorIndex(dimension=7, device="cpu")._pq_m_auto() == 7
    idx.add(_data(n=60000)[0][:100])
    assert idx._candidates(10) == 64
    idx._emb_f32 = torch.zeros((600_000, D))
    assert idx._candidates(10) == 1024 and idx._candidates(400) == 1600
    assert VectorIndex(dimension=D, pq_rerank=9, device="cpu")._candidates(10) == 9
    with pytest.raises(ValueError, match="pq_impl"):
        VectorIndex(dimension=D, index_type="IVFPQ", pq_impl="opq", device="cpu")
    with pytest.raises(ValueError, match="index_type"):
        VectorIndex(dimension=D, index_type="IVFSQ", device="cpu")


def test_hnsw_degrades_to_flat_without_the_native_runtime(monkeypatch):
    monkeypatch.setattr(tvi.native, "available", lambda: False)
    idx = VectorIndex(dimension=D, index_type="HNSW", device="cpu")
    assert idx.index_type == "Flat"


@pytest.mark.parametrize("kind", ["Flat", "IVFFlat", "IVFPQ", "PQ", "LSH", "HNSW"])
def test_only_a_mesh_raises(kind):
    """A mesh no longer raises: it shards Flat (and IVFFlat below
    ivf_min_corpus, which searches Flat) over its 'data' axis and leaves the
    other types on the index's device, as the reference's is_sharded does;
    every type gives the results it gives without the mesh."""
    from anorag_tpu_torch.parallel.mesh import make_mesh

    x, q = _data(n=600)
    flat = kind in ("Flat", "IVFFlat")
    jm = JVectorIndex(dimension=D, index_type=kind, mesh=j_make_mesh(n_devices=3))
    plain = VectorIndex(dimension=D, index_type=kind, device="cpu")
    meshed = VectorIndex(dimension=D, index_type=kind, device="cpu",
                         mesh=make_mesh(devices=["cpu"] * 3))
    for idx in (jm, plain, meshed):
        idx.add(x)
    assert meshed.is_sharded == jm.is_sharded == flat
    assert (meshed.sharded_rows() is not None) == flat
    want = plain.search_arrays(q, 10)
    np.testing.assert_array_equal(meshed.search_arrays(q, 10)[1], want[1])
    np.testing.assert_allclose(meshed.search_arrays(q, 10)[0], want[0], rtol=1e-5, atol=1e-5)


def test_empty_index_of_every_type_searches_to_padding():
    q = unit_rows(np.random.default_rng(1), 2, D)
    for kw in TYPES.values():
        v, i = VectorIndex(dimension=D, device="cpu", **kw).search_arrays(q, 4)
        assert (i == -1).all() and np.isneginf(v).all()


def test_a_corpus_smaller_than_k_pads_every_type():
    x, q = _data(n=40)
    for kind, kw in TYPES.items():
        j = JVectorIndex(dimension=D, **kw)
        t = VectorIndex(dimension=D, device="cpu", **kw)
        j.add(x[:6])
        t.add(x[:6])
        _same(t.search_arrays(q, 10), j.search_arrays(q, 10), kind)


@pytest.mark.parametrize("kind", list(TYPES))
def test_process_through_each_index_type_equals_the_reference(kind):
    """QueryProcessor passes vector_store's index options to the index, as
    the reference does; process() then gives the reference's answers."""
    over = {f"vector_store.{k}": v for k, v in TYPES[kind].items()}
    jqp, qp = _pair(**over)
    assert qp.retriever.index.index_type == jqp.retriever.index.index_type
    for key in ("pq_m", "pq_impl", "lsh_bits", "hnsw_m", "ef_construction", "ef_search",
                "pq_rerank"):
        assert getattr(qp.retriever.index, key) == getattr(jqp.retriever.index, key)
    _process_both(jqp, qp, [q for q, *_ in KB_QUESTIONS] + QUERIES[:3])
