"""The port's device mesh and sharded search (anorag_tpu_torch/parallel/
{mesh,runtime,sharded_search}.py and the sharded branch of VectorIndex,
VectorRetriever and QueryProcessor), param_pspecs and
EncoderTrainer(model_parallel) on a (4, 2) mesh against anorag_tpu's, on
the CPU.

The reference runs on its 8 virtual CPU devices (tests/conftest.py); the
port's meshes repeat the CPU device, 8, 3 or 1 times, so each shard's body
runs as it would on its own device. Tolerances: values to 1e-5 and ids
equal; the trainer's loss histories to rtol 1e-4, as in
tests/test_torch_train.py.

One case differs by design: the reference's make_sharded_topk takes the
shard-local top-k before it masks the pad rows, so a pad row (score 0) can
take the slot of a real row that scores below 0. The port masks first; that
case is held to the reference's single-device VectorIndex and to
dense_topk_np.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from anorag_tpu.config import ConfigLoader
from anorag_tpu.index.vector_index import VectorIndex as JVectorIndex
from anorag_tpu.models import decoder_lm as jdlm
from anorag_tpu.models import encoder as jenc
from anorag_tpu.models import train as jtrain
from anorag_tpu.models.embedding_manager import EmbeddingManager as JEmbeddingManager
from anorag_tpu.models.tokenizer import HashTokenizer as JHashTokenizer
from anorag_tpu.parallel import mesh as jmesh
from anorag_tpu.parallel import runtime as jruntime
from anorag_tpu.parallel import sharded_search as jss
from anorag_tpu.query.processor import QueryProcessor as JQueryProcessor
from anorag_tpu.retrieval.retriever import VectorRetriever as JVectorRetriever
from anorag_tpu_torch.config import Config
from anorag_tpu_torch.index.vector_index import VectorIndex
from anorag_tpu_torch.models import decoder_lm as tdlm
from anorag_tpu_torch.models import encoder as tenc
from anorag_tpu_torch.models import train as ttrain
from anorag_tpu_torch.models.embedding_manager import EmbeddingManager
from anorag_tpu_torch.ops.topk import dense_topk_np
from anorag_tpu_torch.parallel import mesh as tmesh
from anorag_tpu_torch.parallel import runtime as truntime
from anorag_tpu_torch.parallel import sharded_search as tss
from anorag_tpu_torch.query.processor import QueryProcessor
from anorag_tpu_torch.retrieval.retriever import VectorRetriever
from anorag_tpu_torch.testing import sorted_plan

from conftest import make_notes
from test_query_processor import _cfg as jqp_cfg
from test_query_processor import _kb_notes
from test_torch_train import _pairs, port_cfg

CPU = torch.device("cpu")
SHARDS = (8, 3, 1)


def meshes(s: int):
    """(reference mesh over s of its CPU devices, port mesh over the CPU s
    times), both (s, 1)."""
    return jmesh.make_mesh(n_devices=s), tmesh.make_mesh(devices=[CPU] * s)


def rows(rng, n, d):
    return rng.standard_normal((n, d)).astype(np.float32)


def assert_same(got, want, atol=1e-5):
    gv, gi = (np.asarray(x) for x in got)
    wv, wi = (np.asarray(x) for x in want)
    np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=atol)
    np.testing.assert_array_equal(gi, wi)


# ------------------------------------------------------------------ mesh
@pytest.mark.parametrize("n,mp", [(8, 1), (8, 2), (8, 3), (6, 4), (3, 2), (1, 4), (5, 5)])
def test_make_mesh_shapes_and_clamp_equal_the_reference(n, mp):
    want = jmesh.make_mesh(n_devices=n, model_parallel=mp)
    got = tmesh.make_mesh(n_devices=n, model_parallel=mp, devices=[CPU] * 8)
    assert got.shape == dict(want.shape)
    assert got.size == n and got.devices.shape == want.devices.shape
    assert got.shard_devices() == [CPU] * got.shape["data"]


def test_mesh_axes_and_placements():
    mesh = tmesh.make_mesh(model_parallel=2, devices=["cpu"] * 4)
    assert mesh.axis_names == (tmesh.DATA_AXIS, tmesh.MODEL_AXIS) == ("data", "model")
    assert mesh.distinct_devices() == [CPU] and mesh.first_device == CPU
    assert tmesh.data_sharding(mesh, None).spec == tuple(P(jmesh.DATA_AXIS, None))
    assert tmesh.replicated(mesh).spec == tuple(P())
    with pytest.raises(ValueError, match="non-empty"):
        tmesh.make_mesh(devices=[])


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("n", [17, 64, 5])
def test_shard_rows_pads_as_the_reference(s, n):
    jm, tm = meshes(s)
    arr = rows(np.random.default_rng(n), n, 6)
    for pad in (0.0, -1.5):
        want, wn = jmesh.shard_rows(jm, arr, pad)
        got, gn = tmesh.shard_rows(tm, arr, pad, chunk_rows=2)
        assert gn == wn == n and len(got) == s
        assert {tuple(x.shape) for x in got} == {(-(-n // s), 6)}
        np.testing.assert_array_equal(torch.cat(got).numpy(), np.asarray(want))
    bf16, _ = tmesh.shard_rows(tm, torch.from_numpy(arr), dtype=torch.bfloat16)
    assert all(x.dtype == torch.bfloat16 for x in bf16)


# ---------------------------------------------------------- sharded search
@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("n,k", [(500, 10), (20, 7), (64, 1)])
def test_sharded_topk_equals_the_reference(s, n, k):
    rng = np.random.default_rng(n + k)
    emb, q = rows(rng, n, 32), rows(rng, 5, 32)
    jm, tm = meshes(s)
    je, jn = jmesh.shard_rows(jm, emb)
    te, tn = tmesh.shard_rows(tm, emb)
    want = jss.sharded_topk(jm, je, q, k, jn)
    for use_kernel in (None, True):
        got = tss.sharded_topk(tm, te, q, k, tn, use_kernel)
        assert_same(got, want)
        assert_same(got, dense_topk_np(emb, q, k))


def test_pad_rows_never_take_a_real_rows_slot():
    """17 rows over 8 shards of 3: the last real shard holds rows 15, 16
    and a pad row. Every row scores below 0 for this query, so the
    reference's shard-local top-1 there is the pad row, masked after; it
    answers row 14. The port masks first and answers row 16, as the
    single-device index and the exact search do."""
    emb = np.stack([(17 - i) * np.ones(4, np.float32) for i in range(17)])
    q = -np.ones((1, 4), np.float32)
    jm, tm = meshes(8)
    je, jn = jmesh.shard_rows(jm, emb)
    assert np.asarray(jss.sharded_topk(jm, je, q, 1, jn)[1]).tolist() == [[14]]
    te, tn = tmesh.shard_rows(tm, emb)
    got = tss.sharded_topk(tm, te, q, 1, tn)
    assert got[1].tolist() == [[16]] and got[0].tolist() == [[-4.0]]
    assert_same(got, dense_topk_np(emb, q, 1))
    single = JVectorIndex(dimension=4, index_type="Flat", metric="ip",
                          storage_dtype="float32")
    single.add(emb)
    sharded = VectorIndex(dimension=4, index_type="Flat", metric="ip",
                          storage_dtype="float32", mesh=tm, device="cpu")
    sharded.add(emb)
    for k in (1, 3):
        assert_same(sharded.search_arrays(q, k), single.search_arrays(q, k))


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("n", [512, 300])
def test_sharded_hybrid_topk_equals_the_reference(s, n):
    rng = np.random.default_rng(4)
    b, k = 4, 10
    emb, q = rows(rng, n, 32), rows(rng, b, 32)
    jm, tm = meshes(s)
    je, jn = jmesh.shard_rows(jm, emb)
    te, tn = tmesh.shard_rows(tm, emb)
    bias = rng.random((b, te[0].shape[0] * s)).astype(np.float32)
    jbias = jax.device_put(jnp.asarray(bias), NamedSharding(jm, P(None, "data")))
    want = jss.make_sharded_hybrid_topk(jm, k, jn, bias_weight=0.6)(je, jbias, jnp.asarray(q))
    got = tss.make_sharded_hybrid_topk(tm, k, tn, bias_weight=0.6)(te, bias, q)
    assert_same(got, want)
    scores = q @ emb.T + 0.6 * bias[:, :n]
    np.testing.assert_allclose(got[0].numpy(), -np.sort(-scores, axis=1)[:, :k],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("n,l,dense_k,sparse_m,k", [(300, 256, 32, 32, 8),
                                                    (20, 64, 12, 16, 10),
                                                    (5, 16, 8, 8, 4)])
def test_sharded_union_equals_the_reference(s, n, l, dense_k, sparse_m, k):
    """The candidate union: shards with only pad rows (n 5 over 8), dense_k
    above the rows of a shard, ties of the dense and sparse tables."""
    rng = np.random.default_rng(n + l)
    b = 6
    emb, q = rows(rng, n, 32), rows(rng, b, 32)
    doc_rows, weight_rows = sorted_plan(rng, n, b, l, 4)
    jm, tm = meshes(s)
    je, jn = jmesh.shard_rows(jm, emb)
    te, tn = tmesh.shard_rows(tm, emb)
    want = jss.make_sharded_hybrid_union_topk(jm, k, jn, dense_k=dense_k, sparse_m=sparse_m)(
        je, jnp.asarray(q), jnp.asarray(doc_rows), jnp.asarray(weight_rows))
    got = tss.make_sharded_hybrid_union_topk(tm, k, tn, dense_k=dense_k, sparse_m=sparse_m)(
        te, torch.from_numpy(q), torch.from_numpy(doc_rows), torch.from_numpy(weight_rows))
    assert got[1].dtype == torch.int64
    assert_same(got, want)


def test_sharded_encode_equals_encode():
    """Token batches split over the shards (16 over 3: uneven, 2 over 8:
    empty shards), the reference's parameters carried across."""
    jcfg = dataclasses.replace(jenc.EncoderConfig.small(), dtype=jnp.float32)
    jparams = jenc.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = port_cfg(jcfg, dtype=torch.float32)
    model = tenc.Encoder(cfg, CPU)
    model.load_state_dict(tenc.params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    ids, mask = JHashTokenizer(vocab_size=cfg.vocab_size).encode_batch(
        [f"text {i} about item {i % 5}" for i in range(16)], 32)
    want = jss.make_sharded_encode(jmesh.make_mesh(),
                                   lambda p, i, m: jenc.encode(p, i, m, jcfg))(jparams, ids, mask)
    for s, b in ((8, 16), (3, 16), (8, 2), (1, 16)):
        tm = tmesh.make_mesh(devices=[CPU] * s)
        got = tss.make_sharded_encode(tm, lambda p, i, m: p(i.long(), m))(model, ids[:b],
                                                                         mask[:b])
        assert got.shape == (b, cfg.hidden_size)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want)[:b], atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(
            got.detach().numpy(),
            model(torch.from_numpy(ids[:b]).long(), torch.from_numpy(mask[:b])).detach().numpy())


# -------------------------------------------------------------- VectorIndex
def _flat(mesh, d, **kw):
    return dict(dimension=d, index_type="Flat", storage_dtype="float32", mesh=mesh, **kw)


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("n", [300, 64])
def test_vector_index_sharded_matches_single(s, n):
    rng = np.random.default_rng(0)
    emb, q = rows(rng, n, 64), rows(rng, 5, 64)
    jm, tm = meshes(s)
    want = JVectorIndex(**_flat(jm, 64))
    want.add(emb)
    single = VectorIndex(**_flat(None, 64), device="cpu")
    single.add(emb)
    for use_kernel in (None, True):
        sharded = VectorIndex(**_flat(tm, 64), use_kernel=use_kernel, device="cpu")
        sharded.add(emb)
        assert sharded.is_sharded and len(sharded.sharded_rows()) == s
        got = sharded.search_arrays(q, 12)
        assert_same(got, want.search_arrays(q, 12))
        assert_same(got, single.search_arrays(q, 12))
        assert sharded.search(q, 3)[0] == single.search(q, 3)[0]
    np.testing.assert_array_equal(sharded.flat_device_emb().numpy(),
                                  single.flat_device_emb().numpy())


@pytest.mark.parametrize("s", SHARDS)
def test_vector_index_sharded_k_exceeds_corpus(s):
    rng = np.random.default_rng(0)
    emb, q = rows(rng, 6, 32), rows(rng, 2, 32)
    jm, tm = meshes(s)
    want = JVectorIndex(**_flat(jm, 32))
    want.add(emb)
    got = VectorIndex(**_flat(tm, 32), device="cpu")
    got.add(emb)
    v, i = got.search_arrays(q, 10)
    assert v.shape == i.shape == (2, 10) and i.dtype == np.int64
    assert (i[:, 6:] == -1).all() and (i[:, :6] >= 0).all() and np.isneginf(v[:, 6:]).all()
    assert_same((v, i), want.search_arrays(q, 10))


@pytest.mark.parametrize("s", SHARDS)
def test_incremental_add_reshards(s):
    rng = np.random.default_rng(0)
    emb, more = rows(rng, 20, 32), rows(rng, 13, 32)
    jm, tm = meshes(s)
    want = JVectorIndex(**_flat(jm, 32))
    got = VectorIndex(**_flat(tm, 32), device="cpu")
    for idx in (want, got):
        idx.add(emb)
    assert_same(got.search_arrays(emb[:2], 4), want.search_arrays(emb[:2], 4))
    before = got.sharded_rows()
    assert got._sharded_fns
    for idx in (want, got):
        idx.add(more)
    assert_same(got.search_arrays(more[:3], 4), want.search_arrays(more[:3], 4))
    after = got.sharded_rows()
    assert after is not before and len(after) == s
    assert sum(x.shape[0] for x in after) == -(-33 // s) * s
    assert list(got._sharded_fns) == [("dense", 4, 33)]
    assert got.search_arrays(more[:3], 4)[1][:, 0].tolist() == [20, 21, 22]


# ----------------------------------------------------------------- retriever
def _ems(dim=128):
    loader = ConfigLoader(auto_load=False)
    loader.set("embedding.backend", "hash")
    loader.set("embedding.dim", dim)
    return (JEmbeddingManager(cfg=loader, singleton=False),
            EmbeddingManager(loader.as_dict(), device="cpu"))


QUERIES = ["Who is the singer of Blue Horizon?", "Who founded Nexus Labs?",
           "Quantum Leap Institute scientist", "Silent River director film"]


@pytest.mark.parametrize("s", SHARDS)
def test_retriever_sharded_search_and_hybrid_equal_the_reference(s):
    notes = make_notes(40)
    jm, tm = meshes(s)
    kw = dict(index_type="Flat", similarity_threshold=0.0, top_k=8)
    jem, tem = _ems()
    want = JVectorRetriever(embedding_manager=jem, mesh=jm, **kw)
    want.build_index(notes)
    single = VectorRetriever(embedding_manager=tem, **kw)
    single.build_index(notes)
    got = VectorRetriever(embedding_manager=tem, mesh=tm, **kw)
    got.build_index(notes)
    assert got.index.is_sharded and not single.index.is_sharded
    batch = got.prepare(QUERIES)
    assert batch.q_emb.dtype == torch.float32
    for mine, theirs in ((got.hybrid_search(QUERIES, top_k=8),
                          want.hybrid_search(QUERIES, top_k=8)),
                         (got.search(QUERIES, top_k=6), want.search(QUERIES, top_k=6))):
        for a, b in zip(mine, theirs):
            assert [n["note_id"] for n in a] == [n["note_id"] for n in b]
            np.testing.assert_allclose([n["final_score"] for n in a],
                                       [n["final_score"] for n in b], rtol=1e-5, atol=1e-5)
    for a, b in zip(got.hybrid_search(QUERIES, top_k=8), single.hybrid_search(QUERIES, top_k=8)):
        assert [n["note_id"] for n in a] == [n["note_id"] for n in b]
    assert ([n["note_id"] for n in got.retrieve(QUERIES[2], top_k=5)]
            == [n["note_id"] for n in want.retrieve(QUERIES[2], top_k=5)])


# ------------------------------------------------------- product mesh, config
def test_cfg_get_equals_the_reference():
    loader = ConfigLoader(auto_load=False)
    loader.set("tpu.sharded_search", "on")
    cases = [({"tpu": {"sharded_search": "off"}}, "tpu.sharded_search", None),
             ({"tpu": {"mesh": None}}, "tpu.mesh.model_parallel_size", 7),
             ({"tpu": 3}, "tpu.sharded_search", "auto"),
             (None, "tpu.sharded_search", "auto"), (object(), "a.b", 1)]
    for cfg, key, default in cases:
        assert truntime.cfg_get(cfg, key, default) == jruntime.cfg_get(cfg, key, default)
    assert truntime.cfg_get(loader, "tpu.sharded_search") == "on"
    assert truntime.cfg_get(Config({"tpu": {"sharded_search": "on"}}),
                            "tpu.sharded_search") == "on"


def test_product_mesh_off_auto_and_on(monkeypatch):
    truntime.reset_mesh_cache()
    for mode in ("off", "auto"):
        assert truntime.product_mesh({"tpu": {"sharded_search": mode}}, "cpu") is None
    on = {"tpu": {"sharded_search": "on", "mesh": {"model_parallel_size": 2}}}
    mesh = truntime.product_mesh(on, "cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.distinct_devices() == [CPU]
    assert truntime.product_mesh(on, "cpu") is mesh
    truntime.reset_mesh_cache()
    assert truntime.product_mesh(on, "cpu") is not mesh
    # a host with four GPUs: auto shards over all of them
    monkeypatch.setattr(truntime, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    auto = truntime.product_mesh({"tpu": {"mesh": {"model_parallel_size": 2}}})
    assert auto.shape == {"data": 2, "model": 2}
    assert auto.shard_devices() == [torch.device("cuda", 0), torch.device("cuda", 2)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert truntime.product_mesh(None) is None
    assert truntime.product_mesh({"tpu": {"sharded_search": "on"}}).shape == {
        "data": 1, "model": 1}
    truntime.reset_mesh_cache()


def test_query_processor_sharded_on_equals_off_and_the_reference():
    truntime.reset_mesh_cache()
    q = "Who is the spouse of the performer of Blue Horizon?"
    out = {}
    for mode in ("on", "off"):
        loader = jqp_cfg(**{"tpu.sharded_search": mode})
        qp = QueryProcessor(_kb_notes(), cfg=Config(loader.as_dict()), llm=None,
                            device="cpu")
        assert (qp.mesh is not None) == (mode == "on") == qp.retriever.index.is_sharded
        out[mode] = qp.process(q)
    want = JQueryProcessor(_kb_notes(), cfg=jqp_cfg(**{"tpu.sharded_search": "off"}),
                           llm=None).process(q)
    for key in ("answer", "predicted_support_idxs", "answer_method"):
        assert out["on"][key] == out["off"][key] == want[key], key
    assert out["on"]["answer"]
    truntime.reset_mesh_cache()


# ------------------------------------------------------------ param_pspecs
def _spec_tree(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("axis", ["model", "tp"])
def test_param_pspecs_equal_the_reference(axis):
    ecfg = jenc.EncoderConfig.small()
    assert tenc.param_pspecs(port_cfg(ecfg), axis) == _spec_tree(jenc.param_pspecs(ecfg, axis))
    dcfg = jdlm.DecoderConfig.tiny()
    tcfg = tdlm.DecoderConfig.tiny()
    assert tcfg.num_layers == dcfg.num_layers
    assert tdlm.param_pspecs(tcfg, axis) == _spec_tree(jdlm.param_pspecs(dcfg, axis))


# --------------------------------------------------------------- the trainer
def test_model_parallel_trainer_histories_equal_the_reference():
    """The reference's EncoderTrainer(model_parallel=2) shards over a (4, 2)
    mesh of its 8 devices; the port's, given 8 entries of the CPU, over a
    (4, 2) mesh of them (tests/test_torch_tp_train.py holds the other
    meshes and the parameters)."""
    jcfg = dataclasses.replace(jenc.EncoderConfig.small(), dtype=jnp.float32)
    pairs = _pairs(40)
    jt = jtrain.EncoderTrainer(cfg=jcfg, learning_rate=1e-3, model_parallel=2, seed=3)
    assert dict(jt.mesh.shape) == {"data": 4, "model": 2}
    jparams = jax.device_get(jt.params)
    want = jt.train(pairs, epochs=2, batch_size=8, max_length=32)
    cfg = port_cfg(jcfg, dtype=torch.float32)
    tt = ttrain.EncoderTrainer(cfg=cfg, learning_rate=1e-3, model_parallel=2, seed=3,
                               devices=[CPU] * 8)
    assert tt.mesh.shape == {"data": 4, "model": 2}
    tt.params.load_state_dict(tenc.params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    # many small ops a step: one torch thread (a loaded host's thread pool
    # spends more time waiting than computing on them)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = tt.train(pairs, epochs=2, batch_size=8, max_length=32)
    finally:
        torch.set_num_threads(threads)
    assert len(got) == len(want) == 10
    np.testing.assert_allclose(got, want, rtol=1e-4)
