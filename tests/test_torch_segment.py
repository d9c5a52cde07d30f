"""Parity of the port's segment-scan BM25 path and the rest of its BM25
layer (anorag_tpu_torch/ops/bm25.py, ops/topk.py, index/bm25_index.py)
with anorag_tpu on the same seeded numpy inputs.

The Pallas segment kernels run in interpret mode, as tests/test_ops.py:274
runs them. The port's plain versions repeat the kernels' arithmetic (the
log-step block scans in the reference's order), so they must agree bit for
bit; so must the routes built on them. Hybrid results are held to the
reference as tests/test_ops.py holds its own variants (ids equal, scores to
1e-5), and the scatter scores to rtol 1e-6. The CUDA kernels are held
against the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from anorag_tpu.index import bm25_index as jindex
from anorag_tpu.ops import bm25 as jbm25
from anorag_tpu.ops import topk as jtopk
from anorag_tpu_torch.index import bm25_index as tindex
from anorag_tpu_torch.ops import bm25 as tbm25
from anorag_tpu_torch.ops import topk as ttopk
from anorag_tpu_torch.testing import SEGMENT_CASES, segment_plan
from conftest import make_notes


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _assert_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


CASE_IDS = ["{}-b{}-l{}-bl{}".format(c[0], *c[2:]) for c in SEGMENT_CASES]


@pytest.mark.parametrize("case", SEGMENT_CASES, ids=CASE_IDS)
def test_segment_totals_ref_matches_pallas(case):
    name, n_docs, b, l, block_l = case
    a, w = segment_plan(name, n_docs, b, l)
    want = jbm25.segment_totals_pallas(jnp.asarray(a), jnp.asarray(w), n_docs,
                                       block_l=block_l, interpret=True)
    _assert_equal(tbm25.segment_totals_ref(_t(a), _t(w), n_docs, block_l=block_l),
                  want)
    # the wrapper takes the plain version for CPU tensors
    _assert_equal(tbm25.segment_totals(_t(a), _t(w), n_docs, block_l=block_l), want)


@pytest.mark.parametrize("case", SEGMENT_CASES, ids=CASE_IDS)
def test_segment_winners_ref_matches_pallas(case):
    name, n_docs, b, l, block_l = case
    a, w = segment_plan(name, n_docs, b, l)
    want = jbm25.segment_winners_pallas(jnp.asarray(a), jnp.asarray(w), n_docs,
                                        block_l=block_l, interpret=True)
    _assert_equal(tbm25.segment_winners_ref(_t(a), _t(w), n_docs, block_l=block_l),
                  want)
    _assert_equal(tbm25.segment_winners(_t(a), _t(w), n_docs, block_l=block_l), want)


def test_segment_cases_cover_the_edges():
    """The odd case has an empty row and a one-segment row; the straddle
    case has segments across the 1024-wide block edge."""
    _, n_docs, b, l, _ = SEGMENT_CASES[0]
    a, _ = segment_plan("odd", n_docs, b, l)
    assert (a[0] == n_docs).all() and len(np.unique(a[1][a[1] < n_docs])) == 1
    _, n_docs, b, l, _ = SEGMENT_CASES[-1]
    a, _ = segment_plan("straddle", n_docs, b, l)
    assert all(a[r, 1023] == a[r, 1024] < n_docs for r in range(b))


@pytest.mark.parametrize("impl,ref_impl", [("kernel", "pallas"), ("pallas", "pallas"),
                                           ("chain", "xla"), ("xla", "xla"),
                                           ("auto", "auto")])
@pytest.mark.parametrize("case", SEGMENT_CASES[1:3], ids=CASE_IDS[1:3])
def test_sparse_topm_from_sorted_routes_match_reference(case, impl, ref_impl):
    name, n_docs, b, l, _ = case
    a, w = segment_plan(name, n_docs, b, l)
    want = jbm25.sparse_topm_from_sorted(jnp.asarray(a), jnp.asarray(w), 16,
                                         n_docs, impl=ref_impl)
    _assert_equal(tbm25.sparse_topm_from_sorted(_t(a), _t(w), 16, n_docs,
                                                impl=impl), want)


def test_sparse_topm_from_sorted_rejects_unknown_impl():
    a = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="impl"):
        tbm25.sparse_topm_from_sorted(a, a.float(), 4, 10, impl="approx")


@pytest.mark.parametrize("max_seg", [0, 33])
@pytest.mark.parametrize("case", SEGMENT_CASES[1:3], ids=CASE_IDS[1:3])
def test_sparse_topm_winners_segment_route_matches_reference(case, max_seg):
    """max_seg 0 or above 32 takes the segment-winners kernel."""
    name, n_docs, b, l, _ = case
    a, w = segment_plan(name, n_docs, b, l)
    want = jbm25.sparse_topm_winners(jnp.asarray(a), jnp.asarray(w), 16, n_docs,
                                     max_seg=max_seg)
    _assert_equal(tbm25.sparse_topm_winners(_t(a), _t(w), 16, n_docs,
                                            max_seg=max_seg, select_approx=True),
                  want)


def test_tiled_plan_needs_the_window_kernel():
    a3, w3 = tbm25.plan_tiles(np.zeros((2, 300), np.int32),
                              np.zeros((2, 300), np.float32), 10)
    with pytest.raises(ValueError, match="max_seg"):
        tbm25.sparse_topm_winners(_t(a3), _t(w3), 8, 10, max_seg=0)


def _toy_docs():
    return [[0, 1, 2, 2], [1, 3, 4], [5, 6, 0, 1, 1], [7, 8, 9, 3]]


def test_sorted_scoring_and_lookup_match_reference():
    """tests/test_ops.py:198's case: scatter scores, sorted top-m and the
    searchsorted lookup of arbitrary docs."""
    docs = _toy_docs() * 3
    queries = [[1, 2], [0, 3], [9, 9]]
    jp = jbm25.build_postings(docs, vocab_size=10)
    tp = tbm25.build_postings(docs, vocab_size=10)
    gi, lens = tbm25.gather_plan(tp, queries)
    jgi, jlens = jbm25.gather_plan(jp, queries)
    np.testing.assert_array_equal(gi, jgi)
    np.testing.assert_array_equal(lens, jlens)
    ref = np.asarray(jbm25.score_from_plan(jnp.asarray(jp.doc_ids),
                                           jnp.asarray(jp.weights),
                                           jnp.asarray(jgi), jp.n_docs))
    got = tbm25.score_from_plan(_t(tp.doc_ids), _t(tp.weights), _t(gi), tp.n_docs)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    dr, wr, _ = tbm25.gather_plan_sorted(tp, queries)
    seg = tbm25.sparse_topm_from_sorted(_t(dr), _t(wr), 8, tp.n_docs)[0]
    jseg = jbm25.sparse_topm_from_sorted(jnp.asarray(dr), jnp.asarray(wr), 8,
                                         jp.n_docs)[0]
    qd = np.tile(np.arange(-1, 13), (len(queries), 1)).astype(np.int32)
    looked = tbm25.sparse_lookup_sorted(_t(dr), seg, _t(qd))
    want = jbm25.sparse_lookup_sorted(jnp.asarray(dr), jseg, jnp.asarray(qd))
    np.testing.assert_array_equal(looked.numpy(), np.asarray(want))
    np.testing.assert_allclose(looked.numpy()[:, 1:13], ref, rtol=1e-5, atol=1e-6)


def _hybrid_inputs(seed, n, d, b, vocab, q_terms):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    docs = [rng.integers(0, vocab, 12).tolist() for _ in range(n)]
    p = tbm25.build_postings(docs, vocab_size=vocab)
    queries = [rng.integers(0, vocab, int(q_terms(rng))).tolist() for _ in range(b)]
    dr, wr, lens = tbm25.gather_plan_sorted(p, queries)
    return emb, q, dr, wr, lens


@pytest.mark.parametrize("groups", [1, 3, 4, 13])
def test_hybrid_topk_bucketed_matches_reference_and_unbucketed(groups):
    """tests/test_ops.py:319's case: the length-bucketed sparse stage equals
    the unbucketed hybrid_topk, in both packages."""
    n, b = 400, 13
    emb, q, dr, wr, lens = _hybrid_inputs(7, n, 32, b, 80, lambda r: r.integers(1, 7))
    kw = dict(k=10, n_docs=n, dense_k=64, sparse_m=32, sparse_weight=0.6)
    v1, i1 = ttopk.hybrid_topk(_t(emb), _t(q), _t(dr), _t(wr), **kw)
    plan = ttopk.make_bucketed_plan(dr, wr, lens, n_docs=n, groups=groups,
                                    device="cpu")
    assert plan.n_rows == b and len(plan.buckets) == min(groups, b)
    v2, i2 = ttopk.hybrid_topk_bucketed(_t(emb), _t(q), plan, **kw)
    jplan = jtopk.make_bucketed_plan(dr, wr, lens, n_docs=n, groups=groups)
    jv, ji = jtopk.hybrid_topk_bucketed(jnp.asarray(emb), jnp.asarray(q), jplan, **kw)
    np.testing.assert_array_equal(i2.numpy(), i1.numpy())
    np.testing.assert_array_equal(v2.numpy(), v1.numpy())
    np.testing.assert_array_equal(i2.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v2.numpy(), np.asarray(jv), rtol=0, atol=1e-5)


def test_hybrid_topk_bucketed_tiled_matches_reference_and_unbucketed():
    """tests/test_ops.py:495's case: the bucketed tiled path equals the
    unbucketed tiled hybrid_topk bit for bit, and the reference's."""
    n, b = 3000, 12
    emb, q, dr, wr, lens = _hybrid_inputs(9, n, 64, b, 300, lambda r: r.integers(2, 6))
    kw = dict(k=10, n_docs=n, dense_k=64, sparse_m=64, sparse_weight=0.6, max_seg=8)
    a3, w3 = tbm25.plan_tiles(dr, wr, n)
    v1, i1 = ttopk.hybrid_topk(_t(emb), _t(q), _t(a3), _t(w3), **kw)
    plans, inv = tbm25.plan_tiles_bucketed(dr, wr, lens, n, groups=2)
    jplans, jinv = jbm25.plan_tiles_bucketed(dr, wr, lens, n, groups=2)
    np.testing.assert_array_equal(inv, jinv)
    for x, y in zip(plans, jplans):
        np.testing.assert_array_equal(x[0], y[0])
        np.testing.assert_array_equal(x[1], y[1])
        assert x[2] == y[2]
    pa = tuple((_t(a), _t(w)) for a, w, _ in plans)
    bvs = tuple(bv for _, _, bv in plans)
    v2, i2 = ttopk.hybrid_topk_bucketed_tiled(_t(emb), _t(q), pa, _t(inv),
                                              b_valids=bvs, **kw)
    np.testing.assert_array_equal(i2.numpy(), i1.numpy())
    np.testing.assert_array_equal(v2.numpy(), v1.numpy())
    jv, ji = jtopk.hybrid_topk_bucketed_tiled(
        jnp.asarray(emb), jnp.asarray(q),
        tuple((jnp.asarray(a), jnp.asarray(w)) for a, w, _ in jplans),
        jnp.asarray(jinv), b_valids=bvs, **kw)
    np.testing.assert_array_equal(i2.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v2.numpy(), np.asarray(jv), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_fuse_scans_the_corpus_in_chunks(monkeypatch, dtype):
    """Dense candidates over 7-row chunks equal the one-chunk scan and the
    reference's hybrid_topk: exact top-dense_k, lower row first on ties."""
    n, b, k = 300, 4, 10
    emb, q, dr, wr, _ = _hybrid_inputs(5, n, 32, b, 60, lambda r: 4)
    # exact ties among dense scores: rows 10-12 repeat row 3
    emb[10:13] = emb[3]
    emb_t = _t(emb).to(getattr(torch, dtype))
    jemb = jnp.asarray(emb_t.float().numpy()).astype(getattr(jnp, dtype))
    kw = dict(k=k, n_docs=n, dense_k=64, sparse_m=64, sparse_weight=0.6)
    v1, i1 = ttopk.hybrid_topk(emb_t, _t(q), _t(dr), _t(wr), **kw)
    monkeypatch.setattr(ttopk, "SCAN_CHUNK", 7)
    v2, i2 = ttopk.hybrid_topk(emb_t, _t(q), _t(dr), _t(wr), **kw)
    np.testing.assert_array_equal(i2.numpy(), i1.numpy())
    np.testing.assert_array_equal(v2.numpy(), v1.numpy())
    jv, ji = jtopk.hybrid_topk(jemb, jnp.asarray(q), jnp.asarray(dr),
                               jnp.asarray(wr), **kw)
    np.testing.assert_array_equal(i2.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v2.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    # the dense candidates themselves, against an exact sort
    d_v, d_i = ttopk._dense_candidates(emb_t, _t(q), 64, 7)
    scores = _t(q) @ emb_t.float().T
    order = torch.sort(-scores, dim=1, stable=True).indices[:, :64]
    np.testing.assert_array_equal(d_i.numpy(), order.numpy())


# ------------------------------------------------------ the rest of the layer
def test_bm25_scores_match_reference_and_oracle():
    rng = np.random.default_rng(3)
    docs = [rng.integers(0, 40, int(rng.integers(0, 15))).tolist() for _ in range(60)]
    queries = [rng.integers(0, 40, 3).tolist() for _ in range(5)] + [[], [39, 39]]
    p = tbm25.build_postings(docs, 40)
    for normalize in (False, True):
        got = tbm25.bm25_scores(p, queries, normalize=normalize, device="cpu")
        want = jbm25.bm25_scores(jbm25.build_postings(docs, 40), queries,
                                 normalize=normalize)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(tbm25.bm25_scores_np(docs, queries),
                                  jbm25.bm25_scores_np(docs, queries))
    np.testing.assert_allclose(tbm25.bm25_scores(p, queries, device="cpu"),
                               tbm25.bm25_scores_np(docs, queries),
                               rtol=1e-5, atol=1e-6)


def test_bm25_index_scores_and_topk_match_reference():
    notes = make_notes(40)
    ti = tindex.BM25Index(notes, device="cpu")
    ji = jindex.BM25Index(notes)
    queries = ["Aurora Lane singer", "Quantum Leap Institute", "no such words"]
    for normalize in (False, True):
        np.testing.assert_allclose(ti.scores(queries, normalize=normalize),
                                   ji.scores(queries, normalize=normalize),
                                   rtol=1e-6)
    for q in queries[:2]:
        (ts, tidx), (js, jidx) = ti.topk(q, k=5), ji.topk(q, k=5)
        np.testing.assert_allclose(ts, js, rtol=1e-6)
        np.testing.assert_array_equal(tidx, jidx)
    # text_fn and the vocabulary's add / get
    tf = tindex.BM25Index(notes, text_fn=lambda n: n["content"], device="cpu")
    jf = jindex.BM25Index(notes, text_fn=lambda n: n["content"], use_native=False)
    np.testing.assert_allclose(tf.scores(queries), jf.scores(queries), rtol=1e-6)
    assert tf.vocab.get("aurora") == jf.vocab.get("aurora") >= 0
    assert tf.vocab.get("zzz") == -1
    n = len(tf.vocab)
    assert tf.vocab.add("zzz") == n and tf.vocab.add("zzz") == n


def test_field_weighted_index_matches_reference():
    notes = make_notes(30)
    ti = tindex.FieldWeightedBM25Index(notes, device="cpu")
    ji = jindex.FieldWeightedBM25Index(notes)
    queries = ["Blue Horizon", "Marcus Webb director", "Nexus"]
    for normalize in (False, True):
        np.testing.assert_allclose(ti.scores(queries, normalize=normalize),
                                   ji.scores(queries, normalize=normalize),
                                   rtol=1e-6)
    fw = {"title": 3.0, "content": 0.5}
    np.testing.assert_allclose(
        tindex.FieldWeightedBM25Index(notes, field_weights=fw, device="cpu")
        .scores(queries), jindex.FieldWeightedBM25Index(notes, field_weights=fw)
        .scores(queries), rtol=1e-6)
