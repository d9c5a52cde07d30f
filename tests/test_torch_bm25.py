"""Parity of the port's BM25 sparse stage (anorag_tpu_torch/ops/bm25.py)
with anorag_tpu/ops/bm25.py on the same numpy inputs.

The Pallas window-winners kernel runs in interpret mode here, as
tests/test_ops.py runs it. The port's plain version sums the taps in the
reference's order, so ids must be equal and values agree to rtol 1e-6; the
sparse top-m stages to rtol 1e-5. The CUDA kernel itself is held against
the plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from anorag_tpu.ops import bm25 as jbm25
from anorag_tpu_torch.ops import bm25 as tbm25
from anorag_tpu_torch.testing import WINDOW_CASES, sorted_plan


def _np(x):
    return np.asarray(x)


def _assert_winners_equal(got, want, rtol=1e-6):
    (wv, wd, mx), (jv, jd, jm) = got, want
    np.testing.assert_array_equal(wd.numpy(), _np(jd))
    np.testing.assert_allclose(wv.numpy(), _np(jv), rtol=rtol)
    np.testing.assert_allclose(mx.numpy(), _np(jm), rtol=rtol)


@pytest.mark.parametrize("case", WINDOW_CASES, ids=lambda c: "n{}-b{}-l{}-s{}".format(*c))
def test_window_winners_ref_matches_pallas_rows(case):
    n_docs, b, l, max_seg = case
    a, w = sorted_plan(np.random.default_rng(l), n_docs, b, l, max_seg)
    want = jbm25.window_winners_pallas(jnp.asarray(a), jnp.asarray(w), n_docs,
                                       max_seg=max_seg, interpret=True)
    got = tbm25.window_winners_ref(torch.from_numpy(a), torch.from_numpy(w),
                                   n_docs, max_seg)
    _assert_winners_equal(got, want)
    # the wrapper takes the plain version for CPU tensors
    _assert_winners_equal(tbm25.window_winners(
        torch.from_numpy(a), torch.from_numpy(w), n_docs, max_seg), want)


@pytest.mark.parametrize("case", WINDOW_CASES[2:], ids=lambda c: "n{}-b{}-l{}-s{}".format(*c))
def test_window_winners_ref_matches_pallas_tiled(case):
    """The L-major tiled layout: the port turns it back into rows."""
    n_docs, b, l, max_seg = case
    a, w = sorted_plan(np.random.default_rng(l + 1), n_docs, b, l, max_seg)
    a3, w3 = tbm25.plan_tiles(a, w, n_docs)
    want = jbm25.window_winners_tiled(jnp.asarray(a3), jnp.asarray(w3), n_docs,
                                      max_seg=max_seg, b_valid=b, interpret=True)
    got = tbm25.window_winners(torch.from_numpy(a3), torch.from_numpy(w3),
                               n_docs, max_seg, b_valid=b)
    _assert_winners_equal(got, want)


def test_window_winners_segments_cross_table_boundary():
    """The L = 2311 case has segments straddling position 1024 (one bucket
    table width), so the lookback crosses the TPU kernel's block edge."""
    n_docs, b, l, max_seg = WINDOW_CASES[-1]
    a, _ = sorted_plan(np.random.default_rng(l), n_docs, b, l, max_seg)
    assert any(a[r, 1023] == a[r, 1024] < n_docs for r in range(b))


def test_window_winners_rejects_bad_input():
    a = torch.zeros((2, 300), dtype=torch.int32)
    w = torch.zeros((2, 300))
    for bad in (0, 33):
        with pytest.raises(ValueError):
            tbm25.window_winners(a, w, 10, bad)
    with pytest.raises(ValueError):
        tbm25.window_winners(a, w[:, :200], 10, 8)
    # max_seg 0 is not refused: it takes the segment-winners route, as in
    # the reference
    got = tbm25.sparse_topm_winners(a, w, 8, 10, max_seg=0)
    want = jbm25.sparse_topm_winners(jnp.asarray(a.numpy()), jnp.asarray(w.numpy()),
                                     8, 10, max_seg=0)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), _np(y))


def test_build_postings_bitwise_equal():
    rng = np.random.default_rng(3)
    vocab = 500
    docs = [rng.integers(0, vocab, int(rng.integers(0, 40))).tolist()
            for _ in range(300)]
    got = tbm25.build_postings(docs, vocab)
    want = jbm25.build_postings(docs, vocab)
    for name in ("term_offsets", "doc_ids", "weights", "idf"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert got.n_docs == want.n_docs
    # plans built from them
    q_terms = [rng.integers(0, vocab, 5).tolist() for _ in range(7)]
    for x, y in zip(tbm25.gather_plan_sorted(got, q_terms),
                    jbm25.gather_plan_sorted(want, q_terms)):
        np.testing.assert_array_equal(x, y)
    dr, wr, _ = tbm25.gather_plan_sorted(got, q_terms)
    for x, y in zip(tbm25.plan_tiles(dr, wr, 300, round_pow2=True),
                    jbm25.plan_tiles(dr, wr, 300, round_pow2=True)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 255, 257, 4097])
def test_cumsum_rows_matches_xla_cpu_order(n):
    import jax

    w = (np.random.default_rng(n).random((3, n)) * 100).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jnp.cumsum(x, axis=1))(jnp.asarray(w)))
    np.testing.assert_array_equal(tbm25._cumsum_rows(torch.from_numpy(w)).numpy(),
                                  want)


@pytest.mark.parametrize("case", WINDOW_CASES[1:], ids=lambda c: "n{}-b{}-l{}-s{}".format(*c))
def test_sparse_topm_parity(case):
    n_docs, b, l, max_seg = case
    a, w = sorted_plan(np.random.default_rng(l + 2), n_docs, b, l, max_seg)
    ad, wd_ = jnp.asarray(a), jnp.asarray(w)
    at, wt = torch.from_numpy(a), torch.from_numpy(w)
    m = min(8, n_docs)

    jv, jd, jm = jbm25.sparse_topm_winners(ad, wd_, m, n_docs, max_seg=max_seg)
    tv, td, tm = tbm25.sparse_topm_winners(at, wt, m, n_docs, max_seg=max_seg)
    np.testing.assert_array_equal(td.numpy(), _np(jd))
    np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=1e-5)
    np.testing.assert_allclose(tm.numpy(), _np(jm), rtol=1e-5)

    jmask, jv, jd, jm = jbm25.sparse_topm_from_sorted(ad, wd_, m, n_docs, impl="xla")
    tmask, tv, td, tm = tbm25.sparse_topm_from_sorted(at, wt, m, n_docs)
    np.testing.assert_array_equal(td.numpy(), _np(jd))
    np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=1e-5)
    np.testing.assert_allclose(tm.numpy(), _np(jm), rtol=1e-5)
    np.testing.assert_allclose(tmask.numpy(), _np(jmask), rtol=1e-5)
