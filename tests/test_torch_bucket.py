"""The port's bucketed-winners dense top-k (anorag_tpu_torch/ops/topk.py::
bucket_topk, bucket_winners_ref) against anorag_tpu/ops/topk.py::bucket_topk
on the CPU, on the same numpy inputs: the reference's Pallas kernel in
interpret mode and its XLA oracle (use_xla=True).

Tolerance: values to atol 1e-5 (f32 sums taken in another order) and ids
equal outside groups of scores closer than that (testing.check_topk). The
width rule is the reference's, so every case runs at the same W.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from anorag_tpu.ops.topk import _bucket_winners_pallas as j_winners_pallas
from anorag_tpu.ops.topk import bucket_topk as j_bucket_topk
from anorag_tpu.ops.topk import dense_topk_np
from anorag_tpu_torch.ops import topk
from anorag_tpu_torch.testing import (BUCKET_CASES, check_bucket_winners,
                                      check_topk, flat_scores, unit_rows)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(n, d, b, seed):
    rng = np.random.default_rng(seed)
    return unit_rows(rng, n, d), unit_rows(rng, b, d)


def _torch(result):
    v, i = (np.asarray(x) for x in result)
    return torch.from_numpy(v.astype(np.float32)), torch.from_numpy(i.astype(np.int64))


def _case_id(c):
    return "n{}-d{}-b{}-w{}-t{}-k{}".format(*c)


@pytest.mark.parametrize("route", ["pallas", "xla"])
@pytest.mark.parametrize("case", BUCKET_CASES, ids=_case_id)
def test_bucket_topk_matches_reference(case, route):
    """bucket_topk on CPU tensors (the plain version) against the
    reference's interpret-mode Pallas kernel and its XLA oracle, f32."""
    n, d, b, w, tiles, k = case
    emb, q = _inputs(n, d, b, seed=n + d)
    kw = {"use_xla": True} if route == "xla" else {"interpret": True}
    want = _torch(j_bucket_topk(jnp.asarray(emb), jnp.asarray(q), k, w=w,
                                tiles=tiles, **kw))
    e, qt = torch.from_numpy(emb), torch.from_numpy(q)
    got = topk.bucket_topk(e, qt, k, w=w, tiles=tiles)
    assert got[0].shape == (b, k) and got[1].dtype == torch.int32
    check_topk(got, want, flat_scores(e, qt))
    if n < k:                                  # k > N pads with (NEG_INF, -1)
        assert bool((got[1][:, n:] == -1).all())
        assert bool((got[0][:, n:] == topk.NEG_INF).all())


@pytest.mark.parametrize("case", BUCKET_CASES, ids=_case_id)
def test_bucket_topk_use_xla_is_the_plain_route(case):
    n, d, b, w, tiles, k = case
    emb, q = (torch.from_numpy(x) for x in _inputs(n, d, b, seed=n + d))
    got = topk.bucket_topk(emb, q, k, w=w, tiles=tiles, use_xla=True)
    want = topk.bucket_topk(emb, q, k, w=w, tiles=tiles, interpret=True)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_exact_regime_equals_dense_topk_np():
    """N <= W: every column has its own bucket, so the result is the exact
    top-k (tests/test_ops.py:380)."""
    emb, q = _inputs(500, 96, 7, seed=0)
    ov, oi = dense_topk_np(emb, q, 10)
    v, i = topk.bucket_topk(torch.from_numpy(emb), torch.from_numpy(q), 10, w=1024)
    np.testing.assert_array_equal(i.numpy(), oi)
    np.testing.assert_allclose(v.numpy(), ov, atol=1e-5, rtol=0)


def test_recall_in_the_approximate_regime():
    """W 512 over 6,000 rows: two of the top 10 share a bucket with
    probability 1/512 per pair, so recall@10 stays near 0.99."""
    emb, q = _inputs(6000, 128, 16, seed=1)
    _, oi = dense_topk_np(emb, q, 10)
    _, i = topk.bucket_topk(torch.from_numpy(emb), torch.from_numpy(q), 10, w=512)
    rec = np.mean([len(set(i[j].tolist()) & set(oi[j])) / 10 for j in range(16)])
    assert rec >= 0.97


@pytest.mark.parametrize("itemsize,want_w", [(4, 256), (2, 512)])
def test_width_rule_follows_the_reference(itemsize, want_w):
    """The 12 MiB guard at B 512, D 1024 halves w 1024 to 256 for an f32
    corpus and to 512 for bf16; tiles shrink first; k_eff sets a floor."""
    assert topk.bucket_width(512, 1024, itemsize, 1024, 1, 100) == (want_w, 1)
    assert topk.bucket_width(512, 1024, 2, 512, 2, 100) == (512, 2)
    assert topk.bucket_width(512, 1024, 2, 512, 4, 100) == (512, 2)
    assert topk.bucket_width(512, 1024, 4, 128, 1, 300) == (512, 1)
    assert topk.bucket_width(7, 96, 4, 64, 1, 10) == (64, 1)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bucket_winners_table_matches_pallas_interpret(dtype, transposed):
    """The raw (B, W) winners of bucket_winners_ref against the reference's
    interpret-mode kernel on the reference's padded inputs, both layouts,
    at a ragged last tile (1,009 rows, W 128, D 100)."""
    jdt, tdt = DTYPES[dtype]
    n, d, b, w = 1009, 100, 5, 128
    emb, q = _inputs(n, d, b, seed=3)
    n_pad, d_pad, b_pad = 1024, 128, 8
    embp = np.zeros((n_pad, d_pad), np.float32)
    embp[:n, :d] = emb
    qp = np.zeros((b_pad, d_pad), np.float32)
    qp[:b, :d] = q
    je = jnp.asarray(embp.T if transposed else embp, jdt)
    jv, ji = j_winners_pallas(je, jnp.asarray(qp, jdt), jnp.asarray([n], jnp.int32),
                              w, 1, True, transposed=transposed)
    e = torch.from_numpy(emb).to(tdt)
    qt = torch.from_numpy(q).to(tdt)
    got = topk.bucket_winners(e.T.contiguous() if transposed else e, qt, n, w,
                              transposed=transposed)
    want = (torch.tensor(np.asarray(jv)[:b]), torch.tensor(np.asarray(ji)[:b]))
    check_bucket_winners(got, want, e, qt)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_transposed_corpus_equals_the_row_layout(dtype):
    _, tdt = DTYPES[dtype]
    emb, q = _inputs(1009, 100, 3, seed=4)
    e = torch.from_numpy(emb).to(tdt)
    qt = torch.from_numpy(q)
    want = topk.bucket_topk(e, qt, 10, w=256)
    got = topk.bucket_topk(e.T.contiguous(), qt, 10, w=256, transposed=True)
    check_topk(got, want, flat_scores(e, qt))    # CPU matmul order varies by layout
    j = _torch(j_bucket_topk(jnp.asarray(emb.T, DTYPES[dtype][0]), jnp.asarray(q),
                             10, w=256, transposed=True, interpret=True))
    check_topk(got, j, flat_scores(e, qt))


def test_bf16_corpus_with_f32_queries():
    """Queries are cast to the corpus dtype before the product, as the
    reference casts them (:348), then scored in f32."""
    emb, q = _inputs(3000, 256, 16, seed=5)
    want = _torch(j_bucket_topk(jnp.asarray(emb, jnp.bfloat16), jnp.asarray(q), 10,
                                w=512, interpret=True))
    e = torch.from_numpy(emb).to(torch.bfloat16)
    qt = torch.from_numpy(q)
    got = topk.bucket_topk(e, qt, 10, w=512)
    check_topk(got, want, flat_scores(e, qt))
    assert got[0].dtype == torch.float32


def test_a_tie_across_tiles_keeps_the_earlier_row():
    """Row c + W is a copy of row c and both beat every other row: they
    share bucket c, and strict > keeps c, in the reference and the port."""
    n, d, b, w = 900, 64, 2, 256
    emb, q = _inputs(n, d, b, seed=6)
    c = 37
    emb[c] = q[0]
    emb[c + w] = q[0]
    want = _torch(j_bucket_topk(jnp.asarray(emb), jnp.asarray(q), 5, w=w,
                                interpret=True))
    v, i = topk.bucket_topk(torch.from_numpy(emb), torch.from_numpy(q), 5, w=w)
    assert int(i[0, 0]) == c and int(want[1][0, 0]) == c
    assert c + w not in i[0].tolist()
    assert torch.equal(i.long(), want[1])


def test_staging_modes():
    """How the kernel would stage each layout (the mode is chosen in Python,
    so it is checked here): 16-byte copies for aligned row-major rows,
    plain loads along rows otherwise, down columns for the transposed
    corpus."""
    e = torch.zeros((300, 128), dtype=torch.bfloat16)
    assert topk.staging_mode(e) == 0
    assert topk.staging_mode(e[:, :100]) == 1          # D 100: not 16-byte rows
    assert topk.staging_mode(e[1:]) == 0               # row stride 256 bytes
    assert topk.staging_mode(torch.zeros((300, 100), dtype=torch.bfloat16)) == 1
    assert topk.staging_mode(torch.zeros((128, 300)).T) == 2
    assert topk.staging_mode(torch.zeros((300, 132))) == 0


def test_bucket_winners_rejects_what_the_kernel_does_not_take():
    e = torch.zeros((50, 16))
    q = torch.zeros((3, 16))
    with pytest.raises(TypeError):
        topk.bucket_winners(e.half(), q.half(), 50, 64)
    with pytest.raises(TypeError):
        topk.bucket_winners(e, q.double(), 50, 64)
    with pytest.raises(ValueError):
        topk.bucket_winners(e, q[:, :8], 50, 64)
    with pytest.raises(ValueError):
        topk.bucket_winners(e, q, 51, 64)
    with pytest.raises(ValueError):
        topk.bucket_winners(e, q, 50, 0)
