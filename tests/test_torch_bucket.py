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
from anorag_tpu.ops.topk import _bucket_winners_xla as j_winners_xla
from anorag_tpu.ops.topk import bucket_topk as j_bucket_topk
from anorag_tpu.ops.topk import dense_topk_np
from anorag_tpu_torch.ops import topk
from anorag_tpu_torch.testing import (BUCKET_CASES, bucket_split_tables,
                                      check_bucket_winners, check_topk,
                                      copy_across_splits, flat_scores, unit_rows)

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


@pytest.mark.parametrize("n", [5, 1000, 6000, 200_000, 5_000_000])
@pytest.mark.parametrize("w", [128, 512, 2048])
@pytest.mark.parametrize("b", [1, 16, 129, 512])
def test_bucket_work_plan_covers_every_tile_once_in_one_wave(b, w, n):
    """The wgmma route's plan: contiguous, increasing splits of whole
    corpus tiles that cover each of the ceil(n / w) tiles once, none empty,
    and units that fit in one wave of 132 CTAs (one split when the
    (query tile, column tile) pairs alone fill it)."""
    slots = 132
    plan = topk.bucket_work_plan(b, w, n, slots)
    n_tiles = -(-n // w)
    assert plan.q_tiles == -(-b // topk.BUCKET_TILE)
    assert plan.c_tiles == w // topk.BUCKET_TILE
    covered = [t for s in range(plan.splits)
               for t in range(s * plan.per, min((s + 1) * plan.per, n_tiles))]
    assert covered == list(range(n_tiles))
    assert (plan.splits - 1) * plan.per < n_tiles          # no empty split
    pairs = plan.q_tiles * plan.c_tiles
    assert plan.units <= max(slots, pairs)
    if pairs >= slots:
        assert plan.splits == 1
    elif n_tiles >= slots // pairs:
        assert plan.units > slots // 2                     # the wave is mostly full


# (n, d, b, w, per): several splits, a ragged last tile, buckets no row
# reaches (n < w), one tile a split and several
MERGE_CASES = [(6000, 64, 5, 512, 1), (6000, 64, 5, 512, 3), (1009, 48, 3, 128, 2),
               (300, 32, 2, 512, 1), (2000, 16, 4, 128, 5), (4096, 32, 7, 256, 4)]


@pytest.mark.parametrize("case", MERGE_CASES, ids=lambda c: "n{}-d{}-b{}-w{}-per{}".format(*c))
@pytest.mark.parametrize("ties", [False, True])
def test_bucket_merge_of_split_tables_equals_the_unsplit_winners(case, ties):
    """bucket_merge_ref over per-split bucket_winners_ref tables equals the
    unsplit bucket_winners_ref exactly, and both equal the reference's XLA
    oracle; with ties, query 0's own vector sits in bucket 37 of tiles 0 and
    1 and of the first tile of every split: the earliest row keeps it."""
    n, d, b, w, per = case
    emb, q = _inputs(n, d, b, seed=n + per)
    at = copy_across_splits(emb, q[0], w, per, 37) if ties else []
    e, qt = torch.from_numpy(emb), torch.from_numpy(q)
    n_tiles = -(-n // w)
    plan = topk.BucketPlan(1, w // topk.BUCKET_TILE, -(-n_tiles // per), per)
    merged = topk.bucket_merge(*bucket_split_tables(e, qt, n, w, plan))
    want = topk.bucket_winners_ref(e, qt, n, w)
    assert torch.equal(merged[0], want[0]) and torch.equal(merged[1], want[1])
    if at:
        assert int(want[1][0, 37]) == at[0]
    if n < w:
        assert bool((want[0][:, n:] == topk.NEG_INF).all())
        assert bool((want[1][:, n:] == 0).all())
    n_pad = n_tiles * w
    embp = np.zeros((n_pad, d), np.float32)
    embp[:n] = emb
    jv, ji = j_winners_xla(jnp.asarray(embp), jnp.asarray(q), jnp.asarray([n], jnp.int32), w)
    assert torch.equal(want[1], torch.from_numpy(np.asarray(ji)))
    np.testing.assert_allclose(want[0].numpy(), np.asarray(jv), atol=1e-5, rtol=0)


def test_bucket_merge_rejects_what_the_kernel_does_not_take():
    v = torch.zeros((2, 3, 128))
    i = torch.zeros((2, 3, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        topk.bucket_merge(v[0], i[0])
    with pytest.raises(TypeError):
        topk.bucket_merge(v.double(), i)
    with pytest.raises(TypeError):
        topk.bucket_merge(v, i.long())
    assert all(torch.equal(x, y) for x, y in
               zip(topk.bucket_merge(v, i), topk.bucket_merge_ref(v, i)))


def test_bucket_route_from_shapes_and_dtypes():
    """The wgmma route takes bf16 with 16-byte rows (staging mode 0 for both
    operands) and W a multiple of 128, from one query; the first kernel
    everything else."""
    assert topk.bucket_route(1, 200_000, 512, 0, 0, 0) == "wgmma"
    assert topk.bucket_route(512, 200_000, 1024, 0, 0, 0) == "wgmma"
    assert topk.bucket_route(70, 5, 128, 0, 0, 0) == "wgmma"
    assert topk.bucket_route(512, 2**31 - 256, 512, 0, 0, 0) == "mma"  # past 2^31
    assert topk.bucket_route(512, 200_000, 512, 1, 0, 0) == "mma"      # f32
    assert topk.bucket_route(512, 200_000, 512, 0, 2, 0) == "mma"      # (D, N)
    assert topk.bucket_route(512, 200_000, 512, 0, 1, 0) == "mma"      # unaligned
    assert topk.bucket_route(512, 200_000, 512, 0, 0, 1) == "mma"
    assert topk.bucket_route(512, 200_000, 100, 0, 0, 0) == "mma"      # W % 128
    assert topk.bucket_route(512, 0, 512, 0, 0, 0) == "mma"            # no rows
    assert topk.bucket_route(0, 10, 512, 0, 0, 0) == "mma"             # no queries
