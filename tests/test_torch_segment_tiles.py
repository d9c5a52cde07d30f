"""The row-tiles segment-totals kernel's walk, on the CPU.

csrc/segment_scan.cu's totals kernel runs only on the card
(tests/test_torch_cuda.py and chip_smoke.py hold it there). Here a torch
emulation repeats its arithmetic step by step: each 1024-wide block (any
bl up to 1024) scanned by one warp, lane l holding positions 128c + 4l + i
of 8 rows c -- steps 1 and 2 inside the lane and from its left neighbour,
steps 4-64 by warp shuffles that take the row below across the warp's
edge, steps from 128 inside the lane --; each block's published summary (the last x, the
largest x at an end); the carry folded in block order from a published
carry of the row (any one: each is the same fold); the totals from the
carry. It must equal segment_totals_ref, and the interpret-mode Pallas
segment_totals_pallas, bit for bit, on SEGMENT_CASES, bucket-like shapes,
a row that is one doc across many tiles, bl values that are not powers of
two and weights spanning six decades. segment_tile_plan, the tiles and
scratch the wrapper gives the kernel, is tested as well.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from anorag_tpu.ops import bm25 as jbm25
from anorag_tpu_torch.ops import bm25
from anorag_tpu_torch.testing import SEGMENT_CASES, segment_plan

INF = float("inf")


def block_scan_warp(wb: torch.Tensor) -> torch.Tensor:
    """The kernel's add scan of one block (bl,) f32 by one warp: lane l
    holds positions 128c + 4l + i (rows c = 0..7, i = 0..3). Each step reads
    the values before it: steps 1 and 2 inside the lane and from lane l - 1
    (lane 0 from lane 31 of the row below), steps 4m from lane l - m (lanes
    below m from lane l - m + 32 of the row below: those lanes send the row
    below), steps 128d from row c - d in the lane."""
    bl = wb.numel()
    x = torch.zeros(1024, dtype=torch.float32)
    x[:bl] = wb
    x = x.view(8, 32, 4).clone()
    lane = torch.arange(32)
    left = (lane - 1) % 32

    def below(v):                          # row c - 1 of v, 0 below row 0
        return torch.cat([torch.zeros_like(v[:1]), v[:-1]])

    if bl > 1:
        send = torch.where(lane == 31, below(x[..., 3]), x[..., 3])
        r = send[:, left]
        x = torch.stack([x[..., 0] + r, x[..., 1] + x[..., 0], x[..., 2] + x[..., 1],
                         x[..., 3] + x[..., 2]], -1)
    if bl > 2:
        s2 = torch.where(lane == 31, below(x[..., 2]), x[..., 2])
        s3 = torch.where(lane == 31, below(x[..., 3]), x[..., 3])
        x = torch.stack([x[..., 0] + s2[:, left], x[..., 1] + s3[:, left],
                         x[..., 2] + x[..., 0], x[..., 3] + x[..., 1]], -1)
    m = 1
    while m < 32 and 4 * m < bl:
        send = torch.where((lane >= 32 - m)[None, :, None], below(x), x)
        x = x + send[:, (lane - m) % 32, :]
        m *= 2
    d = 1
    while d < 8:
        if 128 * d < bl:
            x[d:] = x[d:] + x[:-d]
        d *= 2
    return x.reshape(-1)[:bl]


def tile_totals(a: torch.Tensor, w: torch.Tensor, n_docs: int, block_l: int,
                rng: np.random.Generator):
    """The kernels' tiles over a (B, L) plan: per block the local scan, the
    summary and the ends; each tile's carry folded in block order from a
    published carry of its row, the latest or one picked by rng. Yields
    (row, block, ids (bl,), masked totals (bl,): valid ? total : -3.0e38)
    in (row, block) order; positions past L are pads."""
    b, l = a.shape
    plan = bm25.segment_tile_plan(b, l, block_l)
    bl, nb = plan.bl, plan.blocks
    for r in range(b):
        summaries, carries = [], []
        for jb in range(nb):
            lo = jb * bl
            ids = torch.full((bl,), n_docs, dtype=torch.int32)
            wb = torch.zeros(bl, dtype=torch.float32)
            n = min(bl, l - lo)
            ids[:n], wb[:n] = a[r, lo:lo + n], w[r, lo:lo + n]
            succ = torch.empty(bl, dtype=torch.int32)
            succ[:-1] = ids[1:]
            succ[-1] = a[r, lo + bl] if jb + 1 < nb else -1
            x = block_scan_warp(wb)
            end = ids != succ
            xe = torch.where(end, x, -INF)
            incl = torch.cummax(xe, 0).values
            before = torch.cat([torch.tensor([-INF]), incl[:-1]])
            summaries.append((x[-1], incl[-1]))
            # the fold: from the row's start or a published carry, in order
            start = 0
            if jb and rng.random() < 0.7:
                start = int(rng.integers(0, jb)) + 1
            cs = cp = torch.tensor(0.0, dtype=torch.float32)
            if start:
                cs, cp = carries[start - 1]
            for xl, xe_j in summaries[start:jb]:
                cp = torch.maximum(cp, xe_j + cs)
                cs = xl + cs
            carries.append((summaries[jb][0] + cs,
                            torch.maximum(cp, summaries[jb][1] + cs)))
            c = x + cs
            total = c - torch.maximum(cp, before + cs)
            valid = end & (ids < n_docs)
            yield r, jb, ids, torch.where(valid, total, -3.0e38)


def tile_walk(a: torch.Tensor, w: torch.Tensor, n_docs: int, block_l: int,
              rng: np.random.Generator):
    """The totals kernel's walk: every tile's masked totals written, the row
    max of the valid totals (at least 0)."""
    b, l = a.shape
    bl = bm25.segment_tile_plan(b, l, block_l).bl
    masked = torch.empty((b, l), dtype=torch.float32)
    mx = torch.zeros((b, 1), dtype=torch.float32)
    for r, jb, _, out in tile_totals(a, w, n_docs, block_l, rng):
        n = min(bl, l - jb * bl)
        masked[r, jb * bl:jb * bl + n] = out[:n]
        mx[r] = torch.maximum(mx[r], torch.clamp(out, min=0.0).max())
    return masked, mx


def _check(a_np, w_np, n_docs, block_l, pallas=True, seed=0):
    a, w = torch.from_numpy(a_np), torch.from_numpy(w_np)
    got = tile_walk(a, w, n_docs, block_l, np.random.default_rng(seed))
    want = bm25.segment_totals_ref(a, w, n_docs, block_l=block_l)
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    if pallas:
        jw = jbm25.segment_totals_pallas(jnp.asarray(a_np), jnp.asarray(w_np), n_docs,
                                         block_l=block_l, interpret=True)
        for g, r in zip(got, jw):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


CASE_IDS = ["{}-b{}-l{}-bl{}".format(c[0], *c[2:]) for c in SEGMENT_CASES]


@pytest.mark.parametrize("bl", [1, 2, 3, 4, 5, 31, 100, 128, 129, 255, 384, 700,
                                1000, 1021, 1024])
def test_block_scan_warp_is_the_reference_log_scan(bl):
    """Every bl, weights spanning six decades: the warp's scan is _log_scan
    bit for bit."""
    rng = np.random.default_rng(bl)
    wb = (10.0 ** rng.uniform(-3, 3, (8, bl))).astype(np.float32)
    wb[rng.random((8, bl)) < 0.1] = 0.0
    want = bm25._log_scan(torch.from_numpy(wb), torch.add)
    for r in range(8):
        assert torch.equal(block_scan_warp(torch.from_numpy(wb[r])), want[r])


@pytest.mark.parametrize("case", SEGMENT_CASES, ids=CASE_IDS)
def test_tile_walk_matches_ref_and_pallas(case):
    name, n_docs, b, l, block_l = case
    a, w = segment_plan(name, n_docs, b, l)
    _check(a, w, n_docs, block_l)


@pytest.mark.parametrize("block_l", [100, 384, 1000])
def test_tile_walk_at_block_widths_not_powers_of_two(block_l):
    a, w = segment_plan("straddle", 300, 3, 2311)
    _check(a, w, 300, block_l)


def test_tile_walk_on_a_bucket_shape():
    """A bucket of the bucketed query: 16 rows 8,192 wide, 8 tiles a row."""
    a, w = segment_plan("bench", 6000, 16, 8192)
    _check(a, w, 6000, 1024, pallas=False, seed=3)


def test_tile_walk_on_one_doc_across_many_tiles():
    """A row that is one doc over 5,000 positions (ends only in its last
    tile), then pads, beside a row of short segments; weights spanning six
    decades."""
    rng = np.random.default_rng(5)
    l, n_docs = 6144, 50
    a = np.full((2, l), n_docs, np.int32)
    a[0, :5000] = 7
    a[1, :4000] = np.sort(rng.integers(0, n_docs, 4000))
    w = np.where(a < n_docs, 10.0 ** rng.uniform(-3, 3, (2, l)), 0.0).astype(np.float32)
    _check(a, w, n_docs, 1024, seed=1)


@pytest.mark.parametrize("seed", range(4))
def test_tile_walk_on_random_plans(seed):
    rng = np.random.default_rng(100 + seed)
    l = int(rng.integers(1, 9000))
    n_docs = int(rng.integers(2, 400))
    a = np.sort(rng.integers(0, n_docs + 1, (3, l)), axis=1).astype(np.int32)
    w = np.where(a < n_docs, 10.0 ** rng.uniform(-3, 3, (3, l)), 0.0).astype(np.float32)
    _check(a, w, n_docs, int(rng.choice([128, 700, 1024])), pallas=False, seed=seed)


@pytest.mark.parametrize("b,l,block_l,bl,blocks", [
    (512, 32768, 1024, 1024, 32),         # the unbucketed plan
    (128, 32768, 1024, 1024, 32),         # the bucketed query's buckets
    (128, 16384, 1024, 1024, 16),
    (128, 8192, 1024, 1024, 8),
    (9, 700, 128, 128, 6),
    (2, 1, 1024, 1, 1),
    (3, 2311, 1000, 1000, 3),
])
def test_segment_tile_plan(b, l, block_l, bl, blocks):
    plan = bm25.segment_tile_plan(b, l, block_l)
    assert (plan.bl, plan.blocks) == (bl, blocks)
    # a summary and a carry a tile (block), the counter, then B f32 of row max
    assert plan.mx_word == 2 * b * blocks + 1
    assert 2 * (plan.scratch_words - plan.mx_word) >= b
    assert 2 * (plan.scratch_words - plan.mx_word) <= b + 1


def test_segment_tile_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        bm25.segment_tile_plan(4, 0)
    with pytest.raises(ValueError):
        bm25.segment_tile_plan(4, 100, block_l=2048)

