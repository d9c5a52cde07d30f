"""The segment-winners row tiles' merge, on the CPU.

csrc/segment_scan.cu's winners kernel runs only on the card
(tests/test_torch_cuda.py and chip_smoke.py hold it there). Here an
emulation repeats its merge step by step: each tile's masked totals from
the totals tiles' emulation (tile_totals, tests/test_torch_segment_tiles.py);
a CTA's group of SEGMENT_GROUP_BLOCKS consecutive blocks of a row, whose
winner of each bucket is taken by strict '>' in block order; that winner's
key, the order-keeping bits of its total above 0xffffffff - block, folded
complemented into the row's key table by min (the kernel's atomicMin on a
table cleared to all ones), its id into the group's id table; groups
finishing in seeded random orders, each row decoded by the group that
finishes it. It must equal segment_winners_ref, and the interpret-mode
Pallas segment_winners_pallas, bit for bit on every SEGMENT_CASES entry (the
tie-heavy case included), at block widths that are not powers of two, on
weights spanning six decades and on a plan whose bucket is won by a total
below 0. The key order and the scratch the wrapper hands the kernel
(segment_tile_plan) are tested as well.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from anorag_tpu.ops import bm25 as jbm25
from anorag_tpu_torch.ops import bm25
from anorag_tpu_torch.testing import SEGMENT_CASES, rounding_plan, segment_plan
from test_torch_segment_tiles import tile_totals

GROUP = bm25.SEGMENT_GROUP_BLOCKS
LOW = np.uint64(0xFFFFFFFF)


def order_bits(v) -> np.ndarray:
    """The kernel's order_bits: f32 bits as u32 in the order of the floats
    (nonnegative: top bit set; negative: every bit flipped)."""
    u = np.asarray(v, np.float32).view(np.uint32)
    return np.where(u >> np.uint32(31), ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def winner_key(total, block) -> np.ndarray:
    return ((order_bits(total).astype(np.uint64) << np.uint64(32))
            | (LOW - np.asarray(block).astype(np.uint64)))


def key_value(key) -> np.ndarray:
    o = (np.asarray(key, np.uint64) >> np.uint64(32)).astype(np.uint32)
    u = np.where(o >> np.uint32(31), o ^ np.uint32(0x80000000), ~o).astype(np.uint32)
    return u.view(np.float32)


def winners_walk(a: torch.Tensor, w: torch.Tensor, n_docs: int, block_l: int,
                 rng: np.random.Generator):
    """The winners kernel's merge over a (B, L) plan, its groups finishing
    in an order drawn from rng: (values (B, bl), ids (B, bl), row max)."""
    b, l = a.shape
    plan = bm25.segment_tile_plan(b, l, block_l)
    bl, nb, groups = plan.bl, plan.blocks, plan.groups
    tiles = {(r, jb): (ids.numpy(), out.numpy())
             for r, jb, ids, out in tile_totals(a, w, n_docs, block_l, rng)}
    keys = np.full((b, bl), ~np.uint64(0), np.uint64)    # complements, all ones
    id_table = np.full((b, groups, bl), -7, np.int32)    # written before read
    done = np.zeros(b, np.int64)
    wv = np.full((b, bl), np.nan, np.float32)
    wd = np.full((b, bl), -7, np.int32)
    mx = np.zeros((b, 1), np.float32)
    for unit in rng.permutation(b * groups):             # finishing order
        g, r = divmod(int(unit), b)
        blocks = range(g * GROUP, min(nb, (g + 1) * GROUP))
        best = np.full(bl, -3.0e38, np.float32)
        bj = np.full(bl, -1, np.int64)
        for jb in blocks:                                 # block order, strict '>'
            out = tiles[(r, jb)][1]
            upd = out > best
            best = np.where(upd, out, best)
            bj = np.where(upd, jb, bj)
            mx[r] = max(mx[r, 0], np.maximum(out, 0.0).max())
        hit = bj >= 0
        keys[r, hit] = np.minimum(keys[r, hit], ~winner_key(best[hit], bj[hit]))
        group_ids = np.stack([tiles[(r, jb)][0] for jb in blocks])
        win_ids = np.take_along_axis(group_ids, np.maximum(bj - g * GROUP, 0)[None], 0)[0]
        id_table[r, g, hit] = win_ids[hit]
        done[r] += 1
        if done[r] == groups:                             # this group decodes the row
            k = ~keys[r]
            full = k != 0
            block = (LOW - (k & LOW)).astype(np.int64)
            wv[r] = np.where(full, key_value(k), np.float32(-3.0e38))
            cols = np.arange(bl)
            wd[r] = np.where(full, id_table[r, np.where(full, block // GROUP, 0), cols], -1)
    assert (done == groups).all()
    return torch.from_numpy(wv), torch.from_numpy(wd), torch.from_numpy(mx)


def _check(a_np, w_np, n_docs, block_l, pallas=True, seeds=(0, 1, 2)):
    a, w = torch.from_numpy(a_np), torch.from_numpy(w_np)
    want = bm25.segment_winners_ref(a, w, n_docs, block_l=block_l)
    jw = None
    if pallas:
        jw = jbm25.segment_winners_pallas(jnp.asarray(a_np), jnp.asarray(w_np), n_docs,
                                          block_l=block_l, interpret=True)
    for seed in seeds:
        got = winners_walk(a, w, n_docs, block_l, np.random.default_rng(seed))
        for g, r in zip(got, want):
            assert torch.equal(g, r), seed
        if jw is not None:
            for g, r in zip(got, jw):
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))


CASE_IDS = ["{}-b{}-l{}-bl{}".format(c[0], *c[2:]) for c in SEGMENT_CASES]


@pytest.mark.parametrize("case", SEGMENT_CASES, ids=CASE_IDS)
def test_winners_walk_matches_ref_and_pallas(case):
    """Every odd shape, groups finishing in three orders."""
    name, n_docs, b, l, block_l = case
    a, w = segment_plan(name, n_docs, b, l)
    _check(a, w, n_docs, block_l)


@pytest.mark.parametrize("block_l", [100, 384, 1000])
def test_winners_walk_at_block_widths_not_powers_of_two(block_l):
    a, w = segment_plan("straddle", 300, 3, 2311)
    _check(a, w, 300, block_l)


def test_winners_walk_on_many_groups_and_six_decades():
    """Rows of 20 blocks of 1000 (three groups, the last of 4 blocks) with
    weights spanning six decades, so that totals a few ulps below 0 occur
    beside ties at 0."""
    rng = np.random.default_rng(9)
    b, l, n_docs = 3, 20_000, 200_000
    a = np.sort(rng.integers(0, n_docs, (b, l)), axis=1).astype(np.int32)
    a[:, int(l * 0.9):] = n_docs
    w = np.where(a < n_docs, 10.0 ** rng.uniform(-3, 3, (b, l)), 0.0).astype(np.float32)
    totals = bm25.segment_totals_ref(torch.from_numpy(a), torch.from_numpy(w), n_docs,
                                     block_l=1000)[0]
    live = totals[totals > -1e38]
    assert (live < 0).any() and (live == 0).any()
    _check(a, w, n_docs, 1000, pallas=False)


def test_winners_walk_on_a_negative_winner():
    """Bucket 3 is won by -2^-23: the key must rank it by its float order."""
    a, w, n_docs, block_l = rounding_plan()
    want = bm25.segment_winners_ref(torch.from_numpy(a), torch.from_numpy(w), n_docs,
                                    block_l=block_l)
    assert want[0][0, 3] == -2.0 ** -23 and want[1][0, 3] == 3
    _check(a, w, n_docs, block_l)


def test_tie_case_ties_across_blocks():
    """The tie case: exact equal totals meet in one bucket from three or
    more blocks, and the reference keeps the earliest of them."""
    name, n_docs, b, l, block_l = next(c for c in SEGMENT_CASES if c[0] == "ties")
    a, w = segment_plan(name, n_docs, b, l)
    totals = bm25.segment_totals_ref(torch.from_numpy(a), torch.from_numpy(w), n_docs)[0]
    wv, wd, _ = bm25.segment_winners_ref(torch.from_numpy(a), torch.from_numpy(w), n_docs)
    nb = -(-l // block_l)
    cols = torch.nn.functional.pad(totals, (0, nb * block_l - l), value=-3.0e38)
    cols = cols.view(b, nb, block_l)
    ids = torch.nn.functional.pad(torch.from_numpy(a), (0, nb * block_l - l), value=n_docs)
    ids = ids.view(b, nb, block_l)
    live = wv > -1e38
    tied = (cols == wv[:, None, :]) & live[:, None, :]    # (b, blocks, bucket)
    assert int((tied.sum(1) >= 3).sum()) > 100
    first = tied.int().argmax(1)                          # earliest tied block
    assert torch.equal(torch.gather(ids, 1, first[:, None, :])[:, 0][live], wd[live])


@pytest.mark.parametrize("seed", range(3))
def test_winner_key_orders_value_then_earlier_block(seed):
    """Sorting by key is sorting by total, then by the earlier block: +0
    totals, totals below 0 and ties among them; every key is above 0 and
    gives its total back."""
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.choice(np.float32([0.0, 1.0, 2.0, -2.0 ** -23]), 200),
                           (rng.standard_normal(200) * 10.0 ** rng.uniform(-8, 4, 200))
                           .astype(np.float32)]).astype(np.float32)
    blocks = rng.integers(0, 2 ** 31 - 1, vals.size)
    blocks[:50] = rng.integers(0, 4, 50)
    keys = winner_key(vals, blocks)
    assert (keys > 0).all()
    np.testing.assert_array_equal(key_value(keys), vals)
    by_key = np.argsort(keys, kind="stable")
    by_value = np.lexsort((-blocks, vals))
    np.testing.assert_array_equal(keys[by_key], keys[by_value])
    # the winner the reference keeps: the largest total, the earliest block
    top = vals.max()
    assert keys.max() == winner_key(top, blocks[vals == top].min())


@pytest.mark.parametrize("b,l,block_l,groups", [
    (512, 32768, 1024, 4),                # the unbucketed plan
    (128, 8192, 1024, 1),
    (64, 32768, 1024, 4),
    (9, 700, 128, 1),
    (3, 20000, 1000, 3),
    (2, 1, 1024, 1),
    (1, 25 * 1024, 1024, 4),
])
def test_segment_winners_scratch(b, l, block_l, groups):
    """The winners kernel's scratch: the totals words (summaries, carries,
    counter, row max), a count per row, a key per bucket, then an id table
    per group of 8 blocks."""
    plan = bm25.segment_tile_plan(b, l, block_l)
    assert plan.groups == groups == -(-plan.blocks // 8)
    assert plan.keys_word == plan.scratch_words + -(-b // 2)
    assert plan.ids_word == plan.keys_word + b * plan.bl
    assert 2 * (plan.winners_words - plan.ids_word) >= b * groups * plan.bl
    assert 2 * (plan.winners_words - plan.ids_word) <= b * groups * plan.bl + 1
