"""The staged window-winners kernel's walk, on the CPU.

csrc/window_winners.cu runs only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold it there). Here a torch emulation repeats its walk: a
CTA per row and bucket range (window_plan), each block's stage read from
the plan's flat storage through the layout's strides (_window_layout, both
layouts in place) with a left halo of 32 positions (an id that is no doc
before position 0, the pad id from the positions held on), the taps read
from the stage in the order j = 2..max_seg up to the first other doc,
winners by strict '>' in block order, the row max. It must equal
window_winners_ref (ids and values bit for bit) on WINDOW_CASES in both
layouts, at max_seg 1 and 32, with ranges that cut rows and blocks at
edges the halo crosses. window_plan itself is tested as well.
"""
import numpy as np
import pytest
import torch

from anorag_tpu_torch.ops import bm25
from anorag_tpu_torch.testing import WINDOW_CASES, sorted_plan

HALO = 32                  # the kernel's left halo: max_seg taps back


def staged_walk(doc_rows, weight_rows, n_docs, max_seg, b_valid=None,
                range_=None, n_sm=132):
    """The kernel's walk; range_ forces the bucket range (else window_plan's)."""
    rows, sb, sj, held, n_pos, bl = bm25._window_layout(doc_rows, b_valid)
    plan = bm25.window_plan(rows, bl, n_sm)
    rng_ = range_ or plan.range
    splits = -(-bl // rng_)
    flat_a = doc_rows.reshape(-1)
    flat_w = weight_rows.reshape(-1)
    nj = -(-n_pos // bl)
    wv = torch.full((rows, bl), bm25.NEG_INF, dtype=torch.float32)
    wd = torch.full((rows, bl), -1, dtype=torch.int32)
    mx = torch.zeros((rows, 1), dtype=torch.float32)
    for r in range(rows):
        for sp in range(splits):
            c0 = sp * rng_
            cr = min(rng_, bl - c0)
            for j in range(nj):
                t0 = j * bl + c0
                t = torch.arange(t0 - HALO, t0 + rng_)
                inside = (t >= 0) & (t < held)
                tc = t.clamp(0, held - 1)
                off = r * sb + (tc // bl) * sj + tc % bl
                ids = torch.where(inside, flat_a[off],
                                  torch.where(t < 0, -7, n_docs).to(torch.int32))
                ws = torch.where(inside, flat_w[off], 0.0)
                for c in range(cr):
                    q = HALO + c
                    pos = t0 + c
                    prev, cur = int(ids[q - 1]), int(ids[q])
                    if pos >= n_pos or cur == prev or not 0 <= prev < n_docs:
                        continue
                    s = ws[q - 1]
                    for tap in range(2, max_seg + 1):
                        if int(ids[q - tap]) != prev:
                            break
                        s = s + ws[q - tap]
                    if s > wv[r, c0 + c]:
                        wv[r, c0 + c], wd[r, c0 + c] = s, prev
                    mx[r] = torch.maximum(mx[r], s)
    return wv, wd, mx


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _case(case, max_seg=None):
    n_docs, b, l, ms = case
    ms = max_seg or ms
    a, w = sorted_plan(np.random.default_rng(l), n_docs, b, l, ms)
    return n_docs, b, ms, a, w


CASE_IDS = ["n{}-b{}-l{}-s{}".format(*c) for c in WINDOW_CASES]


@pytest.mark.parametrize("case", WINDOW_CASES, ids=CASE_IDS)
@pytest.mark.parametrize("layout", ["rows", "tiled"])
def test_staged_walk_matches_ref(case, layout):
    n_docs, b, ms, a, w = _case(case)
    if layout == "tiled":
        a3, w3 = bm25.plan_tiles(a, w, n_docs)
        args = (torch.from_numpy(a3), torch.from_numpy(w3), n_docs, ms, b)
    else:
        args = (torch.from_numpy(a), torch.from_numpy(w), n_docs, ms, None)
    _equal(staged_walk(*args), bm25.window_winners_ref(*args))


@pytest.mark.parametrize("max_seg", [1, 32])
@pytest.mark.parametrize("range_", [4, 36, 128, 1024])
@pytest.mark.parametrize("layout", ["rows", "tiled"])
def test_staged_walk_at_max_seg_and_range_edges(max_seg, range_, layout):
    """Ranges of 4 and 36 buckets put a range edge, and so a halo, inside
    segments; max_seg 32 takes the whole halo."""
    n_docs, b, ms, a, w = _case((3000, 3, 2311, 32), max_seg)
    if layout == "tiled":
        a3, w3 = bm25.plan_tiles(a, w, n_docs, block_l=256)
        args = (torch.from_numpy(a3), torch.from_numpy(w3), n_docs, ms, b)
    else:
        args = (torch.from_numpy(a), torch.from_numpy(w), n_docs, ms, None)
    _equal(staged_walk(*args, range_=min(range_, 1024)), bm25.window_winners_ref(*args))


def test_staged_walk_on_short_rows_and_the_pad_column():
    """L < bl (bl 256 for L 7 and 113): the virtual pad column at t = L
    ends the last segment; t = 0 is never a start."""
    for case in WINDOW_CASES[:2]:
        n_docs, b, ms, a, w = _case(case)
        args = (torch.from_numpy(a), torch.from_numpy(w), n_docs, ms, None)
        got = staged_walk(*args, range_=128)
        _equal(got, bm25.window_winners_ref(*args))
        assert got[0].shape[1] == 256


@pytest.mark.parametrize("rows,bl,n_sm,want", [
    (512, 1024, 132, (1024, 1)),          # the served plan: whole rows
    (256, 1024, 132, (512, 2)),
    (128, 1024, 132, (344, 3)),
    (1, 256, 132, (128, 2)),
    (3, 1021, 132, (148, 7)),
    (2, 7, 132, (8, 1)),
    (64, 640, 132, (128, 5)),
])
def test_window_plan(rows, bl, n_sm, want):
    """Ranges a multiple of 4 (16-byte stages), at most 1024 (256 threads,
    4 stages of (32 + range) ids and weights: 33,792 bytes, under the 48 KB
    a launch takes without opting in), covering bl with no empty split."""
    plan = bm25.window_plan(rows, bl, n_sm)
    assert (plan.range, plan.splits) == want
    assert plan.range % 4 == 0 and plan.range <= 1024
    assert plan.range * plan.splits >= bl > plan.range * (plan.splits - 1)


def test_window_layout_reads_both_layouts_in_place():
    a = np.arange(2 * 300, dtype=np.int32).reshape(2, 300)
    w = a.astype(np.float32)
    assert bm25._window_layout(torch.from_numpy(a), None) == (2, 300, 300, 300, 301, 300)
    a3, _ = bm25.plan_tiles(a, w, 10_000, block_l=128)
    nj, bp, bl = a3.shape
    rows, sb, sj, held, n_pos, blk = bm25._window_layout(torch.from_numpy(a3), 2)
    assert (rows, sb, sj, held, n_pos, blk) == (2, 128, bp * 128, nj * 128, nj * 128, 128)
    flat = a3.reshape(-1)
    for r in range(2):
        t = np.arange(300)
        np.testing.assert_array_equal(flat[r * sb + (t // bl) * sj + t % bl], a[r])


def test_window_layout_rejects_b_valid_past_the_tiled_plan():
    """The kernel reads the tiled plan in place: b_valid past its padded
    rows would read past it."""
    a = np.zeros((2, 300), np.int32)
    a3, _ = bm25.plan_tiles(a, a.astype(np.float32), 10, block_l=128)
    with pytest.raises(ValueError):
        bm25._window_layout(torch.from_numpy(a3), a3.shape[1] + 1)
