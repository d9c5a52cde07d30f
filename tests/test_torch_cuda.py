"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests skip without a GPU. The card's machine has no JAX, so
this file imports none and runs without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from anorag_tpu_torch.ops import bm25, ivf, topk
from anorag_tpu_torch.testing import (ALL_IVF_CASES, BUCKET_CASES,
                                      SEGMENT_CASES, TOPK_CASES, TOPK_TIE_CASES,
                                      WINDOW_CASES, check_bucket_winners,
                                      check_topk, clustered_corpus,
                                      copy_across_splits, flat_scores,
                                      ivf_case, ivf_scores, rounding_plan,
                                      segment_plan, sorted_plan, tie_rows,
                                      topk_case_tiles, topk_seed_choices,
                                      unit_rows)

DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["rows", "tiled"])
def test_window_winners_kernel_matches_ref(cuda_device, layout):
    for n_docs, b, l, max_seg in WINDOW_CASES:
        a, w = sorted_plan(np.random.default_rng(l), n_docs, b, l, max_seg)
        if layout == "tiled":
            a, w = bm25.plan_tiles(a, w, n_docs)
        at = torch.from_numpy(a).to(cuda_device)
        wt = torch.from_numpy(w).to(cuda_device)
        before = bm25.window_winners.launches
        got = bm25.window_winners(at, wt, n_docs, max_seg, b_valid=b)
        assert bm25.window_winners.launches == before + 1
        want = bm25.window_winners_ref(at, wt, n_docs, max_seg, b_valid=b)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]), (n_docs, b, l, max_seg)
        torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=0)
        torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_window_winners_rejects_what_the_kernel_does_not_take(cuda_device):
    a = torch.zeros((2, 300), dtype=torch.int32, device=cuda_device)
    w = torch.zeros((2, 300), device=cuda_device)
    with pytest.raises(TypeError):
        bm25.window_winners(a.long(), w, 10, 8)
    with pytest.raises(ValueError):
        bm25.window_winners(a.t().contiguous().t(), w.t().contiguous().t(), 10, 8)
    with pytest.raises(ValueError):
        bm25.window_winners(a, w.cpu(), 10, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["totals", "winners"])
def test_segment_kernels_match_ref_exactly(cuda_device, kind):
    """The segment kernels add in the plain version's log-step order, so
    every value, id and row max must be equal, not just close."""
    kernel = bm25.segment_totals if kind == "totals" else bm25.segment_winners
    ref = bm25.segment_totals_ref if kind == "totals" else bm25.segment_winners_ref
    for name, n_docs, b, l, block_l in SEGMENT_CASES:
        a, w = segment_plan(name, n_docs, b, l)
        at = torch.from_numpy(a).to(cuda_device)
        wt = torch.from_numpy(w).to(cuda_device)
        before = kernel.launches
        got = kernel(at, wt, n_docs, block_l=block_l)
        assert kernel.launches == before + 1
        want = ref(at, wt, n_docs, block_l=block_l)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert torch.equal(x, y), (kind, name, b, l, block_l)


@pytest.mark.cuda
def test_segment_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    a = torch.zeros((2, 300), dtype=torch.int32, device=cuda_device)
    w = torch.zeros((2, 300), device=cuda_device)
    for fn in (bm25.segment_totals, bm25.segment_winners):
        with pytest.raises(TypeError):
            fn(a.long(), w, 10)
        with pytest.raises(TypeError):
            fn(a, w.double(), 10)
        with pytest.raises(ValueError):
            fn(a.t().contiguous().t(), w.t().contiguous().t(), 10)
        with pytest.raises(ValueError):
            fn(a, w.cpu(), 10)
        with pytest.raises(ValueError):
            fn(a, w[:, :200], 10)
        with pytest.raises(ValueError):
            fn(a, w, 10, block_l=2048)


@pytest.mark.cuda
def test_segment_routes_on_the_card_launch_the_kernels(cuda_device):
    n_docs, b, l = 4000, 8, 4096
    a, w = segment_plan("bench", n_docs, b, l)
    at, wt = torch.from_numpy(a).to(cuda_device), torch.from_numpy(w).to(cuda_device)
    before = bm25.segment_totals.launches
    got = bm25.sparse_topm_from_sorted(at, wt, 16, n_docs)          # auto
    assert bm25.segment_totals.launches == before + 1
    want = bm25.sparse_topm_from_sorted(at.cpu(), wt.cpu(), 16, n_docs, impl="kernel")
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)
    before = bm25.segment_winners.launches
    got = bm25.sparse_topm_winners(at, wt, 16, n_docs, max_seg=0)
    assert bm25.segment_winners.launches == before + 1
    want = bm25.sparse_topm_winners(at.cpu(), wt.cpu(), 16, n_docs, max_seg=0)
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)


def _bucket_plan(rng, b, l, n_docs):
    """A bucket-like sorted plan on the CPU: row 0 empty, row 1 one doc
    across every tile, the rest sorted ids over about 80% of the width with
    weights spanning six decades."""
    a = np.sort(rng.integers(0, n_docs, (b, l)), axis=1).astype(np.int32)
    a[:, int(l * 0.8):] = n_docs
    a[0] = n_docs
    a[1, :l - 5] = 7
    a[1, l - 5:] = n_docs
    w = np.where(a < n_docs, 10.0 ** rng.uniform(-3, 3, (b, l)), 0.0).astype(np.float32)
    return a, w


@pytest.mark.cuda
@pytest.mark.parametrize("b,l", [(128, 8192), (128, 16384), (128, 32768), (9, 3075)])
def test_segment_totals_row_tiles_at_bucket_shapes(cuda_device, b, l):
    """The row tiles at the bucketed query's shapes (and an L that is not a
    multiple of 4: scalar loads), on rows that cross every tile and an
    empty row; the first kernel, the yardstick, gives the same."""
    a, w = _bucket_plan(np.random.default_rng(l), b, l, 200_000)
    at, wt = torch.from_numpy(a).to(cuda_device), torch.from_numpy(w).to(cuda_device)
    want = bm25.segment_totals_ref(at, wt, 200_000)
    for rep in range(3):        # tiles are handed out in another order each time
        got = bm25.segment_totals(at, wt, 200_000)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, want)), rep
    rows = bm25._launch_totals(at, wt, 200_000, 1024, "rows")
    assert all(torch.equal(x, y) for x, y in zip(rows, want))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["b1", "b64", "b512", "ties", "negative"])
def test_segment_winners_row_tiles_exact(cuda_device, case):
    """The row tiles' winners at B 1, 64 and 512 x 32,768 (rows that cross
    every group, an empty row, weights over six decades: totals below 0 and
    ties at 0), on the tie-heavy case (only the earliest block may win) and
    on a bucket won by a total below 0: values, ids and row max equal to the
    plain version, whatever order the groups finish in; the first kernel,
    the yardstick, gives the same."""
    if case.startswith("b"):
        b, n_docs, block_l = int(case[1:]), 200_000, 1024
        a, w = _bucket_plan(np.random.default_rng(b), max(b, 3), 32768, n_docs)
        a, w = a[-b:], w[-b:]          # B 1: one row of sorted ids
    elif case == "ties":
        name, n_docs, b, l, block_l = next(c for c in SEGMENT_CASES if c[0] == "ties")
        a, w = segment_plan(name, n_docs, b, l)
    else:
        a, w, n_docs, block_l = rounding_plan()
    at, wt = torch.from_numpy(a).to(cuda_device), torch.from_numpy(w).to(cuda_device)
    want = bm25.segment_winners_ref(at, wt, n_docs, block_l)
    for rep in range(3):
        got = bm25.segment_winners(at, wt, n_docs, block_l)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, want)), (case, rep)
    rows = bm25._launch_segment_winners(at, wt, n_docs, block_l, "rows")
    assert all(torch.equal(x, y) for x, y in zip(rows, want)), case


@pytest.mark.cuda
@pytest.mark.parametrize("max_seg", [1, 32])
def test_window_winners_staged_reads_the_tiled_plan_in_place(cuda_device, max_seg):
    """plan_tiles' layout read through its strides (b_valid below the
    padded rows), rows of max_seg-long segments, an empty row; the first
    kernel over the copied rows gives the same."""
    n_docs, b, l = 3000, 3, 2311
    a, w = sorted_plan(np.random.default_rng(max_seg), n_docs, b, l, max_seg)
    for block_l in (256, 1024):
        a3, w3 = (torch.from_numpy(x).to(cuda_device)
                  for x in bm25.plan_tiles(a, w, n_docs, block_l=block_l))
        got = bm25.window_winners(a3, w3, n_docs, max_seg, b_valid=b)
        want = bm25.window_winners_ref(a3, w3, n_docs, max_seg, b_valid=b)
        old = bm25._launch_winners(a3, w3, n_docs, max_seg, b, "threads")
        torch.cuda.synchronize()
        for x in (got, old):
            assert torch.equal(x[1], want[1]), block_l
            torch.testing.assert_close(x[0], want[0], rtol=1e-6, atol=0)
            torch.testing.assert_close(x[2], want[2], rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_window_winners_staged_at_the_served_shape(cuda_device):
    """(512, 32,768) at max_seg 8, whole rows a CTA; and 64 rows, where the
    rows' buckets are split in ranges."""
    for b in (512, 64):
        a, w = _bucket_plan(np.random.default_rng(b), b, 32768, 200_000)
        at, wt = torch.from_numpy(a).to(cuda_device), torch.from_numpy(w).to(cuda_device)
        got = bm25.window_winners(at, wt, 200_000, 8)
        want = bm25.window_winners_ref(at, wt, 200_000, 8)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]), b
        torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=0)
        torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_dense_topk_kernel_matches_ref(cuda_device, dtype):
    for n, d, b, k, has_bias in TOPK_CASES:
        rng = np.random.default_rng(n)
        emb = torch.from_numpy(unit_rows(rng, n, d)).to(cuda_device, dtype)
        q = torch.from_numpy(unit_rows(rng, b, d)).to(cuda_device, dtype)
        bias = (torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32))
                .to(cuda_device) if has_bias else None)
        before = topk.dense_topk_kernel.launches
        got = topk.dense_topk_kernel(emb, q, k, bias=bias, bias_weight=0.7)
        assert topk.dense_topk_kernel.launches == before + 1
        want = topk.dense_topk_ref(emb, q, k, bias=bias, bias_weight=0.7)
        torch.cuda.synchronize()
        assert got[0].shape == (b, min(k, n))
        check_topk(got, want, flat_scores(emb, q, bias, 0.7))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_dense_topk_kernel_matches_ref_at_every_tile(cuda_device, dtype):
    """Every tile the kernel takes at the case (topk_case_tiles: 16, 64 and
    128 where k and the rows allow), with and without a seed pass, at every
    odd shape."""
    for n, d, b, k, has_bias in TOPK_CASES:
        rng = np.random.default_rng(n)
        emb = torch.from_numpy(unit_rows(rng, n, d)).to(cuda_device, dtype)
        q = torch.from_numpy(unit_rows(rng, b, d)).to(cuda_device, dtype)
        bias = (torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32))
                .to(cuda_device) if has_bias else None)
        k_eff = min(k, n)
        want = topk.dense_topk_ref(emb, q, k_eff, bias=bias, bias_weight=0.7)
        for q_tile in topk_case_tiles(emb, q, k_eff):
            for seed_rows in topk_seed_choices(n, k_eff, q_tile):
                got = topk._launch_topk(emb, q, k_eff, bias, 0.7, q_tile, seed_rows)
                torch.cuda.synchronize()
                check_topk(got, want, flat_scores(emb, q, bias, 0.7))


@pytest.mark.cuda
def test_dense_topk_128_tile_takes_only_16_byte_rows(cuda_device):
    """bf16 rows of D 100 (not 16-byte multiples) never reach the 128-query
    tile: the wrapper routes a 70-query k 16 batch to the 64-query tile and
    the library refuses the 128-query tile for them."""
    rng = np.random.default_rng(5)
    emb = torch.from_numpy(unit_rows(rng, 500, 100)).to(cuda_device, torch.bfloat16)
    q = torch.from_numpy(unit_rows(rng, 70, 100)).to(cuda_device, torch.bfloat16)
    assert topk_case_tiles(emb, q, 16) == [16, 64]
    assert topk.topk_query_tile(70, 16, 0, topk.vec_ok(100, emb, q)) == 64
    check_topk(topk.dense_topk_kernel(emb, q, 16), topk.dense_topk_ref(emb, q, 16),
               flat_scores(emb, q))
    with pytest.raises(RuntimeError):
        topk._launch_topk(emb, q, 16, None, 1.0, 128, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_dense_topk_kernel_keeps_the_lowest_rows_among_ties(cuda_device, dtype):
    """Tie-heavy corpora: integer scores, exact in any summation order, so
    values and rows equal the plain version's exactly at every tile."""
    for n, d, b, k, has_bias in TOPK_TIE_CASES:
        x, qn, bs = tie_rows(np.random.default_rng(n), n, d, b, has_bias)
        emb = torch.from_numpy(x).to(cuda_device, dtype)
        q = torch.from_numpy(qn).to(cuda_device, dtype)
        bias = None if bs is None else torch.from_numpy(bs).to(cuda_device)
        want = topk.dense_topk_ref(emb, q, k, bias=bias, bias_weight=0.7)
        for q_tile in topk_case_tiles(emb, q, k):
            for seed_rows in topk_seed_choices(n, k, q_tile):
                got = topk._launch_topk(emb, q, k, bias, 0.7, q_tile, seed_rows)
                torch.cuda.synchronize()
                assert torch.equal(got[1], want[1]), (n, b, k, q_tile, seed_rows)
                assert torch.equal(got[0], want[0]), (n, b, k, q_tile, seed_rows)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_ivf_scan_kernel_matches_ref(cuda_device, dtype):
    for case in ALL_IVF_CASES:
        q, layout, rows, sel, blk, n_scan, k = ivf_case(*case)
        e = rows.to(cuda_device, dtype)
        qd = q.to(cuda_device, dtype)
        cid = layout.device_array("cluster_ids", cuda_device)
        seld = sel.to(cuda_device)
        args = (qd, e, cid, seld, blk.to(cuda_device), n_scan, k, layout.block_rows)
        want = ivf.ivf_scan_ref(*args)
        off = layout.device_array("cluster_offsets", cuda_device)
        for kw in ({"cluster_offsets": off}, {}):
            before = ivf.ivf_scan.launches
            got = ivf.ivf_scan(*args, **kw)
            assert ivf.ivf_scan.launches == before + 1
            torch.cuda.synchronize()
            check_topk(got, want, ivf_scores(e, qd, cid, seld))


@pytest.mark.cuda
def test_ivf_work_plan_kernel_matches_ref(cuda_device):
    for case in ALL_IVF_CASES:
        _, layout, _, sel, _, _, _ = ivf_case(*case)
        seld = sel.to(cuda_device)
        off = layout.device_array("cluster_offsets", cuda_device)
        for q_tile, slots, max_splits in ((16, 264, 64), (64, 7, 3), (64, 1000, 256)):
            args = (seld, off, q_tile, slots, max_splits)
            before = ivf.ivf_work_plan.launches
            got = ivf.ivf_work_plan(*args)
            assert ivf.ivf_work_plan.launches == before + 1
            want = ivf.ivf_work_plan_ref(*args)
            kept = int(want.tile_count.sum())
            assert torch.equal(got.tiles, want.tiles), case
            assert torch.equal(got.pairs[:kept], want.pairs[:kept]), case
            assert got.grid == want.grid


@pytest.mark.cuda
def test_topk_wrappers_reject_what_the_kernel_does_not_take(cuda_device):
    emb = torch.zeros((2000, 64), dtype=torch.bfloat16, device=cuda_device)
    q = torch.zeros((3, 64), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(TypeError):
        topk.dense_topk_kernel(emb.half(), q.half(), 5)
    with pytest.raises(TypeError):
        topk.dense_topk_kernel(emb, q.float(), 5)
    with pytest.raises(ValueError):
        topk.dense_topk_kernel(emb.t().contiguous().t(), q, 5)
    with pytest.raises(ValueError):
        topk.dense_topk_kernel(emb, q.cpu(), 5)
    with pytest.raises(ValueError, match="1024"):
        topk.dense_topk_kernel(emb, q, 1025)
    cid = torch.zeros(2000, dtype=torch.int32, device=cuda_device)
    sel = torch.zeros((3, 2), dtype=torch.int32, device=cuda_device)
    blk = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        ivf.ivf_scan(q, emb, cid.long(), sel, blk, 2, 5, 128)
    with pytest.raises(ValueError):
        ivf.ivf_scan(q, emb, cid, sel.t().contiguous().t(), blk, 2, 5, 128)
    with pytest.raises(ValueError):
        ivf.ivf_scan(q, emb, cid.cpu(), sel, blk, 2, 5, 128)
    with pytest.raises(ValueError, match="1024"):
        ivf.ivf_scan(q, emb, cid, sel, blk, 2, 1025, 128)
    with pytest.raises(ValueError):
        ivf.ivf_scan(q, emb, cid, sel, blk, 2, 5, 128,
                     cluster_offsets=torch.zeros(3, dtype=torch.long))


@pytest.mark.cuda
def test_ivf_search_on_the_card_always_scans_with_the_kernel(cuda_device):
    from anorag_tpu_torch.index.vector_index import VectorIndex

    rng = np.random.default_rng(11)
    x = torch.from_numpy(clustered_corpus(rng, 600, 32, 6))
    layout, sorted_emb = ivf.build_ivf(x.to(cuda_device), nlist=6, block_rows=128,
                                       dtype=torch.bfloat16)
    q = unit_rows(rng, 4, 32)
    before = ivf.ivf_scan.launches
    vals, idx = ivf.ivf_search(layout, sorted_emb, q, 10, nprobe=2)
    assert ivf.ivf_scan.launches == before + 1
    assert vals.shape == idx.shape == (4, 10) and (idx >= 0).all()
    with pytest.raises(ValueError, match="use_kernel=False"):
        ivf.ivf_search(layout, sorted_emb, q, 10, nprobe=2, use_kernel=False)
    with pytest.raises(ValueError, match="use_kernel=False"):
        VectorIndex(dimension=32, index_type="IVFFlat", use_kernel=False,
                    device=cuda_device)


@pytest.mark.cuda
def test_ivf_scan_on_the_card_asserts_on_offsets_past_the_corpus(cuda_device):
    """Offsets that would send the kernel past sorted_emb fail ivf_scan's
    device-side assertion at the next synchronisation. That leaves the
    CUDA context unusable, so the scan runs in a child process."""
    code = (
        "import torch\n"
        "from anorag_tpu_torch.ops import ivf\n"
        "from anorag_tpu_torch.testing import ALL_IVF_CASES, ivf_case\n"
        "q, layout, rows, sel, blk, n_scan, k = ivf_case(*ALL_IVF_CASES[0])\n"
        "dev = torch.device('cuda')\n"
        "off = torch.from_numpy(layout.cluster_offsets).clone()\n"
        "off[-1] = rows.shape[0] + 64\n"
        "ivf.ivf_scan(q.to(dev), rows.to(dev), layout.device_array('cluster_ids', dev),\n"
        "             sel.to(dev), blk.to(dev), n_scan, k, layout.block_rows,\n"
        "             cluster_offsets=off.to(dev))\n"
        "torch.cuda.synchronize()\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode != 0, proc.stdout
    assert "device-side assert" in proc.stderr or "cluster_offsets" in proc.stderr, \
        proc.stderr[-2000:]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_bucket_winners_kernel_matches_ref(cuda_device, dtype):
    """The kernel's (B, W) winners against bucket_winners_ref at every odd
    shape, in both corpus layouts; the transposed layout is staged
    differently by the first kernel but summed in the same order, so where
    the row layout takes that kernel too the two are exactly equal (the
    wgmma route sums in its own order and is held by check_bucket_winners,
    and exactly against a second call of its own)."""
    for n, d, b, w, tiles, k in BUCKET_CASES:
        rng = np.random.default_rng(n + d)
        emb = torch.from_numpy(unit_rows(rng, n, d)).to(cuda_device, dtype)
        q = torch.from_numpy(unit_rows(rng, b, d)).to(cuda_device, dtype)
        width, _ = topk.bucket_width(b, d, emb.element_size(), w, tiles, min(k, n))
        before = topk.bucket_winners.launches
        got = topk.bucket_winners(emb, q, n, width)
        assert topk.bucket_winners.launches == before + 1
        want = topk.bucket_winners_ref(emb, q, n, width)
        torch.cuda.synchronize()
        check_bucket_winners(got, want, emb, q)
        route = topk.bucket_route(b, n, width, topk.kernel_dtype_code(emb),
                                  topk.staging_mode(emb), topk.staging_mode(q))
        got_t = topk.bucket_winners(emb.T.contiguous(), q, n, width, transposed=True)
        got_v = topk.bucket_winners(emb.T.contiguous().T, q, n, width)
        assert all(torch.equal(x, y) for x, y in zip(got_v, got_t)), (n, d, b, w)
        if route == "mma":
            assert all(torch.equal(x, y) for x, y in zip(got_t, got)), (n, d, b, w)
        else:
            check_bucket_winners(got_t, want, emb, q)
            again = topk.bucket_winners(emb, q, n, width)
            assert all(torch.equal(x, y) for x, y in zip(again, got)), (n, d, b, w)


# (name, n, d, b, w) on the wgmma route: several splits, n not a multiple
# of W, buckets that no row reaches, one query, a batch past one query tile
# and not a multiple of it, D not a multiple of the 64-column slices, one
# split (the (query tile, column tile) pairs fill the wave)
BUCKET_WGMMA_CASES = [("splits", 20_000, 256, 64, 512), ("ragged", 6001, 128, 1, 256),
                      ("few rows", 300, 64, 3, 512), ("two q tiles", 9000, 96, 130, 128),
                      ("one split", 70_000, 128, 1200, 2048), ("deep", 4000, 1024, 512, 512)]


@pytest.mark.cuda
def test_bucket_winners_wgmma_route_matches_ref(cuda_device):
    """bucket_winners on the wgmma route (bf16, 16-byte rows, W a multiple
    of 128) against bucket_winners_ref, with the route that ran asserted
    and the split tables' merge counted where the plan has several
    splits."""
    for name, n, d, b, w in BUCKET_WGMMA_CASES:
        rng = np.random.default_rng(n + b)
        emb = torch.from_numpy(unit_rows(rng, n, d)).to(cuda_device, torch.bfloat16)
        q = torch.from_numpy(unit_rows(rng, b, d)).to(cuda_device, torch.bfloat16)
        routes = dict(topk.bucket_winners.route_launches)
        merges = topk.bucket_merge.launches
        got = topk.bucket_winners(emb, q, n, w)
        torch.cuda.synchronize()
        assert topk.bucket_winners.route_launches == dict(routes, wgmma=routes["wgmma"] + 1), name
        plan = topk.bucket_work_plan(b, w, n, topk.bucket_slots(cuda_device.index or 0))
        assert topk.bucket_merge.launches == merges + (plan.splits > 1), name
        if name in ("splits", "one split"):
            assert (plan.splits > 1) == (name == "splits"), (name, plan)
        check_bucket_winners(got, topk.bucket_winners_ref(emb, q, n, w), emb, q)
        again = topk.bucket_winners(emb, q, n, w)
        assert all(torch.equal(x, y) for x, y in zip(again, got)), name


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["wgmma", "mma"])
def test_bucket_winners_keeps_the_earliest_row_across_splits(cuda_device, route):
    """A query's own vector in one bucket of every split's first tile (and
    of tiles 0 and 1): both routes keep the earliest row, so the wgmma
    route's merge keeps the earlier split's tie; every other bucket as the
    plain version's."""
    n, d, b, w = 30_000, 128, 64, 512
    rng = np.random.default_rng(11)
    rows, qn = unit_rows(rng, n, d), unit_rows(rng, b, d)
    plan = topk.bucket_work_plan(b, w, n, topk.bucket_slots(cuda_device.index or 0))
    assert plan.splits > 1
    at = copy_across_splits(rows, qn[0], w, plan.per, 37)
    emb = torch.from_numpy(rows).to(cuda_device, torch.bfloat16)
    q = torch.from_numpy(qn).to(cuda_device, torch.bfloat16)
    got = topk._launch_bucket(emb, q, n, w, route)
    want = topk.bucket_winners_ref(emb, q, n, w)
    torch.cuda.synchronize()
    assert int(got[1][0, 37]) == at[0] == int(want[1][0, 37])
    check_bucket_winners(got, want, emb, q)


@pytest.mark.cuda
def test_bucket_merge_kernel_matches_ref(cuda_device):
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.integers(-3, 3, (6, 70, 256)).astype(np.float32))
    i = torch.from_numpy(rng.integers(0, 1 << 30, (6, 70, 256)).astype(np.int32))
    got = topk.bucket_merge(v.to(cuda_device), i.to(cuda_device))
    want = topk.bucket_merge_ref(v, i)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_bucket_wgmma_route_raises_on_what_it_does_not_take(cuda_device):
    """Forced onto operands it does not take, the wgmma route raises: it
    never runs the first kernel in its place."""
    emb = torch.zeros((300, 64), dtype=torch.bfloat16, device=cuda_device)
    q = torch.zeros((3, 64), dtype=torch.bfloat16, device=cuda_device)
    before = dict(topk.bucket_winners.route_launches)
    with pytest.raises(RuntimeError, match="wgmma"):
        topk._launch_bucket(emb, q, 300, 100, "wgmma")            # W % 128
    with pytest.raises(RuntimeError, match="wgmma"):
        topk._launch_bucket(emb[:, :60], q[:, :60], 300, 128, "wgmma")  # 120-byte rows
    assert topk.bucket_winners.route_launches == before


@pytest.mark.cuda
def test_bucket_topk_on_the_card_launches_the_kernel(cuda_device):
    rng = np.random.default_rng(5)
    emb = torch.from_numpy(unit_rows(rng, 500, 96)).to(cuda_device, torch.bfloat16)
    q = torch.from_numpy(unit_rows(rng, 7, 96)).to(cuda_device)
    before = topk.bucket_winners.launches
    got = topk.bucket_topk(emb, q, 10, w=1024)            # exact: N <= W
    assert topk.bucket_winners.launches == before + 1
    want = topk.dense_topk_ref(emb, q.to(emb.dtype), 10)
    check_topk(got, want, flat_scores(emb, q))
    plain = topk.bucket_topk(emb, q, 10, w=1024, use_xla=True)
    assert topk.bucket_winners.launches == before + 1
    check_topk(got, plain, flat_scores(emb, q))
    # a row copied W rows on: the tie stays with the earlier row
    emb32 = torch.from_numpy(unit_rows(rng, 900, 64)).to(cuda_device)
    q32 = torch.from_numpy(unit_rows(rng, 2, 64)).to(cuda_device)
    emb32[37] = q32[0]
    emb32[37 + 256] = q32[0]
    _, ids = topk.bucket_topk(emb32, q32, 5, w=256)
    assert int(ids[0, 0]) == 37 and 37 + 256 not in ids[0].tolist()


@pytest.mark.cuda
def test_bucket_winners_rejects_what_the_kernel_does_not_take(cuda_device):
    emb = torch.zeros((300, 64), dtype=torch.bfloat16, device=cuda_device)
    q = torch.zeros((3, 64), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(TypeError):
        topk.bucket_winners(emb.half(), q.half(), 300, 64)
    with pytest.raises(TypeError):
        topk.bucket_winners(emb, q.float(), 300, 64)
    with pytest.raises(ValueError):
        topk.bucket_winners(emb, q.cpu(), 300, 64)
    with pytest.raises(ValueError):
        topk.bucket_winners(emb, q.t().contiguous().t(), 300, 64)
    with pytest.raises(ValueError):
        topk.bucket_winners(emb, q, 301, 64)


@pytest.mark.cuda
def test_self_join_route_matches_ref_on_the_card(cuda_device, monkeypatch):
    """The relation extractor's device route (f32 unit rows against
    themselves, k 6, through the streaming top-k kernel in query chunks)
    against dense_topk_ref, and its relations against the numpy route's."""
    from anorag_tpu_torch.graph import relation_extractor as trel
    from anorag_tpu_torch.testing import planted_rows

    emb = planted_rows(np.random.default_rng(11), 3000, 64)
    notes = [{"note_id": f"p{i}"} for i in range(len(emb))]
    rel = trel.RelationExtractor(device=cuda_device)
    monkeypatch.setattr(trel, "SEMANTIC_QUERY_CHUNK", 1024)
    before = topk.dense_topk_kernel.launches
    vals, idx = rel._device_topk(torch.from_numpy(emb).to(cuda_device), 6)
    assert topk.dense_topk_kernel.launches == before + 3
    unit = torch.from_numpy(emb).to(cuda_device)
    unit = unit / torch.linalg.vector_norm(unit, dim=1, keepdim=True)
    want = topk.dense_topk_ref(unit, unit, 6)
    check_topk((torch.from_numpy(vals).to(cuda_device), torch.from_numpy(idx).to(cuda_device)),
               want, flat_scores(unit, unit))
    host = trel.RelationExtractor(device=cuda_device)._semantic_similarity(notes, emb)
    monkeypatch.setattr(trel.RelationExtractor, "_host_route", lambda self, n: False)
    dev = rel._semantic_similarity(notes, torch.from_numpy(emb).to(cuda_device))
    assert [(r["source"], r["target"]) for r in dev] == \
        [(r["source"], r["target"]) for r in host]
    np.testing.assert_allclose([r["similarity"] for r in dev],
                               [r["similarity"] for r in host], rtol=1e-5)
    assert (5, 70) in {(r["source"], r["target"]) for r in dev}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(4))
def test_pagerank_on_the_card_matches_the_plain_version(cuda_device, seed):
    """PageRank sums by atomics on the card: held to the CPU's plain torch
    run within rtol 1e-6; the other graph ops exactly."""
    from anorag_tpu_torch.ops import graph

    rng = np.random.default_rng(seed)
    n = 5000
    edges = [(int(rng.integers(n)), int(rng.integers(n)), float(rng.random() * 2),
              int(rng.integers(18))) for _ in range(4 * n)]
    g_card = graph.build_csr(n, edges, device=cuda_device)
    g_cpu = graph.build_csr(n, edges, device="cpu")
    t, c = g_card.tensors(), g_cpu.tensors()
    got = graph.pagerank(t["nbr"], t["nbr_w"])
    assert got.is_cuda
    torch.testing.assert_close(got.cpu(), graph.pagerank(c["nbr"], c["nbr_w"]),
                               rtol=1e-6, atol=0)
    cent = rng.random(n).astype(np.float32)
    np.testing.assert_allclose(graph.k_hop_scores(g_card, [1, 7, 99], cent),
                               graph.k_hop_scores(g_cpu, [1, 7, 99], cent), rtol=1e-6)
    np.testing.assert_array_equal(graph.connected_components(g_card),
                                  graph.connected_components(g_cpu))
