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
    """PageRank on the card against the CPU's plain torch run within rtol
    1e-6 (the card's and the CPU's sums may round apart); the other graph
    ops exactly."""
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


@pytest.mark.cuda
def test_pagerank_on_the_card_is_bit_stable(cuda_device):
    """Each target's in-edges are summed in a fixed order: two runs give
    the same bits."""
    from anorag_tpu_torch.ops import graph

    rng = np.random.default_rng(11)
    n = 20000
    edges = [(int(rng.integers(n)), int(rng.integers(n)), float(rng.random() * 2),
              int(rng.integers(18))) for _ in range(8 * n)]
    t = graph.build_csr(n, edges, device=cuda_device).tensors()
    first = graph.pagerank(t["nbr"], t["nbr_w"])
    for _ in range(3):
        assert torch.equal(graph.pagerank(t["nbr"], t["nbr_w"]), first)


@pytest.mark.cuda
def test_kmeans_fit_on_the_card_is_bit_stable(cuda_device):
    """Two fits of 100,000 x 1024 rows at nlist 64 give the same centroids
    and labels, bit for bit, and the fixed-order sums are within the f32
    bound of a sum of the exact ones."""
    from anorag_tpu_torch.ops.kmeans import cluster_sums, kmeans_fit

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    centres = torch.randn((64, 1024), generator=gen, device=cuda_device)
    label = torch.randint(0, 64, (100_000,), generator=gen, device=cuda_device)
    x = centres[label] + 0.5 * torch.randn((100_000, 1024), generator=gen,
                                           device=cuda_device)
    c1, a1 = kmeans_fit(x, 64)
    c2, a2 = kmeans_fit(x, 64)
    assert c1.is_cuda and torch.equal(c1, c2) and torch.equal(a1, a2)
    sums, counts = cluster_sums(x, label, 64)
    assert torch.equal(counts, torch.bincount(label, minlength=64))
    # within (n - 1) u sum|x| of the exact sum (u = 2^-24)
    exact = torch.zeros(sums.shape, dtype=torch.float64, device=cuda_device)
    exact.index_add_(0, label, x.double())
    bound = torch.zeros_like(exact).index_add_(0, label, x.abs().double())
    assert bool(((sums.double() - exact).abs() <= bound * counts[:, None] * 2.0 ** -24).all())


@pytest.mark.cuda
def test_ivfflat_index_loaded_twice_searches_alike(cuda_device, tmp_path):
    """A saved IVFFlat index keeps its rows only, so each load clusters
    them again: two loads give the same layout and the same results."""
    from anorag_tpu_torch.index.vector_index import VectorIndex

    x = torch.from_numpy(clustered_corpus(np.random.default_rng(4), 30000, 256, 40))
    index = VectorIndex(dimension=256, index_type="IVFFlat", device=cuda_device)
    index.add(x)
    index.save(tmp_path / "ivf")
    q = x[:64] + 0.01 * torch.from_numpy(
        np.random.default_rng(5).standard_normal((64, 256)).astype(np.float32))
    loads = [VectorIndex.load(tmp_path / "ivf", device=cuda_device) for _ in range(2)]
    for idx in loads:
        idx.ivf_min_corpus = 0        # the IVF route below 5,000,000 rows
    got = [idx.search_arrays(q, 20) for idx in loads]
    a, b = (idx._layout for idx in loads)
    assert a is not None and b is not None
    np.testing.assert_array_equal(a.centroids, b.centroids)
    np.testing.assert_array_equal(a.perm, b.perm)
    assert torch.equal(loads[0]._device_emb, loads[1]._device_emb)
    np.testing.assert_array_equal(got[0][1], got[1][1])
    np.testing.assert_array_equal(got[0][0], got[1][0])


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
def test_decoder_on_the_card_matches_the_cpu(cuda_device, b):
    """The decoder LM at checkpoints/note_lm_tpu_large's shape with seeded
    weights: prefill and 64 decode steps on the card against the CPU,
    logits to atol 1e-4, greedy tokens equal (up to a near tie of the
    CPU's top two, testing.decoder_parity)."""
    from anorag_tpu_torch.models import decoder_lm as dlm
    from anorag_tpu_torch.testing import NOTE_LM_TPU_LARGE, decoder_parity

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dlm.DecoderConfig(**NOTE_LM_TPU_LARGE)
    params = dlm.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                             cuda_device)
    out = decoder_parity(params, b, steps=64, pb=256, seed=b)
    assert out["max_abs_err"] <= 1e-4 and out["steps_compared"] >= 32, out


def _blobs(n, d, centres, seed):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centres, d)).astype(np.float32) * 4
    x = c[rng.integers(0, centres, n)] + rng.normal(size=(n, d)).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))


@pytest.mark.cuda
@pytest.mark.parametrize("n,centres", [(300, 4), (6000, 6)])
def test_auto_k_on_the_card_picks_the_cpus_k(cuda_device, n, centres):
    """The elbow auto-K of the offline build (doc/clustering.py) on the
    card against the CPU on well-separated rows: the same K (the card's
    Lloyd draws its init from a CUDA generator, so only the elbow is held
    equal), and kmeans_fit at that K the same partition."""
    from anorag_tpu_torch.ops.kmeans import auto_k, kmeans_fit

    x = _blobs(n, 48, centres, seed=n)
    k = auto_k(x, max_k=12, iters=7)
    assert auto_k(x.to(cuda_device), max_k=12, iters=7) == k == centres
    _, got = kmeans_fit(x.to(cuda_device), k)
    _, want = kmeans_fit(x, k)
    pairs = set(zip(got.cpu().tolist(), want.tolist()))
    assert len(pairs) == k                  # the same clusters up to their order


@pytest.mark.cuda
@pytest.mark.parametrize("eps", [None, 0.5])
def test_density_cluster_on_the_card_matches_the_cpu(cuda_device, eps):
    from anorag_tpu_torch.doc.clustering import TopicClustering, density_cluster

    x = _blobs(800, 32, 5, seed=3)
    got, got_eps = density_cluster(x.to(cuda_device), eps=eps)
    want, want_eps = density_cluster(x, eps=eps)
    assert got_eps == pytest.approx(want_eps, abs=1e-6)
    np.testing.assert_array_equal(got, want)
    notes = [{"note_id": f"n{i}", "content": f"w{i % 9}"} for i in range(len(x))]
    card = TopicClustering(method="dbscan", device=cuda_device).cluster_notes(notes, x)
    cpu = TopicClustering(method="dbscan", device="cpu").cluster_notes(notes, x)
    assert card.pop("eps") == pytest.approx(cpu.pop("eps"), abs=1e-6)
    assert card == cpu


# ------------------------------------------ compressed and graph indexes
def _int8_case(seed, n=3000, r=40, b=37, lsh=False):
    rng = np.random.default_rng(seed)
    if lsh:
        codes = np.where(rng.random((n, r)) < 0.5, 1, -1).astype(np.int8)
        codes[100:160] = codes[7]                   # duplicate rows
        q = np.where(rng.random((b, r)) < 0.5, 1, -1).astype(np.int8)
        return codes, np.ones(n, np.float32), q, np.ones(b, np.float32)
    codes = rng.integers(-127, 128, (n, r)).astype(np.int8)
    codes[500:520] = codes[3]
    scales = rng.uniform(1e-3, 2e-3, n).astype(np.float32)
    scales[500:520] = scales[3]
    q = rng.integers(-127, 128, (b, r)).astype(np.int8)
    return codes, scales, q, rng.uniform(1e-3, 2e-3, b).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("lsh", [False, True])
@pytest.mark.parametrize("b", [1, 37])
def test_int8_scan_on_the_card_equals_the_cpu(cuda_device, lsh, b):
    """torch._int_mm's scan (ops/sq.py) on the card: values bit-equal to
    the CPU's and rows equal, on duplicate rows and LSH's integer ties
    (lower row first), across chunks, with b and r padded to what
    _int_mm takes."""
    from anorag_tpu_torch.ops.sq import int8_dot, sq_topk

    codes, scales, q, qs = (torch.from_numpy(a) for a in _int8_case(b, lsh=lsh, b=b))
    for k, chunk in ((50, 512), (3000, 1 << 18)):
        want = sq_topk(codes, scales, q, qs, k, chunk=chunk)
        got = sq_topk(*(a.to(cuda_device) for a in (codes, scales, q, qs)), k, chunk=chunk)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert torch.equal(int8_dot(q.to(cuda_device), codes.to(cuda_device)).cpu(),
                       q.int() @ codes.int().T)


@pytest.mark.cuda
def test_pq_scan_on_the_card_equals_the_cpu(cuda_device):
    """The ADC gather adds the same f32 terms in the same order on both."""
    from anorag_tpu_torch.ops.pq import pq_lut, pq_topk

    rng = np.random.default_rng(4)
    cb = torch.from_numpy(rng.standard_normal((16, 256, 4)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 256, (5000, 16)).astype(np.uint8))
    codes[900:950] = codes[2]
    q = torch.from_numpy(unit_rows(rng, 9, 64))
    want = pq_topk(codes, pq_lut(q, cb), 300, chunk=1024)
    got = pq_topk(codes.to(cuda_device), pq_lut(q.to(cuda_device), cb.to(cuda_device)),
                  300, chunk=1024)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_codebook_codes_on_the_card_are_the_plain_nearest_centroid(cuda_device):
    """The card's k-means draws another init than the CPU's, so its codes
    are held against a plain nearest-centroid (f64 distances) over its own
    codebooks: a code's distance within f32 rounding of the nearest."""
    from anorag_tpu_torch.ops.pq import encode_pq, train_pq

    x = clustered_corpus(np.random.default_rng(5), 6000, 64, 10)
    cb = train_pq(x, 8, iters=4, device=cuda_device)
    codes = encode_pq(x, cb, chunk=1000, device=cuda_device).cpu().long()
    xd, cd = torch.from_numpy(x).double().reshape(-1, 8, 8), torch.from_numpy(cb).double()
    dist = ((xd[:, :, None, :] - cd[None]) ** 2).sum(-1)            # (N, M, K)
    best = dist.min(-1).values
    got = dist.gather(2, codes[:, :, None])[..., 0]
    # |c|^2 - 2 x.c in f32 rounds to about 1e-7 of |x|^2 + |c|^2
    scale = (xd ** 2).sum(-1) + (cd ** 2).sum(-1).amax(-1)[None]
    assert bool(((got - best).abs() <= 1e-6 * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["IVFPQ", "codebook", "LSH", "HNSW"])
def test_index_types_on_the_card_search_as_their_plain_routes(cuda_device, kind, tmp_path):
    """Each index type on the card: rows and refined scores as an f64
    re-rank of its own candidates gives them; save on the card, load on
    the CPU (and back) with equal results."""
    from anorag_tpu_torch.index.vector_index import VectorIndex

    kw = {"IVFPQ": {"index_type": "IVFPQ"}, "LSH": {"index_type": "LSH"},
          "codebook": {"index_type": "IVFPQ", "pq_impl": "codebook", "pq_m": 8},
          "HNSW": {"index_type": "HNSW"}}[kind]
    rng = np.random.default_rng(6)
    x = clustered_corpus(rng, 4000, 64, 12)
    q = unit_rows(rng, 7, 64)
    index = VectorIndex(dimension=64, device=cuda_device, **kw)
    index.add(x)
    vals, ids = index.search_arrays(q, 10)
    assert ids.shape == (7, 10) and (ids >= 0).all() and np.isfinite(vals).all()
    exact = np.einsum("bkd,bd->bk", x[ids].astype(np.float64)
                      / np.linalg.norm(x[ids], axis=-1, keepdims=True), q.astype(np.float64))
    tol = 1e-2 if kind == "LSH" else 1e-5        # LSH refines against the bf16 rows
    np.testing.assert_allclose(vals, exact, atol=tol)
    index.save(tmp_path / "idx")
    back = VectorIndex.load(tmp_path / "idx", device="cpu")
    if kind == "HNSW":
        bv, bi = back.search_arrays(q, 10)
        np.testing.assert_array_equal(bi, ids)
    again = VectorIndex.load(tmp_path / "idx", device=cuda_device)
    np.testing.assert_array_equal(again.search_arrays(q, 10)[1], ids)


@pytest.mark.cuda
def test_cross_encoder_on_the_card_matches_the_cpu(cuda_device):
    from anorag_tpu_torch.models.cross_encoder import CrossEncoderReranker

    cpu = CrossEncoderReranker(seed=3, device="cpu")
    card = CrossEncoderReranker(params={k: v.to(cuda_device)
                                        for k, v in cpu.model.state_dict().items()},
                                device=cuda_device)
    texts = [f"candidate {i} about Nexus Labs and its founder" for i in range(24)]
    assert not torch.backends.cuda.matmul.allow_tf32
    np.testing.assert_allclose(card.score_pairs("who founded Nexus Labs", texts),
                               cpu.score_pairs("who founded Nexus Labs", texts), atol=1e-4)


@pytest.mark.cuda
def test_fusion_on_the_card_matches_the_cpu(cuda_device):
    from anorag_tpu_torch.ops.fusion import fuse_candidate_table

    rng = np.random.default_rng(8)
    src = {s: {f"n{i}": float(v) for i, v in zip(rng.choice(60, 30, replace=False),
                                                   np.round(rng.random(30) * 4) / 4)}
           for s in ("dense", "bm25", "graph", "path")}
    for method in ("linear", "rrf"):
        got = fuse_candidate_table(src, method, {"dense": 1.0, "bm25": 0.5, "path": 0.1},
                                   device=cuda_device)
        want = fuse_candidate_table(src, method, {"dense": 1.0, "bm25": 0.5, "path": 0.1},
                                    device="cpu")
        assert [r["note_id"] for r in got] == [r["note_id"] for r in want]
        np.testing.assert_allclose([r["final_similarity"] for r in got],
                                   [r["final_similarity"] for r in want], atol=1e-6)


@pytest.mark.cuda
def test_hf_conversion_on_the_card_matches_the_cpu(cuda_device):
    """A seeded state dict with XLMRobertaModel's names (no transformers
    on the card) converted into the port's encoder: CLS states on the
    card within 1e-4 of the CPU's (f32)."""
    import dataclasses

    from anorag_tpu_torch.models import hf_loader
    from anorag_tpu_torch.models.encoder import Encoder, EncoderConfig
    from anorag_tpu_torch.testing import hf_state_dict

    sd = hf_state_dict(torch.Generator().manual_seed(0), 1000, 128, 3, 4, 256, 130)
    cfg = EncoderConfig(vocab_size=1000, hidden_size=128, num_layers=3, num_heads=4,
                        intermediate_size=256, max_position=128, dtype=torch.float32,
                        normalize=False)
    state = hf_loader.convert_state_dict(sd, cfg)
    ids = torch.randint(3, 1000, (5, 40), generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)
    mask[2:, 30:] = 0
    host, card = Encoder(cfg, torch.device("cpu")), Encoder(cfg, cuda_device)
    host.load_state_dict(state)
    card.load_state_dict(state)
    torch.testing.assert_close(card(ids.to(cuda_device), mask.to(cuda_device)).cpu(),
                               host(ids, mask), rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "masters"])
def test_encoder_train_step_on_the_card_matches_the_cpu(cuda_device, mode):
    """One InfoNCE adamw step of a 2-layer encoder at full width (1024,
    16 heads, ffn 4096, vocab 8192, mean pooling), batch 16 x 128, on the
    card against the CPU from the same seeded weights: in f32 the loss and
    the gradients to 1e-5, f32 masters with bf16 compute within 2e-2
    (testing.encoder_step_parity)."""
    from anorag_tpu_torch.models.encoder import EncoderConfig
    from anorag_tpu_torch.testing import encoder_step_parity

    kw = ({"dtype": torch.float32} if mode == "f32"
          else {"dtype": torch.bfloat16, "param_dtype": torch.float32})
    cfg = EncoderConfig(vocab_size=8192, hidden_size=1024, num_layers=2, num_heads=16,
                        intermediate_size=4096, max_position=128, pooling="mean", **kw)
    out = encoder_step_parity(cfg, cuda_device, tol=1e-5 if mode == "f32" else 2e-2)
    assert out["loss_rel_err"] <= 2e-2 and np.isfinite(out["loss"]), out


@pytest.mark.cuda
def test_decoder_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One clipped adamw step of the decoder at checkpoints/
    note_lm_tpu_large's width, 2 layers, batch 8 x 1536, on the card
    against the CPU (f32): the loss to 1e-4, the parameters to 1e-5
    (testing.decoder_step_parity)."""
    from anorag_tpu_torch.models import decoder_lm as dlm
    from anorag_tpu_torch.testing import NOTE_LM_TPU_LARGE, decoder_step_parity

    cfg = dlm.DecoderConfig(**{**NOTE_LM_TPU_LARGE, "num_layers": 2})
    out = decoder_step_parity(cfg, cuda_device)
    assert out["loss_rel_err"] <= 1e-4, out


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 4])
def test_sharded_index_on_the_card_equals_the_unsharded(cuda_device, shards):
    """Flat rows sharded over a mesh that repeats the card: one streaming
    top-k launch a shard, the results those of the unsharded index."""
    from anorag_tpu_torch.index.vector_index import VectorIndex
    from anorag_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(shards)
    x, q = unit_rows(rng, 30_001, 256), unit_rows(rng, 96, 256)
    plain = VectorIndex(dimension=256, index_type="Flat", use_kernel=True,
                        device=cuda_device)
    sharded = VectorIndex(dimension=256, index_type="Flat", use_kernel=True,
                          device=cuda_device, mesh=make_mesh(devices=[cuda_device] * shards))
    for idx in (plain, sharded):
        idx.add(x)
    want = plain.search_arrays(q, 20)
    before = topk.dense_topk_kernel.launches
    got = sharded.search_arrays(q, 20)
    assert topk.dense_topk_kernel.launches == before + shards
    check_topk(tuple(torch.from_numpy(a).to(cuda_device) for a in got),
               tuple(torch.from_numpy(a).to(cuda_device) for a in want),
               flat_scores(plain.flat_device_emb(), plain._preprocess(q)))


@pytest.mark.cuda
def test_sharded_union_on_the_card_equals_the_cpu(cuda_device):
    """The sharded candidate union over 4 shards on the card, its sparse
    stage through the segment-totals kernel (L 4096, B 16): equal to the
    same union over the unsharded rows on the card (values to 1e-5, ids
    equal), and to the sharded union on the CPU within the BM25 routes'
    bound (segment totals within 8 u S of the chain, S the row's weight sum,
    scaled by the fusion's sparse_weight / row max)."""
    from anorag_tpu_torch.ops.topk import hybrid_fuse
    from anorag_tpu_torch.parallel.mesh import make_mesh, shard_rows
    from anorag_tpu_torch.parallel.sharded_search import make_sharded_hybrid_union_topk

    rng = np.random.default_rng(7)
    n, b = 20_000, 16
    emb, q = unit_rows(rng, n, 128), unit_rows(rng, b, 128)
    doc_rows, weight_rows = sorted_plan(rng, n, b, 4096, 8)
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        mesh = make_mesh(devices=[dev] * 4)
        shards, _ = shard_rows(mesh, emb, dtype=torch.bfloat16)
        fn = make_sharded_hybrid_union_topk(mesh, 20, n, dense_k=80, sparse_m=80)
        dr, wr = torch.from_numpy(doc_rows).to(dev), torch.from_numpy(weight_rows).to(dev)
        before = bm25.segment_totals.launches
        vals, ids = fn(shards, torch.from_numpy(q), dr, wr)
        launches = bm25.segment_totals.launches - before
        sp = bm25.sparse_topm_from_sorted(dr, wr, 80, n)
        want = hybrid_fuse(torch.cat(shards)[:n], torch.from_numpy(q).to(dev), *sp[1:], 20,
                           n_docs=n, dense_k=80)
        torch.testing.assert_close(vals, want[0], rtol=0, atol=1e-5)
        assert torch.equal(ids, want[1])
        out[dev.type] = (vals.cpu(), ids.cpu(), launches, sp[3].cpu())
    assert out["cpu"][2] == 0 and out["cuda"][2] == 1
    mx = out["cpu"][3]
    tol = 8 * 2.0**-24 * float(weight_rows.sum(1).max()) * 0.6 / float(mx[mx > 0].min())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0, atol=tol + 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)])
def test_multichip_encoder_step_on_the_card_matches_the_cpu(cuda_device, shape):
    """One InfoNCE adamw step of a ShardedEncoder (2 layers at full width,
    f32) on a mesh over the card's visible devices, taken in turn, against
    the same mesh over the CPU: the loss to rtol 1e-5 and the gradients as
    one vector to a relative norm of 1e-5 (testing.encoder_step_parity's
    f32 bounds); the parameters after the step as _adam_noise_check holds
    them, to atol 2e-5 (an element of layers.0.ffn_out came out 1.04e-05
    off on the card; Adam's first step moves each element by about lr,
    1e-4, so a step not applied or of the wrong sign fails)."""
    from anorag_tpu_torch.models import encoder as enc
    from anorag_tpu_torch.parallel.mesh import make_mesh, visible_devices
    from anorag_tpu_torch.testing import _adam_noise_check
    from anorag_tpu_torch.training.optim import adamw

    cfg = enc.EncoderConfig(vocab_size=8192, hidden_size=1024, num_layers=2, num_heads=16,
                            intermediate_size=4096, max_position=128, pooling="mean",
                            dtype=torch.float32)
    state = enc.Encoder(cfg, torch.device("cpu")).init_random(
        torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(3, 8192, (16, 64))) if "ids" in k
             else torch.ones((16, 64), dtype=torch.int32)
             for k in ("q_ids", "q_mask", "p_ids", "p_mask")}
    runs = []
    for devices in ([torch.device("cpu")] * 4, visible_devices("cuda", 4)):
        params = enc.ShardedEncoder(state, cfg, make_mesh(model_parallel=shape[1],
                                                          devices=devices))
        step = enc.make_train_step(cfg, adamw(params.parameters(), 1e-4, weight_decay=0.01))
        loss = float(step(params, None, batch)[2])
        runs.append((loss, {k: v.cpu() for k, v in params.state_dict().items()},
                     {k: v.cpu() for k, v in params.grad_dict().items()}))
    (l_h, p_h, g_h), (l_c, p_c, g_c) = runs
    assert abs(l_c - l_h) <= 1e-5 * abs(l_h)
    diff = torch.cat([(g_c[n] - g_h[n]).flatten() for n in g_h])
    assert float(diff.norm() / torch.cat([g.flatten() for g in g_h.values()]).norm()) <= 1e-5
    for name in p_h:
        _adam_noise_check(name, p_c[name], p_h[name], g_h[name], 1e-4, 2e-5)


@pytest.mark.cuda
def test_multichip_steps_on_the_card_are_bit_stable(cuda_device):
    """Two runs of a (2, 2) ShardedEncoder step (f32 masters, bf16, remat)
    and of a (2, 2) ShardedDecoder step on the card: loss and parameters
    bit-equal; the stepped decoder's logits and greedy tokens against the
    gathered DecoderParams' (testing.decoder_parity)."""
    from anorag_tpu_torch.models import decoder_lm as dlm
    from anorag_tpu_torch.models import encoder as enc
    from anorag_tpu_torch.parallel.mesh import make_mesh, visible_devices
    from anorag_tpu_torch.testing import decoder_parity, lm_batch
    from anorag_tpu_torch.training.optim import adamw, clip_by_global_norm

    mesh = make_mesh(model_parallel=2, devices=visible_devices("cuda", 4))
    cfg = enc.EncoderConfig(vocab_size=8192, hidden_size=512, num_layers=2, num_heads=8,
                            intermediate_size=2048, max_position=128, pooling="mean",
                            param_dtype=torch.float32, remat=True)
    state = enc.Encoder(cfg, cuda_device).init_random(
        torch.Generator(device=cuda_device).manual_seed(0)).state_dict()
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(3, 8192, (16, 64))) if "ids" in k
             else torch.ones((16, 64), dtype=torch.int32)
             for k in ("q_ids", "q_mask", "p_ids", "p_mask")}
    dcfg = dlm.DecoderConfig(hidden_size=128, num_layers=2, num_heads=4,
                             intermediate_size=256, max_len=256)
    dstate = dlm.init_params(dcfg, torch.Generator(device=cuda_device).manual_seed(1),
                             cuda_device).state_dict()
    ids, w = lm_batch(8, 96)
    dbatch = {"ids": torch.from_numpy(ids), "loss_mask": torch.from_numpy(w)}
    runs = []
    for _ in range(2):
        params = enc.ShardedEncoder(state, cfg, mesh)
        step = enc.make_train_step(cfg, adamw(params.parameters(), 1e-4, weight_decay=0.01))
        loss = float(step(params, None, batch)[2])
        dparams = dlm.ShardedDecoder(dstate, dcfg, mesh)
        dstep = dlm.make_train_step(dcfg, adamw(dparams.parameters(), 1e-3),
                                    clip=clip_by_global_norm(1.0))
        dloss = float(dstep(dparams, None, dbatch)[2])
        runs.append((loss, params.state_dict(), dloss, dparams))
    (l0, s0, d0, dp0), (l1, s1, d1, dp1) = runs
    assert l0 == l1 and d0 == d1
    for name in s0:
        assert torch.equal(s0[name], s1[name]), name
    for name, t in dp0.state_dict().items():
        assert torch.equal(t, dp1.state_dict()[name]), name
    par = decoder_parity(dp0, 4, steps=16, pb=64, reference=dp0.to_params())
    assert par["steps_compared"] >= 8, par
