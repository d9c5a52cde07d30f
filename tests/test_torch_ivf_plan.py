"""The IVF kernel's work plan and grouped walk, on the CPU.

csrc/ivf_scan.cu scans each probed cluster once for each tile of the
queries that probe it. Its plan (ivf_work_plan: the tiles, each tile's
splits and the units), its tile and split rules (ivf_query_tile,
ivf_max_splits) and the cluster offsets it reads are plain PyTorch, tested
here; a torch emulation of the kernel's walk (per tile and split of a
cluster's whole 64-row sub-tiles, scores masked by the scanned blocks, a
top-k into the partial slot (query, probe slot * max_splits + split), then
the merge of a query's partials) is held against ivf_scan_ref with
testing.check_topk (values to atol 1e-5, ids equal outside near ties). The
kernel itself is held against ivf_scan_ref on the card
(tests/test_torch_cuda.py, chip_smoke.py) at the same cases.
"""
import numpy as np
import pytest
import torch

from anorag_tpu.ops.ivf import build_ivf as j_build_ivf
from anorag_tpu_torch.ops import ivf
from anorag_tpu_torch.ops.topk import NEG_INF, top_k
from anorag_tpu_torch.testing import (ALL_IVF_CASES, check_topk,
                                      clustered_corpus, ivf_case, ivf_scores)

SLOTS = 264                  # two CTAs on each of an H100's 132 SMs
CASE_IDS = ["{}-n{}-d{}-nl{}-b{}-np{}-k{}".format(*c) for c in ALL_IVF_CASES]


def _kept_pairs(sel: np.ndarray, nlist: int):
    """The distinct valid (query, cluster) pairs, each at its lowest slot."""
    kept = {}
    for qi, row in enumerate(sel):
        for slot, c in enumerate(row):
            if 0 <= c < nlist and (qi, int(c)) not in kept:
                kept[(qi, int(c))] = slot
    return kept


def _check_plan(plan, sel: np.ndarray, offsets: np.ndarray, slots: int,
                max_splits: int):
    nlist = len(offsets) - 1
    b, p = sel.shape
    assert plan.max_tiles == ivf.max_plan_tiles(b, p, nlist, plan.q_tile)
    assert plan.tiles.dtype == torch.int32 and plan.tiles.shape == (5, plan.max_tiles)
    cl = plan.tile_cluster.numpy()
    start, count = plan.tile_start.numpy(), plan.tile_count.numpy()
    splits = plan.tile_splits.numpy()
    # splits: in proportion to each tile's sub-tiles, about `slots` units
    n_sub = np.where(cl >= 0, -(-(offsets[cl.clip(0) + 1] - offsets[cl.clip(0)]) // 64), 0)
    want = np.minimum(np.maximum(n_sub * slots // max(n_sub.sum(), 1), 1),
                      np.minimum(n_sub, max_splits))
    np.testing.assert_array_equal(splits, want)
    np.testing.assert_array_equal(plan.unit_end.numpy(), np.cumsum(splits))
    assert splits.sum() <= plan.grid <= slots + plan.max_tiles
    pairs = plan.pairs.numpy()
    assert sorted(pairs.tolist()) == list(range(b * p))
    seen = {}
    for t in range(plan.max_tiles):
        if cl[t] < 0:
            assert count[t] == 0
            continue
        assert 1 <= count[t] <= plan.q_tile
        for pr in pairs[start[t]:start[t] + count[t]]:
            qi, slot = divmod(int(pr), p)
            assert sel[qi, slot] == cl[t]
            assert (qi, int(cl[t])) not in seen, "a pair in two tiles"
            seen[(qi, int(cl[t]))] = slot
    assert seen == _kept_pairs(sel, nlist)
    # a cluster's tiles: all full but its last
    for c in set(cl[cl >= 0].tolist()):
        counts = sorted(count[cl == c].tolist(), reverse=True)
        assert all(x == plan.q_tile for x in counts[:-1])
    assert (cl >= 0).sum() <= plan.max_tiles


# ------------------------------------------------------------------- plan
@pytest.mark.parametrize("q_tile", [16, 64])
@pytest.mark.parametrize("case", ALL_IVF_CASES, ids=CASE_IDS)
def test_work_plan_puts_each_pair_in_one_tile(case, q_tile):
    _, layout, _, sel, _, _, _ = ivf_case(*case)
    off = torch.from_numpy(layout.cluster_offsets)
    for slots, max_splits in ((SLOTS, 64), (7, 3)):
        _check_plan(ivf.ivf_work_plan(sel, off, q_tile, slots, max_splits),
                    sel.numpy(), layout.cluster_offsets, slots, max_splits)


def test_work_plan_drops_pads_out_of_range_and_repeats():
    sel = torch.tensor([[2, -2, 2, 0], [5, 1, -1, 1], [-2, -2, -2, -2],
                        [7, 3, 3, 2]], dtype=torch.int32)
    off = torch.tensor([0, 3, 3, 10, 12, 20], dtype=torch.long)     # nlist 5
    plan = ivf.ivf_work_plan(sel, off, 16, SLOTS, 8)
    _check_plan(plan, sel.numpy(), off.numpy(), SLOTS, 8)
    kept = {(int(pr) // 4, int(pr) % 4)
            for t in range(plan.max_tiles) if plan.tile_cluster[t] >= 0
            for pr in plan.pairs[plan.tile_start[t]:plan.tile_start[t]
                                 + plan.tile_count[t]]}
    assert kept == {(0, 0), (0, 3), (1, 1), (3, 1), (3, 3)}
    # clusters in order, the empty cluster 1 probed by query 1 still a tile,
    # with no split
    real = plan.tile_cluster[plan.tile_cluster >= 0].tolist()
    assert real == [0, 1, 2, 3]
    assert plan.tile_splits[:4].tolist() == [1, 0, 1, 1]     # 1 sub-tile each


@pytest.mark.parametrize("q_tile", [16, 64])
def test_work_plan_stays_within_the_launched_bound(q_tile):
    rng = np.random.default_rng(q_tile)
    for b, p, nlist in ((1, 1, 1), (1, 4, 20), (512, 4, 20), (130, 3, 8),
                        (77, 5, 1000), (300, 20, 20), (64, 1, 1)):
        for sel in (rng.integers(-2, nlist + 2, (b, p)),          # random
                    np.zeros((b, p), np.int64),                   # one cluster
                    (np.arange(b * p) % nlist).reshape(b, p)):    # spread
            sel = torch.from_numpy(sel.astype(np.int32))
            off = torch.arange(nlist + 1, dtype=torch.long) * 700
            plan = ivf.ivf_work_plan(sel, off, q_tile, SLOTS, 16)
            _check_plan(plan, sel.numpy(), off.numpy(), SLOTS, 16)
            _, counts = np.unique([c for (_, c) in _kept_pairs(sel.numpy(), nlist)],
                                  return_counts=True)
            assert (plan.tile_cluster >= 0).sum() == (-(-counts // q_tile)).sum()


def test_work_plan_wrapper_runs_the_plain_version_on_cpu_tensors():
    _, layout, _, sel, _, _, _ = ivf_case(*ALL_IVF_CASES[5])
    off = torch.from_numpy(layout.cluster_offsets)
    got = ivf.ivf_work_plan(sel, off, 64, SLOTS, 8)
    want = ivf.ivf_work_plan_ref(sel, off, 64, SLOTS, 8)
    assert torch.equal(got.pairs, want.pairs) and torch.equal(got.tiles, want.tiles)
    assert ivf.ivf_work_plan.launches == 0
    with pytest.raises(TypeError, match="sel"):
        ivf.ivf_work_plan(sel.long(), off, 64, SLOTS, 8)
    with pytest.raises(TypeError, match="offsets"):
        ivf.ivf_work_plan(sel, off.int(), 64, SLOTS, 8)


def test_work_plan_of_an_empty_layout_has_only_surplus_tiles():
    plan = ivf.ivf_work_plan(torch.zeros((3, 2), dtype=torch.int32),
                             torch.zeros(1, dtype=torch.long), 16, SLOTS, 4)
    assert plan.max_tiles == 1 and (plan.tile_cluster == -1).all()
    assert (plan.unit_end == 0).all()


# ---------------------------------------------------------------- offsets
def _check_offsets(layout):
    off, cid = layout.cluster_offsets, layout.cluster_ids
    assert off.dtype == np.int64 and off.shape == (layout.nlist + 1,)
    for c in range(layout.nlist):
        np.testing.assert_array_equal(np.nonzero(cid == c)[0],
                                      np.arange(off[c], off[c + 1]))
    assert off[-1] == layout.n
    np.testing.assert_array_equal(
        ivf.offsets_from_cluster_ids(torch.from_numpy(cid)).numpy(),
        off[:int(cid.max()) + 2])


@pytest.mark.parametrize("case", ALL_IVF_CASES, ids=CASE_IDS)
def test_cluster_offsets_match_cluster_ids(case):
    _check_offsets(ivf_case(*case)[1])


@pytest.mark.parametrize("n,nlist,block_rows", [(600, 6, 128), (1000, 8, 256),
                                                (130, 3, 1024)])
def test_cluster_offsets_of_the_reference_layout(n, nlist, block_rows):
    x = clustered_corpus(np.random.default_rng(n), n, 32, nlist)
    j = j_build_ivf(x, nlist=nlist, block_rows=block_rows)[0]
    _check_offsets(ivf.ivf_layout_from_numpy(
        j.centroids, j.perm, j.cluster_ids, j.block_first_cluster,
        j.block_last_cluster, j.block_rows, j.n))


def test_cluster_offsets_reject_a_layout_not_sorted_by_cluster():
    for bad in ([0, 2, 1, -1], [0, -1, 1, -1], [0, 1, 5, -1]):
        with pytest.raises(ValueError, match="sorted by cluster"):
            ivf.cluster_offsets_np(np.array(bad, np.int32), 3)
    np.testing.assert_array_equal(
        ivf.cluster_offsets_np(np.array([0, 0, 2, -1, -1], np.int32), 4),
        [0, 2, 2, 3, 3])


# ------------------------------------------------------------- tile rules
def test_query_tile_and_splits_rules():
    assert ivf.ivf_query_tile(512, 4, 20, 20) == 64
    assert ivf.ivf_query_tile(512, 4, 20, 129) == 16      # k above SMALL_K
    assert ivf.ivf_query_tile(1, 4, 20, 30) == 16         # one query a cluster
    assert ivf.ivf_query_tile(8, 4, 20, 10) == 16         # 32 pairs, 20 clusters
    assert ivf.ivf_query_tile(64, 4, 20, 20) == 16        # 12.8 a cluster
    assert ivf.ivf_query_tile(80, 4, 20, 20) == 64        # 16 a cluster
    assert ivf.ivf_query_tile(96, 4, 20, 30) == 64        # 19.2 a cluster
    assert ivf.max_plan_tiles(512, 4, 20, 64) == 20 + 32
    assert ivf.ivf_max_splits(512, 4, 20) == ivf.MAX_LISTS // 4
    assert ivf.ivf_max_splits(4, 260, 10) == 1             # two merge levels
    s = ivf.ivf_max_splits(512, 4, 1024)
    assert 512 * 4 * s * 1024 * 8 <= ivf.PARTIAL_BYTES < 512 * 4 * (s + 1) * 1024 * 8
    assert ivf.ivf_max_splits(4096, 8, 1024) == 1          # over the budget: 1
    assert ivf.ivf_launch_shape(512, 4, 20, 20) == (64, 64, 256)
    assert ivf.ivf_launch_shape(1, 4, 20, 30) == (16, 64, 256)
    assert ivf.ivf_launch_shape(4, 260, 300, 10) == (16, 1, 512)


# ------------------------------------------------------------ grouped walk
def _grouped_walk(q, rows, cid, sel, blk, n_scan, k, block_rows, q_tile, slots,
                  max_splits):
    """The kernel's walk in torch: each (tile, split) unit scores its
    queries against its split of the cluster's whole 64-row sub-tiles, rows
    of unscanned blocks masked, keeps a top-k per query in partial slot
    (query, slot * max_splits + split), and each query's partials merge by
    (filled first, score descending, row ascending)."""
    offsets = ivf.offsets_from_cluster_ids(cid)
    plan = ivf.ivf_work_plan(sel, offsets, q_tile, slots, max_splits)
    b, p = sel.shape
    row_ok = ivf._scanned_rows(blk, n_scan, rows.shape[0], block_rows)
    q32 = q.to(rows.dtype).float()
    part_v = torch.full((b, p * max_splits, k), NEG_INF)
    part_i = torch.full((b, p * max_splits, k), -1, dtype=torch.long)
    for t in range(plan.max_tiles):
        c = int(plan.tile_cluster[t])
        if c < 0:
            continue
        lo0 = int(plan.tile_start[t])
        pr = plan.pairs[lo0:lo0 + int(plan.tile_count[t])].long()
        qi, slot = pr // p, pr % p
        lo, hi = int(offsets[c]), int(offsets[c + 1])
        splits = int(plan.tile_splits[t])
        per = -(-(-(-(hi - lo) // ivf.KERNEL_ROWS)) // max(splits, 1)) * ivf.KERNEL_ROWS
        for s in range(splits):
            r0, r1 = lo + s * per, min(lo + (s + 1) * per, hi)
            if r0 >= r1:
                continue
            sc = torch.matmul(q32[qi], rows[r0:r1].float().T)
            sc = torch.where(row_ok[None, r0:r1], sc, NEG_INF)
            v, i = top_k(sc, k)
            i = torch.where(v > NEG_INF / 2, i + r0, -1)
            part_v[qi, slot * max_splits + s, :v.shape[1]] = v
            part_i[qi, slot * max_splits + s, :i.shape[1]] = i
    v, i = part_v.reshape(b, -1), part_i.reshape(b, -1)
    by_row = torch.argsort(torch.where(i < 0, 1 << 40, i), dim=1, stable=True)
    v, i = v.gather(1, by_row), i.gather(1, by_row)
    by_score = torch.argsort(v, dim=1, descending=True, stable=True)[:, :k]
    v, i = v.gather(1, by_score), i.gather(1, by_score)
    return v, torch.where(v > NEG_INF / 2, i, -1).int()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("config", ["card", "other"])
@pytest.mark.parametrize("case", ALL_IVF_CASES, ids=CASE_IDS)
def test_grouped_walk_matches_ivf_scan_ref(case, config, dtype):
    """"card": the tile and splits the kernel takes on an H100 with two
    CTAs an SM; "other": the other tile size, 7 slots and 3 splits at most."""
    q, layout, rows, sel, blk, n_scan, k = ivf_case(*case)
    rows, q = rows.to(dtype), q.to(dtype)
    cid = torch.from_numpy(layout.cluster_ids)
    b, p = sel.shape
    q_tile, max_splits, _ = ivf.ivf_launch_shape(b, p, layout.nlist, k)
    slots = SLOTS
    if config == "other":
        q_tile, slots, max_splits = 80 - q_tile, 7, 3
    got = _grouped_walk(q, rows, cid, sel, blk, n_scan, k, layout.block_rows,
                        q_tile, slots, max_splits)
    args = (q, rows, cid, sel, blk, n_scan, k, layout.block_rows)
    want = ivf.ivf_scan_ref(*args)
    check_topk(got, want, ivf_scores(rows, q, cid, sel))
    # the wrapper on CPU tensors is the plain version, offsets or not
    off = torch.from_numpy(layout.cluster_offsets)
    for v, i in (ivf.ivf_scan(*args), ivf.ivf_scan(*args, cluster_offsets=off)):
        assert torch.equal(i, want[1]) and torch.equal(v, want[0])


def test_ivf_scan_ref_never_counts_pad_rows():
    q, layout, rows, sel, blk, n_scan, k = ivf_case(*ALL_IVF_CASES[0])
    cid = torch.from_numpy(layout.cluster_ids)
    assert (cid < 0).any()
    sel = torch.full_like(sel, -1)                    # the pads' cluster id
    vals, ids = ivf.ivf_scan_ref(q, rows, cid, sel, blk, n_scan, k,
                                 layout.block_rows)
    assert (ids == -1).all() and (vals == NEG_INF).all()


def test_ivf_scan_rejects_offsets_of_another_type():
    q, layout, rows, sel, blk, n_scan, k = ivf_case(*ALL_IVF_CASES[0])
    cid = torch.from_numpy(layout.cluster_ids)
    with pytest.raises(TypeError, match="cluster_offsets"):
        ivf.ivf_scan(q, rows, cid, sel, blk, n_scan, k, layout.block_rows,
                     cluster_offsets=torch.from_numpy(layout.cluster_offsets).int())


def _bad_offsets(off: torch.Tensor, n_rows: int, kind: str) -> torch.Tensor:
    if kind == "short":                    # the last cluster left out
        return off[:-1]
    if kind == "past_corpus":              # one more cluster, past the rows
        return torch.cat([off, off.new_tensor([n_rows + 64])])
    if kind == "shifted":
        return torch.cat([off[:1], off[1:-1] + 1, off[-1:]])
    if kind == "end_past_corpus":
        return torch.cat([off[:-1], off.new_tensor([n_rows + 64])])
    if kind == "decreasing":
        return torch.cat([off[:1], off[2:3], off[1:2], off[3:]])
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["short", "past_corpus", "shifted",
                                  "end_past_corpus", "decreasing"])
def test_ivf_scan_rejects_offsets_that_are_not_cluster_ids(kind):
    q, layout, rows, sel, blk, n_scan, k = ivf_case(*ALL_IVF_CASES[0])
    cid = torch.from_numpy(layout.cluster_ids)
    off = torch.from_numpy(layout.cluster_offsets)
    bad = _bad_offsets(off, rows.shape[0], kind)
    assert not torch.equal(bad, off) and bool((off[1:] > off[:-1]).all())
    with pytest.raises(RuntimeError, match="cluster_offsets"):
        ivf.ivf_scan(q, rows, cid, sel, blk, n_scan, k, layout.block_rows,
                     cluster_offsets=bad)
    # the layout's own offsets, and a trailing empty cluster, pass
    for good in (off, torch.cat([off, off[-1:]])):
        ivf._check_offsets(good, cid)


def test_offsets_check_sees_a_change_to_the_pair_it_last_checked():
    _, layout, rows, _, _, _, _ = ivf_case(*ALL_IVF_CASES[0])
    cid = torch.from_numpy(layout.cluster_ids).clone()
    off = torch.from_numpy(layout.cluster_offsets).clone()
    ivf._check_offsets(off, cid)                   # passes, and is remembered
    ivf._check_offsets(off, cid)
    off[-1] = rows.shape[0] + 64                   # in place: a new version
    with pytest.raises(RuntimeError, match="cluster_offsets"):
        ivf._check_offsets(off, cid)
    off.copy_(torch.from_numpy(layout.cluster_offsets))
    ivf._check_offsets(off, cid)
    cid[layout.n] = layout.nlist                   # the ids change instead: a
                                                   # pad becomes a cluster past them
    with pytest.raises(RuntimeError, match="cluster_offsets"):
        ivf._check_offsets(off, cid)
