"""The streaming top-k kernel's work plan, tile rule and selection, on the
CPU (csrc/streaming_topk.cu runs only on the card; tests/test_torch_cuda.py
holds it there).

topk_work_plan's units cover every (query, row) pair exactly once, in one
wave where the card's slots allow; topk_tiles gives the tiles the kernel
takes and topk_query_tile follows the crossing measured on the card; and an
emulation of the kernel's selection (a threshold per query from the tail of
its running list, candidate buffers of the tile's size filled in any order,
survivors that wait for a merge, the sorted merge along diagonals, the seed
pass's bar, phase 2) gives dense_topk_ref's result exactly, on TOPK_CASES
and on the tie-heavy corpora, at every tile that takes the case.
"""
import numpy as np
import pytest
import torch

from anorag_tpu_torch.ops import topk
from anorag_tpu_torch.testing import (TOPK_CASES, TOPK_TIE_CASES, tie_rows,
                                      unit_rows)


PLAN_SHAPES = [
    # (b, n, q_tile, slots)
    (1, 200_000, 16, 264),
    (512, 200_000, 128, 132),
    (512, 200_000, 64, 132),
    (512, 200_000, 16, 264),
    (513, 257, 128, 132),
    (64, 700, 64, 7),
    (17, 129, 16, 1000),
    (3, 1, 16, 264),
    (1000, 128 * 300 + 5, 16, 50),
    (129, 128 * 7, 128, 3),
]


def unit_of(plan, u, b, n):
    """Unit u's queries [q_lo, q_hi) and rows [r_lo, r_hi), as both kernels
    decode blockIdx.x (split u // q_tiles of query tile u % q_tiles)."""
    split, tile = divmod(u, plan.q_tiles)
    q_lo = tile * plan.q_tile
    r_lo = split * plan.per * topk.TOPK_ROWS
    return (q_lo, min(q_lo + plan.q_tile, b), r_lo,
            min(r_lo + plan.per * topk.TOPK_ROWS, n))


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "b{}-n{}-qt{}-slots{}".format(*s))
def test_units_cover_every_row_once(shape):
    b, n, q_tile, slots = shape
    plan = topk.topk_work_plan(b, n, q_tile, slots)
    assert plan.q_tile == q_tile and plan.q_tiles == -(-b // q_tile)
    assert 1 <= plan.splits <= topk.MAX_SPLITS
    assert plan.splits == 1 or plan.units <= slots       # one wave
    cover = np.zeros((b, n + 1), np.int64)                # row-difference array
    for u in range(plan.units):
        q_lo, q_hi, r_lo, r_hi = unit_of(plan, u, b, n)
        assert 0 <= q_lo < q_hi <= b and 0 <= r_lo < r_hi <= n    # none empty
        assert r_lo % topk.TOPK_ROWS == 0
        cover[q_lo:q_hi, r_lo] += 1
        cover[q_lo:q_hi, r_hi] -= 1
    assert (np.cumsum(cover, axis=1)[:, :n] == 1).all()
    # the tiles of one range run side by side
    first = [unit_of(plan, u, b, n)[2] for u in range(plan.units)]
    assert first == sorted(first)


TILES = [
    # (code, k, vec, tiles): csrc bad_tile's rule
    (0, 1, 1, [16, 64, 128]),
    (0, 32, 1, [16, 64, 128]),
    (0, 32, 0, [16, 64]),          # the wgmma route's TMA needs 16-byte rows
    (0, 33, 1, [16, 64]),
    (0, 128, 0, [16, 64]),
    (0, 129, 1, [16]),
    (0, 1024, 1, [16]),
    (1, 20, 1, [16]),              # f32: 16 only
    (1, 1024, 0, [16]),
]


@pytest.mark.parametrize("code,k,vec,tiles", TILES, ids=lambda v: str(v))
def test_topk_tiles(code, k, vec, tiles):
    assert topk.topk_tiles(code, k, vec) == tiles


def test_query_tile_follows_the_measured_crossing():
    # chip_smoke.py's route lines on an H100 (PERF.md): at k 20 the 16-query
    # tile led at B 32 and trailed the 128-query tile at B 48; at k 128 it
    # led at B 48 and trailed the 64-query tile at B 64
    assert topk.topk_query_tile(32, 20, 0, 1) == 16
    assert topk.topk_query_tile(48, 20, 0, 1) == 128
    assert topk.topk_query_tile(48, 128, 0, 1) == 16
    assert topk.topk_query_tile(64, 128, 0, 1) == 64
    for k, big in ((1, 128), (20, 128), (32, 128), (33, 64), (128, 64)):
        edge = topk.TOPK_BATCH_FROM[big]
        assert topk.topk_query_tile(edge - 1, k, 0, 1) == 16
        assert topk.topk_query_tile(edge, k, 0, 1) == big
        assert topk.topk_query_tile(512, k, 0, 1) == big
        assert topk.topk_query_tile(1, k, 0, 1) == 16
    # rows that are not 16-byte aligned: the 64-query tile led the 16-query
    # tile at every batch from one query, k 20 and 128
    assert topk.TOPK_UNALIGNED_FROM == 1
    for k in (1, 20, 32, 128):
        for b in (1, 16, 64, 512):
            assert topk.topk_query_tile(b, k, 0, 0) == 64
    for b in (1, 64, 512):
        assert topk.topk_query_tile(b, 129, 0, 0) == 16
        assert topk.topk_query_tile(b, 129, 0, 1) == 16      # only 16 holds k > 128
        assert topk.topk_query_tile(b, 1024, 0, 1) == 16
        assert topk.topk_query_tile(b, 20, 1, 1) == 16       # f32: 16 only


def test_seed_rows_rule():
    """The seed pass scans TOPK_SEED_PER_K * k rows, at most a sixteenth of
    the corpus, in whole sub-tiles, on the batch route only, and never fewer
    rows than k or a sub-tile."""
    per_k = topk.TOPK_SEED_PER_K
    assert topk.topk_seed_rows(200_000, 20, 128) == per_k * 20
    assert topk.topk_seed_rows(200_000, 128, 64) == 200_000 // 16 // 128 * 128
    for n, k, q_tile in ((200_000, 30, 16), (2000, 10, 128), (1000, 20, 64)):
        assert topk.topk_seed_rows(n, k, q_tile) == 0
    for n in (4096, 10_000, 200_000, 5_000_000):
        for k in (1, 20, 32, 128):
            rows = topk.topk_seed_rows(n, k, 64)
            assert rows % topk.TOPK_ROWS == 0 and rows <= n // 16
            assert rows == 0 or rows >= max(k, topk.TOPK_ROWS)


def _beats(a, b):
    """The rank rule: a filled entry before an empty one (None), then score
    descending, then row ascending (a seed bar has row 2^31 - 1: any score
    at least its own beats it)."""
    if b is None:
        return True
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _merge_path(lst, cands, k):
    """merge_list: the candidates sorted, then output entry o found by a
    binary search along its diagonal (how many list entries are among the
    first o + 1), the worse of the last taken from each side; at most k."""
    srt = sorted(cands, key=lambda e: (-e[0], e[1]))
    n, nf = len(srt), len(lst)
    out = []
    for o in range(min(k, nf + n)):
        d = o + 1
        lo, hi = max(0, d - n), min(d, nf)
        while lo < hi:
            mid = (lo + hi) // 2
            if _beats(lst[mid], srt[d - mid - 1]):
                lo = mid + 1
            else:
                hi = mid
        i, j = lo, d - lo
        if i == 0:
            out.append(srt[j - 1])
        elif j == 0:
            out.append(lst[i - 1])
        else:
            a, c = lst[i - 1], srt[j - 1]
            out.append(a if _beats(c, a) else c)
    return out


def _emulate_unit(scores, r_lo, r_hi, k, cand, rng, tails):
    """One unit's walk over its rows for its queries (rows of scores): per
    128-row sub-tile, the rows that beat their query's tail (in a random
    order, as the atomics take them) fill its buffer; while any wait, every
    buffer at least half full is merged, the tails refreshed (a full list's
    last entry) and the waiting rows tested again; a last merge at the end.
    tails: the seed bars, or None."""
    nq = scores.shape[0]
    lists, bufs = [[] for _ in range(nq)], [[] for _ in range(nq)]
    tails = list(tails)
    for s0 in range(r_lo, r_hi, topk.TOPK_ROWS):
        rows = np.arange(s0, min(s0 + topk.TOPK_ROWS, r_hi))
        pend = [[c for c in ((float(scores[q, r]), int(r)) for r in rng.permutation(rows))
                 if _beats(c, tails[q])] for q in range(nq)]
        while True:
            for q in range(nq):
                room = cand - len(bufs[q])
                bufs[q], pend[q] = bufs[q] + pend[q][:room], pend[q][room:]
            if not any(pend):
                break
            for q in range(nq):
                if len(bufs[q]) >= cand // 2:
                    lists[q], bufs[q] = _merge_path(lists[q], bufs[q], k), []
                    if len(lists[q]) == k:
                        tails[q] = lists[q][-1]
                pend[q] = [c for c in pend[q] if _beats(c, tails[q])]
    return [_merge_path(lists[q], bufs[q], k) for q in range(nq)]


def emulate_kernel(emb, queries, k, bias, bias_weight, q_tile, cand=64, seed_rows=0,
                   seed=0):
    """The kernel's result computed by its algorithm, on the same f32 scores
    as dense_topk_ref's (one chunk of _bias_scores); with seed_rows, after
    a seed pass over the first seed_rows rows whose k-th best score of each
    query is its first bar (any score at least that)."""
    b, n = queries.shape[0], emb.shape[0]
    q32 = queries.to(emb.dtype).float()
    scores = topk._bias_scores(q32, emb, 0, n, bias, bias_weight).numpy()
    tails = [None] * b
    if seed_rows:
        sv, _ = emulate_kernel(emb[:seed_rows], queries, k, None if bias is None
                               else bias[:, :seed_rows], bias_weight, q_tile, cand)
        tails = [(float(v), 2**31 - 1) for v in sv[:, k - 1]]
    plan = topk.topk_work_plan(b, n, q_tile, slots=7)
    rng = np.random.default_rng(seed)
    parts = [[] for _ in range(b)]
    for u in range(plan.units):
        q_lo, q_hi, r_lo, r_hi = unit_of(plan, u, b, n)
        for qi, got in zip(range(q_lo, q_hi),
                           _emulate_unit(scores[q_lo:q_hi], r_lo, r_hi, k, cand, rng,
                                         tails[q_lo:q_hi])):
            parts[qi] += got
    vals = torch.full((b, k), topk.NEG_INF)
    ids = torch.full((b, k), -1, dtype=torch.int32)
    for qi, entries in enumerate(parts):             # phase 2
        best = sorted(entries, key=lambda e: (-e[0], e[1]))[:k]
        vals[qi, :len(best)] = torch.tensor([e[0] for e in best])
        ids[qi, :len(best)] = torch.tensor([e[1] for e in best], dtype=torch.int32)
    return vals, ids


def _tiles(case, k):
    """The tiles the kernel takes for the case's bf16 rows at k: 16-byte
    rows where D is a multiple of 8."""
    return topk.topk_tiles(0, k, int(case[1] % 8 == 0))


def _case_inputs(case, ties):
    n, d, b, k, has_bias = case
    rng = np.random.default_rng(n)
    if ties:
        x, q, bs = tie_rows(rng, n, d, b, has_bias)
    else:
        x, q = unit_rows(rng, n, d), unit_rows(rng, b, d)
        bs = rng.standard_normal((b, n)).astype(np.float32) if has_bias else None
    return (torch.from_numpy(x), torch.from_numpy(q),
            None if bs is None else torch.from_numpy(bs), min(k, n))


# candidate slots a query of a tile: csrc kWgCand (the wgmma route's 128),
# Tile<QT>::kCand (the mma.sync tiles)
CANDS = {128: 32, 64: 128, 16: 64}

EMULATED = ([(c, False, t, CANDS[t], 0) for c in TOPK_CASES
             for t in _tiles(c, min(c[3], c[0]))]
            + [(c, True, t, cand, 0) for c in TOPK_TIE_CASES for t in _tiles(c, c[3])
               for cand in (CANDS[t], 4)]
            + [(c, ties, 128, CANDS[128], 256) for c, ties in ((TOPK_CASES[6], False),
                                                               (TOPK_TIE_CASES[0], True))])


@pytest.mark.parametrize(
    "case,ties,q_tile,cand,seed_rows", EMULATED,
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_emulated_kernel_matches_ref(case, ties, q_tile, cand, seed_rows):
    """Exactly dense_topk_ref's values and rows, ties included; the
    4-entry buffer makes survivors wait for merges in nearly every
    sub-tile; a seed pass over the first 256 rows sets each query's first
    bar."""
    emb, q, bias, k = _case_inputs(case, ties)
    want = topk.dense_topk_ref(emb, q, k, bias, 0.7)
    got = emulate_kernel(emb, q, k, bias, 0.7, q_tile, cand, seed_rows)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("case", TOPK_TIE_CASES, ids=lambda c: "n{}-d{}-b{}-k{}-bias{}".format(*c))
def test_tie_cases_tie(case):
    """The tie-heavy corpora do what they are for: more rows share the k-th
    best score than the top k holds, for most queries."""
    emb, q, bias, k = _case_inputs(case, True)
    vals, _ = topk.dense_topk_ref(emb, q, k, bias, 0.7)
    s = topk._bias_scores(q.float(), emb, 0, emb.shape[0], bias, 0.7)
    tied = (s == vals[:, -1:]).sum(dim=1)
    assert (tied > k).float().mean() > 0.5
