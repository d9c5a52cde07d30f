"""Inputs shared by the CPU parity tests and chip_smoke.py: sorted BM25
posting plans at odd shapes for the window-winners and segment-scan
kernels, corpora and queries for the top-k and bucket kernels,
check_topk and check_bucket_winners, and the multi-hop KB notes and
questions the answer stages are checked on."""
from __future__ import annotations

from typing import Tuple

import numpy as np

# (n_docs, B, L, max_seg): B = 1 and 3; L below 128, L prime, L across the
# 1024-wide winners table; every max_seg the main path can pick from
# {1, 2, 8, 32}. In a B = 3 case row 0 is empty and row 1 is full.
WINDOW_CASES = (
    (17, 1, 7, 1),
    (257, 3, 113, 2),
    (100, 3, 640, 8),
    (1000, 1, 1021, 8),
    (300, 3, 2311, 32),
)


def sorted_plan(rng: np.random.Generator, n_docs: int, b: int, l: int,
                max_seg: int) -> Tuple[np.ndarray, np.ndarray]:
    """(doc_rows (B, L) int32, weight_rows (B, L) f32) as gather_plan_sorted
    builds them: ids sorted per row, each doc at most max_seg times, pad id
    n_docs with weight 0, weights in [0.01, 1.01)."""
    rows = []
    for bi in range(b):
        if b > 1 and bi == 0:
            ids = np.full(l, n_docs)                          # empty row
        elif b > 1 and bi == 1:
            # full row: no pad, every segment max_seg long (the widest the
            # window covers); needs n_docs * max_seg >= L
            docs = np.sort(rng.choice(n_docs, -(-l // max_seg), replace=False))
            ids = np.repeat(docs, max_seg)
        else:
            ids = np.sort(rng.integers(0, n_docs, int(rng.integers(1, l + 1))))
            v, c = np.unique(ids, return_counts=True)
            ids = np.repeat(v, np.minimum(c, max_seg))
        ids = np.concatenate([ids, np.full(max(l - len(ids), 0), n_docs)])
        rows.append(ids[:l].astype(np.int32))
    a = np.stack(rows)
    w = np.where(a < n_docs, rng.random((b, l)).astype(np.float32) + 0.01,
                 0.0).astype(np.float32)
    return a, w


# Odd shapes for the segment-scan kernels: (kind, n_docs, B, L, block_l).
# "odd" is tests/test_ops.py:274's plan (an empty row, a one-segment row,
# L 700 not a multiple of the block) at block_l 128 and the default; "bench"
# is bench.py's segment-winners check (4,000 docs, B 8, L 4,096); "straddle"
# has a segment across the 1024-wide block edge in every row; "tiny" and
# "single" are a one-row plan of 19 and a plan one position wide; "ties"
# has row r cut into segments r + 1 long (at most 4) of weights 1.0 and
# 2.0 over four 1024-wide blocks, so exact equal totals meet in one bucket
# from every block and only the earliest block may win it.
SEGMENT_CASES = (
    ("odd", 500, 9, 700, 128),
    ("odd", 500, 9, 700, 1024),
    ("bench", 4000, 8, 4096, 1024),
    ("tiny", 29, 1, 19, 1024),
    ("single", 5, 2, 1, 1024),
    ("ties", 5000, 4, 3500, 1024),
    ("straddle", 300, 3, 2311, 1024),
)


def segment_plan(kind: str, n_docs: int, b: int, l: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(doc_rows (B, L) int32 sorted per row, pad n_docs; weight_rows (B, L)
    f32 in [0.01, 1.01) (1.0 or 2.0 for "ties"), 0 on pads) of a
    SEGMENT_CASES kind, from a seed."""
    rng = np.random.default_rng({"odd": 11, "bench": 7}.get(kind, l))
    rows = []
    for bi in range(b):
        if kind == "odd" and bi == 0:
            ids = np.full(l, n_docs)                          # empty row
        elif kind == "odd" and bi == 1:
            ids = np.concatenate([np.zeros(l - 3), np.full(3, n_docs)])
        elif kind == "ties":
            seg = min(bi + 1, 4)
            ids = np.repeat(np.arange(-(-(l - 17) // seg)), seg)[:l - 17]
        elif kind == "straddle":
            docs = np.sort(rng.choice(n_docs, n_docs // 2, replace=False))
            ids = np.repeat(docs, rng.integers(1, 41, len(docs)))
            ids = ids[:int(rng.integers(1100, l + 1))]
            ids[1000:1050] = ids[1000]                      # across 1024
        else:
            lo = l // 2 if kind == "bench" else 1
            ids = np.sort(rng.integers(0, n_docs, int(rng.integers(lo, l + 1))))
        ids = np.concatenate([ids, np.full(l - len(ids), n_docs)])
        rows.append(ids.astype(np.int32))
    a = np.stack(rows)
    if kind == "ties":
        weights = rng.integers(1, 3, (b, l)).astype(np.float32)
    else:
        weights = rng.random((b, l)).astype(np.float32) + 0.01
    w = np.where(a < n_docs, weights, 0.0).astype(np.float32)
    return a, w


def rounding_plan() -> Tuple[np.ndarray, np.ndarray, int, int]:
    """(doc_rows (1, 8), weight_rows (1, 8), n_docs, block_l 4): weights over
    nine decades, so the log-step sums round and doc 3 (weight 0) ends a few
    ulps below the end before it: bucket 3's winner is the negative total
    -2^-23 (an order of float bits that ignored the sign would rank it
    above every positive total)."""
    a = np.array([[0, 0, 0, 1, 1, 2, 2, 3]], np.int32)
    w = np.array([[0.0, 1.2915201352825534e-07, 6.938005725487528e-09,
                   0.0011496919905766845, 0.00513417599722743,
                   1.6172699588423711e-06, 1.4274293184280396, 0.0]], np.float32)
    return a, w, 10, 4


# Odd shapes for the streaming top-k kernel: (N, D, B, k, bias). k > N pads;
# D 72 and 100 are not multiples of 64 (100 also not of 8: the kernel's
# scalar loads); N 129, 257, 333 and 1021 end in a part-full 128-row
# sub-tile; B 17, 65, 70, 129 and 513 cross a 16-, 64- or 128-query tile,
# B 1 and 64 fill none or one; k 1, 16, 20, 32 (the 128-query tile's
# largest), 128 (the 64-query tile's), 129 and 1024 (the kernel's limit);
# D 100 rows are not 16-byte multiples, so the 128-query tile (the wgmma
# route) does not take them: topk_tiles leaves it out.
TOPK_CASES = (
    (7, 64, 3, 10, False),
    (300, 64, 5, 10, True),
    (1500, 72, 5, 33, False),
    (1021, 100, 9, 128, True),
    (2000, 64, 17, 1024, False),
    (129, 64, 1, 1, False),
    (1000, 72, 17, 20, True),
    (700, 100, 64, 128, False),
    (333, 64, 65, 129, True),
    (300, 64, 129, 32, False),
    (257, 72, 513, 20, True),
    (500, 100, 70, 16, False),
)

# Tie-heavy corpora for the streaming top-k kernel: (N, D, B, k, bias), rows
# from tie_rows, so whole 128-row sub-tiles tie on a query's threshold and
# far more than k rows share the best score; bias from {0, 1}. The kernel
# must keep the lowest rows among ties, as its plain version does.
TOPK_TIE_CASES = (
    (1500, 64, 70, 20, False),
    (1300, 72, 3, 129, True),
    (900, 64, 130, 32, True),
)


def topk_case_tiles(emb, queries, k: int) -> list:
    """The query tiles the streaming top-k kernel takes for these operands
    at k (ops/topk.py topk_tiles)."""
    from anorag_tpu_torch.ops import topk

    return topk.topk_tiles(topk.kernel_dtype_code(emb), k,
                           topk.vec_ok(emb.shape[1], emb, queries))


def topk_seed_choices(n: int, k: int, q_tile: int) -> list:
    """The seed passes checked at an odd shape of n rows: none, and one over
    the first 256 rows where the tile takes seed passes (the batch tiles)
    and they hold k; the odd shapes are too small for topk_seed_rows's
    rule."""
    return [0] + ([256] if q_tile > 16 and k <= 256 < n else [])


def tie_rows(rng: np.random.Generator, n: int, d: int, b: int, bias: bool):
    """(rows (N, D), queries (B, D), bias (B, N) or None), f32 with small
    integer values, so every score is an exact integer (+ 0 or 1 times the
    bias weight): each row one of 4 patterns with entries in [-2, 2], one
    in fifty its own; queries with entries in [-1, 1]."""
    patterns = rng.integers(-2, 3, (4, d))
    x = patterns[rng.integers(0, 4, n)]
    own = rng.random(n) < 0.02
    x[own] = rng.integers(-2, 3, (int(own.sum()), d))
    q = rng.integers(-1, 2, (b, d))
    bs = rng.integers(0, 2, (b, n)).astype(np.float32) if bias else None
    return x.astype(np.float32), q.astype(np.float32), bs

# Odd shapes for the IVF scan: (N, D, nlist, B, nprobe, k). k 150 over one
# probed cluster leaves slots unfilled; B 17 crosses a 16-query tile.
IVF_CASES = (
    (600, 32, 6, 4, 1, 10),
    (600, 32, 6, 4, 3, 10),
    (600, 32, 6, 4, 6, 10),
    (1000, 72, 8, 17, 1, 150),
    (1000, 100, 8, 3, 2, 30),
)

# The IVF kernel's grouped walk beyond IVF_CASES: (kind, N, D, nlist, B,
# nprobe, k). "skewed": one cluster holds 80% of the rows and most probes
# (64-query tiles, several to that cluster); "part_full": B 130 at nprobe 3,
# so 64-query tiles end part-full (D 100: bf16 rows take plain loads);
# "pads": sel rows with -2 pads, repeated clusters and an id past nlist;
# "subset": blk_ids a strict subset of select_blocks' output; "k1024": the
# kernel's largest k (16-query tiles); "one": B 1; "lists": nprobe 260 of
# nlist 300, more sorted partials than one merge level takes.
IVF_PLAN_CASES = (
    ("skewed", 4000, 64, 6, 200, 2, 20),
    ("part_full", 2000, 100, 8, 130, 3, 10),
    ("pads", 1000, 72, 8, 33, 4, 10),
    ("subset", 2000, 64, 8, 20, 3, 10),
    ("k1024", 3000, 64, 8, 5, 3, 1024),
    ("one", 2000, 64, 8, 1, 4, 30),
    ("lists", 3000, 32, 300, 4, 260, 10),
)

# every IVF case, IVF_CASES as kind "plain"
ALL_IVF_CASES = tuple(("plain", *c) for c in IVF_CASES) + IVF_PLAN_CASES


def ivf_case(kind: str, n: int, d: int, nlist: int, b: int, nprobe: int, k: int):
    """(queries (B, D) f32, layout, sorted rows (N_pad, D) f32, sel (B,
    nprobe) int32, blk_ids int32, n_scan, k) on the CPU for an
    ALL_IVF_CASES entry, from a seed; block_rows 128, k at most N."""
    import torch

    from anorag_tpu_torch.ops import ivf

    rng = np.random.default_rng(n + nprobe)
    if kind == "skewed":
        centers = rng.standard_normal((nlist, d)) * 4
        labels = np.where(rng.random(n) < 0.8, 0, rng.integers(1, nlist, n))
        x = centers[labels] + rng.standard_normal((n, d)) * 0.3
        x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
        q = x[rng.integers(0, n, b)] + 0.1 * rng.standard_normal((b, d))
        q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
        layout, rows = ivf.ivf_layout_from_assign(
            torch.from_numpy(x), centers / np.linalg.norm(centers, axis=1,
                                                          keepdims=True),
            labels, block_rows=128)
    else:
        x = clustered_corpus(rng, n, d, nlist)
        q = unit_rows(rng, b, d)
        layout, rows = ivf.build_ivf(torch.from_numpy(x), nlist=nlist,
                                     block_rows=128)
    q = torch.from_numpy(q)
    sel = ivf.ivf_probe(layout, q, nprobe)
    if kind == "pads":
        s = sel.numpy().copy()
        s[0::3, -1] = -2                        # the reference's pad
        s[1::3, 1] = s[1::3, 0]                 # a repeated cluster
        s[2::3, 0] = layout.nlist + 3           # past nlist
        sel = torch.from_numpy(s)
    blk = ivf.select_blocks(layout, sel.numpy())
    n_scan = int((blk >= 0).sum())
    if kind == "subset":
        keep = blk[:n_scan][::2].copy()
        blk = np.full_like(blk, -1)
        blk[:len(keep)] = keep
        n_scan = len(keep)
    return q, layout, rows, sel, torch.from_numpy(blk), n_scan, min(k, n)



# Bucketed top-k shapes: (N, D, B, w, tiles, k). tests/test_ops.py:380 and
# :594's cases (N <= w, exact; tiles 1 to 3; N prime; D 33, 48 and 100; B
# 1; k > N pads with -1), k > w (w doubles to 512), w 100 (not a multiple
# of the kernel's 64-column tiles) with B 70 (past one 64-query tile), and
# the width rule biting (B 512, D 1024, w 1024: W 256 in f32, 512 in bf16).
BUCKET_CASES = (
    (500, 96, 7, 1024, 1, 10),
    (6000, 128, 16, 512, 1, 10),
    (6000, 128, 16, 512, 2, 10),
    (37, 48, 1, 64, 1, 10),
    (1009, 100, 3, 256, 2, 10),
    (513, 64, 2, 1024, 1, 10),
    (130, 33, 4, 128, 3, 10),
    (5, 128, 16, 1024, 1, 10),
    (2000, 64, 5, 128, 1, 300),
    (700, 72, 70, 100, 1, 10),
    (3000, 1024, 512, 1024, 1, 100),
)


def check_bucket_winners(got, want, rows, q, atol: float = 1e-5) -> float:
    """Hold a bucket-winners table (values (B, W) f32, ids (B, W)) against
    its plain version's: values to atol; the same buckets empty (NEG_INF,
    id 0); every id in its bucket (id mod W = column); where the ids differ,
    both score the plain value to atol against rows (N, D) and queries q,
    which only a near tie allows. Returns the largest value error; raises
    AssertionError."""
    import torch

    (gv, gi), (wv, wi) = got, want
    if gv.shape != wv.shape or gi.shape != wi.shape:
        raise AssertionError(f"shapes {tuple(gv.shape)} vs {tuple(wv.shape)}")
    empty = wv < -1e38
    if not torch.equal(gv < -1e38, empty):
        raise AssertionError("empty buckets differ from the plain version")
    if not torch.equal(gi.long().where(empty, 0), torch.zeros_like(gi.long())):
        raise AssertionError("an empty bucket's id is not 0")
    err = (gv - wv).abs().where(~empty, torch.zeros_like(gv))
    max_err = float(err.max()) if err.numel() else 0.0
    if max_err > atol:
        raise AssertionError(f"values differ by {max_err:.3g} > {atol}")
    col = torch.arange(gv.shape[1], device=gi.device)
    if bool(((gi.long() % gv.shape[1] != col) & ~empty).any()):
        raise AssertionError("an id lies outside its bucket")
    r, c = torch.nonzero(gi != wi, as_tuple=True)
    if len(r):
        q32 = q.to(rows.dtype).float()[r]
        for ids in (gi[r, c], wi[r, c]):
            s = (rows[ids.long()].float() * q32).sum(-1)
            if bool(((s - wv[r, c]).abs() > atol).any()):
                raise AssertionError(f"{len(r)} ids differ outside near ties")
    return max_err


def bucket_split_tables(rows, q, n: int, w: int, plan):
    """The split tables of the bucket kernel's wgmma route by plain
    arithmetic: split s is bucket_winners_ref over corpus tiles [s per,
    (s + 1) per) of rows (N, D), its rows numbered from 0 and empty buckets
    (NEG_INF, 0). Returns ((splits, B, w) f32, (splits, B, w) int32)."""
    import torch

    from anorag_tpu_torch.ops.topk import bucket_winners_ref

    vals, ids = [], []
    for s in range(plan.splits):
        lo = s * plan.per * w
        v, i = bucket_winners_ref(rows[lo:], q, min(lo + plan.per * w, n) - lo, w)
        vals.append(v)
        ids.append(torch.where(v > -1e38, i + lo, 0))
    return torch.stack(vals), torch.stack(ids).int()


def copy_across_splits(rows: np.ndarray, row: np.ndarray, w: int, per: int,
                       col: int) -> list:
    """Write `row` into bucket col of the first two corpus tiles and of the
    first tile of every split (per tiles of w rows each), where rows has
    them: exact ties within a split and across every split boundary.
    Returns the rows written, ascending; the first must win the bucket."""
    at = sorted({col, col + w} | {col + s * per * w for s in range(len(rows) // w + 1)})
    at = [r for r in at if r < len(rows)]
    rows[at] = row
    return at


def unit_rows(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def planted_rows(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    """(N, D) f32 rows, N >= 96, scaled by 0.5-2, with planted near
    duplicates for the relation extractor's 0.7 cosine threshold: rows 41
    to 48 at cosines 0.97 down to 0.83 from row 40 (more neighbours than
    its top 6 keep, no ties), pairs (5, 70) and (71, 6) at 0.8, (12, 90)
    at 0.6 and (91, 13) at 0.62; the rest random."""
    emb = unit_rows(rng, n, d)

    def near(base, cos):
        noise = rng.standard_normal(d).astype(np.float32)
        noise -= (noise @ base) * base
        noise /= np.linalg.norm(noise)
        return np.float32(cos) * base + np.float32(np.sqrt(1 - cos ** 2)) * noise

    for j in range(41, 49):
        emb[j] = near(emb[40], 0.97 - 0.02 * (j - 41))
    for a, b, cos in ((5, 70, 0.8), (71, 6, 0.8), (12, 90, 0.6), (91, 13, 0.62)):
        emb[b] = near(emb[a], cos)
    return emb * rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)


def clustered_corpus(rng: np.random.Generator, n: int, d: int,
                     n_clusters: int) -> np.ndarray:
    """(N, D) f32 unit rows around n_clusters random centres."""
    centers = rng.standard_normal((n_clusters, d)) * 4
    x = centers[rng.integers(0, n_clusters, n)] + rng.standard_normal((n, d)) * 0.3
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def check_topk(got, want, score_of, atol: float = 1e-5) -> float:
    """Hold a top-k result (values (B, k), ids (B, k), -1 unfilled) against
    its plain version's: the same slots filled; values to atol; every id
    distinct in its row and scoring its value by score_of(ids) -> (B, k)
    to atol; ids equal wherever the gap to the neighbouring scores exceeds
    atol, and equal as sets within each group of scores closer than that,
    except the last group, which may tie with rows outside the top k.
    Returns the largest value error; raises AssertionError."""
    import torch

    (gv, gi), (wv, wi) = got, want
    gi, wi = gi.long(), wi.long()
    filled = wi >= 0
    if not torch.equal(gi >= 0, filled):
        raise AssertionError("filled slots differ from the plain version")
    err = (gv - wv).abs().where(filled, torch.zeros_like(gv))
    max_err = float(err.max()) if err.numel() else 0.0
    if max_err > atol:
        raise AssertionError(f"values differ by {max_err:.3g} > {atol}")
    rescored = score_of(gi.clamp_min(0))
    bad = ((rescored - gv).abs() > atol) & filled
    if bool(bad.any()) or bool(torch.isnan(rescored).where(filled, False).any()):
        raise AssertionError(f"{int(bad.sum())} ids do not score their value")
    srt = torch.sort(gi.where(filled, -1 - torch.arange(gi.shape[1],
                                                        device=gi.device)), dim=1)[0]
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        raise AssertionError("an id repeats within a row")
    # groups of scores closer than atol, numbered along each row
    gap = (wv[:, :-1] - wv[:, 1:]) > atol
    group = torch.nn.functional.pad(gap.long().cumsum(dim=1), (1, 0))
    last = group[:, -1:]
    keep = filled & (group != last)
    key_g = torch.sort(group * (1 << 40) + gi.where(keep, -1), dim=1)[0]
    key_w = torch.sort(group * (1 << 40) + wi.where(keep, -1), dim=1)[0]
    if not torch.equal(key_g, key_w):
        raise AssertionError("ids differ from the plain version outside ties")
    return max_err


def flat_scores(emb, q, bias=None, bias_weight: float = 1.0):
    """For check_topk: ids (B, k) -> their f32 scores against queries q in
    emb's dtype (+ bias_weight * bias), recomputed row by row."""
    q32 = q.to(emb.dtype).float()

    def score_of(ids):
        s = (emb[ids].float() * q32[:, None, :]).sum(-1)
        if bias is not None:
            s = s + bias_weight * bias.gather(1, ids)
        return s
    return score_of


def ivf_scores(sorted_emb, q, cluster_ids, sel):
    """For check_topk: sorted-corpus rows (B, k) -> their f32 scores, NaN
    where a row's cluster is not among its query's sel."""
    import torch

    q32 = q.to(sorted_emb.dtype).float()

    def score_of(pos):
        hit = (cluster_ids[pos][..., None] == sel[:, None, :]).any(-1)
        s = (sorted_emb[pos].float() * q32[:, None, :]).sum(-1)
        return torch.where(hit, s, float("nan"))
    return score_of


# The multi-hop KB of tests/test_query_processor.py (_kb_notes): Blue
# Horizon -> Aurora Lane -> Chris Reed, with head_key / rel / tail_key on
# the two chain notes. Rows: (note_id, title, content, entities,
# paragraph idx, key fields).
_KB_ROWS = (
    ("n1", "Blue Horizon (album)", "Blue Horizon is performed by Aurora Lane.",
     ("Blue Horizon", "Aurora Lane"), 0,
     {"head_key": "Blue Horizon", "rel": "performed_by", "tail_key": "Aurora Lane"}),
    ("n2", "Aurora Lane", "Aurora Lane's spouse is Chris Reed.",
     ("Aurora Lane", "Chris Reed"), 1,
     {"head_key": "Aurora Lane", "rel": "spouse_of", "tail_key": "Chris Reed"}),
    ("n3", "Aurora Lane", "Aurora Lane was born in Boston.",
     ("Aurora Lane", "Boston"), 2, {}),
    ("n4", "Silent River (film)", "Marcus Webb directed Silent River.",
     ("Marcus Webb", "Silent River"), 3, {}),
    ("n5", "Nexus Labs", "David Kim founded Nexus Labs in 2010.",
     ("David Kim", "Nexus Labs"), 4, {}),
    ("n6", "Quantum Leap Institute", "Elena Cortez leads the Quantum Leap Institute.",
     ("Elena Cortez", "Quantum Leap Institute"), 5, {}),
)

# (question, answer, answer_method or None for any, predicted_answerable):
# the reference's own expectations on the KB (tests/test_query_processor.py
# test_process_batch_fast_path and test_unanswerable_gate).
KB_QUESTIONS = (
    ("Who is the spouse of the performer of Blue Horizon?", "Chris Reed",
     "answer_selector", True),
    ("Who founded Nexus Labs?", "David Kim", None, True),
    ("Who is the spouse of the performer of Ghostly Meridian?",
     "insufficient information", None, False),
)


def kb_notes(id_prefix: str = "") -> list:
    """The six KB notes as fresh dicts; note ids get `id_prefix` (so they
    cannot collide with a corpus's own ids)."""
    notes = []
    for nid, title, content, ents, pidx, extra in _KB_ROWS:
        notes.append({
            "note_id": id_prefix + nid, "doc_id": f"doc_{pidx}", "title": title,
            "content": content, "text": content, "raw_span": content,
            "entities": list(ents), "paragraph_idxs": [pidx], **extra,
        })
    return notes
