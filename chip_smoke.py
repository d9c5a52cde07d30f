#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (anorag_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printing its seconds:
  1. device  -- nvidia-smi's name and power limit, torch's device name;
  2. build   -- nvcc builds the CUDA sources (window_winners,
                streaming_topk, ivf_scan, segment_scan, bucket_winners) in
                parallel (plain C interface, ctypes) and prints each
                kernel's registers and spills (-Xptxas -v);
  3. setup   -- a 200,000-note corpus drawn from a 30,000-word Zipf
                vocabulary (40 terms a note), 1024-wide unit embeddings
                and the full-width encoder (24 layers, hidden 1024, bf16),
                all from --seed, data and weights made on the card;
  4. kernels -- each kernel against its plain PyTorch version on the card,
                at the odd shapes of the CPU tests and at the main path's
                real shapes: window-winners ids equal and values to rtol
                1e-6 (the first kernel too, on the main path, timed beside the
                staged walk); the streaming top-k (512 x 200,000 x 1024 bf16 at k
                20 and 128, with a bias, 1 query at k 30) and top-k values
                to atol 1e-5, ids equal outside score ties (testing.
                check_topk), at every odd shape through both routes, on
                the tie-heavy corpora exactly equal; its two routes (16-
                and 128- or 64-query tiles) timed side by side at B 1 to
                512, k 20 and 128, and the chunked dense candidates of
                hybrid_fuse beside it at k 128; the IVF scan at every case
                of testing.ALL_IVF_CASES (skewed clusters, part-full
                tiles, pads and repeats in sel, a subset of the blocks,
                k 1024, B 1, two merge levels), with the layout's
                cluster offsets and without; the kernels' and plain
                versions' device times (CUDA events around launches back
                to back), the wrappers' host time, the bound, and
                torch.matmul + torch.topk as the library yardstick;
  5. bucket  -- the bucket-winners kernel's two routes (wgmma for bf16
                with 16-byte rows and W a multiple of 128, the first
                mma.sync / FMA kernel for the rest) against their plain
                version at the CPU tests' odd shapes (bf16 and f32, the
                (N, D) and the transposed (D, N) corpus; both routes where
                the wgmma route applies): values to atol 1e-5, ids equal
                outside near ties (testing.check_bucket_winners); then at
                the bench shape, the served 200,000 x 1024 bf16 corpus and
                512 encoder queries, k 100, w 512, tiles 1 and 2 (W 512):
                both routes checked the same way, also on a copy whose
                bucket 37 holds one tied row in every split (the earliest
                must win), the merge of the wgmma route's split tables
                exactly equal to bucket_merge_ref; each timed beside its
                bound and plain version (the merge with its tables evicted
                from L2 before each call), the routes beside the library
                chain (torch.mm with f32 output, a pad to whole tiles, max
                over the (B, N/W, W) view, torch.topk) and side by side at
                B 1 to 512; bucket_topk's recall@10 against exact f32 on
                64 queries, with the launches of both routes and the merge
                counted;
  6. segment -- the segment-totals and segment-winners kernels (row tiles)
                and their first kernels (a CTA a row) exactly equal to their
                plain versions (values, ids, row max) at the odd shapes (the
                tie-heavy case included) and at the first served batch's
                (512, 32,768) plan, their times beside the first kernels',
                plain times and bounds; segment winners' route lines, both
                kernels exact and timed on the plan's first 1, 16, 64, 128
                and 512 rows; the length-bucketed hybrid query
                (make_bucketed_plan, 4 groups, and hybrid_topk_bucketed)
                over the 4 served batches, its segment-totals launches
                counted and its results equal to the same routes over the
                unbucketed plan; segment totals exactly equal at each
                bucket shape it launched, timed there out of L2 beside the
                first kernel, the plain version and the bound;
                hybrid_topk with max_seg 0 through the segment-winners
                kernel, its sparse top-m held against the chain (row max and
                shared scores to rtol 1e-4, recall at least 0.9); the
                bucketed tiled path equal to the unbucketed tiled one;
  7. serve   -- a ServingEngine answers 4 requests of 512 queries (8
                content-band terms each); every response has
                top_k rows of valid note ids; the kernels' launch counts,
                reset just before, match the batches routed to them; one
                batch again with the plain sparse stage gives the same
                top-10 ids; latency, QPS and peak memory;
  8. breakdown -- one batch again, stage by stage (encode, host plan,
                upload, sparse, dense + fusion, finalize), synchronised;
  9. trace   -- one request through a ServingEngine under torch.profiler:
                the device's busy time and idle share, the window-winners
                kernels' own time, and the largest device kernels;
  10. search -- a VectorRetriever with use_kernel=True over the same notes
                and embeddings: search for one 512-query request at top_k
                20 and retrieve for 32 single queries at top_k 10 (fetch 30,
                the /search endpoint's traffic); the top-k kernel's
                launches, reset just before, equal the calls; latency, QPS;
                then the same traffic through the default route
                (use_kernel None: chunked matmul + exact top-k, what
                QueryProcessor's retriever takes below 5,000,000 notes),
                its scores equal to the kernel route's to 1e-5;
  11. bench  -- the port's benchmark entry point in-process
                (anorag_tpu_torch/bench.py): kernel_parity, bench_hybrid at
                200,000 docs with its recall gate (recall@10 against exact
                f32 at least 0.985) and bench_encoder, their JSON on one
                line; every kernel they reach, counted from 0, launched;
  12. ivf    -- a default VectorIndex(index_type="IVFFlat") (nlist 20,
                nprobe 4, 15 k-means rounds) over 5,000,000 x 1024 rows
                drawn on the card around 1,000 centres: build time, 4
                batches of 512 queries at top_k 20 and 64 single queries at
                top_k 30 through search_arrays (the IVF kernel's launches
                and the work plan kernel's equal the searches), one batch
                and one single query against the plain version, each with
                its work plan (tiles, splits, units, CTAs, partial bytes;
                the plan kernel equal to ivf_work_plan_ref and timed), the
                kernel's, plain version's and library yardstick's times,
                the 16- and 64-query tiles timed side by side at batches of
                1 to 512 queries (k 20 and 30), each checked against the
                plain version, recall@10 against exact search (printed, not
                gated), peak device memory and the host's peak RSS; then
                hybrid_topk over the same rows at B 64 and 512 with a
                seeded BM25 plan, which must allocate under 1 GiB above the
                resident index, its dense candidates held against the
                streaming top-k kernel.
Then one JSON line of kernel numbers, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure prints its traceback and exits
non-zero without that last line; so does a machine without CUDA.
"""
from __future__ import annotations

import argparse
import json
import resource
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 on the tensor cores
L2_FLUSH_BYTES = 256 << 20     # written between timed calls to empty the 50 MB L2
VOCAB, DOC_LEN, Q_LEN, MIN_RANK = 30_000, 40, 8, 100
N_NOTES, N_REQUESTS, BATCH = 200_000, 4, 512
N_IVF, IVF_CENTRES, IVF_BATCHES, IVF_SINGLES = 5_000_000, 1000, 4, 64
# batch sizes at which the IVF kernel's 16- and 64-query tiles are timed
IVF_TILE_BATCHES = (1, 4, 16, 32, 64, 96, 128, 192, 256, 512)
# batch sizes at which the streaming top-k kernel's two routes are timed
TOPK_ROUTE_BATCHES = (1, 4, 16, 32, 48, 64, 128, 512)
# batch sizes at which the bucket-winners kernel's two routes are timed
BUCKET_ROUTE_BATCHES = (1, 16, 32, 48, 64, 128, 512)
# batch sizes at which segment winners' row tiles and first kernel are timed
# (64: the served stream_batch)
SEGMENT_ROUTE_BATCHES = (1, 16, 64, 128, 512)
N_RETRIEVE = 32


def _phase(name: str, t0: float) -> float:
    t = time.perf_counter()
    print(f"phase {name}: {t - t0:.2f} s", flush=True)
    return t


def _zipf_doc_terms(rng, n_docs: int):
    """(N, DOC_LEN) term ranks from a Zipf vocabulary, as bench.py draws
    its corpus."""
    import numpy as np

    p = 1.0 / (1.0 + np.arange(VOCAB))
    p /= p.sum()
    return rng.choice(VOCAB, size=(n_docs, DOC_LEN), p=p)


def _query_terms(rng, b: int):
    """Query terms from the content band (rank >= 100), as bench.py draws
    them: real queries are content words, not the stopword head."""
    import numpy as np

    ranks = np.arange(MIN_RANK, VOCAB)
    p = 1.0 / (ranks + 1.0)
    p /= p.sum()
    return [rng.choice(ranks, size=Q_LEN, p=p) for _ in range(b)]


def _kernel_name(symbol: str) -> str:
    """A kernel's name from its mangled symbol, as ptxas -v names it:
    namespaces dropped, integral template arguments kept
    ('segment_winners_tiles<true>')."""
    import re

    i = 2 if symbol.startswith("_Z") else 0
    nested = symbol[i:i + 1] == "N"
    i += nested
    name = symbol
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        name, i = symbol[j:j + int(symbol[i:j])], j + int(symbol[i:j])
        if not nested:
            break
    args = re.match(r"I((?:L[a-z]n?\d+E)+)E", symbol[i:])
    if args:
        vals = re.findall(r"L([a-z])(n?\d+)E", args.group(1))
        name += "<" + ", ".join({"0": "false", "1": "true"}[v] if t == "b" else
                                v.replace("n", "-") for t, v in vals) + ">"
    return name


def _time_ms(fn, n: int = 20, reps: int = 21, warm: int = 3):
    """(device ms, host ms) per call of fn(), after `warm` calls. Device: n
    calls back to back between two CUDA events, over n, median of `reps`.
    A sleep kernel queued first holds the card until all n calls are
    enqueued, so the host path between launches opens no gaps. Host: the
    time the n calls take to enqueue, over n."""
    import torch

    def event():
        return torch.cuda.Event(enable_timing=True)

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    start, end = event(), event()
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    end.synchronize()
    hold = int(3 * n * host_ms * 1e6 / start.elapsed_time(end)) + 1
    times = []
    for _ in range(reps):
        start, end = event(), event()
        torch.cuda._sleep(hold)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    times.sort()
    return times[len(times) // 2], host_ms


def _time_cold_ms(fn, reps: int = 41, warm: int = 3) -> float:
    """Device ms of one fn() call that finds its inputs out of the L2
    cache: before each call a write of L2_FLUSH_BYTES (several times the
    card's 50 MB L2) evicts them, outside the call's CUDA events. A sleep
    kernel first holds the card while the rep is enqueued. Median of
    `reps`."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000)
        flush.zero_()
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    del flush
    return times[len(times) // 2]


def _busy_ms(events) -> float:
    """Union of the device intervals of profiler events, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e3


def _check_winners(got, want, what: str) -> float:
    """ids equal, values and row max to rtol 1e-6; returns max abs error."""
    import torch

    (wv, wd, mx), (rv, rd, rm) = got, want
    if not torch.equal(wd, rd):
        bad = int((wd != rd).sum())
        raise AssertionError(f"{what}: {bad} winner ids differ from the plain version")
    torch.testing.assert_close(wv, rv, rtol=1e-6, atol=0, msg=what)
    torch.testing.assert_close(mx, rm, rtol=1e-6, atol=0, msg=what)
    live = rv > -1e38
    err = (wv - rv).abs()[live].max() if bool(live.any()) else torch.zeros(())
    return float(max(err, (mx - rm).abs().max()))


def _topk_bound(b: int, rows: int, d: int, k: int, item: int, extra_bytes: int = 0,
                extra_ops: int = 0):
    """(bound ms, bound_by) of a top-k over `rows` corpus rows of width d
    (item bytes each, read once) for b queries: bytes read and written once
    over the memory rate, against 2*b*rows*d operations over the peak rate
    of the inputs' type (bf16 on the tensor cores, f32 outside them)."""
    moved = rows * d * item + b * d * item + b * k * 8 + extra_bytes
    ops = 2 * b * rows * d + extra_ops
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = ops / (BF16_OPS_PER_S if item == 2 else F32_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _check_plan(got, want, what: str) -> float:
    """The IVF work plan kernel's plan equal to its plain version's: the
    tiles and the kept pairs. Returns the largest absolute difference (0)."""
    kept = int(want.tile_count.sum())
    err = max(int((got.tiles - want.tiles).abs().max()) if want.max_tiles else 0,
              int((got.pairs[:kept] - want.pairs[:kept]).abs().max()) if kept else 0)
    if err or got.grid != want.grid:
        raise AssertionError(f"ivf_work_plan {what}: the kernel's plan differs "
                             f"from ivf_work_plan_ref's")
    return float(err)


def _check_topk_odd_shapes(dev):
    """The streaming top-k and IVF scan kernels against their plain
    versions at the CPU tests' odd shapes, bf16 and f32 (the IVF scan at
    both tile sizes where k allows), and the IVF work plan kernel against
    its plain version (both tile sizes); max abs
    errors and the number of plans compared."""
    import numpy as np
    import torch

    from anorag_tpu_torch.ops import ivf
    from anorag_tpu_torch.ops.topk import (_launch_topk, dense_topk_kernel,
                                           dense_topk_ref)
    from anorag_tpu_torch.testing import (ALL_IVF_CASES, TOPK_CASES,
                                          TOPK_TIE_CASES, check_topk,
                                          flat_scores, ivf_case, ivf_scores,
                                          tie_rows, topk_case_tiles,
                                          topk_seed_choices, unit_rows)

    dense, scan, plans = [], [], 0
    for dtype in (torch.bfloat16, torch.float32):
        for n, d, b, k, has_bias in TOPK_CASES:
            rng = np.random.default_rng(n)
            emb = torch.from_numpy(unit_rows(rng, n, d)).to(dev, dtype)
            q = torch.from_numpy(unit_rows(rng, b, d)).to(dev, dtype)
            bias = (torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32))
                    .to(dev) if has_bias else None)
            want = dense_topk_ref(emb, q, k, bias, 0.7)
            score_of = flat_scores(emb, q, bias, 0.7)
            dense.append(check_topk(dense_topk_kernel(emb, q, k, bias, 0.7), want,
                                    score_of))
            # both routes, whichever topk_query_tile picks for the case, the
            # batch route with and without a seed pass
            for q_tile in topk_case_tiles(emb, q, min(k, n)):
                for seed_rows in topk_seed_choices(n, min(k, n), q_tile):
                    dense.append(check_topk(
                        _launch_topk(emb, q, min(k, n), bias, 0.7, q_tile, seed_rows),
                        want, score_of))
        # tie-heavy corpora: integer scores, so rows and values exactly equal
        for n, d, b, k, has_bias in TOPK_TIE_CASES:
            x, qn, bs = tie_rows(np.random.default_rng(n), n, d, b, has_bias)
            emb = torch.from_numpy(x).to(dev, dtype)
            q = torch.from_numpy(qn).to(dev, dtype)
            bias = None if bs is None else torch.from_numpy(bs).to(dev)
            want = dense_topk_ref(emb, q, k, bias, 0.7)
            for q_tile in topk_case_tiles(emb, q, k):
                for seed_rows in topk_seed_choices(n, k, q_tile):
                    got = _launch_topk(emb, q, k, bias, 0.7, q_tile, seed_rows)
                    if not (torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1])):
                        raise AssertionError(
                            f"dense_topk on the tie case {(n, d, b, k)} at tile "
                            f"{q_tile}, seed rows {seed_rows}, differs from the "
                            f"plain version")
                    dense.append(0.0)
        for case in ALL_IVF_CASES:
            q, layout, rows, sel, blk, n_scan, k = ivf_case(*case)
            e, qd, seld = rows.to(dev, dtype), q.to(dev, dtype), sel.to(dev)
            cid = layout.device_array("cluster_ids", dev)
            args = (qd, e, cid, seld, blk.to(dev), n_scan, k, layout.block_rows)
            want = ivf.ivf_scan_ref(*args)
            off = layout.device_array("cluster_offsets", dev)
            for kw in ({"cluster_offsets": off}, {}):
                scan.append(check_topk(ivf.ivf_scan(*args, **kw), want,
                                       ivf_scores(e, qd, cid, seld)))
            # both tiles, whichever ivf_query_tile picks for the case
            for q_tile in (16, 64) if k <= ivf.SMALL_K else ():
                scan.append(check_topk(
                    ivf._launch_scan(qd, e, seld, args[4], n_scan, k,
                                     layout.block_rows, off, q_tile),
                    want, ivf_scores(e, qd, cid, seld)))
            if dtype == torch.bfloat16:
                for q_tile, slots, max_splits in ((16, 264, 64), (64, 7, 3)):
                    plan_args = (seld, off, q_tile, slots, max_splits)
                    _check_plan(ivf.ivf_work_plan(*plan_args),
                                ivf.ivf_work_plan_ref(*plan_args), str(case))
                    plans += 1
    torch.cuda.synchronize()
    return dense, scan, plans


def _dense_real_shapes(dev, emb, queries, seed: int, smi_line: str):
    """The streaming top-k kernel at the main path's shapes: checked against
    its plain version and timed beside it and beside torch.matmul +
    torch.topk. Returns (max abs errors, numbers of the 512-query k 20
    case)."""
    import torch

    from anorag_tpu_torch.ops.topk import (SCAN_CHUNK, _dense_candidates,
                                           _launch_topk, dense_topk_kernel,
                                           dense_topk_ref, topk_query_tile,
                                           topk_tiles)
    from anorag_tpu_torch.testing import check_topk, flat_scores

    b, n, d = queries.shape[0], emb.shape[0], emb.shape[1]
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    bias = torch.randn((b, n), generator=gen, device=dev)
    one = queries[:1].contiguous()
    cases = [(f"{b} x {n} x {d} k 20", queries, 20, None),
             (f"{b} x {n} x {d} k 128", queries, 128, None),
             (f"{b} x {n} x {d} k 20 + bias", queries, 20, bias),
             (f"1 x {n} x {d} k 30", one, 30, None)]
    errs, main = [], None
    for name, q, k, bs in cases:
        errs.append(check_topk(dense_topk_kernel(emb, q, k, bs, 0.6),
                               dense_topk_ref(emb, q, k, bs, 0.6),
                               flat_scores(emb, q, bs, 0.6)))
        ms, host_ms = _time_ms(lambda: dense_topk_kernel(emb, q, k, bs, 0.6),
                               n=3, reps=5)
        plain_ms, _ = _time_ms(lambda: dense_topk_ref(emb, q, k, bs, 0.6),
                               n=1, reps=3, warm=1)
        if bs is None:
            lib_ms, _ = _time_ms(lambda: torch.topk(torch.matmul(q, emb.T), k),
                                 n=3, reps=5)
        else:
            lib_ms, _ = _time_ms(lambda: torch.topk(
                torch.matmul(q, emb.T) + 0.6 * bs, k), n=3, reps=5)
        bound_ms, bound_by = _topk_bound(
            q.shape[0], n, d, k, emb.element_size(),
            extra_bytes=4 * q.shape[0] * n if bs is not None else 0,
            extra_ops=2 * q.shape[0] * n if bs is not None else 0)
        print(f"dense_topk {name}: kernel {ms:.4f} ms a launch, wrapper's host path "
              f"{host_ms:.4f} ms a call, plain {plain_ms:.4f} ms, torch.matmul + "
              f"torch.topk (two library calls) {lib_ms:.4f} ms, bound {bound_ms:.4f} "
              f"ms ({bound_by}) | {smi_line}", flush=True)
        if main is None:
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=lib_ms)
    del bias

    # Both routes side by side, so the crossing topk_query_tile uses is
    # measured: the 16-query tile against the 128-query tile (k 20) or the
    # 64-query tile (k 128), each checked against the plain version.
    for k in (20, 128):
        big = topk_tiles(0, k, 1)[-1]
        for bq in TOPK_ROUTE_BATCHES:
            q = queries[:bq].contiguous()
            want = dense_topk_ref(emb, q, k)
            times = {}
            for q_tile in (16, big):
                errs.append(check_topk(_launch_topk(emb, q, k, None, 1.0, q_tile),
                                       want, flat_scores(emb, q)))
                times[q_tile], _ = _time_ms(
                    lambda: _launch_topk(emb, q, k, None, 1.0, q_tile), n=3, reps=5)
            print(f"dense_topk route B {bq} k {k}: 16-query tile {times[16]:.4f} ms, "
                  f"{big}-query tile {times[big]:.4f} ms; topk_query_tile picks "
                  f"{topk_query_tile(bq, k, 0, 1)} | {smi_line}", flush=True)

    # The chunked route hybrid_fuse runs for its dense candidates, beside
    # the kernel at the same shape (the bench's hybrid: k 128).
    k = 128
    errs.append(check_topk(dense_topk_kernel(emb, queries, k),
                           _dense_candidates(emb, queries, k, SCAN_CHUNK),
                           flat_scores(emb, queries)))
    cand_ms, _ = _time_ms(lambda: _dense_candidates(emb, queries, k, SCAN_CHUNK),
                          n=3, reps=5)
    kern_ms, _ = _time_ms(lambda: dense_topk_kernel(emb, queries, k), n=3, reps=5)
    print(f"hybrid dense candidates {b} x {n} x {d} k {k}: _dense_candidates "
          f"(f32 torch.matmul per {SCAN_CHUNK}-row chunk + exact merge) "
          f"{cand_ms:.4f} ms, dense_topk_kernel {kern_ms:.4f} ms | {smi_line}",
          flush=True)
    return errs, main


def _bucket_phase(dev, emb, queries, smi_line: str):
    """The bucket-winners kernel's two routes and the merge of the wgmma
    route's split tables against their plain versions, at the odd shapes
    and at the bench shape (emb (N, D) bf16, queries (B, D)), ties across
    splits included; each timed beside its bound and plain version, the
    routes beside the library chain and side by side at B 1 to 512;
    bucket_topk's main-path run counted, and its recall@10 against exact
    f32 on 64 queries. Returns (numbers by kernel: "wgmma", "mma", "merge",
    each with its max abs error; their launches in the main-path run)."""
    import numpy as np
    import torch

    from anorag_tpu_torch.ops.topk import (NEG_INF, _launch_bucket, bucket_merge,
                                           bucket_merge_ref, bucket_route,
                                           bucket_slots, bucket_topk, bucket_width,
                                           bucket_winners, bucket_winners_ref,
                                           bucket_work_plan, kernel_dtype_code,
                                           staging_mode, top_k)
    from anorag_tpu_torch.testing import (BUCKET_CASES, bucket_split_tables,
                                          check_bucket_winners, check_topk,
                                          copy_across_splits, flat_scores, unit_rows)

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the plain versions need full f32 matmuls: "
                             "torch.backends.cuda.matmul.allow_tf32 is on")

    def route_of(e, q, n, w):
        return bucket_route(q.shape[0], n, w, kernel_dtype_code(e), staging_mode(e),
                            staging_mode(q))

    # Every odd shape through the route bucket_winners picks, the first
    # kernel again where that was the wgmma route, the transposed corpus
    # (the first kernel) and bucket_topk.
    errs = {"wgmma": [], "mma": [], "merge": []}
    for dtype in (torch.bfloat16, torch.float32):
        for n, d, b, w, tiles, k in BUCKET_CASES:
            rng = np.random.default_rng(n + d)
            e = torch.from_numpy(unit_rows(rng, n, d)).to(dev, dtype)
            q = torch.from_numpy(unit_rows(rng, b, d)).to(dev, dtype)
            width, _ = bucket_width(b, d, e.element_size(), w, tiles, min(k, n))
            want = bucket_winners_ref(e, q, n, width)
            route = route_of(e, q, n, width)
            errs[route].append(check_bucket_winners(bucket_winners(e, q, n, width), want,
                                                    e, q))
            if route == "wgmma":
                errs["mma"].append(check_bucket_winners(
                    _launch_bucket(e, q, n, width, "mma"), want, e, q))
            errs["mma"].append(check_bucket_winners(
                bucket_winners(e.T.contiguous(), q, n, width, transposed=True),
                want, e, q))
            errs[route].append(check_topk(
                bucket_topk(e, q, k, w=w, tiles=tiles),
                bucket_topk(e, q, k, w=w, tiles=tiles, use_xla=True), flat_scores(e, q)))
    torch.cuda.synchronize()
    print(f"bucket check: {len(errs['wgmma'])} wgmma-route and {len(errs['mma'])} "
          f"first-kernel odd-shape comparisons agree (both dtypes, both layouts, and "
          f"bucket_topk), max abs err {max(errs['wgmma'] + errs['mma']):.3g}", flush=True)

    queries = queries.contiguous()
    (b, d), n, k = queries.shape, emb.shape[0], 100
    widths = {tiles: bucket_width(b, d, emb.element_size(), 512, tiles, k)
              for tiles in (1, 2)}
    width = widths[1][0]
    if any(wt[0] != 512 for wt in widths.values()):
        raise AssertionError(f"the width rule gave {widths}, not W 512")
    if route_of(emb, queries, n, width) != "wgmma":
        raise AssertionError("the bench shape does not take the wgmma route")
    plan = bucket_work_plan(b, width, n, bucket_slots(dev.index or 0))
    want = bucket_winners_ref(emb, queries, n, width)
    for route in ("wgmma", "mma"):
        errs[route].append(check_bucket_winners(
            _launch_bucket(emb, queries, n, width, route), want, emb, queries))
    # the merge, on the split tables by plain arithmetic: exactly equal
    part = bucket_split_tables(emb, queries, n, width, plan)
    merged = bucket_merge(*part)
    if not all(torch.equal(x, y) for x, y in zip(merged, bucket_merge_ref(*part))):
        raise AssertionError("bucket_merge differs from bucket_merge_ref")
    errs["merge"].append(check_bucket_winners(merged, want, emb, queries))
    # ties across splits: query 0's own vector in bucket 37 of tiles 0 and 1
    # and of every split's first tile; the earliest row must win
    tied = emb.clone()
    at = copy_across_splits(tied, queries[0], width, plan.per, 37)
    want_t = bucket_winners_ref(tied, queries, n, width)
    for route in ("wgmma", "mma"):
        got = _launch_bucket(tied, queries, n, width, route)
        errs[route].append(check_bucket_winners(got, want_t, tied, queries))
        if int(got[1][0, 37]) != at[0] or int(want_t[1][0, 37]) != at[0]:
            raise AssertionError(f"the {route} route lost the earliest of the tied rows "
                                 f"{at[:4]}...: {int(got[1][0, 37])}")
    del tied, want_t, want
    print(f"bucket at the bench shape: both routes equal to the plain version, the "
          f"merge of {plan.splits} split tables exactly equal to bucket_merge_ref, and "
          f"a tie over {len(at)} rows across the splits kept by its earliest row on "
          f"both routes", flush=True)

    ms, host_ms = _time_ms(lambda: bucket_winners(emb, queries, n, width), n=5, reps=7)
    mma_ms, _ = _time_ms(lambda: _launch_bucket(emb, queries, n, width, "mma"),
                         n=5, reps=7)
    plain_ms, _ = _time_ms(lambda: bucket_winners_ref(emb, queries, n, width),
                           n=1, reps=3, warm=1)
    # the merge with its tables out of L2, against the HBM bound; on the
    # main path it reads them warm, just written by the wgmma kernel
    merge_ms = _time_cold_ms(lambda: bucket_merge(*part))
    merge_plain_ms = _time_cold_ms(lambda: bucket_merge_ref(*part), reps=11)
    merge_warm_ms, _ = _time_ms(lambda: bucket_merge(*part), n=5, reps=7)
    merge_bytes = part[0].numel() * 8 + b * width * 8
    merge_bound_ms = 1e3 * merge_bytes / HBM_BYTES_PER_S
    del part, merged
    n_pad = -(-n // width) * width

    def library():
        s = torch.mm(queries, emb.T, out_dtype=torch.float32)
        s = torch.nn.functional.pad(s, (0, n_pad - n), value=NEG_INF)
        v, t = s.view(b, -1, width).max(dim=1)
        tv, tp = torch.topk(v, k)
        return tv, t.gather(1, tp) * width + tp

    # bucket_topk at the bench shape, tiles 1 and 2: the main path, its
    # kernels' launches counted from 0
    torch.cuda.synchronize()
    bucket_winners.launches = bucket_merge.launches = 0
    bucket_winners.route_launches = {"wgmma": 0, "mma": 0}
    runs = [bucket_topk(emb, queries, k, w=512, tiles=tiles) for tiles in (1, 2)]
    torch.cuda.synchronize()
    launches = dict(bucket_winners.route_launches, merge=bucket_merge.launches)
    if (bucket_winners.launches != 2 or launches["wgmma"] != 2
            or launches["merge"] != 2 * (plan.splits > 1)
            or not torch.equal(runs[0][1], runs[1][1])):
        raise AssertionError(f"bucket_topk at tiles 1 and 2: launches {launches}, "
                             f"ids equal {torch.equal(runs[0][1], runs[1][1])}")
    lib_gap = float((library()[0] - runs[0][0]).abs().max())
    if lib_gap > 1e-5:
        raise AssertionError(f"the library chain's top-{k} values differ from "
                             f"bucket_topk's by {lib_gap}")
    lib_ms, _ = _time_ms(library, n=5, reps=7)
    bound_ms, bound_by = _topk_bound(b, n, d, width, emb.element_size())
    print(f"bucket_winners {b} x {n} x {d} {emb.dtype} W {width}: wgmma route "
          f"{ms:.4f} ms a call ({plan.splits} splits of {plan.per} tiles, "
          f"{plan.units} units, the merge included), wrapper's host path "
          f"{host_ms:.4f} ms a call; first kernel {mma_ms:.4f} ms; plain "
          f"{plain_ms:.4f} ms; library chain (torch.mm f32 out, pad, max over the "
          f"(B, N/W, W) view, torch.topk k {k}: four calls) {lib_ms:.4f} ms, its "
          f"values equal bucket_topk's to {lib_gap:.3g}; bound {bound_ms:.4f} ms "
          f"({bound_by}) | {smi_line}", flush=True)
    print(f"bucket_merge of {plan.splits} x {b} x {width} split tables, out of L2 "
          f"before each call: kernel {merge_ms:.4f} ms, plain {merge_plain_ms:.4f} ms, "
          f"bound {merge_bound_ms:.4f} ms (bytes: {merge_bytes / 1e6:.1f} MB at HBM's "
          f"rate); back to back, tables in L2: kernel {merge_warm_ms:.4f} ms | "
          f"{smi_line}", flush=True)

    # both routes side by side, each checked: bucket_route gives the wgmma route
    # every batch, which these lines must keep showing faster
    for bq in BUCKET_ROUTE_BATCHES:
        q = queries[:bq].contiguous()
        want = bucket_winners_ref(emb, q, n, width)
        times = {}
        for route in ("mma", "wgmma"):
            errs[route].append(check_bucket_winners(
                _launch_bucket(emb, q, n, width, route), want, emb, q))
            times[route], _ = _time_ms(lambda: _launch_bucket(emb, q, n, width, route),
                                       n=5, reps=7)
        print(f"bucket route B {bq} W {width}: first kernel {times['mma']:.4f} ms, "
              f"wgmma route {times['wgmma']:.4f} ms; bucket_route picks "
              f"{route_of(emb, q, n, width)} | {smi_line}", flush=True)

    # recall@10 of the tiles-1 run's first 64 queries against exact f32
    nq = 64
    exact = top_k(torch.matmul(queries[:nq].float(), emb.float().T), 10)[1].cpu()
    got = runs[0][1][:nq, :10].cpu()
    recall = float(np.mean([len(set(got[j].tolist()) & set(exact[j].tolist())) / 10
                            for j in range(nq)]))
    print(f"bucket_topk k {k}, w 512, tiles 1 and 2 (W {width}): launches {launches}, "
          f"ids equal across tiles; recall@10 of {nq} queries against exact f32 "
          f"{recall:.4f} (expected about 1 - 9/1024 = 0.9912)", flush=True)
    chain = dict(plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=lib_ms)
    return {"wgmma": dict(ms=ms, max_abs_err=max(errs["wgmma"]), **chain),
            "mma": dict(ms=mma_ms, max_abs_err=max(errs["mma"]), **chain),
            "merge": dict(ms=merge_ms, max_abs_err=max(errs["merge"]),
                          plain_ms=merge_plain_ms, bound_ms=merge_bound_ms,
                          bound_by="bytes", library_ms=None)}, launches


def _bench_phase(dev, smi_line: str) -> dict:
    """anorag_tpu_torch.bench in-process: kernel_parity, the 200,000-doc
    bench_hybrid with its recall gate, bench_encoder. Every kernel they
    reach (counted from 0 just before) must launch. Returns the
    bucket-winners routes' launches and the merge's."""
    import torch

    from anorag_tpu_torch import bench
    from anorag_tpu_torch.ops import bm25, topk

    counted = (topk.bucket_winners, bm25.window_winners, bm25.segment_winners,
               topk.bucket_merge)
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    topk.bucket_winners.route_launches = {"wgmma": 0, "mma": 0}
    parity = bench.kernel_parity(dev)
    headline = bench.bench_hybrid(200_000, cpu_baseline=True, keep_ctx=True,
                                  device=dev)
    ctx = headline.pop("_ctx")
    encoder = bench.bench_encoder(ctx)
    del ctx
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    print(json.dumps({"kernel_parity": parity, "hybrid_200k": headline,
                      "encoder": encoder, "launches": launches,
                      "card": smi_line}), flush=True)
    rec = headline["recall_at_10_vs_exact_f32"]
    if rec < bench.RECALL_GATE:
        raise AssertionError(f"bench recall@10 vs exact f32 {rec:.4f} < the gate "
                             f"{bench.RECALL_GATE}")
    idle = [name for name, n in launches.items() if n < 1 and name != "bucket_merge"]
    if idle:
        raise AssertionError(f"the bench launched no {idle}")
    return dict(topk.bucket_winners.route_launches, merge=launches["bucket_merge"])


def _search_phase(dev, em, notes, emb, requests, smi_line: str):
    """VectorRetriever.search and .retrieve through the streaming top-k
    kernel (use_kernel=True); returns the kernel's launches in the phase."""
    import torch

    from anorag_tpu_torch.ops.topk import dense_topk_kernel
    from anorag_tpu_torch.retrieval.retriever import VectorRetriever

    vr = VectorRetriever(em, use_kernel=True, top_k=20)
    vr.build_index(notes, embeddings=emb)
    vr.retrieve("warm the encoder", top_k=10)
    torch.cuda.synchronize(dev)
    dense_topk_kernel.launches = 0
    t0 = time.perf_counter()
    rows = vr.search(requests[0], top_k=20, threshold=-1.0)
    t_search = time.perf_counter() - t0
    singles, lat = requests[1][:N_RETRIEVE], []
    picked = []
    for query in singles:
        t1 = time.perf_counter()
        picked.append(vr.retrieve(query, top_k=10, threshold=-1.0))
        lat.append(time.perf_counter() - t1)
    launches = dense_topk_kernel.launches
    calls = 1 + len(singles)
    for got, want in [(rows, 20)] + [([r], 10) for r in picked]:
        for row in got:
            if len(row) != want:
                raise AssertionError(f"search returned {len(row)} rows, not {want}")
            for r in row:
                i = int(r["note_id"][1:])
                if not (0 <= i < len(notes) and notes[i]["note_id"] == r["note_id"]):
                    raise AssertionError(f"invalid note {r['note_id']}")
    if launches != calls:
        raise AssertionError(f"dense_topk kernel launched {launches} times for "
                             f"{calls} searches")
    print(f"search: {len(requests[0])} queries at top_k 20 in {t_search:.4f} s "
          f"({len(requests[0]) / t_search:.1f} queries/s); retrieve: {len(singles)} "
          f"single queries at top_k 10 (fetch 30), latency mean "
          f"{sum(lat) / len(lat):.4f} s, max {max(lat):.4f} s, "
          f"{len(singles) / sum(lat):.1f} queries/s; dense_topk launches {launches} "
          f"of {calls} calls | {smi_line}", flush=True)

    # The default route (use_kernel None: chunked matmul + exact top-k), the
    # one QueryProcessor's retriever and so /search take below ivf_min_corpus.
    vd = VectorRetriever(em, top_k=20)
    vd.build_index(notes, embeddings=emb)
    vd.search(requests[0], top_k=20, threshold=-1.0)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    rows_d = vd.search(requests[0], top_k=20, threshold=-1.0)
    t_default = time.perf_counter() - t0
    lat_d = []
    for query in singles:
        t1 = time.perf_counter()
        vd.retrieve(query, top_k=10, threshold=-1.0)
        lat_d.append(time.perf_counter() - t1)
    if dense_topk_kernel.launches != launches:
        raise AssertionError("the default route launched the top-k kernel")
    for got, want in zip(rows_d, rows):
        gap = max(abs(g["similarity"] - w["similarity"]) for g, w in zip(got, want))
        if len(got) != len(want) or gap > 1e-5:
            raise AssertionError(f"default route's scores differ from the "
                                 f"kernel route's by {gap}")
    print(f"search, default route (chunked torch.matmul + exact top-k): "
          f"{len(requests[0])} queries at top_k 20 in {t_default:.4f} s "
          f"({len(requests[0]) / t_default:.1f} queries/s); retrieve: latency mean "
          f"{sum(lat_d) / len(lat_d):.4f} s, max {max(lat_d):.4f} s, "
          f"{len(singles) / sum(lat_d):.1f} queries/s; scores equal to the kernel "
          f"route's to 1e-5 | {smi_line}", flush=True)
    del vd
    return launches


def _scan_bound(b: int, l: int, bl: int, winners: bool):
    """(bound ms, bound_by, bytes, ops) of a segment kernel over a (b, l)
    plan: ids and weights read once, the masked totals or the winners table
    and the row max written once, against the log-step adds and maxes plus
    about six compares and selects a position over the f32 rate."""
    lp = -(-l // bl) * bl
    moved = 8 * b * l + (8 * b * bl if winners else 4 * b * l) + 4 * b
    ops = b * lp * (2 * max(bl - 1, 0).bit_length() + 6)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            moved, ops)


def _sparse_against_chain(got, chain, tol, what: str) -> float:
    """Hold a sparse top-m table (vals, ids, row max) against the chain's:
    row max and the totals of docs in both to tol (B, 1); returns the mean
    recall of the chain's docs, printed beside the recall that also counts a
    missing doc tied (within tol) with the chain's m-th total."""
    import numpy as np
    import torch

    (gv, gd, gm), (cv, cd, cm) = got, chain
    if bool(((gm - cm).abs() > tol).any()):
        raise AssertionError(f"{what}: row max off the chain's by more than 8 u S")
    gv, gd, cv, cd, tol = (x.cpu().numpy() for x in (gv, gd, cv, cd, tol))
    recs, tied = [], []
    for r in range(len(cv)):
        gold = {d: v for d, v in zip(cd[r], cv[r]) if d >= 0}
        mine = {d: v for d, v in zip(gd[r], gv[r]) if d >= 0}
        shared = sorted(set(gold) & set(mine))
        gap = max((abs(mine[d] - gold[d]) for d in shared), default=0.0)
        if gap > tol[r, 0]:
            raise AssertionError(f"{what}: row {r} total off the chain's by {gap:.3g} "
                                 f"> 8 u S = {tol[r, 0]:.3g}")
        recs.append(len(shared) / max(len(gold), 1))
        last = min(gold.values(), default=0.0)
        tied.append(np.mean([d in mine or gold[d] - last <= tol[r, 0] for d in gold])
                    if gold else 1.0)
    recall = float(np.mean(recs))
    print(f"{what} against the chain: row max and shared totals within 8 u S "
          f"(largest {tol.max():.3g}); recall of the chain's top-{cv.shape[1]} "
          f"{recall:.4f} (min {min(recs):.4f}), counting ties at the cut "
          f"{float(np.mean(tied)):.4f}", flush=True)
    return recall


def _segment_phase(dev, retriever, requests, top_k: int, smi_line: str):
    """The segment-scan kernels and their first kernels against their plain
    versions (exact) at the odd shapes and the served plan, their times and
    bounds, and segment winners' route lines; then the
    length-bucketed hybrid query over every served batch (segment totals)
    against the same routes over the unbucketed plan, both segment routes'
    sparse tables against the chain, hybrid_topk with max_seg 0 (segment
    winners), and the bucketed tiled path against the unbucketed one.
    Returns the two kernels' numbers for the JSON line."""
    import torch

    from anorag_tpu_torch.ops import bm25
    from anorag_tpu_torch.ops.topk import (hybrid_fuse, hybrid_topk,
                                           hybrid_topk_bucketed,
                                           hybrid_topk_bucketed_tiled,
                                           make_bucketed_plan)
    from anorag_tpu_torch.testing import SEGMENT_CASES, segment_plan

    kernels = (("bm25_segment_totals", bm25.segment_totals, bm25.segment_totals_ref),
               ("bm25_segment_winners", bm25.segment_winners, bm25.segment_winners_ref))

    def exact(got, want, what):
        for x, y in zip(got, want):
            if not torch.equal(x, y):
                bad = int((x != y).sum())
                raise AssertionError(f"{what}: {bad} outputs differ from the plain version")

    # the first kernels, one CTA a row: the yardsticks the row tiles are timed against
    first = {"bm25_segment_totals": lambda a, w, n_docs, block_l=1024:
             bm25._launch_totals(a, w, n_docs, block_l, "rows"),
             "bm25_segment_winners": lambda a, w, n_docs, block_l=1024:
             bm25._launch_segment_winners(a, w, n_docs, block_l, "rows")}

    n = 0
    for kind, n_docs, b, l, block_l in SEGMENT_CASES:
        a, w = (torch.from_numpy(x).to(dev) for x in segment_plan(kind, n_docs, b, l))
        for name, kernel, ref in kernels:
            want = ref(a, w, n_docs, block_l=block_l)
            exact(kernel(a, w, n_docs, block_l=block_l), want, f"{name} {kind} ({b}, {l})")
            exact(first[name](a, w, n_docs, block_l=block_l), want,
                  f"{name} first kernel, {kind} ({b}, {l})")
            n += 2
    n_docs = len(retriever.notes)
    batches = [retriever.prepare(req, top_k=top_k) for req in requests]
    emb = retriever.index.flat_device_emb()
    batch = batches[0]
    dr, wr = batch.doc_rows, batch.weight_rows
    b, l = dr.shape
    numbers = {}
    for name, kernel, ref in kernels:
        want = ref(dr, wr, n_docs)
        exact(kernel(dr, wr, n_docs), want, f"{name} main path ({b}, {l})")
        exact(first[name](dr, wr, n_docs), want, f"{name} first kernel, main path ({b}, {l})")
        n += 2
        ms, host_ms = _time_ms(lambda: kernel(dr, wr, n_docs))
        old_ms, _ = _time_ms(lambda: first[name](dr, wr, n_docs))
        plain_ms, _ = _time_ms(lambda: ref(dr, wr, n_docs), n=2, reps=5, warm=1)
        bound_ms, bound_by, moved, ops = _scan_bound(b, l, min(1024, l),
                                                     name.endswith("winners"))
        numbers[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None, old_ms=old_ms)
        print(f"{name} at ({b}, {l}): kernel {ms:.4f} ms a launch (20 back to back), "
              f"first kernel {old_ms:.4f} ms, wrapper's host path {host_ms:.4f} ms a call, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{moved / 1e6:.1f} MB, {ops / 1e6:.1f} M ops) | {smi_line}", flush=True)
    # segment winners' route lines: the first rows of the main path's plan,
    # the row tiles beside the first kernel, each exact
    routes = []
    for rb in SEGMENT_ROUTE_BATCHES:
        if rb > b:
            continue
        a_, w_ = dr[:rb].contiguous(), wr[:rb].contiguous()
        want = bm25.segment_winners_ref(a_, w_, n_docs)
        exact(bm25.segment_winners(a_, w_, n_docs), want, f"segment winners ({rb}, {l})")
        exact(first["bm25_segment_winners"](a_, w_, n_docs), want,
              f"segment winners first kernel ({rb}, {l})")
        n += 2
        t_ms, _ = _time_ms(lambda: bm25.segment_winners(a_, w_, n_docs))
        o_ms, _ = _time_ms(lambda: first["bm25_segment_winners"](a_, w_, n_docs))
        bound_ms = _scan_bound(rb, l, min(1024, l), True)[0]
        print(f"bm25_segment_winners route line B {rb} x {l}: row tiles {t_ms:.4f} ms, "
              f"first kernel {o_ms:.4f} ms, bound {bound_ms:.4f} ms | {smi_line}", flush=True)
        routes.append(dict(b=rb, ms=t_ms, old_ms=o_ms, bound_ms=bound_ms))
    numbers["bm25_segment_winners"]["routes"] = routes
    torch.cuda.synchronize()
    print(f"segment kernel check: {n} comparisons exactly equal (values, ids, row max)")

    # the length-bucketed hybrid query: segment totals in its sparse stage
    plans = [make_bucketed_plan(x.doc_rows.cpu().numpy(), x.weight_rows.cpu().numpy(),
                                x.lens, n_docs, groups=4, device=dev) for x in batches]
    torch.cuda.synchronize()
    bm25.segment_totals.launches = 0
    t0 = time.perf_counter()
    outs = [hybrid_topk_bucketed(emb, x.q_emb, plan, x.k, n_docs, dense_k=x.dense_k,
                                 sparse_m=x.sparse_m) for x, plan in zip(batches, plans)]
    torch.cuda.synchronize()
    t_bucketed = time.perf_counter() - t0
    totals_launches = bm25.segment_totals.launches
    routed = sum(int(dr_.is_cuda and dr_.shape[1] >= 2048 and dr_.shape[0] >= 8)
                 for plan in plans for _, dr_, _ in plan.buckets)
    if totals_launches != routed or totals_launches < 1:
        raise AssertionError(f"segment_totals launched {totals_launches} times; "
                             f"{routed} buckets were routed to it")
    # Expected: each row through the route its bucket took (segment totals
    # for buckets on the card at least 2048 wide, the chain otherwise) over
    # the unbucketed plan. Both scans run from each row's start in fixed
    # blocks (1024 for the kernel, 16 for the chain), so a row cut to its
    # bucket's width gives the same totals bit for bit.
    for x, plan, (vals, ids) in zip(batches, plans, outs):
        use_kernel = torch.zeros(x.doc_rows.shape[0], dtype=torch.bool, device=dev)
        order = torch.argsort(plan.inv)                 # bucket slot -> row
        lo = 0
        for n_valid, dr_, _ in plan.buckets:
            use_kernel[order[lo:lo + n_valid]] = dr_.shape[1] >= 2048 and dr_.shape[0] >= 8
            lo += n_valid
        tables = [bm25.sparse_topm_from_sorted(x.doc_rows, x.weight_rows, x.sparse_m,
                                               n_docs, impl=impl)[1:]
                  for impl in ("kernel", "chain")]
        sv, sd, sm = (torch.where(use_kernel[:, None], k_, c_)
                      for k_, c_ in zip(*tables))
        want = hybrid_fuse(emb, x.q_emb, sv, sd, sm, x.k, n_docs, dense_k=x.dense_k)
        if not (torch.equal(vals, want[0]) and torch.equal(ids, want[1])):
            raise AssertionError("bucketed hybrid differs from the same routes over "
                                 "the unbucketed plan")
    widths = [[int(dr_.shape[1]) for _, dr_, _ in plan.buckets] for plan in plans]
    print(f"bucketed hybrid: {len(batches)} x {b} queries, bucket widths {widths}, "
          f"{t_bucketed:.4f} s; segment_totals launches {totals_launches} (routed "
          f"{routed}); scores and ids equal to the same routes over the unbucketed "
          f"plan | {smi_line}", flush=True)
    # segment totals at each bucket shape the bucketed query launched, on
    # its first bucket of that shape: exact, then timed with the plan out
    # of L2 (under 50 MB: back to back it would stay there), beside the first
    # kernel and the bound
    shapes = {}
    for plan in plans:
        for _, dr_, wr_ in plan.buckets:
            if dr_.shape[1] >= 2048 and dr_.shape[0] >= 8:
                shapes.setdefault(tuple(dr_.shape), (dr_, wr_))
    bucket_numbers = []
    for (bb, lb), (dr_, wr_) in sorted(shapes.items()):
        want = bm25.segment_totals_ref(dr_, wr_, n_docs)
        exact(bm25.segment_totals(dr_, wr_, n_docs), want, f"segment totals bucket ({bb}, {lb})")
        exact(bm25._launch_totals(dr_, wr_, n_docs, 1024, "rows"), want,
              f"segment totals first kernel, bucket ({bb}, {lb})")
        n += 2
        ms = _time_cold_ms(lambda: bm25.segment_totals(dr_, wr_, n_docs))
        old_ms = _time_cold_ms(lambda: bm25._launch_totals(dr_, wr_, n_docs, 1024, "rows"))
        warm_ms, _ = _time_ms(lambda: bm25.segment_totals(dr_, wr_, n_docs))
        plain_ms, _ = _time_ms(lambda: bm25.segment_totals_ref(dr_, wr_, n_docs), n=2,
                               reps=5, warm=1)
        bound_ms, bound_by, moved, _ = _scan_bound(bb, lb, 1024, False)
        print(f"bm25_segment_totals at bucket ({bb}, {lb}), out of L2: kernel {ms:.4f} ms, "
              f"first kernel {old_ms:.4f} ms; back to back {warm_ms:.4f} ms; plain "
              f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}: "
              f"{moved / 1e6:.1f} MB) | {smi_line}", flush=True)
        bucket_numbers.append(dict(shape=[bb, lb], ms=ms, old_ms=old_ms, warm_ms=warm_ms,
                                   plain_ms=plain_ms, bound_ms=bound_ms))
    numbers["bm25_segment_totals"]["buckets"] = bucket_numbers

    # Against the chain: both routes take totals as differences of f32
    # running sums, so each is off the exact total by a few units of
    # u * S (u = 2^-24, S the row's weight sum); they are held to 8 u S.
    _, cv, cd, cm = bm25.sparse_topm_from_sorted(dr, wr, batch.sparse_m, n_docs,
                                                 impl="chain")
    tol = 8 * 2.0 ** -24 * wr.sum(dim=1, keepdim=True)
    _, kv, kd, km = bm25.sparse_topm_from_sorted(dr, wr, batch.sparse_m, n_docs,
                                                 impl="kernel")
    _sparse_against_chain((kv, kd, km), (cv, cd, cm), tol, "segment totals")

    # max_seg 0: hybrid_topk takes the segment-winners kernel
    bm25.segment_winners.launches = 0
    hybrid_topk(emb, batch.q_emb, dr, wr, batch.k, n_docs, dense_k=batch.dense_k,
                sparse_m=batch.sparse_m, max_seg=0)
    torch.cuda.synchronize()
    winners_launches = bm25.segment_winners.launches
    if winners_launches != 1:
        raise AssertionError(f"hybrid_topk(max_seg=0) launched segment_winners "
                             f"{winners_launches} times, not once")
    recall = _sparse_against_chain(
        bm25.sparse_topm_winners(dr, wr, batch.sparse_m, n_docs, max_seg=0),
        (cv, cd, cm), tol, "segment winners")
    if recall < 0.9:
        raise AssertionError(f"segment winners' sparse top-m recall {recall:.4f} < 0.9")
    print(f"hybrid_topk max_seg 0: segment_winners launches {winners_launches}",
          flush=True)

    # the bucketed tiled path equals the unbucketed tiled one exactly
    for x in batches:
        a_np, w_np = x.doc_rows.cpu().numpy(), x.weight_rows.cpu().numpy()
        a3, w3 = (torch.from_numpy(t).to(dev) for t in bm25.plan_tiles(a_np, w_np, n_docs))
        want = hybrid_topk(emb, x.q_emb, a3, w3, x.k, n_docs, dense_k=x.dense_k,
                           sparse_m=x.sparse_m, max_seg=x.max_seg)
        tiles, inv = bm25.plan_tiles_bucketed(a_np, w_np, x.lens, n_docs, groups=2)
        got = hybrid_topk_bucketed_tiled(
            emb, x.q_emb, [(torch.from_numpy(a).to(dev), torch.from_numpy(w).to(dev))
                           for a, w, _ in tiles],
            torch.from_numpy(inv).to(dev), x.k, n_docs, [bv for _, _, bv in tiles],
            dense_k=x.dense_k, sparse_m=x.sparse_m, max_seg=x.max_seg)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError("bucketed tiled hybrid differs from the unbucketed one")
    print(f"bucketed tiled hybrid: {len(batches)} batches equal to the unbucketed "
          f"tiled path", flush=True)
    designs = {"bm25_segment_totals": "row tiles: a warp a 1024-wide block staged "
                                      "through shared memory, tiles from one counter "
                                      "in (block, row) order; each publishes its "
                                      "summary, folds its row's summaries in block "
                                      "order from the latest published carry, "
                                      "publishes its carry",
               "bm25_segment_winners": "the same row tiles, a CTA of 8 warps a group "
                                       "of 8 blocks of one row, groups from one "
                                       "counter in (group, row) order; the group's "
                                       "winners merged in shared memory, then one "
                                       "64-bit atomicMin a bucket into the row's key "
                                       "table (value, then earlier block), the id into "
                                       "the group's id table; the CTA that finishes a "
                                       "row's last group decodes it; the plan's loads "
                                       "marked to leave L2 first"}
    return [dict(name=name, route="cuda", source="anorag_tpu_torch/csrc/segment_scan.cu",
                 design=designs[name], replaces=replaces, launches=launches,
                 max_abs_err=0.0, **numbers[name])
            for name, replaces, launches in (
                ("bm25_segment_totals", "anorag_tpu/ops/bm25.py:184", totals_launches),
                ("bm25_segment_winners", "anorag_tpu/ops/bm25.py:287", winners_launches))]


def _ivf_phase(dev, seed: int, smi_line: str):
    """The default IVFFlat index at 5,000,000 rows: build, traffic, checks
    and timings. Returns (ivf_scan launches, max abs error, timing numbers,
    ivf_work_plan launches, its timing numbers)."""
    import torch

    from anorag_tpu_torch.index.vector_index import VectorIndex
    from anorag_tpu_torch.ops.ivf import (_launch_scan, ivf_launch_shape, ivf_probe,
                                          ivf_query_tile, ivf_scan, ivf_scan_ref,
                                          ivf_slots, ivf_work_plan, ivf_work_plan_ref,
                                          select_blocks)
    from anorag_tpu_torch.ops.topk import dense_topk_kernel, kernel_dtype_code
    from anorag_tpu_torch.testing import check_topk, ivf_scores

    d = 1024
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    centres = torch.randn((IVF_CENTRES, d), generator=gen, device=dev)
    x = torch.empty((N_IVF, d), device=dev)
    step = 1 << 18
    for lo in range(0, N_IVF, step):
        hi = min(lo + step, N_IVF)
        label = torch.randint(0, IVF_CENTRES, (hi - lo,), generator=gen, device=dev)
        x[lo:hi] = centres[label] + 0.5 * torch.randn((hi - lo, d), generator=gen,
                                                      device=dev)
    torch.cuda.synchronize(dev)
    t_data = time.perf_counter() - t
    index = VectorIndex(dimension=d, index_type="IVFFlat", device=dev)
    t = time.perf_counter()
    index.add(x)
    del x, centres
    torch.cuda.empty_cache()
    t_add = time.perf_counter() - t
    t = time.perf_counter()
    index._materialize()
    torch.cuda.synchronize(dev)
    t_build = time.perf_counter() - t
    peak_build = torch.cuda.max_memory_allocated(dev) / 1e9
    layout, sorted_emb = index._layout, index._device_emb
    sizes = torch.bincount(torch.from_numpy(layout.cluster_ids[:layout.n]).long(),
                           minlength=layout.nlist)
    print(f"ivf build: data {t_data:.2f} s, add (normalize, host copy) {t_add:.2f} s, "
          f"k-means + cluster sort {t_build:.2f} s; nlist {layout.nlist}, "
          f"block_rows {layout.block_rows}, {layout.num_blocks} blocks, cluster "
          f"sizes {sizes.min().item()}-{sizes.max().item()}; peak device memory "
          f"{peak_build:.2f} GB", flush=True)

    # traffic: noisy copies of random corpus rows
    cpu_gen = torch.Generator().manual_seed(seed + 3)
    n_q = IVF_BATCHES * BATCH + IVF_SINGLES
    rows = torch.randint(0, N_IVF, (n_q,), generator=cpu_gen)
    queries = (index._emb_f32[rows]
               + 0.01 * torch.randn((n_q, d), generator=cpu_gen)).to(dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ivf_scan.launches = ivf_work_plan.launches = 0
    lat_b, lat_1, single_ids = [], [], []
    for i in range(IVF_BATCHES):
        t = time.perf_counter()
        vals, ids = index.search_arrays(queries[i * BATCH:(i + 1) * BATCH], 20)
        lat_b.append(time.perf_counter() - t)
        if ids.shape != (BATCH, 20) or ids.min() < -1 or ids.max() >= N_IVF:
            raise AssertionError("IVF batch returned invalid ids")
    for j in range(IVF_BATCHES * BATCH, n_q):
        t = time.perf_counter()
        vals, ids = index.search_arrays(queries[j:j + 1], 30)
        lat_1.append(time.perf_counter() - t)
        if ids.shape != (1, 30) or ids.min() < -1 or ids.max() >= N_IVF:
            raise AssertionError("IVF single query returned invalid ids")
        single_ids.append(ids[0, :10])
    launches, plan_launches = ivf_scan.launches, ivf_work_plan.launches
    peak_search = torch.cuda.max_memory_allocated(dev) / 1e9
    if launches != IVF_BATCHES + IVF_SINGLES or plan_launches != launches:
        raise AssertionError(f"ivf_scan launched {launches} times and ivf_work_plan "
                             f"{plan_launches} for {IVF_BATCHES + IVF_SINGLES} searches")
    n_b = IVF_BATCHES * BATCH
    print(f"ivf traffic: {IVF_BATCHES} x {BATCH} queries at top_k 20, latency "
          f"{', '.join(f'{x:.4f}' for x in lat_b)} s ({n_b / sum(lat_b):.1f} "
          f"queries/s); {IVF_SINGLES} single queries at top_k 30, latency mean "
          f"{sum(lat_1) / len(lat_1):.4f} s, max {max(lat_1):.4f} s "
          f"({IVF_SINGLES / sum(lat_1):.1f} queries/s); ivf_scan launches "
          f"{launches}, ivf_work_plan launches {plan_launches}; peak device memory {peak_search:.2f} GB; host peak RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.2f} GB "
          f"| {smi_line}", flush=True)

    # the kernel against its plain version, and timings, at the real shapes
    cid = layout.device_array("cluster_ids", dev)
    off = layout.device_array("cluster_offsets", dev)

    def scan_args(q, k):
        qn = index._preprocess(q)
        sel = ivf_probe(layout, qn, index.nprobe).contiguous()
        blk = select_blocks(layout, sel.cpu().numpy())
        return (qn.to(sorted_emb.dtype).contiguous(), sorted_emb, cid, sel,
                torch.from_numpy(blk).to(dev), int((blk >= 0).sum()), k,
                layout.block_rows)

    scanned = [scan_args(queries[i * BATCH:(i + 1) * BATCH], 20)[5]
               for i in range(IVF_BATCHES)]
    print(f"ivf blocks scanned per batch: {scanned} of {layout.num_blocks}")
    numbers = {}
    err = 0.0
    for name, q, k in ((f"{BATCH} x {N_IVF} x {d} k 20", queries[:BATCH], 20),
                       (f"1 x {N_IVF} x {d} k 30", queries[n_b:n_b + 1], 30)):
        args = scan_args(q, k)
        err = max(err, check_topk(ivf_scan(*args, cluster_offsets=off),
                                  ivf_scan_ref(*args),
                                  ivf_scores(sorted_emb, args[0], cid, args[3])))
        b, nprobe = args[3].shape
        q_tile, max_splits, stride = ivf_launch_shape(b, nprobe, layout.nlist, k)
        slots = ivf_slots(kernel_dtype_code(sorted_emb), q_tile, k, dev.index)
        plan_args = (args[3], off, q_tile, slots, max_splits)
        plan = ivf_work_plan(*plan_args)
        plan_err = _check_plan(plan, ivf_work_plan_ref(*plan_args), name)
        plan_ms, plan_host_ms = _time_ms(lambda: ivf_work_plan(*plan_args), n=5, reps=5)
        plan_plain_ms, _ = _time_ms(lambda: ivf_work_plan_ref(*plan_args), n=5, reps=5)
        # bytes: sel and offsets read, pairs and tiles written
        plan_bound_ms = 1e3 * (8 * b * nprobe + 8 * off.numel()
                               + 20 * plan.max_tiles) / HBM_BYTES_PER_S
        used = plan.tile_splits[plan.tile_splits > 0]
        print(f"ivf_scan {name} plan: {int((plan.tile_cluster >= 0).sum())} tiles of "
              f"up to {q_tile} queries (bound {plan.max_tiles}), {int(used.min())}-"
              f"{int(used.max())} splits a tile, {int(plan.unit_end[-1])} units for "
              f"{slots} resident CTAs, grid {plan.grid}, partials (B, {stride}, k) "
              f"{b * stride * k * 8 / 1e6:.3f} MB; the plan kernel equal to its plain "
              f"version, {plan_ms:.4f} ms a launch (wrapper's host path "
              f"{plan_host_ms:.4f} ms), plain {plan_plain_ms:.4f} ms, bound "
              f"{plan_bound_ms:.6f} ms (bytes)", flush=True)
        ms, host_ms = _time_ms(lambda: ivf_scan(*args, cluster_offsets=off), n=3,
                               reps=5)
        plain_ms, _ = _time_ms(lambda: ivf_scan_ref(*args), n=1, reps=2, warm=1)
        lib_ms, _ = _time_ms(lambda: torch.topk(torch.matmul(args[0], sorted_emb.T), k),
                             n=1, reps=3, warm=1)
        sel, n_scan = args[3], args[5]
        needed = int(sizes.to(dev)[sel.long()].sum())        # rows each query must score
        moved = (n_scan * layout.block_rows * (d * 2 + 4) + b * d * 2 + sel.numel() * 4
                 + b * k * 8)
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, 2 * needed * d / BF16_OPS_PER_S
        bound_ms = 1e3 * max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"ivf_scan {name}: {n_scan} blocks scanned, kernel {ms:.4f} ms a launch, "
              f"wrapper's host path {host_ms:.4f} ms a call, plain {plain_ms:.4f} ms, "
              f"torch.matmul + torch.topk over every row (two library calls, no "
              f"cluster mask) {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{moved / 1e9:.3f} GB, {2 * needed * d / 1e12:.3f} TFLOP) | {smi_line}",
              flush=True)
        numbers.setdefault("main", dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                        bound_by=bound_by, library_ms=lib_ms))
        numbers.setdefault("plan", dict(ms=plan_ms, plain_ms=plan_plain_ms,
                                        bound_ms=plan_bound_ms, bound_by="bytes",
                                        library_ms=None, max_abs_err=plan_err))

    # the 16- and 64-query tiles side by side, from one query to the batch,
    # each checked against the plain version: ivf_query_tile's rule
    for b in IVF_TILE_BATCHES:
        for k in (20, 30):
            args = scan_args(queries[:b], k)
            want = ivf_scan_ref(*args)
            times = []
            for q_tile in (16, 64):
                def run():
                    return _launch_scan(args[0], args[1], args[3], args[4], args[5], k,
                                        args[7], off, q_tile)
                err = max(err, check_topk(run(), want,
                                          ivf_scores(sorted_emb, args[0], cid, args[3])))
                times.append(_time_ms(run, n=3, reps=5)[0])
            m = b * index.nprobe
            print(f"ivf_scan tiles B {b} k {k} ({m / min(layout.nlist, m):.1f} queries a "
                  f"probed cluster on average): 16-query {times[0]:.4f} ms, 64-query "
                  f"{times[1]:.4f} ms, ivf_query_tile picks "
                  f"{ivf_query_tile(b, index.nprobe, layout.nlist, k)} | {smi_line}",
                  flush=True)

    # recall@10 of the single queries against exact search of the same rows
    qn = index._preprocess(queries[n_b:]).to(sorted_emb.dtype).contiguous()
    _, exact = dense_topk_kernel(sorted_emb, qn, 10)
    exact = layout.device_array("perm", dev)[exact.long()].cpu().numpy()
    recall = sum(len(set(a.tolist()) & set(b.tolist())) / 10
                 for a, b in zip(single_ids, exact)) / len(exact)
    print(f"ivf recall@10 of {len(exact)} single queries against exact search: "
          f"{recall:.4f} (nprobe {index.nprobe} of {layout.nlist}; not gated)")
    _hybrid_memory_check(dev, index, queries, seed, smi_line)
    return launches, err, numbers["main"], plan_launches, numbers["plan"]


def _hybrid_memory_check(dev, index, queries, seed: int, smi_line: str):
    """hybrid_topk over the 5,000,000-row index's original-order rows at B
    64 and 512 with a seeded sorted BM25 plan: the device memory it
    allocates above what was resident must stay below 1 GiB (the dense
    candidates scan SCAN_CHUNK rows at a time, so no f32 copy of the corpus
    forms), and its dense candidates must agree with the streaming top-k
    kernel at k = dense_k."""
    import numpy as np
    import torch

    from anorag_tpu_torch.ops.topk import (SCAN_CHUNK, _dense_candidates,
                                           dense_topk_kernel, hybrid_topk)
    from anorag_tpu_torch.testing import check_topk, flat_scores

    emb = index.flat_device_emb()
    rng = np.random.default_rng(seed + 4)
    l, dense_k = 4096, 128
    for bq in (64, BATCH):
        ids = np.sort(rng.integers(0, N_IVF, (bq, l)), axis=1)
        ids[np.arange(l)[None, :] >= rng.integers(l // 2, l + 1, (bq, 1))] = N_IVF
        w = np.where(ids < N_IVF, rng.random((bq, l)) + 0.01, 0.0).astype(np.float32)
        dr = torch.from_numpy(ids.astype(np.int32)).to(dev)
        wr = torch.from_numpy(w).to(dev)
        q = index._preprocess(queries[:bq]).to(emb.dtype).contiguous()
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        vals, hid = hybrid_topk(emb, q, dr, wr, 20, N_IVF, dense_k=dense_k,
                                sparse_m=dense_k)
        torch.cuda.synchronize(dev)
        t_h = time.perf_counter() - t
        extra = torch.cuda.max_memory_allocated(dev) - before
        if hid.shape != (bq, 20) or hid.min() < 0 or hid.max() >= N_IVF:
            raise AssertionError("hybrid_topk over the IVF corpus returned invalid ids")
        if extra >= 1 << 30:
            raise AssertionError(f"hybrid_topk at B {bq} allocated {extra / 1e9:.3f} GB "
                                 f"above the resident index, not below 1 GiB")
        err = check_topk(_dense_candidates(emb, q, dense_k, SCAN_CHUNK),
                         dense_topk_kernel(emb, q, dense_k), flat_scores(emb, q))
        print(f"hybrid_topk over {N_IVF} x {emb.shape[1]} {emb.dtype} rows at B {bq}: "
              f"{t_h:.4f} s, {extra / 1e9:.4f} GB allocated above the resident "
              f"{before / 1e9:.2f} GB (limit 1 GiB); dense candidates agree with "
              f"dense_topk_kernel at k {dense_k} (max abs err {err:.3g}) | {smi_line}",
              flush=True)


def run(dev, seed: int = 0):
    """All phases on device `dev`; returns (kernel numbers, nvidia-smi
    line, device name)."""
    import numpy as np
    import torch

    from anorag_tpu_torch import _build
    from anorag_tpu_torch.bench import card_line
    from anorag_tpu_torch.ops import bm25
    from anorag_tpu_torch.ops.bm25 import (_winners_select, gather_plan_sorted,
                                           plan_tiles, sparse_topm_winners,
                                           window_winners, window_winners_ref)
    from anorag_tpu_torch.ops.topk import hybrid_fuse
    from anorag_tpu_torch.models.embedding_manager import EmbeddingManager
    from anorag_tpu_torch.query.processor import QueryProcessor
    from anorag_tpu_torch.retrieval.retriever import max_seg_for
    from anorag_tpu_torch.serving import ServingEngine
    from anorag_tpu_torch.testing import WINDOW_CASES, sorted_plan

    t = time.perf_counter()
    # 1. device
    smi_line = card_line() or "nvidia-smi gave no output"
    kind = torch.cuda.get_device_name(dev)
    print(f"card: {smi_line} | torch: {kind} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}",
          flush=True)
    t = _phase("device", t)

    # 2. build: one nvcc for each source, all started together
    from concurrent.futures import ThreadPoolExecutor

    sources = ("window_winners", "streaming_topk", "ivf_scan", "segment_scan",
               "bucket_winners")
    with ThreadPoolExecutor(len(sources)) as pool:
        logs = dict(zip(sources, pool.map(_build.build, sources)))
    for name, log in logs.items():
        kernel = ""
        for line in log.splitlines():
            if "entry function '" in line:
                kernel = _kernel_name(line.split("'")[1])
            if "registers" in line or "spill" in line or "error" in line:
                print(f"nvcc {name} {kernel}: {line.strip()}")
        print(f"built: {name}" if log else f"{name}: cached")
    t = _phase("build", t)

    # 3. setup: corpus, embeddings and encoder weights from --seed
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in range(VOCAB)])
    doc_terms = _zipf_doc_terms(rng, N_NOTES)
    notes = [{"note_id": f"n{i}", "title": "", "content": " ".join(row)}
             for i, row in enumerate(words[doc_terms].tolist())]
    gen = torch.Generator(device=dev).manual_seed(seed)
    emb = torch.randn((N_NOTES, 1024), generator=gen, device=dev)
    emb = (emb / torch.linalg.vector_norm(emb, dim=1, keepdim=True)).to(torch.bfloat16)
    cfg = {"vector_store": {"top_k": 20}, "context": {"max_notes_for_llm": 20}}
    em = EmbeddingManager(cfg, device=dev, seed=seed)
    em.encode_queries(["draw the encoder weights"])
    qp = QueryProcessor(notes, embeddings=emb, cfg=cfg, device=dev,
                        embedding_manager=em)
    del emb
    requests = [[" ".join(words[q]) for q in _query_terms(rng, BATCH)]
                for _ in range(N_REQUESTS)]
    retriever = qp.retriever
    n_docs = len(notes)
    top_k = qp.default_top_k()
    t = _phase("setup", t)

    # 4. kernels against their plain versions on the card
    errs = []
    for case in WINDOW_CASES:
        nd, b, l, max_seg = case
        a, w = sorted_plan(np.random.default_rng(l), nd, b, l, max_seg)
        at, wt = torch.from_numpy(a).to(dev), torch.from_numpy(w).to(dev)
        errs.append(_check_winners(window_winners(at, wt, nd, max_seg),
                                   window_winners_ref(at, wt, nd, max_seg),
                                   f"window_winners {case}"))
        a3, w3 = (torch.from_numpy(x).to(dev) for x in plan_tiles(a, w, nd))
        errs.append(_check_winners(
            window_winners(a3, w3, nd, max_seg, b_valid=b),
            window_winners_ref(a3, w3, nd, max_seg, b_valid=b),
            f"window_winners tiled {case}"))
    batch = retriever.prepare(requests[0], top_k=top_k)
    dr, wr, max_seg = batch.doc_rows, batch.weight_rows, batch.max_seg
    b, l = dr.shape
    errs.append(_check_winners(window_winners(dr, wr, n_docs, max_seg),
                               window_winners_ref(dr, wr, n_docs, max_seg),
                               f"window_winners main path ({b}, {l})"))
    torch.cuda.synchronize()
    print(f"kernel check: {len(errs)} comparisons equal, max abs err {max(errs):.3g}")
    errs.append(_check_winners(bm25._launch_winners(dr, wr, n_docs, max_seg, None, "threads"),
                               window_winners_ref(dr, wr, n_docs, max_seg),
                               f"window_winners first kernel, main path ({b}, {l})"))
    torch.cuda.synchronize()
    kernel_ms, wrapper_host_ms = _time_ms(
        lambda: window_winners(dr, wr, n_docs, max_seg))
    old_ms, _ = _time_ms(lambda: bm25._launch_winners(dr, wr, n_docs, max_seg, None,
                                                      "threads"))
    plain_ms, _ = _time_ms(lambda: window_winners_ref(dr, wr, n_docs, max_seg))
    block_l = min(1024, max(l, 256))
    moved = 2 * 4 * b * l + 8 * b * block_l + 4 * b
    starts = int(((dr[:, 1:] != dr[:, :-1]) & (dr[:, :-1] < n_docs)).sum())
    starts += int((dr[:, -1] < n_docs).sum())          # the virtual pad column
    ops = b * (l + 1) + starts * (2 * max_seg - 1)
    bound_ms = 1e3 * max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
    bound_by = "bytes" if moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"
    print(f"window_winners at ({b}, {l}) max_seg {max_seg}: staged walk {kernel_ms:.4f} ms "
          f"a launch (20 back to back), first kernel {old_ms:.4f} ms, wrapper's host "
          f"path {wrapper_host_ms:.4f} ms a call, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {moved / 1e6:.1f} MB, {ops / 1e6:.1f} M ops) "
          f"| {smi_line}")
    dense_errs, scan_errs, n_plans = _check_topk_odd_shapes(dev)
    print(f"streaming top-k check: {len(dense_errs)} dense and {len(scan_errs)} IVF "
          f"odd-shape comparisons agree, max abs err {max(dense_errs + scan_errs):.3g}; "
          f"{n_plans} IVF work plans equal to their plain version")
    real_errs, dense_main = _dense_real_shapes(
        dev, retriever.index.flat_device_emb(), batch.q_emb, seed, smi_line)
    dense_errs += real_errs
    t = _phase("kernels", t)

    # 5. bucket: the bucket-winners kernel, odd shapes and the bench shape
    bucket_main, bucket_launches = _bucket_phase(
        dev, retriever.index.flat_device_emb(), batch.q_emb, smi_line)
    t = _phase("bucket", t)

    # 6. segment: the segment-scan kernels and the paths that run them
    segment_kernels = _segment_phase(dev, retriever, requests, top_k, smi_line)
    t = _phase("segment", t)

    # 7. serve: the main path, launch counts reset just before
    routed = 0
    for req in requests:
        q_terms = retriever.query_terms(req)
        width = gather_plan_sorted(retriever._lexical.postings, q_terms)[0].shape[1]
        routed += int(width >= 2048 and 0 < max_seg_for(q_terms) <= bm25.MAX_SEG)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    window_winners.launches = 0
    done_at = {}
    t_serve = time.perf_counter()
    with ServingEngine(qp, sub_batch=BATCH, depth=2) as engine:
        submitted = []
        for i, req in enumerate(requests):
            fut = engine.submit(req)
            fut.add_done_callback(lambda _f, i=i: done_at.__setitem__(i, time.perf_counter()))
            submitted.append((time.perf_counter(), fut))
        responses = [fut.result(timeout=600) for _, fut in submitted]
    t_end = max(done_at.values())
    launches = window_winners.launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    for req, resp in zip(requests, responses):
        assert len(resp) == len(req), (len(resp), len(req))
        for rows in resp:
            assert len(rows) == top_k, len(rows)
            for r in rows:
                i = int(r["note_id"][1:])
                assert 0 <= i < n_docs and r["note_id"] == notes[i]["note_id"], r["note_id"]
    if launches != routed or launches < 1:
        raise AssertionError(f"window_winners launched {launches} times on the main "
                             f"path; {routed} sub-batches were routed to it")
    lat = [done_at[i] - s for i, (s, _) in enumerate(submitted)]
    n_q = sum(len(r) for r in requests)
    print(f"served {len(requests)} x {BATCH} queries over {n_docs} notes: "
          f"window_winners launches {launches} (routed {routed}); latency per "
          f"request {', '.join(f'{x:.3f}' for x in lat)} s; "
          f"{n_q / (t_end - t_serve):.1f} queries/s; peak memory {peak_gb:.2f} GB "
          f"| {smi_line}")
    # one batch again, with the plain sparse stage
    vals_k, ids_k = retriever.search_batch(batch)
    sp = _winners_select(*window_winners_ref(dr, wr, n_docs, max_seg),
                         batch.sparse_m)
    vals_p, ids_p = hybrid_fuse(retriever.index.flat_device_emb(), batch.q_emb,
                                *sp, batch.k, n_docs=n_docs, dense_k=batch.dense_k)
    if not torch.equal(ids_k[:, :10], ids_p[:, :10]):
        raise AssertionError("top-10 ids differ between the kernel and the plain "
                             "sparse stage")
    print("plain sparse stage: top-10 ids equal on the first batch")
    t = _phase("serve", t)

    # 8. one batch stage by stage, each stage synchronised
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        stages[name] = time.perf_counter() - t0
        return out

    req = requests[-1]
    q = stage("encode", lambda: retriever.index._preprocess(
        em.encode_queries(req)).to(torch.bfloat16))
    q_terms = stage("terms", lambda: retriever.query_terms(req))
    plan = stage("host plan", lambda: gather_plan_sorted(
        retriever._lexical.postings, q_terms))
    dr1, wr1 = stage("upload", lambda: (torch.from_numpy(plan[0]).to(dev),
                                        torch.from_numpy(plan[1]).to(dev)))
    sp = stage("sparse", lambda: sparse_topm_winners(
        dr1, wr1, batch.sparse_m, n_docs, max_seg=max_seg_for(q_terms)))
    vals, ids = stage("dense+fusion", lambda: hybrid_fuse(
        retriever.index.flat_device_emb(), q, *sp, batch.k, n_docs=n_docs,
        dense_k=batch.dense_k))
    stage("finalize", lambda: retriever.hybrid_search_finalize(
        ("pending", req, vals, ids)))
    print(f"one {len(req)}-query batch by stage (s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.4f} | {smi_line}")
    t = _phase("breakdown", t)

    # 9. trace: one request through the engine under torch.profiler
    from torch.profiler import ProfilerActivity, profile

    with ServingEngine(qp, sub_batch=BATCH, depth=2) as engine:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.submit(requests[0]).result(timeout=600)
            torch.cuda.synchronize(dev)
            wall_ms = 1e3 * (time.perf_counter() - t0)
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if on_card:
        by_name = {}
        for e in on_card:
            span = (e.time_range.end - e.time_range.start) / 1e3
            by_name[e.name] = by_name.get(e.name, 0.0) + span
        busy = _busy_ms(on_card)
        ww = sum(v for k, v in by_name.items() if "window_winners_staged" in k)
        print(f"trace of one {BATCH}-query request: wall {wall_ms:.2f} ms, device busy "
              f"{busy:.2f} ms, idle share {1 - busy / wall_ms:.4f}; window_winners "
              f"kernels {ww:.4f} ms | {smi_line}")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            print(f"  device {ms:9.3f} ms  {name[:140]}")
    else:
        print("trace: no device events recorded; idle share not measured")
    t = _phase("trace", t)

    # 10. search: VectorRetriever.search / retrieve through the top-k kernel
    dense_launches = _search_phase(dev, em, notes, retriever.index.flat_device_emb(),
                                   requests[1:3], smi_line)
    t = _phase("search", t)

    # 11. bench: the port's benchmark entry point, in-process
    for name, count in _bench_phase(dev, smi_line).items():
        bucket_launches[name] += count
    idle = [name for name, count in bucket_launches.items() if count < 1]
    if idle:
        raise AssertionError(f"the bucket phase and the bench launched no bucket "
                             f"kernel {idle}: {bucket_launches}")
    t = _phase("bench", t)

    # 12. ivf: the default IVFFlat index at 5,000,000 rows
    ivf_launches, ivf_err, ivf_main, plan_launches, plan_main = _ivf_phase(
        dev, seed, smi_line)
    scan_errs.append(ivf_err)
    t = _phase("ivf", t)

    return {"kernels": [{
        "name": "bm25_window_winners", "route": "cuda",
        "source": "anorag_tpu_torch/csrc/window_winners.cu",
        "replaces": "anorag_tpu/ops/bm25.py:404",
        "design": "a staged walk per bucket range: a CTA a row and a range of "
                  "buckets walks the blocks in order behind a 4-stage cp.async "
                  "ring (the range and a 32-position halo), taps from registers "
                  "and shared memory, the row max by atomicMax in the one launch",
        "launches": launches, "max_abs_err": max(errs),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None, "old_ms": old_ms,
    }, {
        "name": "dense_topk", "route": "cuda",
        "source": "anorag_tpu_torch/csrc/streaming_topk.cu",
        "design": "128-row sub-tiles; from 48 queries 128-query tiles at k <= "
                  "32 with 16-byte rows on wgmma m64n128k16 (two consumer "
                  "warpgroups) behind a 4-stage TMA ring of 64 columns with a "
                  "producer thread and mbarriers; 64-query tiles at k <= 128 "
                  "from 64 queries (from one on rows that are not 16-byte "
                  "aligned) on mma.sync (16 warps, 3-stage cp.async ring of "
                  "64 columns); "
                  "both after a seed pass over 512 k rows; else 16-query tiles "
                  "on mma.sync (8 warps; bf16 4 stages of 128 columns to k "
                  "512, 2 above; f32 6 stages of 32, 4 above); one CTA an SM; "
                  "one selection on the accumulators for both kernels, "
                  "survivors to candidate buffers merged by a bitonic sort and "
                  "merge path; units of one wave, the query tiles of a corpus "
                  "range side by side",
        "replaces": "anorag_tpu/ops/topk.py:40",
        "launches": dense_launches, "max_abs_err": max(dense_errs), **dense_main,
    }, {
        "name": "ivf_scan", "route": "cuda",
        "source": "anorag_tpu_torch/csrc/ivf_scan.cu",
        "design": "each probed cluster scanned once per tile of the queries "
                  "that probe it; mma.sync tiles of 64 queries (16 at k > 128 "
                  "or a small batch) behind a cp.async ring of 2 stages at 64 "
                  "queries, 3 at 16",
        "replaces": "anorag_tpu/ops/ivf.py:119",
        "launches": ivf_launches, "max_abs_err": max(scan_errs), **ivf_main,
    }, {
        "name": "ivf_work_plan", "route": "cuda",
        "source": "anorag_tpu_torch/csrc/ivf_scan.cu",
        "design": "part of ivf_scan, not a counterpart of its own: the scan's "
                  "work plan in one CTA, sel inverted into 64- or 16-query "
                  "tiles of one cluster and about equal units",
        "part_of": "ivf_scan",
        "replaces": "anorag_tpu/ops/ivf.py:119",
        "launches": plan_launches, **plan_main,
    }, *segment_kernels, {
        "name": "bucket_winners", "route": "cuda",
        "source": "anorag_tpu_torch/csrc/bucket_winners.cu",
        "design": "the wgmma route (bf16, 16-byte rows, W a multiple of 128): "
                  "units of 128 queries x 128 bucket columns x a split of the "
                  "corpus tiles filling one wave; a producer thread keeps a "
                  "5-stage TMA ring of 64-column slices, two consumer "
                  "warpgroups run wgmma m64n128k16 and take the bucket max on "
                  "the accumulators (setmaxnreg: consumers 232 registers)",
        "replaces": "anorag_tpu/ops/topk.py:172",
        "launches": bucket_launches["wgmma"], **bucket_main["wgmma"],
    }, {
        "name": "bucket_winners_mma", "route": "cuda",
        "source": "anorag_tpu_torch/csrc/bucket_winners.cu",
        "design": "the first kernel, the route for f32 (FMAs), the transposed "
                  "corpus, unaligned rows and W not a multiple of 128: 32-query "
                  "x 64-column tiles, mma.sync m16n8k16, a 3-stage cp.async ring",
        "part_of": "bucket_winners",
        "replaces": "anorag_tpu/ops/topk.py:172",
        "launches": bucket_launches["mma"], **bucket_main["mma"],
    }, {
        "name": "bucket_merge", "route": "cuda",
        "source": "anorag_tpu_torch/csrc/bucket_winners.cu",
        "design": "part of bucket_winners: the wgmma route's split tables "
                  "merged per cell by strict > in split order",
        "part_of": "bucket_winners",
        "replaces": "anorag_tpu/ops/topk.py:172",
        "launches": bucket_launches["merge"], **bucket_main["merge"],
    }]}, smi_line, kind


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the corpus, the queries and the weights")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    try:
        import torch

        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device; this check runs only on the GPU",
                  file=sys.stderr)
            return 2
        kernels, smi_line, kind = run(torch.device("cuda", 0), seed=args.seed)
    except Exception:
        traceback.print_exc()
        return 1
    print(f"total: {time.perf_counter() - t0:.2f} s")
    print(json.dumps(kernels))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
