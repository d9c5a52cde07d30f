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
                vocabulary (40 terms a note), its last six notes replaced
                by the multi-hop KB of testing.kb_notes, 1024-wide unit
                embeddings and the full-width encoder (24 layers, hidden
                1024, bf16), all from --seed, data and weights made on the
                card; the first three queries of request 0 are the KB
                questions (testing.KB_QUESTIONS); the notes come four
                paragraphs a document; the QueryProcessor's constructor
                builds the note graph (relation extraction, its semantic
                self-join through the streaming top-k kernel, build_csr,
                PageRank on the card) and the entity index, each part
                timed, the kernel's launches counted from 0;
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
                content-band terms each) through the answer stages: every
                answer carries the reference's keys (query, answer,
                predicted_answer, predicted_support_idxs,
                predicted_answerable, answer_method, notes), its notes are
                top_k rows of valid note ids, and the KB questions get the
                reference's answers (Chris Reed by the answer selector,
                David Kim, insufficient information and not answerable);
                the kernels' launch counts, reset just before, match the
                batches routed to them; one batch again with the plain
                sparse stage gives the same top-10 ids; answered queries/s,
                latency, the count of each answer method, peak memory;
  8. breakdown -- one batch again, stage by stage (encode, host plan,
                upload, sparse, dense + fusion, finalize, answer: the
                answer stages of QueryProcessor._assemble_batch, whose
                text caches the serve phase warmed), synchronised; then
                the answer stages on a fresh 512-query batch, on each KB
                question alone, and the corpus-wide scans the KB
                questions reach (NoteGraph.seed_recall, the note-id map,
                the exact-math pool), host seconds;
  9. trace   -- one request through a ServingEngine under torch.profiler:
                the device's busy time and idle share, the window-winners
                kernels' own time, and the largest device kernels;
  10. process -- the per-query pipeline (QueryProcessor.process) on the
                same processor: the graph build's parts and times, its
                edges by relation type, the self-join's launches (one per
                32,768 queries); the self-join route (f32 unit rows, k 6)
                against dense_topk_ref on 512 random rows and the first
                8,192 as queries (testing.check_topk), timed at 8,192
                beside its plain version, torch.matmul + torch.topk and
                its bound (f32 peak outside the tensor cores); the KB
                questions through process() with the reference's answers,
                the first again on the sub-question path; 32 Zipf queries'
                latency (median, p90) and each stage's host time; one
                process() under torch.profiler (device busy time, idle
                share);
  11. offline -- the offline knowledge-base build of `python -m
                anorag_tpu_torch.main process` in-process: 200 synthetic
                MuSiQue-style items (scripts/gen_synth_musique.py, 40
                paragraphs each, drawn from --seed in a subprocess), --no-llm,
                the full-width encoder with seeded weights, on the card; each
                stage timed (chunks, rule notes, embeddings, clustering with
                its auto-K, relation extraction, the self-join and its
                launches, build_csr, PageRank, graph.json, GraphML, the
                consistency gate), the build traced for its idle share; the
                counts (paragraphs, chunks, notes, clusters, edges by type);
                gates: every artifact of result.json written, the report
                consistent, more than 20,000 notes, the self-join's top-k
                kernel launches equal to ceil(notes / 32,768), its top 6 on
                512 rows against dense_topk_ref (testing.check_topk) and its
                launch at the build's shape timed beside the plain version,
                torch.matmul + torch.topk (f32, no TF32) and the bound; a
                second `process` of the same file all cache hits with every
                artifact's SHA1 unchanged; `main query`'s QueryProcessor over
                the work dir answering the first 64 items' questions through
                process() with the reference's keys (latency median and p90,
                answer methods, exact match against the gold answers and
                aliases, printed, not gated: the encoder's weights are
                random); a VectorRetriever over the built notes and
                embeddings: save -> load equal retrieve ids and scores (1e-6)
                for 32 questions, 100 notes removed and added back giving the
                same top-10 sets, the namespace fallback with one item's doc
                id giving notes of that doc only, the lexical fallback's hits;
                peak device memory and the host's peak RSS;
  12. llm    -- the LLM layer and the decoder LM: seeded weights at
                checkpoints/note_lm_tpu_large's shape (6 layers, hidden 384,
                8 heads, FFN 1536, max_len 2048; f32) written with save_lm
                into a temporary directory; prefill and 64 decode steps on
                the card against the CPU at B 1 and 8 (logits to atol 1e-4,
                greedy tokens equal: testing.decoder_parity); prefill ms at
                B 1 and 8, pb 256 and 1024, a decode step's device and wall
                ms and generated bytes/s beside its bound (the weights and
                all max_len K/V columns over HBM bandwidth); setup's KB
                written as a work dir (atomic_notes.json, embeddings.npy,
                graph.json) and served by serve.build_processor(no_llm=
                False) with llm.provider jax and answer_selector.
                apply_before_llm off (LocalLLM -> LLMFactory -> the decoder
                provider), llm.max_output_tokens 64 (256 decode steps a
                call); the KB questions and 3 Zipf queries through
                process() (host s a query by stage, the LLM's share; the KB
                answers equal to the same processor's without the LLM where
                EFSA rescues them), one request of 4 through a
                ServingEngine, one /query over HTTP at the config's 512
                tokens (1,024 steps a call at pb 1,024), 8 concurrent
                OllamaClient requests to serve_llm's batcher (one batch);
                every query that reaches the LLM stage answered by method
                llm, the LLM called in every part, every decode step's
                logits finite, hand kernels' launches counted from 0 (the
                served request's window winners); one process() profiled
                at llm.max_output_tokens 16 (idle share);
  13. http   -- the port's HTTP server (anorag_tpu_torch/serve.py) on
                127.0.0.1 over the same QueryProcessor, its engine at the
                config defaults (sub-batch 64, depth 3): /healthz; /search
                with a KB question gives qp.retriever.retrieve's note ids;
                /query answers the Blue Horizon question with Chris Reed;
                /query with a qid (process()) answers the KB questions as
                the process phase did (answer, support, method, notes);
                /query_batch answers request 0 with the contract keys and
                the KB answers; each call's latency, and how many of
                request 0's answers equal the serve phase's (they may
                differ only where the 64-query batches' note lists do);
  14. search -- a VectorRetriever with use_kernel=True over the same notes
                and embeddings: search for one 512-query request at top_k
                20 and retrieve for 32 single queries at top_k 10 (fetch 30,
                the /search endpoint's traffic); the top-k kernel's
                launches, reset just before, equal the calls; latency, QPS;
                then the same traffic through the default route
                (use_kernel None: chunked matmul + exact top-k, what
                QueryProcessor's retriever takes below 5,000,000 notes),
                its scores equal to the kernel route's to 1e-5;
  15. bench  -- the port's benchmark entry point in-process
                (anorag_tpu_torch/bench.py): kernel_parity, bench_hybrid at
                200,000 docs with its recall gate (recall@10 against exact
                f32 at least 0.985) and bench_encoder, their JSON on one
                line; every kernel they reach, counted from 0, launched;
  16. ivf    -- a default VectorIndex(index_type="IVFFlat") (nlist 20,
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
Then one JSON line of kernel numbers (dense_topk's launches count both
graph builds' self-joins; dense_topk_f32_self_join and
dense_topk_f32_offline_self_join hold their shapes), the
nvidia-smi line, and last
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
from collections import Counter

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 on the tensor cores
L2_FLUSH_BYTES = 256 << 20     # written between timed calls to empty the 50 MB L2
VOCAB, DOC_LEN, Q_LEN, MIN_RANK = 30_000, 40, 8, 100
N_NOTES, N_REQUESTS, BATCH = 200_000, 4, 512
N_PROCESS = 32                 # Zipf queries through QueryProcessor.process
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
# (base, row, cosine): near duplicates planted in setup's random unit rows,
# whose cosines lie about 22 standard deviations below the relation
# extractor's 0.7 threshold: a group of 9 (more neighbours above it than a
# note's top 6 keeps), two pairs above it either way round, two below; the
# rows 4 apart, so that no two share a document and a context edge
PLANTED = tuple((1000, 1000 + 4 * m, 0.97 - 0.02 * (m - 1)) for m in range(1, 9)) + (
    (5000, 5004, 0.8), (5012, 5008, 0.8), (6000, 6004, 0.6), (6012, 6008, 0.62))


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


def _union_ms(spans, per_ms: float) -> float:
    """Length of the union of (start, end) intervals, in ms (per_ms time
    units a millisecond)."""
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / per_ms


def _busy_ms(events) -> float:
    """Union of the device intervals of profiler events, in ms."""
    return _union_ms(((e.time_range.start, e.time_range.end) for e in events), 1e3)


def _kineto_busy_ms(prof) -> tuple:
    """(device busy ms, device events) of a finished torch.profiler run,
    read from its raw kineto events: the parse behind prof.events() takes
    minutes on the hundreds of thousands of kernels of a long run."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
             if e.device_type() == cuda]
    return _union_ms(spans, 1e6), len(spans)


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


# what QueryProcessor.process_batch returns for each query (the reference's
# anorag_tpu/query/processor.py:365-373)
ANSWER_KEYS = {"query", "answer", "predicted_answer", "predicted_support_idxs",
               "predicted_answerable", "answer_method", "notes"}
# what the HTTP /query_batch endpoint returns for each query
HTTP_BATCH_KEYS = {"query", "answer", "predicted_support_idxs", "answer_method"}


def _check_answers(queries, answers, notes, top_k: int) -> None:
    """One answer dict per query, in order, with the reference's keys; its
    notes top_k rows of valid note ids."""
    if len(answers) != len(queries):
        raise AssertionError(f"{len(answers)} answers for {len(queries)} queries")
    for q, a in zip(queries, answers):
        if set(a) != ANSWER_KEYS or a["query"] != q or a["predicted_answer"] != a["answer"]:
            raise AssertionError(f"answer {sorted(a)} for {q!r}")
        if len(a["notes"]) != top_k:
            raise AssertionError(f"{len(a['notes'])} notes for {q!r}, not {top_k}")
        for r in a["notes"]:
            i = int(r["note_id"][1:])
            if not (0 <= i < len(notes) and r["note_id"] == notes[i]["note_id"]):
                raise AssertionError(f"note id {r['note_id']} for {q!r}")


def _check_kb_answers(answers, where: str) -> None:
    """The first answers are the KB questions': the reference's answers,
    method and answerability where it states them."""
    from anorag_tpu_torch.testing import KB_QUESTIONS

    for a, (q, answer, method, answerable) in zip(answers, KB_QUESTIONS):
        got = (a["answer"], a.get("answer_method"), a.get("predicted_answerable", answerable))
        want = (answer, method or a.get("answer_method"), answerable)
        if a["query"] != q or got != want:
            raise AssertionError(f"{where}: {q!r} answered {got}, expected {want}")


def _answer_costs(qp, request, rng, words, top_k: int, notes, smi_line: str) -> None:
    """The answer stages' host seconds where the breakdown's warm caches do
    not reach: a fresh batch (queries never served, so the tokenizer's
    caches hold none of their notes), each KB question alone, and the
    corpus-wide scans those questions reach."""
    from anorag_tpu_torch.testing import KB_QUESTIONS

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    fresh = [" ".join(words[q]) for q in _query_terms(rng, BATCH)]
    rows = qp.retriever.hybrid_search_finalize(
        qp.retriever.hybrid_search_dispatch(fresh, top_k=top_k))
    answers, cold_s = timed(lambda: qp._assemble_batch(rows, fresh, None))
    _check_answers(fresh, answers, notes, top_k)
    kb = request[:len(KB_QUESTIONS)]
    rows = qp.retriever.hybrid_search_finalize(
        qp.retriever.hybrid_search_dispatch(kb, top_k=top_k))
    per_q = []
    for row, q in zip(rows, kb):
        per_q.append(timed(lambda: qp._assemble_batch([row], [q], None))[1])
    _check_kb_answers(qp._assemble_batch(rows, kb, None), "breakdown")
    _, recall_s = timed(lambda: qp.note_graph.seed_recall(KB_QUESTIONS[1][0], top_k=5))
    _, id_map_s = timed(lambda: {n["note_id"]: n for n in qp.notes})
    _, pool_s = timed(lambda: list(rows[0]) + list(qp.note_graph.notes.values()))
    print(f"answer stages (host s): fresh {len(fresh)}-query batch {cold_s:.4f} "
          f"({1e3 * cold_s / len(fresh):.3f} ms a query); KB questions alone "
          + ", ".join(f"{q[:34]!r} {dt:.4f}" for q, dt in zip(kb, per_q))
          + f"; corpus-wide scans over {len(qp.notes)} notes: seed_recall "
          f"{recall_s:.4f}, id_to_note {id_map_s:.4f}, exact-math pool {pool_s:.4f} "
          f"| {smi_line}")


def _http_phase(qp, request, served, kb_process, notes, top_k: int,
                smi_line: str) -> None:
    """The port's HTTP server over qp with its engine at the config
    defaults; each endpoint checked, its latency printed. /query with a qid
    runs process(): the KB questions' answers, support, method and first
    notes must equal kb_process's (the process phase's)."""
    import threading
    import urllib.request

    from anorag_tpu_torch.serve import Server, make_handler
    from anorag_tpu_torch.serving import ServingEngine
    from anorag_tpu_torch.testing import KB_QUESTIONS

    sub_batch = int(qp.cfg.get("serving.stream_batch"))
    depth = int(qp.cfg.get("serving.stream_depth"))
    engine = ServingEngine(qp, sub_batch=sub_batch, depth=depth)
    server = Server(("127.0.0.1", 0), make_handler(qp, engine))
    thread = threading.Thread(target=server.serve_forever, name="http-smoke")
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    lat = {}

    def call(path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(url + path, data=data,
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            body = json.loads(r.read())
            code = r.status
        lat[path] = time.perf_counter() - t0
        if code != 200:
            raise AssertionError(f"{path}: HTTP {code} {body}")
        return body

    blue = KB_QUESTIONS[0][0]
    try:
        health = call("/healthz")
        if health != {"status": "ok", "n_notes": len(notes)}:
            raise AssertionError(f"/healthz: {health}")
        got = [n["note_id"] for n in call("/search", {"query": blue, "top_k": 10})["notes"]]
        want = [n["note_id"] for n in qp.retriever.retrieve(blue, top_k=10, threshold=0.0)]
        if got != want:
            raise AssertionError(f"/search ids {got} != retrieve's {want}")
        one = call("/query", {"query": blue, "top_k": 5})
        if one["answer"] != KB_QUESTIONS[0][1] or len(one["notes"]) != 5:
            raise AssertionError(f"/query answered {one['answer']!r} with "
                                 f"{len(one['notes'])} notes")
        lat["/query engine"] = lat["/query"]
        for i, (q, *_) in enumerate(KB_QUESTIONS):
            got = call("/query", {"query": q, "qid": f"kb{i}", "top_k": 5})
            want = kb_process[i]
            same = (got["answer"], got["predicted_support_idxs"], got["answer_method"],
                    [n["note_id"] for n in got["notes"]]) == (
                want["answer"], want["predicted_support_idxs"], want["answer_method"],
                [n["note_id"] for n in want["notes"][:5]])
            if not same:
                raise AssertionError(f"/query with a qid answered {q!r} with "
                                     f"{got['answer']!r}, process() {want['answer']!r}")
        lat["/query qid"] = lat.pop("/query")
        results = call("/query_batch", {"queries": request, "top_k": top_k})["results"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
        engine.close()
    if len(results) != len(request):
        raise AssertionError(f"/query_batch: {len(results)} results for {len(request)}")
    for q, r in zip(request, results):
        if set(r) != HTTP_BATCH_KEYS or r["query"] != q:
            raise AssertionError(f"/query_batch result keys {sorted(r)} for {q!r}")
    _check_kb_answers(results, "/query_batch")
    # the note lists the server's 64-query batches give (the same dispatch
    # and rerank, without the answer stages)
    at_sub = []
    for i in range(0, len(request), sub_batch):
        chunk = request[i:i + sub_batch]
        rows = qp.retriever.hybrid_search_finalize(
            qp.retriever.hybrid_search_dispatch(chunk, top_k=top_k))
        at_sub += [[n["note_id"] for n in qp._post_select_processing(r, r, q)]
                   for r, q in zip(rows, chunk)]
    notes_differ = {i for i, a in enumerate(served)
                    if [n["note_id"] for n in a["notes"]] != at_sub[i]}
    answers_differ = {i for i, (a, r) in enumerate(zip(served, results))
                      if (a["answer"], a["predicted_support_idxs"], a["answer_method"])
                      != (r["answer"], r["predicted_support_idxs"], r["answer_method"])}
    if answers_differ - notes_differ:
        raise AssertionError(f"/query_batch answers differ from the serve phase's where "
                             f"the note lists are equal: {sorted(answers_differ - notes_differ)}")
    print(f"http at sub-batch {sub_batch}, depth {depth}: latency /healthz "
          f"{lat['/healthz']:.4f} s, /search {lat['/search']:.4f}, /query "
          f"{lat['/query engine']:.4f}, /query with a qid (process(), the last KB "
          f"question; answers equal to process()'s) {lat['/query qid']:.4f}, "
          f"/query_batch ({len(request)} queries) "
          f"{lat['/query_batch']:.4f}; request 0's answers equal to the serve "
          f"phase's {len(request) - len(answers_differ)} of {len(request)}; note "
          f"lists differ at batch {sub_batch} from batch {len(request)} for "
          f"{len(notes_differ)} | {smi_line}")


# the graph build's parts that setup times: (module of anorag_tpu_torch,
# its class or None, the function, the name printed)
_REL = ("graph.relation_extractor", "RelationExtractor")
GRAPH_PARTS = (
    (*_REL, "extract_all_relations", "relations"),
    (*_REL, "_reference_relations", "reference"),
    (*_REL, "_source_context", "context"),
    (*_REL, "_semantic_similarity", "semantic"),
    (*_REL, "_device_topk", "self-join"),
    (*_REL, "_dedup_and_cap", "dedup"),
    ("graph.graph_index", None, "build_csr", "build_csr"),
    ("graph.graph_index", None, "pagerank", "pagerank"),
    ("graph.builder", "GraphBuilder", "build_graph", "graph total"),
    ("index.entity_index", "EntityInvertedIndex", "build_index", "entity index"),
    ("graph.retriever", "GraphRetriever", "_ensure_indexes", "graph token index"),
)
# process()'s stages whose host time the process phase sums, by attribute
# path on the QueryProcessor
PROCESS_STAGES = ("retriever.search", "bm25.topk", "_enhanced_hybrid_search_v2",
                  "_two_hop_expansion", "path_ranker.rerank_candidates",
                  "recall_optimizer.optimize_recall", "multi_hop.retrieve",
                  "_filter_with_multihop_safety", "dispatcher.dispatch",
                  "_post_select_processing", "_answer", "_write_final_recall")
# what QueryProcessor.process returns (the reference's
# anorag_tpu/query/processor.py:533-544)
PROCESS_KEYS = ANSWER_KEYS | {"candidate_notes", "context", "trace"}


def _timer(fn, name: str, times: dict, sync: bool):
    """fn wrapped to add its seconds (the card synchronised after it when
    `sync`) to times[name]."""
    import functools

    import torch

    @functools.wraps(fn)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if sync:
            torch.cuda.synchronize()
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0
        return out

    return timed


def _time_parts(times: dict, parts=GRAPH_PARTS):
    """Wrap `parts` ((module, class or None, attribute, name), GRAPH_PARTS
    by default) with timers adding to `times`, the card synchronised after
    each; returns the function that takes the timers out again."""
    import importlib

    undo = []
    for mod, cls, attr, name in parts:
        owner = importlib.import_module(f"anorag_tpu_torch.{mod}")
        if cls:
            owner = getattr(owner, cls)
        fn = owner.__dict__[attr]
        undo.append((owner, attr, fn))
        setattr(owner, attr, _timer(fn, name, times, sync=True))

    def restore():
        for owner, attr, fn in undo:
            setattr(owner, attr, fn)

    return restore


def _time_process_stages(qp, times: dict):
    """Wrap process()'s stages (PROCESS_STAGES) on qp's objects with host
    timers adding to `times`; returns the function that removes them."""
    undo = []
    for path in PROCESS_STAGES:
        *owners, attr = path.split(".")
        obj = qp
        for o in owners:
            obj = getattr(obj, o)
        setattr(obj, attr, _timer(getattr(obj, attr), path, times, sync=False))
        undo.append((obj, attr))

    def restore():
        for obj, attr in undo:
            delattr(obj, attr)

    return restore


def _plant(emb, gen) -> None:
    """Plant PLANTED's near duplicates in the (N, D) f32 unit rows emb:
    row = cos * base + sin * (unit noise orthogonal to base)."""
    import torch

    for base, row, cos in PLANTED:
        e = emb[base]
        noise = torch.randn(e.shape, generator=gen, device=emb.device)
        noise -= (noise @ e) * e
        emb[row] = cos * e + (1 - cos * cos) ** 0.5 * noise / torch.linalg.vector_norm(noise)


def _check_semantic_edges(gi, unit, threshold: float, k: int) -> tuple:
    """The graph's semantic edges are exactly the reference's rule on
    PLANTED's rows (row j among note i's top k by cosine, at least the
    threshold, i < j), with similarities equal to their numpy cosines to
    1e-5; that rule may stop at the planted rows because no other row
    comes near one. Returns (edges, largest similarity error)."""
    import numpy as np
    import torch

    rows = sorted({r for base, row, _ in PLANTED for r in (base, row)})
    sel = torch.tensor(rows, device=unit.device)
    near = unit[sel] @ unit.T
    near[:, sel] = -1.0
    if float(near.max()) >= threshold:
        raise AssertionError(f"a planted row has a cosine {float(near.max())} with a "
                             f"row outside PLANTED")
    x = gi.embeddings[sel].cpu().numpy()
    x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-9)
    cos = x @ x.T
    want = {}
    for a, i in enumerate(rows):
        for b in np.argsort(-cos[a], kind="stable")[:k]:
            if rows[b] > i and cos[a, b] >= threshold:
                want[(i, rows[b])] = float(cos[a, b])
    got = {(r["source"], r["target"]): r["similarity"] for r in gi.edge_meta
           if r["relation_type"] == "semantic_similarity"}
    if set(got) != set(want):
        raise AssertionError(f"semantic edges {sorted(got)}, want {sorted(want)}")
    err = max(abs(got[e] - want[e]) for e in want)
    if err > 1e-5:
        raise AssertionError(f"semantic edge similarities off their numpy cosines by {err}")
    return len(want), err


def _process_phase(dev, qp, graph_times: dict, build_launches: int, rng, words,
                   smi_line: str):
    """The per-query pipeline on setup's processor: the graph build's parts
    and its semantic edges on the planted rows, the self-join route at the
    build's launches against its plain version and timed, the KB
    questions through process() (once more on the sub-question path), 32
    Zipf queries' latency and stage times, one process() under
    torch.profiler. Returns (the self-join's kernel numbers, the KB
    questions' process() answers)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from anorag_tpu_torch.graph.relation_extractor import (SEMANTIC_QUERY_CHUNK,
                                                           RelationExtractor)
    from anorag_tpu_torch.ops.topk import dense_topk_kernel, dense_topk_ref
    from anorag_tpu_torch.testing import KB_QUESTIONS, check_topk, flat_scores

    # 1. the graph the constructor built
    gi = qp.multi_hop.graph_index
    by_type = Counter(r["relation_type"] for r in gi.edge_meta)
    n = len(qp.notes)
    print(f"graph build over {n} notes (host s, the card synchronised after each "
          f"part): " + ", ".join(f"{k} {v:.3f}" for k, v in graph_times.items())
          + f"; {gi.graph.n_edges} edges by type {dict(by_type.most_common())}, "
          f"semantic {by_type.get('semantic_similarity', 0)}; self-join launches "
          f"{build_launches} ({SEMANTIC_QUERY_CHUNK} queries each, the last "
          f"{n - (n - 1) // SEMANTIC_QUERY_CHUNK * SEMANTIC_QUERY_CHUNK}) | {smi_line}",
          flush=True)
    want_launches = -(-n // SEMANTIC_QUERY_CHUNK)
    if build_launches != want_launches:
        raise AssertionError(f"the graph build launched the top-k kernel "
                             f"{build_launches} times, not {want_launches}")
    if gi.embeddings is not qp.embeddings:
        raise AssertionError("the graph holds a second copy of the corpus embeddings")
    ex = RelationExtractor(device=dev)
    k = ex.max_semantic_edges + 1
    unit = qp.embeddings / torch.linalg.vector_norm(qp.embeddings, dim=1,
                                                    keepdim=True).clamp_min(1e-9)
    n_semantic, sim_err = _check_semantic_edges(gi, unit, ex.semantic_threshold, k)
    print(f"semantic edges: the {n_semantic} that the reference's rule gives on the "
          f"{len(PLANTED)} planted near duplicates and none else, similarities "
          f"within {sim_err:.3g} of numpy's cosines", flush=True)

    # 2. the self-join route (f32 unit rows against themselves, k 6) at the
    # build's launches: its first chunk (which holds the planted rows) and
    # its last, shorter one, each over all rows, and 512 rows from across
    # the corpus; timed at a whole chunk
    chunk = unit[:SEMANTIC_QUERY_CHUNK]
    tail = unit[(n - 1) // SEMANTIC_QUERY_CHUNK * SEMANTIC_QUERY_CHUNK:]
    rows = torch.from_numpy(np.sort(rng.choice(n, 512, replace=False))).to(dev)
    err = 0.0
    for q in (unit[rows].contiguous(), chunk, tail):
        err = max(err, check_topk(dense_topk_kernel(unit, q, k), dense_topk_ref(unit, q, k),
                                  flat_scores(unit, q)))
    ms, _ = _time_ms(lambda: dense_topk_kernel(unit, chunk, k), n=1, reps=3, warm=1)
    plain_ms, _ = _time_ms(lambda: dense_topk_ref(unit, chunk, k), n=1, reps=3, warm=1)
    lib_ms, _ = _time_ms(lambda: torch.topk(torch.matmul(chunk, unit.T), k), n=1,
                         reps=3, warm=1)
    bound_ms, bound_by = _topk_bound(chunk.shape[0], n, unit.shape[1], k, 4)
    full_bound, _ = _topk_bound(n, n, unit.shape[1], k, 4)
    print(f"self-join route (f32, k {k}) against dense_topk_ref: the build's first "
          f"launch ({chunk.shape[0]} queries), its last ({tail.shape[0]}) and 512 of the "
          f"{n} rows as queries agree, max abs err {err:.3g}; at {chunk.shape[0]} x {n} "
          f"x {unit.shape[1]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.matmul + torch.topk {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}, f32 at {F32_OPS_PER_S / 1e12:.0f} TFLOP/s outside the tensor "
          f"cores); the build's whole self-join {graph_times.get('self-join', 0.0):.4f} "
          f"s in {build_launches} launches, bound {full_bound / 1e3:.4f} s | {smi_line}",
          flush=True)
    del unit, chunk, tail

    # 3. the KB questions through process(), one again on the sub-question path
    kb, kb_s = [], []
    for i, (q, *_) in enumerate(KB_QUESTIONS):
        t0 = time.perf_counter()
        kb.append(qp.process(q, qid=f"kb{i}"))
        kb_s.append(time.perf_counter() - t0)
    for a in kb:
        if not PROCESS_KEYS <= set(a) or a["predicted_answer"] != a["answer"]:
            raise AssertionError(f"process: keys {sorted(a)} for {a['query']!r}")
    _check_kb_answers(kb, "process")
    qp.cfg.set("query.use_subquestion_decomposition", True)
    try:
        sub = qp.process(KB_QUESTIONS[0][0])
    finally:
        qp.cfg.set("query.use_subquestion_decomposition", False)
    if sub["answer"] != KB_QUESTIONS[0][1] or not sub.get("sub_questions"):
        raise AssertionError(f"sub-question path answered {sub['answer']!r} "
                             f"with sub-questions {sub.get('sub_questions')}")
    print(f"process(): KB questions answered " + ", ".join(
        f"{a['answer']!r} ({a['answer_method']}, {dt:.4f} s)" for a, dt in zip(kb, kb_s))
          + f"; on the sub-question path {sub['answer']!r} from "
          f"{len(sub['sub_questions'])} sub-questions; the graph's token index, "
          f"built in the first process(), {graph_times.get('graph token index', 0.0):.3f} "
          f"s of it | {smi_line}", flush=True)

    # 4. 32 Zipf queries: latency and each stage's host time
    queries = [" ".join(words[t]) for t in _query_terms(rng, N_PROCESS)]
    stage_s: dict = {}
    restore = _time_process_stages(qp, stage_s)
    lat = []
    try:
        for query in queries:
            t0 = time.perf_counter()
            a = qp.process(query)
            lat.append(time.perf_counter() - t0)
            if not PROCESS_KEYS <= set(a) or not a["notes"]:
                raise AssertionError(f"process({query!r}) gave keys {sorted(a)} and "
                                     f"{len(a['notes'])} notes")
    finally:
        restore()
    lat_s = sorted(lat)
    print(f"process() over {N_PROCESS} Zipf queries: latency median "
          f"{lat_s[len(lat_s) // 2]:.4f} s, p90 {lat_s[int(0.9 * len(lat_s))]:.4f} s, "
          f"max {lat_s[-1]:.4f} s; host s a query by stage (fusion counts its calls "
          f"inside the two-hop stage too): " + ", ".join(
              f"{k} {v / N_PROCESS:.4f}" for k, v in stage_s.items())
          + f" | {smi_line}", flush=True)

    # 5. one process() under torch.profiler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        qp.process(queries[0])
        torch.cuda.synchronize(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if on_card:
        busy = _busy_ms(on_card)
        print(f"trace of one process(): wall {wall_ms:.2f} ms, device busy "
              f"{busy:.2f} ms, idle share {1 - busy / wall_ms:.4f}, "
              f"{len(on_card)} device events | {smi_line}", flush=True)
    else:
        print("trace of one process(): no device events recorded; idle share "
              "not measured")
    return dict(launches=build_launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms), kb


# the offline phase: the knowledge-base build of `main process`
OFFLINE_ITEMS = 200            # synthetic MuSiQue-style items, 40 paragraphs each
OFFLINE_MIN_NOTES = 20_000     # above this the self-join runs on the card (SEMANTIC_HOST_ROWS)
OFFLINE_QUERIES = 64           # items whose questions go through process()
OFFLINE_RETRIEVE = 32          # questions of the retriever's round trips
OFFLINE_REMOVED = 100          # notes removed and added back
_DOC = "doc.processor"
OFFLINE_PARTS = (
    ("doc.chunker", "DocumentChunker", "chunk_file", "chunks"),
    (_DOC, "_RuleNoteGenerator", "generate_atomic_notes", "rule notes"),
    (_DOC, None, "resolve_note_abbreviations", "abbreviations"),
    ("models.embedding_manager", "EmbeddingManager", "encode_atomic_notes", "embeddings"),
    ("doc.clustering", "TopicClustering", "cluster_notes", "clustering"),
    ("doc.clustering", None, "auto_k", "auto-K"),
    ("graph.builder", "GraphBuilder", "build_graph_with_metrics", "graph"),
    (*_REL, "extract_all_relations", "relations"),
    (*_REL, "_device_topk", "self-join"),
    ("graph.graph_index", None, "build_csr", "build_csr"),
    ("graph.graph_index", None, "pagerank", "pagerank"),
    (_DOC, None, "export_graphml", "GraphML"),
    ("graph.graph_index", "GraphIndex", "save", "graph.json"),
    ("doc.consistency", "ConsistencyChecker", "check_consistency", "consistency"),
)
# the artifacts of a work dir whose bytes a second `process` must leave as
# they were (result.json is compared without its processing_stats: their
# elapsed_s, and graph_metrics, which a cache hit of the graph lacks, as in
# the reference)
OFFLINE_ARTIFACTS = ("chunks.jsonl", "atomic_notes.json", "embeddings.npy",
                     "clustering.json", "graph.json", "graph.json_embeddings.npz",
                     "graph.json_mappings.json", "graph.graphml",
                     "consistency_report.json")


def _sha1s(work) -> dict:
    import hashlib

    out = {name: hashlib.sha1((work / name).read_bytes()).hexdigest()
           for name in OFFLINE_ARTIFACTS}
    result = json.loads((work / "result.json").read_text())
    result.pop("processing_stats")
    out["result.json"] = hashlib.sha1(json.dumps(result, sort_keys=True).encode()).hexdigest()
    return out


def _normalize_answer(s: str) -> str:
    """MuSiQue's answer normalisation: lower case, no punctuation, no
    articles, single spaces."""
    import re
    import string

    s = "".join(ch for ch in str(s).lower() if ch not in set(string.punctuation))
    return " ".join(re.sub(r"\b(a|an|the)\b", " ", s).split())


def _offline_phase(dev, seed: int, smi_line: str) -> dict:
    """The offline knowledge-base build through `main process` on the card
    (OFFLINE_ITEMS synthetic items, the full-width encoder with seeded
    weights), each stage timed and its idle share traced; the gates on the
    artifacts, the self-join's launches and its top-k, a second `process`
    of cache hits only; the first OFFLINE_QUERIES items' questions through
    process() over `main query`'s processor; the retriever's round trips.
    Returns the offline self-join's kernel numbers."""
    import logging
    import subprocess
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from anorag_tpu_torch import main as tmain
    from anorag_tpu_torch.config import Config
    from anorag_tpu_torch.graph.relation_extractor import SEMANTIC_QUERY_CHUNK
    from anorag_tpu_torch.index.store import ArtifactStore
    from anorag_tpu_torch.ops.topk import dense_topk_kernel, dense_topk_ref
    from anorag_tpu_torch.retrieval.retriever import VectorRetriever
    from anorag_tpu_torch.testing import check_topk, flat_scores
    from anorag_tpu_torch.utils.file_io import latest_work_dir, read_json, read_jsonl

    tmp = Path(tempfile.mkdtemp(prefix="anorag_offline_"))
    synth = tmp / "synth.jsonl"
    t0 = time.perf_counter()
    subprocess.run([sys.executable, str(Path(__file__).resolve().parent / "scripts"
                                        / "gen_synth_musique.py"),
                    str(synth), "--n", str(OFFLINE_ITEMS), "--seed", str(seed)],
                   check=True, stdout=subprocess.DEVNULL)
    items = read_jsonl(synth)
    n_par = sum(len(it["paragraphs"]) for it in items)
    print(f"offline corpus: {len(items)} synthetic items, {n_par} paragraphs "
          f"({time.perf_counter() - t0:.2f} s to draw)", flush=True)
    cfg = Config({"storage": {"result_root": str(tmp / "result")}})
    root_log = logging.getLogger()
    log_state = (root_log.level, list(root_log.handlers))

    # 1. the build: stages timed, the self-join's launches counted from 0,
    # the card's activity traced for the idle share
    times: dict = {}
    undo = _time_parts(times, OFFLINE_PARTS)
    built: list = []
    cached = ArtifactStore.cached

    def counting(self, name, cfg_, input_hash, build, save, load, force=False):
        def build_():
            built.append(name)
            return build()
        return cached(self, name, cfg_, input_hash, build_, save, load, force)

    ArtifactStore.cached = counting
    try:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        dense_topk_kernel.launches = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rc = tmain.main(["process", str(synth), "--no-llm"], cfg)
            torch.cuda.synchronize(dev)
            build_s = time.perf_counter() - t0
        launches = dense_topk_kernel.launches
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    finally:
        undo()
        ArtifactStore.cached = cached
    if rc != 0:
        raise AssertionError(f"main process exited {rc}")
    t0 = time.perf_counter()
    busy_ms, n_events = _kineto_busy_ms(prof)
    parse_s = time.perf_counter() - t0
    del prof
    work = latest_work_dir(tmp / "result")
    result = read_json(work / "result.json")
    stats = result["processing_stats"]
    notes = read_json(work / "atomic_notes.json")
    graph = read_json(work / "graph.json")
    by_type = Counter(link["relation_type"] for link in graph["links"])
    print(f"offline build ({len(items)} items) through main process: "
          f"{build_s:.3f} s, by stage (s; the card synchronised after the "
          f"device stages): " + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f"; device busy {busy_ms / 1e3:.3f} s in {n_events} device events (read "
          f"in {parse_s:.3f} s), idle share {1 - busy_ms / 1e3 / build_s:.4f}; peak "
          f"device memory {peak_gb:.2f} GB | {smi_line}", flush=True)
    print(f"offline KB: {n_par} paragraphs, {stats['n_chunks']} chunks, "
          f"{stats['n_notes']} notes, {stats['n_clusters']} clusters, "
          f"{stats['n_edges']} edges by type {dict(by_type.most_common())}; "
          f"self-join launches {launches}; stages built {built}", flush=True)

    # 2. gates: every artifact written, consistent, above the crossing, the
    # self-join's launches and its top-k
    for key in ("embeddings_path", "graph_file"):
        if not Path(result[key]).exists():
            raise AssertionError(f"result.json names {result[key]}, which is missing")
    missing = [a for a in OFFLINE_ARTIFACTS if not (work / a).exists()]
    if missing:
        raise AssertionError(f"the build wrote no {missing}")
    if not result["consistency"]["consistent"]:
        raise AssertionError(f"consistency: {result['consistency']['issues'][:3]}")
    n = len(notes)
    if n <= OFFLINE_MIN_NOTES:
        raise AssertionError(f"{n} notes, not above {OFFLINE_MIN_NOTES}: the self-join "
                             f"ran on the host")
    if launches != -(-n // SEMANTIC_QUERY_CHUNK):
        raise AssertionError(f"the self-join launched {launches} times for {n} notes")
    emb = torch.from_numpy(np.load(work / "embeddings.npy")).to(dev)
    if emb.shape != (n, 1024) or not bool(torch.isfinite(emb).all()):
        raise AssertionError(f"embeddings.npy of shape {tuple(emb.shape)}, or not finite")
    unit = (emb / torch.linalg.vector_norm(emb, dim=1, keepdim=True).clamp_min(1e-9)).contiguous()
    del emb
    k = 6
    rng = np.random.default_rng(seed + 4)
    rows = torch.from_numpy(np.sort(rng.choice(n, min(512, n), replace=False))).to(dev)
    q = unit[rows].contiguous()
    err = check_topk(dense_topk_kernel(unit, q, k), dense_topk_ref(unit, q, k),
                     flat_scores(unit, q))
    ms, _ = _time_ms(lambda: dense_topk_kernel(unit, unit, k), n=1, reps=3, warm=1)
    plain_ms, _ = _time_ms(lambda: dense_topk_ref(unit, unit, k), n=1, reps=3, warm=1)
    lib_ms, _ = _time_ms(lambda: torch.topk(torch.matmul(unit, unit.T), k), n=1,
                         reps=3, warm=1)
    bound_ms, bound_by = _topk_bound(n, n, unit.shape[1], k, 4)
    print(f"offline self-join (f32, k {k}) against dense_topk_ref on 512 rows: max abs "
          f"err {err:.3g}; one launch of {n} x {n} x {unit.shape[1]}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, torch.matmul + torch.topk {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}) | {smi_line}", flush=True)
    del unit, q

    # 3. a second process of the same file: cache hits only, artifacts unchanged
    before = _sha1s(work)
    built.clear()
    ArtifactStore.cached = counting
    try:
        t0 = time.perf_counter()
        rc = tmain.main(["process", str(synth), "--no-llm"], cfg)
        again_s = time.perf_counter() - t0
    finally:
        ArtifactStore.cached = cached
    if rc != 0 or built or latest_work_dir(tmp / "result") != work:
        raise AssertionError(f"second process: exit {rc}, rebuilt {built}")
    changed = [a for a, h in _sha1s(work).items() if before[a] != h]
    if changed:
        raise AssertionError(f"second process changed {changed}")
    print(f"second process: every stage a cache hit, {len(before)} artifacts' SHA1 "
          f"unchanged, {again_s:.3f} s", flush=True)

    # 4. the first items' questions through process() over main query's processor
    t0 = time.perf_counter()
    qp = tmain.load_query_processor(work, cfg)
    load_s = time.perf_counter() - t0
    lat, methods, em_hits = [], Counter(), 0
    for it in items[:OFFLINE_QUERIES]:
        t0 = time.perf_counter()
        a = qp.process(it["question"])
        lat.append(time.perf_counter() - t0)
        if not PROCESS_KEYS <= set(a):
            raise AssertionError(f"process({it['question']!r}) gave keys {sorted(a)}")
        methods[a["answer_method"]] += 1
        gold = {_normalize_answer(g) for g in [it["answer"], *it.get("answer_aliases", [])]}
        em_hits += _normalize_answer(a["answer"]) in gold
    lat_s = sorted(lat[1:])
    print(f"main query's processor over the KB: loaded in {load_s:.3f} s; "
          f"{OFFLINE_QUERIES} questions through process(): first {lat[0]:.4f} s, then "
          f"median {lat_s[len(lat_s) // 2]:.4f} s, p90 {lat_s[int(0.9 * len(lat_s))]:.4f} s; "
          f"answer methods {dict(methods.most_common())}; exact match "
          f"{em_hits / OFFLINE_QUERIES:.4f} (random encoder weights; not gated) "
          f"| {smi_line}", flush=True)

    # 5. the retriever over the built notes and embeddings on the card
    emb = torch.from_numpy(np.load(work / "embeddings.npy")).to(dev)
    vr = VectorRetriever(qp.em, top_k=10)
    vr.build_index(notes, emb)
    questions = [it["question"] for it in items[:OFFLINE_RETRIEVE]]
    first = [vr.retrieve(q, threshold=-1.0) for q in questions]
    t0 = time.perf_counter()
    vr.save(tmp / "retriever")
    save_s = time.perf_counter() - t0
    loaded = VectorRetriever(qp.em, top_k=10)
    t0 = time.perf_counter()
    if not loaded.load(tmp / "retriever"):
        raise AssertionError("VectorRetriever.load refused its own save")
    load_rt_s = time.perf_counter() - t0
    for q, got in zip(questions, first):
        again = loaded.retrieve(q, threshold=-1.0)
        if [r["note_id"] for r in again] != [r["note_id"] for r in got] or max(
                (abs(x["similarity"] - y["similarity"]) for x, y in zip(again, got)),
                default=0.0) > 1e-6:
            raise AssertionError(f"save -> load changed retrieve({q!r})")
    gone = [nt["note_id"] for nt in notes[::max(1, n // OFFLINE_REMOVED)][:OFFLINE_REMOVED]]
    removed_notes = [nt for nt in notes if nt["note_id"] in set(gone)]
    t0 = time.perf_counter()
    if vr.remove_notes(gone) != len(gone):
        raise AssertionError("remove_notes removed another count")
    vr.add_notes(removed_notes)
    churn_s = time.perf_counter() - t0
    for q, got in zip(questions, first):
        if {r["note_id"] for r in vr.retrieve(q, threshold=-1.0)} != {r["note_id"] for r in got}:
            raise AssertionError(f"remove_notes + add_notes changed retrieve({q!r})'s top 10")
    doc = str(notes[0]["doc_id"])
    in_doc = vr.search_with_namespace_fallback(items[0]["question"], doc, top_k=10)
    if not in_doc or any(str(r.get("doc_id")) != doc for r in in_doc):
        raise AssertionError(f"namespace search for {doc} gave docs "
                             f"{sorted({str(r.get('doc_id')) for r in in_doc})}")
    hits = vr.lexical_fallback_search(items[0]["question"], top_k=5)
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"retriever over the KB: save {save_s:.3f} s -> load {load_rt_s:.3f} s gives "
          f"equal retrieve ids and scores for {len(questions)} questions; {len(gone)} "
          f"notes removed and added back "
          f"({churn_s:.3f} s), equal top-10 sets; namespace {doc}: {len(in_doc)} notes "
          f"of that doc only; lexical fallback hits "
          f"{[(r['note_id'], round(r['final_score'], 4)) for r in hits]}; peak device "
          f"memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, host peak RSS "
          f"{rss_gb:.2f} GB | {smi_line}", flush=True)
    del qp, vr, loaded, emb
    for h in root_log.handlers[:]:           # main's log handlers go with the KB
        if h not in log_state[1]:
            root_log.removeHandler(h)
            h.close()
    root_log.setLevel(log_state[0])
    for f in sorted(tmp.rglob("*"), reverse=True):
        f.unlink() if f.is_file() else f.rmdir()
    tmp.rmdir()
    return dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)


# the llm phase: the decoder LM at checkpoints/note_lm_tpu_large's shape
# (cut from 5 and 8 when the offline phase joined, to keep the script
# near half its time limit)
LLM_ZIPF = 3                   # Zipf queries through process() with the LLM
LLM_SERVED = 4                 # queries of the request served with the LLM
LLM_CONCURRENT = 8             # concurrent requests to serve_llm
LLM_SERVE_MAX_NEW = 512        # serve_llm's byte budget (its --max-new default)
# llm.max_output_tokens (the provider generates 4 bytes a token) of the
# process() and served runs; /query runs at the config's 512 (1,024 steps
# at pb 1,024); the profiled process() at 16
LLM_MAX_OUTPUT_TOKENS = 64
LLM_PROFILED_TOKENS = 16


class _DecodeWatch:
    """decoder_lm._decode_step wrapped while the pipeline runs: counts the
    steps and the rows they decode, and keeps on the card the count of
    logits that were not finite (read once, at the end)."""

    def __init__(self, dlm, dev):
        import torch

        self.dlm, self.inner = dlm, dlm._decode_step
        self.steps = self.rows = 0
        self.bad = torch.zeros((), dtype=torch.int64, device=dev)
        dlm._decode_step = self

    def __call__(self, params, tok, *args, **kwargs):
        import torch

        logits = self.inner(params, tok, *args, **kwargs)
        self.steps += 1
        self.rows += tok.shape[0]
        self.bad += (~torch.isfinite(logits)).sum()
        return logits

    def close(self) -> int:
        self.dlm._decode_step = self.inner
        return int(self.bad)


def _write_work_dir(work, qp, notes) -> dict:
    """The KB files serve.build_processor reads, from setup's processor:
    atomic_notes.json, embeddings.npy (f32) and graph.json (the graph the
    constructor built, without its embeddings sidecar: the processor's
    embeddings take their place). Returns the seconds of each."""
    import numpy as np

    from anorag_tpu_torch.utils.file_io import write_json

    times = {}
    t0 = time.perf_counter()
    write_json(work / "atomic_notes.json", notes)
    times["atomic_notes.json"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.save(work / "embeddings.npy", qp.embeddings.cpu().numpy())
    times["embeddings.npy"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gi = qp.multi_hop.graph_index
    emb, gi.embeddings = gi.embeddings, None
    try:
        gi.save(work / "graph.json")
    finally:
        gi.embeddings = emb
    times["graph.json"] = time.perf_counter() - t0
    return times


def _profiled_ms(dev, fn, reps: int) -> tuple:
    """(wall ms, device busy ms, device kernels) a call of fn(), over `reps`
    calls after one warm call: the host clock around the calls, the card
    synchronised; then the device's busy time (the union of its kernels'
    intervals) from torch.profiler over `reps` more calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(dev)
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_ms(on_card) if on_card else float("nan")
    return 1e3 * wall / reps, busy / reps, len(on_card) / reps


def _llm_timings(dev, params, cfg, smi_line: str) -> None:
    """Prefill and decode at B 1 and 8 on seeded prompts: prefill at pb 256
    and 1024 and a decode step (at position 256, over a pb-256 cache), each
    as wall ms (host clock, synchronised) and device busy ms
    (torch.profiler); `generate` for 256 steps at pb 256 (wall, the steps
    it ran counted), generated bytes/s; against a step's bound: the
    weights and all max_len K/V columns it reads (the reference's step
    attends over all of them) over HBM bandwidth."""
    import numpy as np
    import torch

    from anorag_tpu_torch.models import decoder_lm as dlm

    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    rng = np.random.default_rng(7)
    for b in (1, 8):
        line = []
        for pb in (256, 1024):
            ids = torch.from_numpy(rng.integers(dlm._BYTE0 + 32, dlm._BYTE0 + 127,
                                                (b, pb)).astype(np.int32)).to(dev)
            pad = torch.zeros(b, dtype=torch.int32, device=dev)
            wall_ms, busy_ms, _ = _profiled_ms(
                dev, lambda: dlm._prefill(params, ids, pad, cfg), reps=5)
            line.append(f"prefill pb {pb} {wall_ms:.4f} ms wall, {busy_ms:.4f} device")
        ids = ids[:, -256:].contiguous()
        _, cache = dlm._prefill(params, ids, pad, cfg)
        rope = dlm._rope_tables(torch.arange(cfg.max_len, device=dev), cfg.head_dim)
        tok = ids[:, -1]
        step_wall, step_busy, kernels = _profiled_ms(
            dev, lambda: dlm._decode_step(params, tok, 256, pad, cache, cfg, rope), reps=16)
        steps, ran = 256, []
        inner = dlm._decode_step
        dlm._decode_step = lambda *a: ran.append(1) or inner(*a)
        try:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = dlm.generate(params, ids, pad, cfg, steps)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        finally:
            dlm._decode_step = inner
        emitted = int((out != dlm.PAD_ID).sum())
        kv_bytes = cfg.num_layers * 2 * b * cfg.max_len * cfg.hidden_size * 4
        bound_ms = 1e3 * (weight_bytes + kv_bytes) / HBM_BYTES_PER_S
        gen_ms = 1e3 * wall / len(ran)
        print(f"decoder B {b}: {'; '.join(line)}; a decode step {step_wall:.4f} ms wall, "
              f"{step_busy:.4f} ms device busy, {kernels:.0f} kernels; in generate "
              f"{gen_ms:.4f} ms a step (wall, {len(ran)} steps), {emitted / wall:.1f} "
              f"generated bytes/s; a step's bound {bound_ms:.4f} ms (bytes: weights "
              f"{weight_bytes / 1e6:.1f} MB + K/V {kv_bytes / 1e6:.1f} MB): generate "
              f"{gen_ms / bound_ms:.1f}x the bound, device busy "
              f"{step_busy / bound_ms:.1f}x | {smi_line}", flush=True)


def _post_json(url: str, payload: dict) -> dict:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=900) as r:
        if r.status != 200:
            raise AssertionError(f"{url}: HTTP {r.status}")
        return json.loads(r.read())


def _serve_llm_burst(dev, ckpt, cfg, smi_line: str) -> dict:
    """serve_llm's batcher and handler (what `python -m
    anorag_tpu_torch.serve_llm --model ckpt` runs) on 127.0.0.1 with the
    checkpoint read back on the card; LLM_CONCURRENT OllamaClients post at
    once; one batch must serve them all. Returns the part's numbers."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from anorag_tpu_torch import serve, serve_llm
    from anorag_tpu_torch.llm.clients import OllamaClient
    from anorag_tpu_torch.models import decoder_lm as dlm

    params, _ = dlm.load_lm(ckpt, device=dev)
    lm = dlm.DecoderLM(params, cfg, prompt_bucket=cfg.max_len // 2)
    # the window only waits while fewer than LLM_CONCURRENT have come
    batcher = serve_llm.MicroBatcher(lm, LLM_CONCURRENT, LLM_SERVE_MAX_NEW, window_s=5.0)
    server = serve.Server(("127.0.0.1", 0), serve_llm.make_handler(batcher, "note-lm"))
    thread = threading.Thread(target=server.serve_forever, name="serve-llm-smoke")
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    clients = [OllamaClient(base_url=url, model="note-lm", timeout=900)
               for _ in range(LLM_CONCURRENT)]
    start = threading.Barrier(LLM_CONCURRENT)

    def ask(i):
        start.wait()
        t0 = time.perf_counter()
        text = clients[i].generate(f"Who is note {i} about?", system_prompt="Answer.",
                                   max_tokens=LLM_SERVE_MAX_NEW // 4)
        return text, time.perf_counter() - t0

    try:
        if not clients[0].is_available():
            raise AssertionError("serve_llm: the health ping failed")
        t0 = time.perf_counter()
        with ThreadPoolExecutor(LLM_CONCURRENT) as ex:
            got = list(ex.map(ask, range(LLM_CONCURRENT)))
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(60)
        batcher.close()
    stats = dict(batcher.stats)
    calls = sum(c.stats["calls"] for c in clients)
    if (stats["requests"], stats["batches"], stats["errors"]) != (LLM_CONCURRENT, 1, 0) \
            or any(c.stats["errors"] for c in clients):
        raise AssertionError(f"serve_llm: batcher {stats}, client calls {calls}, "
                             f"texts {[len(t) for t, _ in got]}")
    lat = sorted(dt for _, dt in got)
    print(f"serve_llm: {LLM_CONCURRENT} concurrent OllamaClient requests in "
          f"{stats['batches']} batch of {stats['requests']} (max_new "
          f"{LLM_SERVE_MAX_NEW}, prompt bucket {cfg.max_len // 2}): latency median "
          f"{lat[len(lat) // 2]:.4f} s, max {lat[-1]:.4f} s, generate {stats['gen_s']:.4f} "
          f"s, wall {wall:.4f} s; {sum(len(t.encode()) for t, _ in got)} bytes "
          f"returned | {smi_line}", flush=True)
    return {"s": wall, "calls": calls}


def _llm_phase(dev, qp, notes, words, rng, seed: int, smi_line: str) -> None:
    """The LLM layer and the decoder on the card: seeded weights at
    checkpoints/note_lm_tpu_large's shape written with save_lm; the decoder
    against the CPU (testing.decoder_parity) and timed; a work dir of
    setup's KB served through serve.build_processor(no_llm=False) with a
    config naming llm.provider jax (LocalLLM -> LLMFactory -> the decoder
    provider); the KB questions and Zipf queries through process(), one
    request through a ServingEngine, one /query over HTTP, concurrent
    requests to serve_llm through OllamaClient; one process() profiled.
    Every decode step's logits finite, every query that reaches the LLM
    stage answered by method llm, the LLM called in every part, the KB
    answers EFSA's wherever it rescues them, hand kernels launched."""
    import copy
    import tempfile
    import threading
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    from anorag_tpu_torch import serve
    from anorag_tpu_torch.models import decoder_lm as dlm
    from anorag_tpu_torch.ops import bm25, ivf, topk
    from anorag_tpu_torch.query import processor
    from anorag_tpu_torch.serving import ServingEngine
    from anorag_tpu_torch.testing import KB_QUESTIONS, NOTE_LM_TPU_LARGE, decoder_parity

    counted = (bm25.window_winners, bm25.segment_totals, bm25.segment_winners,
               topk.dense_topk_kernel, topk.bucket_winners, topk.bucket_merge,
               ivf.ivf_scan, ivf.ivf_work_plan)
    cfg = dlm.DecoderConfig(**NOTE_LM_TPU_LARGE)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_llm_") as tmp:
        tmp = Path(tmp)
        # 1. seeded weights, written as a checkpoint
        t0 = time.perf_counter()
        params = dlm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        dlm.save_lm(tmp / "lm", params, cfg)
        print(f"decoder: {sum(p.numel() for p in params.parameters())} parameters at "
              f"note_lm_tpu_large's shape {NOTE_LM_TPU_LARGE}, seeded and saved in "
              f"{time.perf_counter() - t0:.2f} s | {smi_line}", flush=True)

        # 2. the card against the CPU, then timed
        for b in (1, 8):
            out = decoder_parity(params, b, steps=64, pb=256, seed=seed + b)
            print(f"decoder on the card against the CPU at B {b}, pb 256: prefill and "
                  f"64 decode steps, logits max abs err {out['max_abs_err']:.3g} (atol "
                  f"1e-4), greedy tokens equal over {out['steps_compared']} steps "
                  f"({out['near_ties']} rows cut short by a near tie) | {smi_line}",
                  flush=True)
        _llm_timings(dev, params, cfg, smi_line)
        del params

        # 3. the work dir and the processor with the LLM
        work = tmp / "kb"
        work.mkdir()
        write_s = _write_work_dir(work, qp, notes)
        # setup's config with the LLM: the decoder provider, and the answer
        # selector after it (README's LLM mode; before it, it answers most
        # queries and the LLM is never asked)
        llm_cfg = copy.deepcopy(qp.cfg)
        llm_cfg.set("llm.provider", "jax")
        llm_cfg.set("llm.jax", {"model": str(tmp / "lm")})
        llm_cfg.set("answer_selector.apply_before_llm", False)
        full_budget = llm_cfg.get("llm.max_output_tokens")
        llm_cfg.set("llm.max_output_tokens", LLM_MAX_OUTPUT_TOKENS)
        t0 = time.perf_counter()
        qp2 = serve.build_processor(str(work), no_llm=False, cfg=llm_cfg, device=dev)
        torch.cuda.synchronize(dev)
        build_s = time.perf_counter() - t0
        if qp2.llm is None:
            raise AssertionError("build_processor dropped the LLM")
        llm, provider = qp2.llm, qp2.llm.client
        print("work dir written (s): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                                   write_s.items())
              + f"; serve.build_processor(no_llm=False) {build_s:.3f} s: provider "
              f"{type(provider).__name__} ({provider.provider_name}) on "
              f"{provider.device}, {len(qp2.notes)} notes, "
              f"{qp2.multi_hop.graph_index.graph.n_edges} graph edges | {smi_line}",
              flush=True)

        # 4. the pipeline runs; stage (c) and every decode step watched
        stage_c = []
        final_answer = processor.generate_final_answer

        def watched_final_answer(llm_, query, *args, **kwargs):
            stage_c.append(query)
            return final_answer(llm_, query, *args, **kwargs)

        processor.generate_final_answer = watched_final_answer
        watch = _DecodeWatch(dlm, dev)
        for fn in counted:
            fn.launches = 0
        parts = {}

        def part(name, fn, n_queries=1):
            calls, steps = provider.stats["calls"], watch.steps
            t_llm = provider.stats["total_time"]
            del stage_c[:]
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize(dev)
            parts[name] = {"s": time.perf_counter() - t0, "n": n_queries,
                           "calls": provider.stats["calls"] - calls,
                           "steps": watch.steps - steps,
                           "llm_s": provider.stats["total_time"] - t_llm,
                           "stage_c": set(stage_c)}
            return out

        def check_methods(name, answers):
            reached = parts[name]["stage_c"]
            wrong = [(a["query"], a["answer_method"]) for a in answers
                     if a["query"] in reached and a["answer_method"] != "llm"]
            if wrong or not reached or not parts[name]["calls"]:
                raise AssertionError(f"llm {name}: {len(reached)} queries reached the "
                                     f"LLM stage, {parts[name]['calls']} LLM calls; "
                                     f"answered otherwise: {wrong}")

        kb_q = [q for q, *_ in KB_QUESTIONS]
        zipf = [" ".join(words[t]) for t in _query_terms(rng, LLM_ZIPF + LLM_SERVED - 2)]
        request = kb_q[:2] + zipf[LLM_ZIPF:]
        stage_s: dict = {}
        try:
            restore = _time_process_stages(qp2, stage_s)
            try:
                kb = part("process KB", lambda: [qp2.process(q) for q in kb_q], len(kb_q))
                zp = part("process Zipf", lambda: [qp2.process(q) for q in zipf[:LLM_ZIPF]],
                          LLM_ZIPF)
            finally:
                restore()
            check_methods("process KB", kb)
            check_methods("process Zipf", zp)
            # the KB answers without the LLM: EFSA's, which the LLM mode's
            # rescue must give
            qp2.llm = None
            try:
                alone = [qp2.process(q) for q in kb_q]
            finally:
                qp2.llm = llm
            rescued = _check_llm_kb_answers(kb, alone)

            routed = bm25.window_winners.launches
            with ServingEngine(qp2, sub_batch=LLM_SERVED, depth=1) as engine:
                served = part("served request", lambda: engine.submit(request).result(
                    timeout=1800), LLM_SERVED)
            routed = bm25.window_winners.launches - routed
            check_methods("served request", served)
            _check_answers(request, served, notes, qp2.default_top_k())

            engine = ServingEngine(qp2, sub_batch=int(qp2.cfg.get("serving.stream_batch")),
                                   depth=int(qp2.cfg.get("serving.stream_depth")))
            server = serve.Server(("127.0.0.1", 0), serve.make_handler(qp2, engine))
            thread = threading.Thread(target=server.serve_forever, name="http-llm-smoke")
            thread.start()
            qp2.cfg.set("llm.max_output_tokens", full_budget)
            try:
                url = f"http://127.0.0.1:{server.server_address[1]}/query"
                body = part("http /query", lambda: _post_json(url, {"query": kb_q[1]}))
            finally:
                server.shutdown()
                server.server_close()
                thread.join(60)
                engine.close()
            check_methods("http /query", [{**body, "query": kb_q[1]}])

            parts["serve_llm"] = _serve_llm_burst(dev, tmp / "lm", cfg, smi_line)

            # one process() under torch.profiler, the LLM's budget cut
            qp2.cfg.set("llm.max_output_tokens", LLM_PROFILED_TOKENS)
            try:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    traced = part("profiled process", lambda: qp2.process(kb_q[1]))
                    wall_ms = 1e3 * (time.perf_counter() - t0)
            finally:
                qp2.cfg.set("llm.max_output_tokens", LLM_MAX_OUTPUT_TOKENS)
            check_methods("profiled process", [traced])
        finally:
            processor.generate_final_answer = final_answer
            bad = watch.close()
        launches = {fn.__name__: fn.launches for fn in counted if fn.launches}
        if bad:
            raise AssertionError(f"{bad} decode logits were not finite")
        if not launches:
            raise AssertionError("no hand kernel launched in the llm phase")
        del qp2, llm, provider
    torch.cuda.empty_cache()

    for name, p in parts.items():
        extra = f", {p['calls']} client calls"
        if "steps" in p:
            extra = (f", {p['calls']} LLM calls, {p['steps']} decode steps, "
                     f"{len(p['stage_c'])} queries at the LLM stage, LLM "
                     f"{p['llm_s']:.4f} s ({p['llm_s'] / p['s']:.4f} of it)")
        print(f"llm {name}: {p['s']:.4f} s" + (f", {p['s'] / p['n']:.4f} s a query"
                                               if p.get("n", 1) > 1 else "")
              + f"{extra} | {smi_line}", flush=True)
    n_proc = len(kb_q) + LLM_ZIPF
    print(f"process() with the LLM, host s a query by stage: " + ", ".join(
        f"{k} {v / n_proc:.4f}" for k, v in stage_s.items()) + f" | {smi_line}", flush=True)
    print(f"KB answers with the LLM: " + ", ".join(
        f"{a['answer']!r} ({a['answer_method']})" for a in kb)
          + f"; without it (apply_before_llm off): " + ", ".join(
              f"{a['answer']!r} ({a['answer_method']})" for a in alone)
          + f"; rescued by EFSA with the reference tests' answer: {rescued} | {smi_line}",
          flush=True)
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if on_card:
        busy = _busy_ms(on_card)
        print(f"trace of one process() with the LLM (llm.max_output_tokens "
              f"{LLM_PROFILED_TOKENS}: {parts['profiled process']['steps']} decode steps): "
              f"wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, idle share "
              f"{1 - busy / wall_ms:.4f}, {len(on_card)} device events | {smi_line}",
              flush=True)
    else:
        print("trace of one process() with the LLM: no device events recorded; idle "
              "share not measured")
    print(f"hand kernels launched in the llm phase (counted from 0): {launches}; "
          f"window_winners in the served request {routed} | {smi_line}", flush=True)


def _check_llm_kb_answers(with_llm, alone) -> dict:
    """Each KB question: answered at the LLM stage with the answer the same
    processor gives without the LLM (EFSA's, or insufficient information
    when EFSA has none: the seeded model's text is no valid JSON, so the
    rescue decides), or stopped by a gate before it with the reference
    tests' answer. Returns, for each question the LLM stage answered,
    whether that is the reference tests' expectation."""
    from anorag_tpu_torch.testing import KB_QUESTIONS

    rescued = {}
    for (q, want, _, answerable), got, efsa in zip(KB_QUESTIONS, with_llm, alone):
        if got["answer_method"] == "llm":
            if got["answer"] != efsa["answer"] or efsa["answer_method"] not in ("efsa",
                                                                               "none"):
                raise AssertionError(f"{q!r}: the LLM mode answered {got['answer']!r}, "
                                     f"without the LLM {efsa['answer']!r} by "
                                     f"{efsa['answer_method']}")
            rescued[q] = got["answer"] == want
        elif (got["answer"], got["predicted_answerable"]) != (want, answerable):
            raise AssertionError(f"{q!r} answered {got['answer']!r} by "
                                 f"{got['answer_method']}, not {want!r}")
    return rescued


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
    from anorag_tpu_torch.ops.topk import dense_topk_kernel, hybrid_fuse
    from anorag_tpu_torch.models.embedding_manager import EmbeddingManager
    from anorag_tpu_torch.query.processor import QueryProcessor
    from anorag_tpu_torch.retrieval.retriever import max_seg_for
    from anorag_tpu_torch.serving import ServingEngine
    from anorag_tpu_torch.testing import KB_QUESTIONS, WINDOW_CASES, kb_notes, sorted_plan

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
    # four paragraphs a document, as the reference's corpora come: without
    # doc ids every note shares one "unknown" document, and the relation
    # extractor's source-context pass pairs all N notes with each other
    notes = [{"note_id": f"n{i}", "title": "", "content": " ".join(row),
              "doc_id": f"d{i // 4}", "paragraph_idxs": [i % 4]}
             for i, row in enumerate(words[doc_terms].tolist())]
    for i, kb in enumerate(kb_notes(), start=N_NOTES - 6):
        notes[i] = {**kb, "note_id": f"n{i}"}
    gen = torch.Generator(device=dev).manual_seed(seed)
    emb = torch.randn((N_NOTES, 1024), generator=gen, device=dev)
    emb /= torch.linalg.vector_norm(emb, dim=1, keepdim=True)
    _plant(emb, gen)
    emb = emb.to(torch.bfloat16)
    cfg = {"vector_store": {"top_k": 20}, "context": {"max_notes_for_llm": 20}}
    em = EmbeddingManager(cfg, device=dev, seed=seed)
    em.encode_queries(["draw the encoder weights"])
    # the constructor builds the note graph (the main path of process()):
    # its parts timed, the top-k kernel's launches counted from 0
    graph_times: dict = {}
    untime_graph = _time_parts(graph_times)
    dense_topk_kernel.launches = 0
    t_qp = time.perf_counter()
    qp = QueryProcessor(notes, embeddings=emb, cfg=cfg, device=dev,
                        embedding_manager=em)
    torch.cuda.synchronize(dev)
    graph_times["processor total"] = time.perf_counter() - t_qp
    build_launches = dense_topk_kernel.launches
    del emb
    requests = [[" ".join(words[q]) for q in _query_terms(rng, BATCH)]
                for _ in range(N_REQUESTS)]
    requests[0][:len(KB_QUESTIONS)] = [q for q, *_ in KB_QUESTIONS]
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
        _check_answers(req, resp, notes, top_k)
    _check_kb_answers(responses[0], "serve")
    if launches != routed or launches < 1:
        raise AssertionError(f"window_winners launched {launches} times on the main "
                             f"path; {routed} sub-batches were routed to it")
    lat = [done_at[i] - s for i, (s, _) in enumerate(submitted)]
    n_q = sum(len(r) for r in requests)
    methods = Counter(a["answer_method"] for resp in responses for a in resp)
    print(f"served {len(requests)} x {BATCH} queries over {n_docs} notes: "
          f"window_winners launches {launches} (routed {routed}); latency per "
          f"request {', '.join(f'{x:.3f}' for x in lat)} s; "
          f"{n_q / (t_end - t_serve):.1f} answered queries/s; answer methods "
          f"{dict(methods.most_common())}; peak memory {peak_gb:.2f} GB | {smi_line}")
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
    rows = stage("finalize", lambda: retriever.hybrid_search_finalize(
        ("pending", req, vals, ids)))
    _check_answers(req, stage("answer", lambda: qp._assemble_batch(rows, req, None)),
                   notes, top_k)
    print(f"one {len(req)}-query batch by stage (s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.4f} | {smi_line}")
    _answer_costs(qp, requests[0], np.random.default_rng(seed + 1), words, top_k, notes,
                  smi_line)
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

    # 10. process: the per-query pipeline on the same processor
    try:
        self_join, kb_process = _process_phase(
            dev, qp, graph_times, build_launches, np.random.default_rng(seed + 2),
            words, smi_line)
    finally:
        untime_graph()
    t = _phase("process", t)

    # 11. offline: the knowledge-base build of main process, then main query
    offline_join = _offline_phase(dev, seed, smi_line)
    t = _phase("offline", t)

    # 12. llm: the LLM layer and the decoder LM through process(), the
    # served path, /query and serve_llm
    _llm_phase(dev, qp, notes, words, np.random.default_rng(seed + 3), seed, smi_line)
    t = _phase("llm", t)

    # 13. http: the port's server at the config defaults
    _http_phase(qp, requests[0], responses[0], kb_process, notes, top_k, smi_line)
    t = _phase("http", t)

    # 14. search: VectorRetriever.search / retrieve through the top-k kernel
    dense_launches = _search_phase(dev, em, notes, retriever.index.flat_device_emb(),
                                   requests[1:3], smi_line)
    t = _phase("search", t)

    # 15. bench: the port's benchmark entry point, in-process
    for name, count in _bench_phase(dev, smi_line).items():
        bucket_launches[name] += count
    idle = [name for name, count in bucket_launches.items() if count < 1]
    if idle:
        raise AssertionError(f"the bucket phase and the bench launched no bucket "
                             f"kernel {idle}: {bucket_launches}")
    t = _phase("bench", t)

    # 16. ivf: the default IVFFlat index at 5,000,000 rows
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
        "launches": dense_launches + build_launches + offline_join["launches"],
        "max_abs_err": max(dense_errs),
        **dense_main,
    }, {
        "name": "dense_topk_f32_self_join", "route": "cuda",
        "source": "anorag_tpu_torch/csrc/streaming_topk.cu",
        "design": "part of dense_topk, not a kernel of its own: the note graph's "
                  "semantic edges, f32 unit rows against themselves at k 6 "
                  "(16-query tiles, FMAs), one launch per chunk of queries; "
                  "timed at a chunk of 32768 queries",
        "part_of": "dense_topk",
        "replaces": "anorag_tpu/ops/topk.py:40",
        **self_join,
    }, {
        "name": "dense_topk_f32_offline_self_join", "route": "cuda",
        "source": "anorag_tpu_torch/csrc/streaming_topk.cu",
        "design": "part of dense_topk, not a kernel of its own: the note graph's "
                  "semantic edges in the offline build of main process, the KB's "
                  "f32 unit rows against themselves at k 6 in one launch; timed "
                  "at that launch's shape",
        "part_of": "dense_topk",
        "replaces": "anorag_tpu/ops/topk.py:40",
        **offline_join,
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
