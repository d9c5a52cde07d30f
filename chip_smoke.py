#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (anorag_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printing its seconds:
  1. device  -- nvidia-smi's name and power limit, torch's device name;
  2. build   -- nvcc builds the path's CUDA kernel (plain C interface,
                ctypes);
  3. setup   -- a 200,000-note corpus drawn from a 30,000-word Zipf
                vocabulary (40 terms a note), 1024-wide unit embeddings
                and the full-width encoder (24 layers, hidden 1024, bf16),
                all from --seed, data and weights made on the card;
  4. kernels -- each kernel against its plain PyTorch version on the card:
                the odd shapes of the CPU tests and the main path's real
                batch; ids equal, values to rtol 1e-6; at the real shape
                the kernel's and the plain version's device time (20 calls
                back to back, CUDA events), the wrapper's host time per
                call, and the bound;
  5. serve   -- a ServingEngine answers 4 requests of 512 queries (8
                content-band terms each); every response has
                top_k rows of valid note ids; the kernels' launch counts,
                reset just before, match the batches routed to them; one
                batch again with the plain sparse stage gives the same
                top-10 ids; latency, QPS and peak memory;
  6. breakdown -- one batch again, stage by stage (encode, host plan,
                upload, sparse, dense + fusion, finalize), synchronised;
  7. trace   -- one request through a ServingEngine under torch.profiler:
                the device's busy time and idle share, the window-winners
                kernels' own time, and the largest device kernels.
Then one JSON line of kernel numbers, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure prints its traceback and exits
non-zero without that last line; so does a machine without CUDA.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
VOCAB, DOC_LEN, Q_LEN, MIN_RANK = 30_000, 40, 8, 100
N_NOTES, N_REQUESTS, BATCH = 200_000, 4, 512


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


def _time_ms(fn, n: int = 20, reps: int = 21):
    """(device ms, host ms) per call of fn(), after 3 warm-ups. Device: n
    calls back to back between two CUDA events, over n, median of `reps`.
    A sleep kernel queued first holds the card until all n calls are
    enqueued, so the host path between launches opens no gaps. Host: the
    time the n calls take to enqueue, over n."""
    import torch

    def event():
        return torch.cuda.Event(enable_timing=True)

    for _ in range(3):
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


def run(dev, seed: int = 0):
    """All phases on device `dev`; returns (kernel numbers, nvidia-smi
    line, device name)."""
    import numpy as np
    import torch

    from anorag_tpu_torch import _build
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    smi_line = smi[0].strip() if smi else "nvidia-smi gave no output"
    kind = torch.cuda.get_device_name(dev)
    print(f"card: {smi_line} | torch: {kind} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}",
          flush=True)
    t = _phase("device", t)

    # 2. build
    log = _build.build("window_winners")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"nvcc window_winners: {line.strip()}")
    print("built: window_winners" if log else "window_winners: cached")
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
    kernel_ms, wrapper_host_ms = _time_ms(
        lambda: window_winners(dr, wr, n_docs, max_seg))
    plain_ms, _ = _time_ms(lambda: window_winners_ref(dr, wr, n_docs, max_seg))
    block_l = min(1024, max(l, 256))
    moved = 2 * 4 * b * l + 8 * b * block_l + 4 * b
    starts = int(((dr[:, 1:] != dr[:, :-1]) & (dr[:, :-1] < n_docs)).sum())
    starts += int((dr[:, -1] < n_docs).sum())          # the virtual pad column
    ops = b * (l + 1) + starts * (2 * max_seg - 1)
    bound_ms = 1e3 * max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
    bound_by = "bytes" if moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"
    print(f"window_winners at ({b}, {l}) max_seg {max_seg}: kernel {kernel_ms:.4f} ms "
          f"a launch (20 back to back), wrapper's host path {wrapper_host_ms:.4f} ms "
          f"a call, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{moved / 1e6:.1f} MB, {ops / 1e6:.1f} M ops) | {smi_line}")
    t = _phase("kernels", t)

    # 5. serve: the main path, launch counts reset just before
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

    # 6. one batch stage by stage, each stage synchronised
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

    # 7. trace: one request through the engine under torch.profiler
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
        ww = sum(v for k, v in by_name.items() if "window_winners_kernel" in k
                 or "row_max_kernel" in k)
        print(f"trace of one {BATCH}-query request: wall {wall_ms:.2f} ms, device busy "
              f"{busy:.2f} ms, idle share {1 - busy / wall_ms:.4f}; window_winners "
              f"kernels {ww:.4f} ms | {smi_line}")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            print(f"  device {ms:9.3f} ms  {name[:140]}")
    else:
        print("trace: no device events recorded; idle share not measured")
    t = _phase("trace", t)

    return {"kernels": [{
        "name": "bm25_window_winners", "route": "cuda",
        "source": "anorag_tpu_torch/csrc/window_winners.cu",
        "replaces": "anorag_tpu/ops/bm25.py:404",
        "launches": launches, "max_abs_err": max(errs),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
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
