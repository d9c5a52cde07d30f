"""Benchmark of the port: hybrid-query (dense + BM25 fusion) QPS on one
card, with recall@10 against exact f32, the encoder's forward pass
(tokens/s) and end-to-end encode -> hybrid search QPS.

    python -m anorag_tpu_torch.bench

Counterpart of the repo's root bench.py, with its key names. The workload:
over a corpus of unit rows (N x 1024, bf16 on the card) and a 30,000-word
Zipf vocabulary (40 terms a doc), answer batches of 512 queries (8
content-band terms each) with
  final = dense + 0.6 * bm25 / max_bm25, top-100,
through hybrid_topk (exact dense candidates, dense_k 128; the window-winners
BM25 kernel, sparse_m 128). Two scale points:

  * 200,000 docs, recall@10 of the whole batch against an exact-f32 numpy
    brute force on the host, which is also the CPU baseline;
  * 1,000,000 docs (its own process, run first), recall@10 of 64 queries
    against exact f32 scores on the card.

Before any timing, kernel_parity holds the kernels this workload and its
kernel-parity gate reach against their plain versions or the chain, and
raises on a mismatch. The recall gate is 0.985; a miss exits 1 after the
JSON line.

MFU counts only the dense matmul operations (2 B N D) over the whole hybrid
latency, against the card's dense bf16 peak from PEAK_TFLOPS; a card not in
the table gets mfu null. Prints ONE JSON line, with the card's name and
power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from anorag_tpu_torch.device import resolve_device

RECALL_TARGET = 0.95     # reported; no route of the port depends on it
RECALL_GATE = 0.985
SPARSE_M = 128
# Dense bf16 tensor-core peaks, TFLOP/s, by a part of the device name
# (NVIDIA's data sheets); checked in order, so PCIe and NVL come first.
PEAK_TFLOPS = (("H100 PCIe", 756.0), ("H100 NVL", 835.0),
               ("H100 80GB HBM3", 989.4), ("H100 SXM", 989.4))


def peak_tflops(device_kind: str) -> Optional[float]:
    """Dense bf16 peak FLOP/s of the named card; None for a card not in
    PEAK_TFLOPS (no guess)."""
    for part, tflops in PEAK_TFLOPS:
        if part in device_kind:
            return tflops * 1e12
    return None


def make_doc_terms(n_docs: int, vocab: int, doc_len: int, rng) -> np.ndarray:
    """Zipf-ish term matrix (N, L): one vectorized draw."""
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return rng.choice(vocab, size=(n_docs, doc_len), p=p).astype(np.int32)


def make_query_terms(b: int, vocab: int, q_len: int, rng, min_rank: int = 100):
    """Query terms from the content-word band (rank >= min_rank): real
    queries are content words, not the stopword head of the Zipf curve."""
    ranks = np.arange(min_rank, vocab)
    p = 1.0 / (ranks + 1.0)
    p /= p.sum()
    return [rng.choice(ranks, size=q_len, p=p).tolist() for _ in range(b)]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _unit_rows(rng, n: int, d: int) -> np.ndarray:
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _winner_check(got, gold, name: str, rtol: float = 1e-4) -> float:
    """Hold a sparse top-m table (vals, ids, row max) against the chain's:
    row max and the totals of docs in both to rtol, and recall of the
    chain's docs at least 0.9; returns the recall."""
    tv2, td2, mx2 = (x.cpu().numpy() for x in got)
    tv, td, mx = (x.cpu().numpy() for x in gold)
    np.testing.assert_allclose(mx2, mx, rtol=rtol, err_msg=f"{name} row max")
    recs = []
    for bi in range(len(tv)):
        want = {d: v for d, v in zip(td[bi], tv[bi]) if d >= 0}
        have = {d: v for d, v in zip(td2[bi], tv2[bi]) if d >= 0}
        shared = set(want) & set(have)
        recs.append(len(shared) / max(len(want), 1))
        for d in shared:
            np.testing.assert_allclose(have[d], want[d], rtol=rtol,
                                       err_msg=f"{name} doc {d}")
    rec = float(np.mean(recs))
    if rec < 0.9:
        raise AssertionError(f"{name} recall vs the chain too low: {rec}")
    return rec


def kernel_parity(device=None) -> dict:
    """The kernels against their plain versions on `device`, before any
    timing: bucket_topk through its kernel against the plain version (ids
    equal, values to rtol 1e-5), then the segment-winners route, the
    window-winners route and select_approx against the chain (row max and
    shared docs' totals to rtol 1e-4, recall >= 0.9). On the CPU every
    route runs its plain version. Raises on a mismatch."""
    from anorag_tpu_torch.ops.bm25 import (sparse_topm_from_sorted,
                                           sparse_topm_winners)
    from anorag_tpu_torch.ops.topk import bucket_topk

    dev = resolve_device(device)
    rng = np.random.default_rng(7)
    emb = torch.from_numpy(_unit_rows(rng, 3000, 256)).to(dev)
    q = torch.from_numpy(_unit_rows(rng, 16, 256)).to(dev)
    v1, i1 = bucket_topk(emb, q, 10, w=512)
    v2, i2 = bucket_topk(emb, q, 10, w=512, use_xla=True)
    if not torch.equal(i1, i2):
        raise AssertionError("bucket_topk: kernel ids != plain version's")
    torch.testing.assert_close(v1, v2, rtol=1e-5, atol=0,
                               msg="bucket_topk: kernel values != plain version's")

    n_docs, b, l = 4000, 8, 4096
    rows = []
    for _ in range(b):
        nv = int(rng.integers(l // 2, l))
        ids = np.sort(rng.integers(0, n_docs, nv))
        rows.append(np.concatenate([ids, np.full(l - nv, n_docs)]).astype(np.int32))
    a = np.stack(rows)
    w = np.where(a < n_docs, rng.random((b, l)).astype(np.float32) + 0.01, 0.0)
    ad = torch.from_numpy(a).to(dev)
    wd = torch.from_numpy(w.astype(np.float32)).to(dev)
    _, tv, td, mx = sparse_topm_from_sorted(ad, wd, 16, n_docs, impl="xla")
    gold = (tv, td, mx)
    rec_scan = _winner_check(sparse_topm_winners(ad, wd, 16, n_docs), gold,
                             "segment_winners")
    max_run = 1
    for bi in range(b):
        row = a[bi][a[bi] < n_docs]
        if len(row):
            max_run = max(max_run, int(np.unique(row, return_counts=True)[1].max()))
    rec_win = _winner_check(sparse_topm_winners(ad, wd, 16, n_docs,
                                                max_seg=min(max_run, 32)),
                            gold, "window_winners")
    rec_approx = _winner_check(sparse_topm_winners(ad, wd, 16, n_docs,
                                                   select_approx=True),
                               gold, "winners_select_approx")
    return {"bucket_topk": "exact", "segment_winners": rec_scan,
            "window_winners": rec_win, "winners_select_approx": rec_approx,
            "backend": dev.type}


def _exact_oracle(emb: torch.Tensor, q: torch.Tensor, sparse: torch.Tensor,
                  k: int, chunk: int = 65536):
    """Top-k ids of q . e (f32, rows widened chunk by chunk) + 0.6 * sparse."""
    from anorag_tpu_torch.ops.topk import top_k

    if emb.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the exact-f32 oracle needs allow_tf32 off")
    scores = torch.cat([torch.matmul(q, emb[lo:lo + chunk].float().T)
                        for lo in range(0, emb.shape[0], chunk)], dim=1)
    return top_k(scores + 0.6 * sparse, k)[1]


def bench_hybrid(n_docs: int, b: int = 512, dim: int = 1024, vocab: int = 30_000,
                 doc_len: int = 40, q_len: int = 8, k: int = 100,
                 topk_eval: int = 10, rounds: int = 20,
                 cpu_baseline: bool = True, oracle_queries: int = 0,
                 seed: int = 0, keep_ctx: bool = False,
                 recall_target: float | None = None, device=None) -> dict:
    """The hybrid query at n_docs x dim on `device` (the card unless the CPU
    is asked for): QPS and latency as the best of 3 blocks (5 above 500,000
    docs) of `rounds` calls, each block closed by a synchronize; recall@10
    against the numpy exact-f32 CPU baseline (cpu_baseline) or against exact
    f32 on the device over oracle_queries queries. recall_target has no
    effect on the route: every route of the port is exact."""
    from anorag_tpu_torch.ops.bm25 import (build_postings, gather_plan,
                                           gather_plan_sorted)
    from anorag_tpu_torch.ops.topk import hybrid_topk

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    rt = RECALL_TARGET if recall_target is None else recall_target
    rng = np.random.default_rng(seed)
    dtype = torch.bfloat16 if on_card else torch.float32

    # unit rows made on the device; a host copy only for the CPU baseline
    gen = torch.Generator(device=dev).manual_seed(seed)
    emb = torch.randn((n_docs, dim), generator=gen, device=dev)
    emb /= torch.linalg.vector_norm(emb, dim=1, keepdim=True)
    emb_host = emb.cpu().numpy() if cpu_baseline else None
    emb_dev = emb.to(dtype)
    del emb

    doc_terms = make_doc_terms(n_docs, vocab, doc_len, rng)
    postings = build_postings(doc_terms, vocab)
    q = _unit_rows(rng, b, dim)
    q_terms = make_query_terms(b, vocab, q_len, rng)
    doc_rows, weight_rows, _ = gather_plan_sorted(postings, q_terms)
    dr_dev = torch.from_numpy(doc_rows).to(dev)
    wr_dev = torch.from_numpy(weight_rows).to(dev)
    q_dev = torch.from_numpy(q).to(dev, dtype)

    def hybrid_dev():
        return hybrid_topk(emb_dev, q_dev, dr_dev, wr_dev, k, n_docs=n_docs,
                           dense_k=128, sparse_m=SPARSE_M, sparse_weight=0.6,
                           recall_target=rt, max_seg=q_len, select_approx=True)

    v, i = hybrid_dev()
    _sync(dev)
    best_dt = float("inf")
    for _ in range(3 if n_docs <= 500_000 else 5):
        t0 = time.perf_counter()
        for _ in range(rounds):
            v, i = hybrid_dev()
        _sync(dev)
        best_dt = min(best_dt, time.perf_counter() - t0)
    qps = b * rounds / best_dt
    our_idx = i[:, :topk_eval].cpu().numpy()

    def sparse_cpu(rows_plan, nq):
        s = np.zeros((nq, n_docs), np.float32)
        for bi in range(nq):
            r = rows_plan[bi]
            r = r[r >= 0]
            s[bi] = np.bincount(postings.doc_ids[r], weights=postings.weights[r],
                                minlength=n_docs).astype(np.float32)
        mx = s.max(axis=1, keepdims=True)
        return np.where(mx > 0, s / np.maximum(mx, 1e-30), 0.0)

    gi, _ = gather_plan(postings, q_terms)
    lat_s = best_dt / rounds
    dense_flops = 2.0 * b * n_docs * dim
    peak = peak_tflops(torch.cuda.get_device_name(dev)) if on_card else None
    out = {
        "n_docs": n_docs, "batch": b,
        "recall_target": rt,
        "qps": qps,
        "latency_ms_per_batch": 1000.0 * lat_s,
        "achieved_tflops": dense_flops / lat_s / 1e12,
        "mfu": dense_flops / lat_s / peak if peak else None,
    }

    def recall(exact_idx, nq):
        return float(np.mean([len(set(our_idx[j]) & set(exact_idx[j])) / topk_eval
                              for j in range(nq)]))

    if cpu_baseline:
        sparse_norm = sparse_cpu(gi, b)

        def hybrid_cpu():
            scores = q @ emb_host.T + 0.6 * sparse_norm
            part = np.argpartition(-scores, k - 1, axis=1)[:, :k]
            ps = np.take_along_axis(scores, part, axis=1)
            order = np.argsort(-ps, axis=1)
            return (np.take_along_axis(ps, order, 1),
                    np.take_along_axis(part, order, 1))

        hybrid_cpu()                     # warm caches
        best_cpu = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            _, cpu_idx = hybrid_cpu()
            best_cpu = min(best_cpu, time.perf_counter() - t0)
        out["cpu_baseline_qps"] = b / best_cpu
        out["vs_baseline"] = qps * best_cpu / b
        out["recall_at_10_vs_exact_f32"] = recall(cpu_idx[:, :topk_eval], b)
    elif oracle_queries:
        nq = min(oracle_queries, b)
        sparse_sub = torch.from_numpy(sparse_cpu(gi[:nq], nq)).to(dev)
        oracle = _exact_oracle(emb_dev, torch.from_numpy(q[:nq]).to(dev),
                               sparse_sub, topk_eval)
        out["recall_at_10_vs_exact_f32"] = recall(oracle.cpu().numpy(), nq)
        out["recall_oracle_queries"] = nq
    if keep_ctx:
        out["_ctx"] = {"emb_dev": emb_dev, "dr_dev": dr_dev, "wr_dev": wr_dev,
                       "k": k, "n_docs": n_docs, "batch": b, "q_dev": q_dev,
                       "max_seg": q_len}
    return out


def _timed(dev: torch.device, fn) -> float:
    """Seconds fn() takes: CUDA events on the card, the host clock on the
    CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def bench_true_device(ctx: dict, recall_target: float, iters=(2, 10)) -> dict:
    """Per-step device time of the whole hybrid step: `iters[0]`, then
    `iters[1]`, steps queued back to back between two CUDA events (best of
    4), and the slope between the two totals, so the fixed cost of a block
    drops out."""
    from anorag_tpu_torch.ops.topk import hybrid_topk

    emb, q = ctx["emb_dev"], ctx["q_dev"]
    dr, wr = ctx["dr_dev"], ctx["wr_dev"]
    n_docs, b, k = ctx["n_docs"], ctx["batch"], ctx["k"]
    dev = emb.device

    def steps(it):
        for _ in range(it):
            hybrid_topk(emb, q, dr, wr, k, n_docs=n_docs, dense_k=128,
                        sparse_m=SPARSE_M, sparse_weight=0.6,
                        recall_target=recall_target, max_seg=ctx["max_seg"],
                        select_approx=True)

    totals = {}
    for it in iters:
        steps(it)
        _sync(dev)
        totals[it] = min(_timed(dev, lambda: steps(it)) for _ in range(4))
    per_iter = max((totals[iters[1]] - totals[iters[0]]) / (iters[1] - iters[0]),
                   1e-9)
    dense_flops = 2.0 * b * n_docs * emb.shape[1]
    peak = peak_tflops(torch.cuda.get_device_name(dev)) if dev.type == "cuda" else None
    return {
        "latency_ms_true_device": 1e3 * per_iter,
        "qps_true_device": b / per_iter,
        "mfu_true_device": dense_flops / per_iter / peak if peak else None,
        "chain_iters": list(iters),
        "chain_totals_ms": {str(i): 1e3 * t for i, t in totals.items()},
    }


def bench_encoder(ctx: dict | None, b: int = 256, seq: int = 128,
                  q_seq: int = 64, rounds: int = 5, cfg=None, device=None) -> dict:
    """The encoder's forward pass at the default EncoderConfig (24 layers,
    hidden 1024, 16 heads, FFN 4096, bf16) with weights drawn from seed 0 on
    the device (the card's machine has no checkpoint reader; random weights
    cost the same operations): tokens/s and MFU over b x seq tokens, best of
    3 blocks of `rounds` calls; with a hybrid ctx, end-to-end encode ->
    hybrid search QPS at query length q_seq. cfg overrides the config (the
    tests run a small one); device defaults to ctx's, else the card."""
    from anorag_tpu_torch.models.encoder import Encoder, EncoderConfig
    from anorag_tpu_torch.ops.topk import hybrid_topk

    dev = ctx["emb_dev"].device if ctx is not None else resolve_device(device)
    cfg = cfg or EncoderConfig(max_position=max(seq, q_seq))
    enc = Encoder(cfg, dev).init_random(torch.Generator(device=dev).manual_seed(0))
    label = (f"bge-m3-class {cfg.num_layers}L/{cfg.hidden_size}h "
             f"(random-init, seed 0)")
    rng = np.random.default_rng(0)

    def tokens(rows, width):
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, width))).to(dev)
        return ids, torch.ones((rows, width), dtype=torch.int32, device=dev)

    def best_of_3(fn):
        fn()
        _sync(dev)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(rounds):
                fn()
            _sync(dev)
            best = min(best, time.perf_counter() - t0)
        return best

    ids, mask = tokens(b, seq)
    lat = best_of_3(lambda: enc(ids, mask)) / rounds
    n_tok = b * seq
    h, i_sz, n_layers = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    flops = n_tok * n_layers * (2 * (4 * h * h + 2 * h * i_sz) + 4 * seq * h)
    peak = peak_tflops(torch.cuda.get_device_name(dev)) if dev.type == "cuda" else None
    res = {
        "config": label,
        "batch": b, "seq_len": seq,
        "tokens_per_s": n_tok / lat,
        "latency_ms_per_batch": lat * 1e3,
        "achieved_tflops": flops / lat / 1e12,
        "mfu": flops / lat / peak if peak else None,
    }
    if ctx is not None:
        emb, dr, wr = ctx["emb_dev"], ctx["dr_dev"], ctx["wr_dev"]
        eb = ctx["batch"]                 # the sparse plan's batch
        q_ids, q_mask = tokens(eb, q_seq)

        def e2e():
            qv = enc(q_ids, q_mask).to(emb.dtype)
            return hybrid_topk(emb, qv, dr, wr, ctx["k"], n_docs=ctx["n_docs"],
                               dense_k=128, sparse_m=SPARSE_M, sparse_weight=0.6,
                               recall_target=RECALL_TARGET, max_seg=ctx["max_seg"],
                               select_approx=True)

        res["e2e_encode_search_qps"] = eb * rounds / best_of_3(e2e)
        res["e2e_query_seq_len"] = q_seq
    return res


def _scale_1m(device=None) -> dict:
    return bench_hybrid(1_000_000, cpu_baseline=False, oracle_queries=64,
                        rounds=10, seed=1, device=device)


def card_line() -> Optional[str]:
    """nvidia-smi's "name, power.limit" line of the first card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out[0].strip() if out else None


def _child(flag: str, timeout: int) -> str:
    """stdout of this module run again with `flag`; raises with its output
    when it fails."""
    proc = subprocess.run([sys.executable, "-m", "anorag_tpu_torch.bench", flag],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=Path(__file__).resolve().parents[1])
    if proc.returncode != 0:
        raise RuntimeError(f"{flag} failed (rc {proc.returncode}):\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout


def main(argv=None) -> int:
    """The benchmark; prints one JSON line, returns 1 when recall@10 misses
    RECALL_GATE. recall_autotune keeps the reference's key with one rung:
    the reference climbs a ladder of approx_max_k recall targets when the
    gate fails, but every route of the port is exact, so recall_target
    moves no result and a second rung could not change the recall."""
    argv = sys.argv[1:] if argv is None else argv
    if "--probe-only" in argv:
        x = torch.ones((128, 128), device="cuda")
        print(json.dumps({"probe": "ok", "v": float((x @ x)[0, 0]),
                          "backend": "cuda"}))
        return 0
    if "--scale-1m-only" in argv:
        print(json.dumps(_scale_1m()))
        return 0

    # A tiny op on the card in a child process first: a machine without a
    # working card gives one error line, not a traceback mid-run.
    try:
        _child("--probe-only", 300)
    except (RuntimeError, subprocess.TimeoutExpired) as e:
        print(json.dumps({"metric": "hybrid_query_qps_per_chip", "value": None,
                          "unit": "queries/s", "vs_baseline": None,
                          "error": f"no usable CUDA device: tiny-op probe failed "
                                   f"({type(e).__name__})"}))
        return 1

    # The 1M point first, in its own process, so its corpus meets a clean
    # card; the child exits and frees everything before the rest allocates.
    scale_1m = json.loads(_child("--scale-1m-only", 1800).strip().splitlines()[-1])

    dev = resolve_device("cuda")
    parity = kernel_parity(dev)
    headline = bench_hybrid(200_000, cpu_baseline=True, keep_ctx=True, device=dev)
    rec = headline["recall_at_10_vs_exact_f32"]
    gate_ok = rec >= RECALL_GATE
    autotune = [{"rt": headline["recall_target"], "recall": rec,
                 "qps": headline["qps"]}]
    ctx = headline.pop("_ctx")
    true_dev = bench_true_device(ctx, headline["recall_target"])
    encoder = bench_encoder(ctx)
    del ctx

    kind = torch.cuda.get_device_name(dev)
    peak = peak_tflops(kind)
    out = {
        "metric": "hybrid_query_qps_per_chip",
        "search_method": "exact dense candidates (f32 scores of bf16 rows, "
                         "65,536-row chunks, exact top-128) + window-winners "
                         "BM25 kernel (max_seg 8), exact selects",
        "value": headline["qps"],
        "unit": "queries/s",
        "vs_baseline": headline["vs_baseline"],
        "recall_at_10_vs_exact_f32": rec,
        "recall_gate": RECALL_GATE,
        "recall_gate_passed": gate_ok,
        "recall_target_used": headline["recall_target"],
        "recall_autotune": autotune,
        "corpus": {"n_docs": headline["n_docs"], "dim": 1024, "dtype": "bfloat16"},
        "batch": headline["batch"],
        "latency_ms_per_batch": headline["latency_ms_per_batch"],
        "achieved_tflops": headline["achieved_tflops"],
        "mfu": headline["mfu"],
        "true_device": true_dev,
        "peak_tflops_assumed": peak / 1e12 if peak else None,
        "cpu_baseline_qps": headline["cpu_baseline_qps"],
        "kernel_parity": parity,
        "encoder": encoder,
        "scale_1m": scale_1m,
        "backend": "cuda",
        "device": {"name": kind, "nvidia_smi": card_line()},
    }
    print(json.dumps(out))
    return 0 if gate_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
