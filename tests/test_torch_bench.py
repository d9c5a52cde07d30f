"""The port's benchmark entry point (anorag_tpu_torch/bench.py) on the CPU:
its data generators against the repo's bench.py, and each phase at a tiny
size through the plain versions, returning the reference's keys."""
import numpy as np
import pytest

import bench as ref_bench
from anorag_tpu_torch import bench
from anorag_tpu_torch.models.encoder import EncoderConfig

HYBRID_KEYS = {"n_docs", "batch", "recall_target", "qps", "latency_ms_per_batch",
               "achieved_tflops", "mfu"}


@pytest.mark.parametrize("seed", [0, 3])
def test_generators_equal_the_reference(seed):
    a = bench.make_doc_terms(500, 3000, 40, np.random.default_rng(seed))
    b = ref_bench.make_doc_terms(500, 3000, 40, np.random.default_rng(seed))
    np.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype
    qa = bench.make_query_terms(16, 3000, 8, np.random.default_rng(seed))
    qb = ref_bench.make_query_terms(16, 3000, 8, np.random.default_rng(seed))
    assert qa == qb


def test_kernel_parity_on_the_cpu_returns_the_reference_keys():
    out = bench.kernel_parity(device="cpu")
    assert set(out) == {"bucket_topk", "segment_winners", "window_winners",
                        "winners_select_approx", "backend"}
    assert out["bucket_topk"] == "exact" and out["backend"] == "cpu"
    for key in ("segment_winners", "window_winners", "winners_select_approx"):
        assert out[key] >= 0.9


def test_bench_hybrid_passes_its_recall_gate_at_a_tiny_size():
    """3,000 docs at the bench's width 1024, B 16, one round: the exact
    routes reach the gate against the numpy baseline. (At width 64 the
    candidate union's approximation, not the port, caps recall near 0.93,
    in the reference as well.)"""
    out = bench.bench_hybrid(3000, b=16, dim=1024, rounds=1, device="cpu",
                             keep_ctx=True)
    ctx = out.pop("_ctx")
    assert set(out) == HYBRID_KEYS | {"cpu_baseline_qps", "vs_baseline",
                                      "recall_at_10_vs_exact_f32"}
    assert out["recall_at_10_vs_exact_f32"] >= bench.RECALL_GATE
    assert out["mfu"] is None                    # no peak for the CPU
    dev = bench.bench_true_device(ctx, bench.RECALL_TARGET, iters=(1, 2))
    assert set(dev) == {"latency_ms_true_device", "qps_true_device",
                        "mfu_true_device", "chain_iters", "chain_totals_ms"}


def test_bench_hybrid_device_oracle_route():
    out = bench.bench_hybrid(2000, b=8, dim=64, rounds=1, device="cpu",
                             cpu_baseline=False, oracle_queries=4)
    assert set(out) == HYBRID_KEYS | {"recall_at_10_vs_exact_f32",
                                      "recall_oracle_queries"}
    assert out["recall_oracle_queries"] == 4
    assert 0.0 <= out["recall_at_10_vs_exact_f32"] <= 1.0


def test_bench_encoder_at_a_small_config():
    cfg = EncoderConfig.small()
    ctx = bench.bench_hybrid(1000, b=4, dim=cfg.hidden_size, rounds=1,
                             device="cpu", cpu_baseline=False, keep_ctx=True)["_ctx"]
    out = bench.bench_encoder(ctx, b=2, seq=16, q_seq=8, rounds=1, cfg=cfg)
    assert set(out) == {"config", "batch", "seq_len", "tokens_per_s",
                        "latency_ms_per_batch", "achieved_tflops", "mfu",
                        "e2e_encode_search_qps", "e2e_query_seq_len"}
    assert out["tokens_per_s"] > 0 and out["e2e_query_seq_len"] == 8
    assert "random-init" in out["config"]


def test_peak_table():
    assert bench.peak_tflops("NVIDIA H100 80GB HBM3") == pytest.approx(989.4e12)
    assert bench.peak_tflops("NVIDIA H100 PCIe") == pytest.approx(756e12)
    assert bench.peak_tflops("NVIDIA H100 NVL") == pytest.approx(835e12)
    assert bench.peak_tflops("NVIDIA A100-SXM4-80GB") is None
