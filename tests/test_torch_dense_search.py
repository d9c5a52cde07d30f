"""The port's dense top-k (anorag_tpu_torch/ops/topk.py) against
anorag_tpu/ops/topk.py on the CPU, on the same numpy inputs.

The kernel route's plain version (dense_topk_ref, what dense_topk_kernel
runs on CPU tensors) is held against the Pallas kernel in interpret mode,
as tests/test_topk.py runs it; every other method against its JAX
counterpart. On tie-free data the rows are equal and scores agree to 1e-5
(f32 sums taken in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from anorag_tpu.ops.topk import dense_topk as j_dense_topk
from anorag_tpu.ops.topk import dense_topk_np as j_dense_topk_np
from anorag_tpu.ops.topk import dense_topk_xla as j_dense_topk_xla
from anorag_tpu_torch.ops import topk
from anorag_tpu_torch.testing import TOPK_CASES, TOPK_TIE_CASES, tie_rows, unit_rows

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(n, d, b, seed=0, with_bias=False):
    rng = np.random.default_rng(seed)
    emb = unit_rows(rng, n, d)
    q = unit_rows(rng, b, d)
    bias = rng.standard_normal((b, n)).astype(np.float32) if with_bias else None
    return emb, q, bias


def _same(got, want, atol=1e-5):
    gv, gi = (np.asarray(x) for x in got)
    wv, wi = (np.asarray(x) for x in want)
    assert gv.shape == wv.shape
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gv, wv, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", TOPK_CASES, ids=lambda c: "n{}-d{}-b{}-k{}-bias{}".format(*c))
def test_kernel_route_matches_pallas_interpret(case, dtype):
    """dense_topk(method="kernel") on the CPU (dense_topk_ref) against
    dense_topk(method="pallas", interpret=True), with and without bias,
    k > N padding included."""
    n, d, b, k, with_bias = case
    emb, q, bias = _inputs(n, d, b, seed=n, with_bias=with_bias)
    jdt, tdt = DTYPES[dtype]
    want = j_dense_topk(jnp.asarray(emb, jdt), q, k, method="pallas",
                        interpret=True, block_rows=256, bias=bias, bias_weight=0.7)
    got = topk.dense_topk(torch.from_numpy(emb).to(tdt), torch.from_numpy(q), k,
                          method="kernel",
                          bias=None if bias is None else torch.from_numpy(bias),
                          bias_weight=0.7)
    _same(got, want)
    assert got[0].shape == (b, k)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", TOPK_TIE_CASES, ids=lambda c: "n{}-d{}-b{}-k{}-bias{}".format(*c))
def test_kernel_route_keeps_the_reference_rows_among_ties(case, dtype):
    """On the tie-heavy corpora (integer scores, whole sub-tiles tied) the
    kernel route on the CPU (dense_topk_ref) returns exactly the reference's
    exact route: lax.top_k's lower row first, which the kernel keeps too
    (the Pallas kernel's slot history is not the rule; see
    test_tie_rule_is_lower_row_first)."""
    n, d, b, k, has_bias = case
    emb, q, bias = tie_rows(np.random.default_rng(n), n, d, b, has_bias)
    jdt, tdt = DTYPES[dtype]
    want = j_dense_topk(jnp.asarray(emb, jdt), q, k, method="exact", bias=bias,
                        bias_weight=0.7)
    got = topk.dense_topk(torch.from_numpy(emb).to(tdt), torch.from_numpy(q), k,
                          method="kernel",
                          bias=None if bias is None else torch.from_numpy(bias),
                          bias_weight=0.7)
    _same(got, want, atol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("method", ["auto", "approx", "exact", "scan",
                                    "approx_scan", "exact_smalln"])
def test_methods_match_reference(method, dtype):
    emb, q, _ = _inputs(900, 48, 6, seed=3)
    jdt, tdt = DTYPES[dtype]
    want = j_dense_topk(jnp.asarray(emb, jdt), q, 25, method=method)
    got = topk.dense_topk(torch.from_numpy(emb).to(tdt), torch.from_numpy(q), 25,
                          method=method)
    _same(got, want)


@pytest.mark.parametrize("method", ["auto", "approx", "exact", "exact_smalln"])
def test_methods_with_bias_match_reference(method):
    emb, q, bias = _inputs(500, 32, 4, seed=5, with_bias=True)
    want = j_dense_topk(emb, q, 12, method=method, bias=bias, bias_weight=0.4)
    got = topk.dense_topk(torch.from_numpy(emb), torch.from_numpy(q), 12,
                          method=method, bias=torch.from_numpy(bias),
                          bias_weight=0.4)
    _same(got, want)


@pytest.mark.parametrize("method", ["approx", "exact", "scan"])
def test_methods_across_corpus_chunks_match_reference(method, monkeypatch):
    """The matmul routes scan the corpus SCAN_CHUNK rows at a time; with a
    small chunk the exact merge across chunks is exercised, bias included."""
    monkeypatch.setattr(topk, "SCAN_CHUNK", 128)
    emb, q, bias = _inputs(700, 32, 5, seed=9, with_bias=True)
    fused = None if method == "scan" else bias
    want = j_dense_topk(emb, q, 40, method="exact" if method == "scan" else method,
                        bias=fused, bias_weight=0.4)
    got = topk.dense_topk(torch.from_numpy(emb), torch.from_numpy(q), 40,
                          method=method, bias=torch.from_numpy(bias),
                          bias_weight=0.4)
    _same(got, want)


@pytest.mark.parametrize("levels", [2, 5, 1000])
@pytest.mark.parametrize("k", [1, 7, 64, 200])
def test_top_k_matches_lax_top_k_with_ties(levels, k):
    """top_k (one torch.topk over value-and-index keys) equals lax.top_k,
    values and indices, on data with many ties."""
    import jax

    x = np.random.default_rng(levels + k).integers(0, levels, (6, 200)).astype(np.float32)
    want = jax.lax.top_k(jnp.asarray(x), k)
    got = topk.top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_use_kernel_matches_use_pallas(use_kernel):
    emb, q, _ = _inputs(700, 64, 5, seed=7)
    want = j_dense_topk(emb, q, 10, use_pallas=use_kernel, block_rows=256,
                        interpret=True)
    got = topk.dense_topk(torch.from_numpy(emb), torch.from_numpy(q), 10,
                          use_kernel=use_kernel)
    _same(got, want)


@pytest.mark.parametrize("k", [1, 10, 33])
def test_dense_topk_xla_matches_reference(k):
    emb, q, _ = _inputs(700, 64, 5)
    want = j_dense_topk_xla(emb, q, k, chunk=256)
    got = topk.dense_topk_xla(torch.from_numpy(emb), torch.from_numpy(q), k, chunk=256)
    _same(got, want)


def test_dense_topk_np_is_the_reference_oracle():
    emb, q, _ = _inputs(400, 16, 3, seed=11)
    for got, want in zip(topk.dense_topk_np(emb, q, 9), j_dense_topk_np(emb, q, 9)):
        np.testing.assert_array_equal(got, want)


def _tie_corpus():
    """Scores 0.5 at rows 0 and 1, 0.9 at row 128, 0 elsewhere."""
    emb = np.zeros((256, 4), np.float32)
    emb[0, 0] = emb[1, 0] = 0.5
    emb[128, 0] = 0.9
    return emb, np.array([[1.0, 0.0, 0.0, 0.0]], np.float32)


@pytest.mark.parametrize("method", ["kernel", "exact", "scan", "auto"])
def test_tie_rule_is_lower_row_first(method):
    """Among exactly tied scores the port keeps the lower row, as the
    reference's exact and scan methods do ([128, 0]). It does not follow the
    reference's Pallas kernel, which returns [128, 1] here: that kernel
    replaces the first slot holding the running minimum (ops/topk.py:101-106),
    so the rows it keeps among ties follow its slot history, not the row
    order."""
    emb, q = _tie_corpus()
    _, want = j_dense_topk(emb, q, 2, method="exact")
    _, pallas = j_dense_topk(emb, q, 2, method="pallas", interpret=True,
                             block_rows=128)
    assert np.asarray(want).tolist() == [[128, 0]]
    assert np.asarray(pallas).tolist() == [[128, 1]]
    _, got = topk.dense_topk(torch.from_numpy(emb), torch.from_numpy(q), 2,
                             method=method)
    assert got.tolist() == [[128, 0]]


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    emb = torch.zeros((50, 8))
    q = torch.zeros((2, 8))
    with pytest.raises(TypeError):
        topk.dense_topk_kernel(emb.half(), q.half(), 3)
    with pytest.raises(TypeError):
        topk.dense_topk_kernel(emb.bfloat16(), q, 3)
    with pytest.raises(TypeError):
        topk.dense_topk_kernel(emb, q, 3, bias=torch.zeros((2, 50), dtype=torch.float64))
    with pytest.raises(ValueError):
        topk.dense_topk_kernel(emb, q, 3, bias=torch.zeros((2, 49)))
    with pytest.raises(ValueError, match="1024"):
        topk.dense_topk_kernel(torch.zeros((2000, 8)), q, 1025)
    with pytest.raises(ValueError, match="unknown"):
        topk.dense_topk(emb, q, 3, method="pallas")
