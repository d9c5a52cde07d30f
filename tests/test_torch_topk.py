"""Parity of the port's hybrid fusion (anorag_tpu_torch/ops/topk.py) with
anorag_tpu/ops/topk.py::hybrid_topk in f32 on the same numpy inputs: a
(B, L) plan takes the from-sorted chain in both packages, a plan_tiles
plan takes the window-winners kernel (Pallas in interpret mode against
the port's plain version). Top-k ids equal, scores to 1e-5."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from anorag_tpu.ops.topk import hybrid_topk as j_hybrid_topk
from anorag_tpu_torch.ops.bm25 import plan_tiles
from anorag_tpu_torch.ops.topk import hybrid_topk, top_k
from anorag_tpu_torch.testing import sorted_plan


def _inputs(seed, n_docs=700, d=64, b=3, l=2311, max_seg=8):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n_docs, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    a, w = sorted_plan(rng, n_docs, b, l, max_seg)
    return emb, q, a, w


@pytest.mark.parametrize("layout", ["rows", "tiled"])
def test_hybrid_topk_parity(layout):
    n_docs, max_seg, k = 700, 8, 10
    emb, q, a, w = _inputs(0, n_docs=n_docs, max_seg=max_seg)
    if layout == "tiled":
        a, w = plan_tiles(a, w, n_docs)
    kw = dict(k=k, n_docs=n_docs, dense_k=40, sparse_m=40, max_seg=max_seg)
    jv, ji = j_hybrid_topk(jnp.asarray(emb), jnp.asarray(q), jnp.asarray(a),
                           jnp.asarray(w), **kw)
    tv, ti = hybrid_topk(torch.from_numpy(emb), torch.from_numpy(q),
                         torch.from_numpy(a), torch.from_numpy(w), **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)


def test_top_k_ties_go_to_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    v, i = top_k(x, 2)
    assert i.tolist() == [[1, 2]] and v.tolist() == [[3.0, 3.0]]
