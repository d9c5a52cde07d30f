"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests skip without a GPU. The card's machine has no JAX, so
this file imports none and runs without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from anorag_tpu_torch.ops import bm25
from anorag_tpu_torch.testing import WINDOW_CASES, sorted_plan


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["rows", "tiled"])
def test_window_winners_kernel_matches_ref(cuda_device, layout):
    for n_docs, b, l, max_seg in WINDOW_CASES:
        a, w = sorted_plan(np.random.default_rng(l), n_docs, b, l, max_seg)
        if layout == "tiled":
            a, w = bm25.plan_tiles(a, w, n_docs)
        at = torch.from_numpy(a).to(cuda_device)
        wt = torch.from_numpy(w).to(cuda_device)
        before = bm25.window_winners.launches
        got = bm25.window_winners(at, wt, n_docs, max_seg, b_valid=b)
        assert bm25.window_winners.launches == before + 1
        want = bm25.window_winners_ref(at, wt, n_docs, max_seg, b_valid=b)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]), (n_docs, b, l, max_seg)
        torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=0)
        torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_window_winners_rejects_what_the_kernel_does_not_take(cuda_device):
    a = torch.zeros((2, 300), dtype=torch.int32, device=cuda_device)
    w = torch.zeros((2, 300), device=cuda_device)
    with pytest.raises(TypeError):
        bm25.window_winners(a.long(), w, 10, 8)
    with pytest.raises(ValueError):
        bm25.window_winners(a.t().contiguous().t(), w.t().contiguous().t(), 10, 8)
    with pytest.raises(ValueError):
        bm25.window_winners(a, w.cpu(), 10, 8)
