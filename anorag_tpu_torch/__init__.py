"""PyTorch/CUDA port of anorag_tpu for one NVIDIA H100.

The package mirrors anorag_tpu's layout (ops/bm25.py, ops/topk.py,
models/encoder.py, ...) so each module has an obvious counterpart, and it
imports nothing from anorag_tpu and nothing of JAX: the JAX package stays
the reference that the port is tested against. Entry points run on the
card (`device="cuda"`) unless the caller passes `device="cpu"`.

The ported slice is the batched hybrid query: text in, query encoding,
BM25 posting plan, dense + sparse candidate-union fusion, ranked notes out,
served by ServingEngine. Its one TPU kernel, BM25 window-winners, is the
CUDA kernel in csrc/window_winners.cu.
"""
