"""PyTorch/CUDA port of anorag_tpu for one NVIDIA H100.

The package mirrors anorag_tpu's layout (ops/bm25.py, ops/topk.py,
models/encoder.py, ...) so each module has an obvious counterpart, and it
imports nothing from anorag_tpu and nothing of JAX: the JAX package stays
the reference that the port is tested against. Entry points run on the
card (`device="cuda"`) unless the caller passes `device="cpu"`.

The port covers the offline knowledge-base build (doc/processor.py,
python -m anorag_tpu_torch.main process), the per-query pipeline and the
batched hybrid query (query/processor.py), the HTTP server (serve.py) and
the LLM layer; every TPU kernel of anorag_tpu/ops has a hand-written CUDA
counterpart in csrc/.
"""

# the reference's version: ArtifactStore stamps it into its manifests
__version__ = "0.3.3"
