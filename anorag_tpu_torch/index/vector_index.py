"""VectorIndex, Flat only: the dense corpus on the device.

Counterpart of anorag_tpu/index/vector_index.py: _preprocess (:122),
_effective_type (:146) and flat_device_emb (:347). The default IVFFlat
resolves to Flat below ivf_min_corpus rows, as in the reference; IVF at or
above that size, IVFPQ, LSH and HNSW are not ported yet (ROADMAP, queue 1
item "Alternative indexes") and raise NotImplementedError.
"""
from __future__ import annotations

from typing import Optional

import torch

from anorag_tpu_torch.device import DeviceLike, resolve_device

def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP: alternative indexes -- IVF, PQ, "
        f"SQ, LSH); the port serves Flat, and IVFFlat below ivf_min_corpus")


class VectorIndex:
    def __init__(
        self,
        dimension: int = 1024,
        index_type: str = "IVFFlat",
        ivf_min_corpus: int = 5_000_000,
        device: DeviceLike = None,
    ):
        if index_type not in ("Flat", "IVFFlat"):
            raise _not_ported(f"index type {index_type!r}")
        self.dimension = dimension
        self.index_type = index_type
        self.ivf_min_corpus = ivf_min_corpus
        self.device = resolve_device(device)
        self._device_emb: Optional[torch.Tensor] = None

    @property
    def ntotal(self) -> int:
        return 0 if self._device_emb is None else self._device_emb.shape[0]

    def _preprocess(self, vecs) -> torch.Tensor:
        """f32 rows on the index's device, L2-normalized so that the inner
        product is the cosine (the reference's default metric)."""
        vecs = torch.as_tensor(vecs, dtype=torch.float32, device=self.device)
        norms = torch.linalg.vector_norm(vecs, dim=1, keepdim=True)
        return vecs / norms.clamp_min(1e-12)

    def _effective_type(self, n: int) -> str:
        if self.index_type == "IVFFlat" and n < self.ivf_min_corpus:
            return "Flat"
        return self.index_type

    def add(self, vectors) -> None:
        vecs = self._preprocess(vectors)
        if vecs.shape[1] != self.dimension:
            raise ValueError(f"vectors of width {vecs.shape[1]}, index of "
                             f"width {self.dimension}")
        n = self.ntotal + vecs.shape[0]
        if self._effective_type(n) != "Flat":
            raise _not_ported(f"IVFFlat at {n} rows (>= ivf_min_corpus "
                              f"{self.ivf_min_corpus})")
        vecs = vecs.to(torch.bfloat16)    # the reference's storage_dtype
        self._device_emb = (vecs if self._device_emb is None
                            else torch.cat([self._device_emb, vecs]))

    def flat_device_emb(self) -> torch.Tensor:
        """(N, D) bf16 corpus rows in original row order."""
        return self._device_emb
