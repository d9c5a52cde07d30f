"""Counterpart of anorag_tpu/utils/padding.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Pad-to-bucket helpers — the static-shape discipline for XLA.

Candidate pools, postings lists, and neighbor lists are dynamic in the
reference; on TPU every device array is padded to a bucket size and carries a
validity mask (SURVEY.md §7.3 "Dynamic shapes").
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple if multiple > 1 else max(x, 1)


def bucket_size(n: int, multiple: int = 128, min_size: int = 128) -> int:
    """Next power-of-two-ish bucket aligned to `multiple`."""
    n = max(n, 1)
    b = min_size
    while b < n:
        b *= 2
    return round_up(b, multiple)


def pad_rows(arr: np.ndarray, target_rows: int, fill: float = 0.0) -> np.ndarray:
    """Pad the leading axis to `target_rows`."""
    arr = np.asarray(arr)
    n = arr.shape[0]
    if n == target_rows:
        return arr
    if n > target_rows:
        raise ValueError(f"cannot pad {n} rows down to {target_rows}")
    pad_shape = (target_rows - n,) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)], axis=0)


def pad_1d(values: Sequence, target: int, fill) -> np.ndarray:
    out = np.full((target,), fill)
    vals = np.asarray(list(values))
    out = out.astype(vals.dtype) if len(vals) else out
    out[: len(vals)] = vals
    return out


def pad_ragged(
    rows: Sequence[Sequence[int]],
    pad_value: int = -1,
    width_multiple: int = 8,
    max_width: int | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged int lists -> (padded matrix, lengths). Width aligned for TPU."""
    lens = np.array([len(r) for r in rows], dtype=np.int32)
    width = int(lens.max()) if len(lens) and lens.max() > 0 else 1
    if max_width is not None:
        width = min(width, max_width)
    width = round_up(width, width_multiple)
    out = np.full((len(rows), width), pad_value, dtype=np.int32)
    for i, r in enumerate(rows):
        r = list(r)[:width]
        out[i, : len(r)] = r
        lens[i] = len(r)
    return out, lens


def mask_from_lengths(lengths: np.ndarray, width: int) -> np.ndarray:
    return np.arange(width)[None, :] < np.asarray(lengths)[:, None]
