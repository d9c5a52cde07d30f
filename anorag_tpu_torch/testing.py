"""Inputs shared by the CPU parity tests and chip_smoke.py: sorted BM25
posting plans at odd shapes for the window-winners kernel."""
from __future__ import annotations

from typing import Tuple

import numpy as np

# (n_docs, B, L, max_seg): B = 1 and 3; L below 128, L prime, L across the
# 1024-wide winners table; every max_seg the main path can pick from
# {1, 2, 8, 32}. In a B = 3 case row 0 is empty and row 1 is full.
WINDOW_CASES = (
    (17, 1, 7, 1),
    (257, 3, 113, 2),
    (100, 3, 640, 8),
    (1000, 1, 1021, 8),
    (300, 3, 2311, 32),
)


def sorted_plan(rng: np.random.Generator, n_docs: int, b: int, l: int,
                max_seg: int) -> Tuple[np.ndarray, np.ndarray]:
    """(doc_rows (B, L) int32, weight_rows (B, L) f32) as gather_plan_sorted
    builds them: ids sorted per row, each doc at most max_seg times, pad id
    n_docs with weight 0, weights in [0.01, 1.01)."""
    rows = []
    for bi in range(b):
        if b > 1 and bi == 0:
            ids = np.full(l, n_docs)                          # empty row
        elif b > 1 and bi == 1:
            # full row: no pad, every segment max_seg long (the widest the
            # window covers); needs n_docs * max_seg >= L
            docs = np.sort(rng.choice(n_docs, -(-l // max_seg), replace=False))
            ids = np.repeat(docs, max_seg)
        else:
            ids = np.sort(rng.integers(0, n_docs, int(rng.integers(1, l + 1))))
            v, c = np.unique(ids, return_counts=True)
            ids = np.repeat(v, np.minimum(c, max_seg))
        ids = np.concatenate([ids, np.full(max(l - len(ids), 0), n_docs)])
        rows.append(ids[:l].astype(np.int32))
    a = np.stack(rows)
    w = np.where(a < n_docs, rng.random((b, l)).astype(np.float32) + 0.01,
                 0.0).astype(np.float32)
    return a, w
