"""Counterpart of anorag_tpu/graph/quality.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Graph quality metrics (density, components, degree).

Parity target: upstream graph/graph_quality.py:5-46, computed on CSR
arrays (components via on-device label propagation).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from anorag_tpu_torch.ops.graph import connected_components


def compute_metrics(graph_index) -> Dict[str, Any]:
    g = graph_index.graph
    n = g.n_nodes
    m = g.n_edges
    if n == 0:
        return {"nodes": 0, "edges": 0, "density": 0.0, "components": 0,
                "avg_degree": 0.0, "max_degree": 0, "isolated_nodes": 0}
    deg = (g.nbr >= 0).sum(axis=1)
    labels = connected_components(g)
    return {
        "nodes": int(n),
        "edges": int(m),
        "density": float(2 * m / (n * (n - 1))) if n > 1 else 0.0,
        "components": int(len(np.unique(labels))),
        "avg_degree": float(deg.mean()),
        "max_degree": int(deg.max()),
        "isolated_nodes": int((deg == 0).sum()),
    }
