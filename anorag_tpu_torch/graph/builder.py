"""GraphBuilder: notes -> GraphIndex (+ quality metrics).

Counterpart of anorag_tpu/graph/builder.py, copied with its imports
renamed, except that the constructor takes the device (keyword only; the
card unless the caller asks for the CPU) that its RelationExtractor and
the GraphIndex it builds run on.

Parity target: upstream graph/graph_builder.py:18-50 — nodes carry
the full note payload, edges come from RelationExtractor with
weight/relation_type. Instead of an nx.Graph intermediate, edges go straight
into the CSR GraphIndex.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

from anorag_tpu_torch.device import DeviceLike, resolve_device
from anorag_tpu_torch.graph.graph_index import GraphIndex
from anorag_tpu_torch.graph.quality import compute_metrics
from anorag_tpu_torch.graph.relation_extractor import RelationExtractor


class GraphBuilder:
    def __init__(self, extractor: Optional[RelationExtractor] = None,
                 pagerank_alpha: float = 0.85, pagerank_iters: int = 30, *,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.extractor = extractor or RelationExtractor(device=self.device)
        self.pagerank_alpha = pagerank_alpha
        self.pagerank_iters = pagerank_iters

    def build_graph(
        self,
        notes: Sequence[Dict[str, Any]],
        embeddings: Optional[np.ndarray] = None,
        topic_groups: Optional[Sequence[Sequence[str]]] = None,
    ) -> GraphIndex:
        relations = self.extractor.extract_all_relations(notes, embeddings, topic_groups)
        return GraphIndex(self.pagerank_alpha, self.pagerank_iters,
                          device=self.device).build_index(
            notes, relations, embeddings
        )

    def build_graph_with_metrics(self, notes, embeddings=None, topic_groups=None):
        gi = self.build_graph(notes, embeddings, topic_groups)
        return gi, compute_metrics(gi)

    @staticmethod
    def to_graph_data(gi: GraphIndex) -> Dict[str, Any]:
        """node-link dict matching the reference graph.json artifact."""
        return {
            "nodes": [{"id": n.get("note_id"), **{k: v for k, v in n.items() if k != "note_id"}}
                      for n in gi.notes],
            "links": [
                {
                    "source": gi.notes[r["source"]].get("note_id"),
                    "target": gi.notes[r["target"]].get("note_id"),
                    "weight": r.get("weight", 1.0),
                    "relation_type": r.get("relation_type"),
                }
                for r in gi.edge_meta
            ],
        }
