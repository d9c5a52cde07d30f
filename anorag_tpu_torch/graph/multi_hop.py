"""MultiHopQueryProcessor: owns the GraphIndex + GraphRetriever.

Counterpart of anorag_tpu/graph/multi_hop.py, copied with its imports
renamed, except that the constructor takes the device (keyword only; the
card unless the caller asks for the CPU) that the graph is built or
loaded on, and keeps the embeddings as the graph index's f32 tensor.

Parity target: upstream graph/multi_hop_query_processor.py:16-83 —
load-or-build the graph index, then retrieve(query_emb, top_k, keywords,
entities) -> notes with reasoning-path explanations.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from anorag_tpu_torch.device import DeviceLike, resolve_device
from anorag_tpu_torch.graph.builder import GraphBuilder
from anorag_tpu_torch.graph.graph_index import GraphIndex
from anorag_tpu_torch.graph.retriever import GraphRetriever, ReasoningPath


class MultiHopQueryProcessor:
    def __init__(
        self,
        notes: Optional[Sequence[Dict[str, Any]]] = None,
        embeddings: Optional[np.ndarray] = None,
        graph_file: Optional[str] = None,
        retriever_kwargs: Optional[Dict[str, Any]] = None,
        *,
        device: DeviceLike = None,
    ):
        device = resolve_device(device)
        if graph_file and Path(graph_file).exists():
            self.graph_index = GraphIndex.load(graph_file, device=device)
            if embeddings is not None and self.graph_index.embeddings is None:
                self.graph_index.embeddings = torch.as_tensor(embeddings).to(
                    device, torch.float32)
        else:
            self.graph_index = GraphBuilder(device=device).build_graph(
                list(notes or []), embeddings)
        self.retriever = GraphRetriever(self.graph_index, **(retriever_kwargs or {}))

    def retrieve(
        self,
        query_emb: Optional[np.ndarray] = None,
        top_k: int = 20,
        keywords: Sequence[str] = (),
        entities: Sequence[str] = (),
    ) -> Tuple[List[Dict[str, Any]], List[ReasoningPath]]:
        return self.retriever.retrieve_with_reasoning_paths(
            query_emb=query_emb, top_k=top_k, keywords=keywords, entities=entities
        )
