"""GraphIndex: CSR note graph + centrality + persistence.

Counterpart of anorag_tpu/graph/graph_index.py, copied with its imports
renamed, except where the index's device enters: the constructor takes it
(keyword only; the card unless the caller asks for the CPU), build_index
keeps the embeddings as one f32 tensor on it (no copy when they are one
already) and runs PageRank there (ops/graph.pagerank, numpy centrality as
the reference's), save writes them back to numpy, and cosines (the
port's own) scores rows against a query there (ops.graph.cosines, row
norms computed once). save / load keep the reference's file format
(node-link JSON, the _embeddings.npz and _mappings.json sidecars), so a
graph file written by anorag_tpu loads here.

Parity target: upstream graph/graph_index.py — holds the graph,
note_id<->index maps, embeddings; computes weighted PageRank centrality at
build (:43-49); saves/loads JSON node-link + embeddings + mappings sidecars
(:68-112); GraphML export with attribute sanitization (:114-155).
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from anorag_tpu_torch.device import DeviceLike, resolve_device
from anorag_tpu_torch.graph.relation_extractor import RELATION_TYPE_IDS, RELATION_TYPES
from anorag_tpu_torch.ops.graph import CSRGraph, build_csr, cosines, pagerank
from anorag_tpu_torch.utils.file_io import read_json, write_json
from anorag_tpu_torch.utils.logging import get_logger

logger = get_logger("anorag.graph")
_TYPE_NAMES = list(RELATION_TYPES)


class GraphIndex:
    def __init__(self, pagerank_alpha: float = 0.85, pagerank_iters: int = 30, *,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.alpha = pagerank_alpha
        self.iters = pagerank_iters
        self.notes: List[Dict[str, Any]] = []
        self.note_id_to_idx: Dict[str, int] = {}
        self.graph: Optional[CSRGraph] = None
        self.centrality: Optional[np.ndarray] = None
        self.embeddings: Optional[torch.Tensor] = None
        self.edge_meta: List[Dict[str, Any]] = []

    def build_index(
        self,
        notes: Sequence[Dict[str, Any]],
        relations: Sequence[Dict[str, Any]],
        embeddings: Optional[np.ndarray] = None,
    ) -> "GraphIndex":
        self.notes = list(notes)
        self.note_id_to_idx = {n.get("note_id"): i for i, n in enumerate(self.notes)}
        self.embeddings = None if embeddings is None else torch.as_tensor(
            embeddings).to(self.device, torch.float32)
        edges = [
            (
                int(r["source"]), int(r["target"]), float(r.get("weight", 1.0)),
                RELATION_TYPE_IDS.get(r.get("relation_type", "semantic_similarity"), 0),
            )
            for r in relations
        ]
        self.edge_meta = list(relations)
        self.graph = build_csr(len(self.notes), edges, device=self.device)
        if len(self.notes):
            t = self.graph.tensors()
            self.centrality = pagerank(t["nbr"], t["nbr_w"], alpha=self.alpha,
                                       iters=self.iters).cpu().numpy()
        else:
            self.centrality = np.zeros(0, np.float32)
        logger.info("graph index: %d nodes, %d edges", len(self.notes), len(edges))
        return self

    # ------------------------------------------------------------- access
    def idx_of(self, note_id: str) -> int:
        return self.note_id_to_idx.get(note_id, -1)

    def note(self, idx: int) -> Dict[str, Any]:
        return self.notes[idx]

    def neighbors(self, idx: int) -> List[Dict[str, Any]]:
        g = self.graph
        out = []
        for j in range(g.nbr.shape[1]):
            v = int(g.nbr[idx, j])
            if v < 0:
                break
            out.append({
                "index": v,
                "weight": float(g.nbr_w[idx, j]),
                "relation_type": _TYPE_NAMES[int(g.nbr_t[idx, j])],
            })
        return out

    def cosines(self, query_emb, rows: Optional[Sequence[int]] = None) -> np.ndarray:
        """Cosine of each embedding row (all, or `rows`) with query_emb on
        the index's device (ops.graph.cosines): (len,) f32 numpy."""
        return cosines(self.embeddings, query_emb, rows).cpu().numpy()

    # -------------------------------------------------------- persistence
    def save(self, path: str | Path) -> None:
        path = Path(path)
        node_link = {
            "nodes": [{"id": n.get("note_id"), **{k: v for k, v in n.items() if k != "note_id"}}
                      for n in self.notes],
            "links": [
                {
                    "source": self.notes[r["source"]].get("note_id"),
                    "target": self.notes[r["target"]].get("note_id"),
                    "weight": r.get("weight", 1.0),
                    "relation_type": r.get("relation_type"),
                }
                for r in self.edge_meta
            ],
        }
        write_json(path, node_link)
        sidecar = {}
        if self.embeddings is not None:
            sidecar["embeddings"] = self.embeddings.cpu().numpy()
        if self.centrality is not None:
            sidecar["centrality"] = self.centrality
        if sidecar:
            np.savez_compressed(str(path) + "_embeddings.npz", **sidecar)
        write_json(str(path) + "_mappings.json", self.note_id_to_idx)

    @classmethod
    def load(cls, path: str | Path, **kw) -> "GraphIndex":
        path = Path(path)
        data = read_json(path)
        inst = cls(**kw)
        notes = []
        for node in data.get("nodes", []):
            n = dict(node)
            n["note_id"] = n.pop("id")
            notes.append(n)
        id_to_idx = {n["note_id"]: i for i, n in enumerate(notes)}
        relations = [
            {
                "source": id_to_idx[l["source"]],
                "target": id_to_idx[l["target"]],
                "weight": l.get("weight", 1.0),
                "relation_type": l.get("relation_type", "semantic_similarity"),
            }
            for l in data.get("links", [])
            if l.get("source") in id_to_idx and l.get("target") in id_to_idx
        ]
        emb = None
        sidecar = Path(str(path) + "_embeddings.npz")
        if sidecar.exists():
            with np.load(sidecar) as z:
                emb = z["embeddings"] if "embeddings" in z.files else None
        inst.build_index(notes, relations, emb)
        return inst
