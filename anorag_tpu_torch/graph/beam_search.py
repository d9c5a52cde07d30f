"""Counterpart of anorag_tpu/graph/beam_search.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Beam search over the literal-keyed NoteGraph.

Parity target: upstream graph/search.py:33-106 — anchors expand hop
by hop; an optional relation-chain constrains each hop's relation type
(alternatives split on '|', '*' matches anything); candidates are pruned by
(prev_key, rel) bucket caps then beam size; a path completes when it has
consumed the whole relation chain; degenerate zero-edge paths are dropped.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class KeyPath:
    keys: List[str] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)
    rels: List[str] = field(default_factory=list)
    score: float = 0.0

    @property
    def head(self) -> str:
        return self.keys[-1] if self.keys else ""


def _rel_allowed(rel: str, constraint: Optional[str]) -> bool:
    if not constraint or constraint == "*":
        return True
    return rel in {c.strip() for c in constraint.split("|") if c.strip()}


def beam_search(
    graph,
    anchors: Sequence[str],
    rel_chain: Optional[Sequence[str]] = None,
    max_hops: int = 4,
    beam_size: int = 8,
    branch: int = 6,
) -> List[KeyPath]:
    beams = [KeyPath(keys=[a]) for a in anchors if a]
    if not beams:
        return []
    done: List[KeyPath] = []

    for _ in range(max_hops):
        expansions: List[KeyPath] = []
        for path in beams:
            hop_idx = len(path.rels)
            if rel_chain is not None and hop_idx >= len(rel_chain):
                continue
            constraint = rel_chain[hop_idx] if rel_chain is not None else None
            advanced = False
            for rel, tail, note_id, weight, _para in graph.neighbors(path.head):
                if not _rel_allowed(rel, constraint):
                    continue
                if tail in path.keys:
                    continue
                advanced = True
                ext = KeyPath(
                    keys=path.keys + [tail],
                    notes=path.notes + [note_id],
                    rels=path.rels + [rel],
                    score=path.score + float(weight),
                )
                if rel_chain is not None and len(ext.rels) >= len(rel_chain):
                    done.append(ext)
                else:
                    expansions.append(ext)
            if not advanced and rel_chain is not None:
                # INVERSE hop fallback: "the album performed by P" anchors
                # at P, but the stored edge runs work --performed_by--> P.
                # Only when no forward edge satisfies the constraint, walk
                # the reverse adjacency (discounted so forward paths
                # outrank when both exist).
                for rel, src, note_id in graph.rheads(path.head):
                    if not _rel_allowed(rel, constraint):
                        continue
                    if src in path.keys:
                        continue
                    ext = KeyPath(
                        keys=path.keys + [src],
                        notes=path.notes + [note_id],
                        rels=path.rels + [rel],
                        score=path.score + 0.9,
                    )
                    if len(ext.rels) >= len(rel_chain):
                        done.append(ext)
                    else:
                        expansions.append(ext)
        if not expansions and not done:
            break
        expansions.sort(key=lambda p: -p.score)
        # (prev_key, rel) bucket caps keep one hub from flooding the beam
        bucket: Dict[Tuple[str, str], int] = {}
        beams = []
        for cand in expansions:
            bk = (cand.keys[-2] if len(cand.keys) > 1 else "", cand.rels[-1] if cand.rels else "")
            if bucket.get(bk, 0) >= max(1, branch):
                continue
            bucket[bk] = bucket.get(bk, 0) + 1
            beams.append(cand)
            if len(beams) >= beam_size:
                break
        if not beams:
            break

    results = [p for p in (done or beams) if p.notes]
    results.sort(key=lambda p: -p.score)
    return results[:beam_size]
