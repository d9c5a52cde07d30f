"""Counterpart of anorag_tpu/graph/note_graph.py,
copied as it is with its imports renamed to anorag_tpu_torch.

NoteGraph: literal-keyed adjacency over (head_key, rel, tail_key) notes.

Parity target: upstream graph/index.py — notes whose v2 schema
carries head_key/rel/tail_key become edges head_key -> tail_key; edge weight
= key_match_weight + type_compat_weight (if typed) + same_paragraph_bonus
(if a paragraph idx exists); lexical seed_recall with head-key
diversification; capped neighbor lookup. Used by the Chain-of-Retrieval
controller and the relation-chain answer selector.
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from anorag_tpu_torch.utils.text import tokenize


@dataclass(frozen=True)
class KeyEdge:
    rel: str
    tail_key: str
    note_id: str
    weight: float
    paragraph_idx: int


class NoteGraph:
    def __init__(
        self,
        key_match_weight: float = 1.5,
        type_compat_weight: float = 1.0,
        same_paragraph_bonus: float = 0.3,
        default_rel: str = "related_to",
    ):
        self.w_key = key_match_weight
        self.w_type = type_compat_weight
        self.b_para = same_paragraph_bonus
        self.default_rel = default_rel
        self.notes: Dict[str, Dict[str, Any]] = {}
        self._edges: Dict[str, List[KeyEdge]] = defaultdict(list)
        # reverse adjacency: tail_key -> [(rel, head_key, note_id)] — set
        # enumeration for the aggregation answer stages ("all works
        # released on label L")
        self._redges: Dict[str, List[Tuple[str, str, str]]] = defaultdict(list)

    @classmethod
    def from_config(cls, cfg) -> "NoteGraph":
        edge = cfg.get("graph.edge", {}) or {}
        return cls(
            key_match_weight=float(edge.get("key_match_weight", 1.5)),
            type_compat_weight=float(edge.get("type_compat_weight", 1.0)),
            same_paragraph_bonus=float(edge.get("same_paragraph_bonus", 0.3)),
            default_rel=str(cfg.get("note_keys.default_rel", "related_to")),
        )

    # -------------------------------------------------------------- build
    def add_note(self, note: Dict[str, Any]) -> None:
        text = str(note.get("text") or note.get("content") or "").strip()
        if not text:
            return
        nid = note.get("note_id") or note.get("id") or f"ng_{len(self.notes)}"
        note = dict(note)
        note.setdefault("id", nid)
        note.setdefault("note_id", nid)
        self.notes[nid] = note

        head, tail = note.get("head_key") or "", note.get("tail_key") or ""
        if not head or not tail:
            return
        paras = note.get("paragraph_idxs") or []
        para = int(paras[0]) if paras else -1
        weight = self.w_key
        if note.get("type_head") or note.get("type_tail"):
            weight += self.w_type
        if para >= 0:
            weight += self.b_para
        rel = note.get("rel") or self.default_rel
        self._edges[head].append(KeyEdge(rel, tail, nid, weight, para))
        self._redges[tail].append((rel, head, nid))
        # secondary triples: a sentence can assert more than one fact
        # ("W was released in 2006 on the label L"); the extra edges share
        # the note and its paragraphs
        for sk in note.get("secondary_keys") or ():
            sh, st = sk.get("head_key") or "", sk.get("tail_key") or ""
            if not sh or not st:
                continue
            srel = sk.get("rel") or self.default_rel
            self._edges[sh].append(KeyEdge(srel, st, nid, weight, para))
            self._redges[st].append((srel, sh, nid))

    def add_notes(self, notes: Sequence[Dict[str, Any]]) -> None:
        for n in notes:
            self.add_note(n)

    # -------------------------------------------------------------- query
    def neighbors(self, head_key: str) -> List[Tuple[str, str, str, float, int]]:
        """(rel, tail_key, note_id, weight, paragraph_idx) tuples."""
        return [(e.rel, e.tail_key, e.note_id, e.weight, e.paragraph_idx)
                for e in self._edges.get(head_key, ())]

    def resolve_head(self, surface: str) -> Optional[str]:
        """Case-insensitive head-key lookup for a question surface form;
        also tries the surface with any trailing parenthesized type suffix
        ("W (album)") stripped."""
        return self._resolve(surface, self._edges)

    def resolve_tail(self, surface: str) -> Optional[str]:
        """resolve_head over the reverse adjacency (tail keys)."""
        return self._resolve(surface, self._redges)

    @staticmethod
    def _resolve(surface: str, keys) -> Optional[str]:
        if surface in keys:
            return surface
        low = surface.lower()
        base = re.sub(r"\s*\([^)]*\)\s*$", "", surface).strip().lower()
        hit = None
        for h in keys:
            hl = h.lower()
            if hl == low:
                return h
            if hit is None and hl == base:
                hit = h
        return hit

    def rheads(self, tail_key: str) -> List[Tuple[str, str, str]]:
        """[(rel, head_key, note_id)] of edges INTO tail_key."""
        return list(self._redges.get(tail_key, ()))

    def seed_recall(self, question: str, top_k: int = 40, diversify: bool = True) -> List[str]:
        """Lexical token-overlap recall, length-normalized; optionally keep
        only the best note per head_key."""
        if not self.notes:
            return []
        q_tokens = set(tokenize(question))
        if not q_tokens:
            return list(self.notes)[:top_k]
        scored: List[Tuple[str, float]] = []
        for nid, note in self.notes.items():
            toks = tokenize(
                f"{note.get('text') or note.get('content') or ''} "
                f"{note.get('head_key','')} {note.get('tail_key','')}"
            )
            if not toks:
                continue
            overlap = sum(1 for t in toks if t in q_tokens)
            if overlap:
                scored.append((nid, overlap / len(toks)))
        if not scored:
            return list(self.notes)[:top_k]
        scored.sort(key=lambda kv: -kv[1])
        ranked = [nid for nid, _ in scored]
        if diversify:
            seen_heads: set = set()
            div: List[str] = []
            for nid in ranked:
                hk = str(self.notes[nid].get("head_key") or "")
                if hk and hk in seen_heads:
                    continue
                if hk:
                    seen_heads.add(hk)
                div.append(nid)
            ranked = div or ranked
        return ranked[:top_k]

    def get_neighbors(self, note_id: str, cap: int = 8) -> List[str]:
        """Neighbor note ids through this note's head/tail keys, strongest
        edges first."""
        note = self.notes.get(note_id)
        if not note:
            return []
        edges: List[KeyEdge] = []
        keys = [note.get("head_key") or "", note.get("tail_key") or ""]
        for i, k in enumerate(keys):
            if k and (i == 0 or k != keys[0]):
                edges.extend(self._edges.get(k, ()))
        edges.sort(key=lambda e: -e.weight)
        out: List[str] = []
        for e in edges:
            if e.note_id != note_id and e.note_id not in out:
                out.append(e.note_id)
            if len(out) >= cap:
                break
        return out
