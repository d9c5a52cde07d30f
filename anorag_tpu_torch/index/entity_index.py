"""Counterpart of anorag_tpu/index/entity_index.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Entity inverted index: entity -> note ids.

Parity target: upstream graph/entity_inverted_index.py — built from
note entity lists plus regex extraction over evidence text (:48-150), entity
normalization/validation (:151-183), fuzzy candidate lookup (:184-223),
incremental add/remove, save/load. Fuzzy matching uses a pure-Python
Levenshtein ratio (no fuzzywuzzy dependency).
"""
from __future__ import annotations

from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, Iterable, List, Set

from anorag_tpu_torch.utils.file_io import read_json, write_json
from anorag_tpu_torch.utils.text import extract_entities_fallback, normalize_entity


def levenshtein_ratio(a: str, b: str) -> float:
    """Similarity in [0,1] = 1 - dist/max_len.

    Uses the native C++ implementation when built, else iterative-DP Python.
    """
    if a == b:
        return 1.0
    if not a or not b:
        return 0.0
    from anorag_tpu_torch import native

    got = native.levenshtein_ratio_native(a, b) if native.available() else None
    if got is not None:
        return got
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return 1.0 - prev[-1] / max(len(a), len(b))


class EntityInvertedIndex:
    def __init__(self, min_entity_len: int = 2, fuzzy_threshold: float = 0.85):
        self.min_entity_len = min_entity_len
        self.fuzzy_threshold = fuzzy_threshold
        self._index: Dict[str, Set[str]] = defaultdict(set)

    # ------------------------------------------------------------- build
    @staticmethod
    def _norm(entity: str) -> str:
        return normalize_entity(entity).lower()

    def _valid(self, entity: str) -> bool:
        e = entity.strip()
        return len(e) >= self.min_entity_len and not e.isdigit() or (e.isdigit() and len(e) == 4)

    def build_index(self, notes: Iterable[Dict[str, Any]], extract_from_text: bool = True) -> None:
        for note in notes:
            self.add_note(note, extract_from_text=extract_from_text)

    def add_note(self, note: Dict[str, Any], extract_from_text: bool = True) -> None:
        nid = note.get("note_id")
        ents = [str(e) for e in (note.get("entities") or [])]
        if extract_from_text:
            text = f"{note.get('raw_span', '')} {note.get('content', '')}"
            ents.extend(extract_entities_fallback(text, min_len=self.min_entity_len))
        for e in ents:
            if self._valid(e):
                self._index[self._norm(e)].add(nid)

    def remove_note(self, note_id: str) -> None:
        empty = []
        for ent, ids in self._index.items():
            ids.discard(note_id)
            if not ids:
                empty.append(ent)
        for ent in empty:
            del self._index[ent]

    # ------------------------------------------------------------- query
    def lookup(self, entity: str, fuzzy: bool = True) -> List[str]:
        key = self._norm(entity)
        hits = set(self._index.get(key, ()))
        if not hits and fuzzy:
            for ent, ids in self._index.items():
                if abs(len(ent) - len(key)) <= 3 and levenshtein_ratio(ent, key) >= self.fuzzy_threshold:
                    hits |= ids
        return sorted(hits)

    def candidates_for_entities(self, entities: Iterable[str], fuzzy: bool = True) -> List[str]:
        out: Set[str] = set()
        for e in entities:
            out.update(self.lookup(e, fuzzy=fuzzy))
        return sorted(out)

    @property
    def n_entities(self) -> int:
        return len(self._index)

    # -------------------------------------------------------- persistence
    def save(self, path: str | Path) -> None:
        write_json(path, {k: sorted(v) for k, v in self._index.items()})

    @classmethod
    def load(cls, path: str | Path, **kw) -> "EntityInvertedIndex":
        inst = cls(**kw)
        for ent, ids in read_json(path).items():
            inst._index[ent] = set(ids)
        return inst
