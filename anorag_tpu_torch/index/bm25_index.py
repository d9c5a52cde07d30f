"""BM25 index over atomic notes: vocabulary, postings and query terms.

Counterpart of anorag_tpu/index/bm25_index.py (BM25Index, query_terms
:86): the scored text per note is `title_raw_span` (title + raw_span),
`content` or `summary`. Postings are built in numpy (ops/bm25.py); the
reference's native C++ postings build gives the same weights on ASCII
corpora.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from anorag_tpu_torch.ops.bm25 import BM25Postings, build_postings
from anorag_tpu_torch.utils.text import tokenize


def note_text(note: Dict[str, Any], field: str = "title_raw_span") -> str:
    if field == "title_raw_span":
        return f"{note.get('title', '')} {note.get('raw_span', '') or note.get('content', '')}".strip()
    if field == "summary":
        return str(note.get("summary") or note.get("content") or "")
    return str(note.get(field) or note.get("content") or "")


class Vocab:
    """String term -> dense integer id (built once per corpus)."""

    def __init__(self):
        self._map: Dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._map)

    def encode(self, terms: Sequence[str], grow: bool = False) -> List[int]:
        if grow:
            return [self._map.setdefault(t, len(self._map)) for t in terms]
        return [i for i in (self._map.get(t, -1) for t in terms) if i >= 0]


class BM25Index:
    def __init__(
        self,
        notes: Sequence[Dict[str, Any]],
        text_field: str = "title_raw_span",
        k1: float = 1.5,
        b: float = 0.75,
    ):
        self.text_field = text_field
        self.vocab = Vocab()
        doc_terms = [np.asarray(self.vocab.encode(
            tokenize(note_text(n, text_field)), grow=True), np.int64)
            for n in notes]
        self.n_docs = len(doc_terms)
        self.postings: BM25Postings = build_postings(
            doc_terms, max(len(self.vocab), 1), k1=k1, b=b)

    def query_terms(self, query: str) -> List[int]:
        return self.vocab.encode(tokenize(query))
