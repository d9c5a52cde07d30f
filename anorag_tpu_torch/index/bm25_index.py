"""BM25 index over atomic notes: vocabulary, postings, query terms, scores
and field weighting.

Counterpart of anorag_tpu/index/bm25_index.py, every name of it: note_text,
Vocab, BM25Index (query_terms :86, scores :89, topk :97) and
FieldWeightedBM25Index (:105). The scored text per note is
`title_raw_span` (title + raw_span), `content` or `summary`. Postings are
built in numpy (ops/bm25.py); the reference's native C++ postings build
gives the same weights on ASCII corpora and is only faster, so `use_native`
is accepted and has no effect. Scores come from the scatter path
(ops/bm25.bm25_scores) on the index's device: the card unless the caller
asks for the CPU.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from anorag_tpu_torch.device import DeviceLike
from anorag_tpu_torch.ops.bm25 import (BM25Postings, FieldWeightedPostings,
                                       bm25_scores, build_field_weighted,
                                       build_postings)
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

    def add(self, term: str) -> int:
        return self._map.setdefault(term, len(self._map))

    def get(self, term: str) -> int:
        return self._map.get(term, -1)

    def __len__(self) -> int:
        return len(self._map)

    def encode(self, terms: Sequence[str], grow: bool = False) -> List[int]:
        if grow:
            return [self.add(t) for t in terms]
        return [i for i in (self._map.get(t, -1) for t in terms) if i >= 0]


class BM25Index:
    def __init__(
        self,
        notes: Sequence[Dict[str, Any]],
        text_field: str = "title_raw_span",
        k1: float = 1.5,
        b: float = 0.75,
        text_fn: Optional[Callable[[Dict[str, Any]], str]] = None,
        use_native: bool = True,
        device: DeviceLike = None,
    ):
        self.text_field = text_field
        self.device = device
        self.vocab = Vocab()
        fn = text_fn or (lambda n: note_text(n, text_field))
        doc_terms = [np.asarray(self.vocab.encode(tokenize(fn(n)), grow=True),
                                np.int64) for n in notes]
        self.n_docs = len(doc_terms)
        self.postings: BM25Postings = build_postings(
            doc_terms, max(len(self.vocab), 1), k1=k1, b=b)

    def query_terms(self, query: str) -> List[int]:
        return self.vocab.encode(tokenize(query))

    def scores(self, queries: Sequence[str], normalize: bool = True) -> np.ndarray:
        """(B, N) BM25 scores; normalize divides each row by its max, the
        reference's normalization before fusion."""
        if self.n_docs == 0:
            return np.zeros((len(queries), 0), np.float32)
        qt = [self.query_terms(q) for q in queries]
        return bm25_scores(self.postings, qt, normalize=normalize,
                           device=self.device)

    def topk(self, query: str, k: int = 40, normalize: bool = True):
        """(scores (k,), doc indices (k,)) of one query, best first."""
        s = self.scores([query], normalize=normalize)[0]
        k = min(k, len(s))
        idx = np.argpartition(-s, k - 1)[:k] if k else np.zeros(0, np.int64)
        idx = idx[np.argsort(-s[idx], kind="stable")]
        return s[idx], idx


class FieldWeightedBM25Index:
    """title 2.0 / entities 1.5 / content 1.0 weighted BM25."""

    def __init__(
        self,
        notes: Sequence[Dict[str, Any]],
        field_weights: Optional[Dict[str, float]] = None,
        k1: float = 1.5,
        b: float = 0.75,
        device: DeviceLike = None,
    ):
        self.field_weights = field_weights or {"title": 2.0, "entities": 1.5, "content": 1.0}
        self.device = device
        self.vocab = Vocab()
        field_docs: Dict[str, List[List[int]]] = {}
        for f in self.field_weights:
            docs = []
            for n in notes:
                if f == "entities":
                    text = " ".join(str(e) for e in (n.get("entities") or []))
                else:
                    text = str(n.get(f) or "")
                docs.append(self.vocab.encode(tokenize(text), grow=True))
            field_docs[f] = docs
        self._fw: FieldWeightedPostings = build_field_weighted(
            field_docs, max(len(self.vocab), 1), self.field_weights, k1=k1, b=b)
        self.n_docs = len(notes)

    def scores(self, queries: Sequence[str], normalize: bool = True) -> np.ndarray:
        if self.n_docs == 0:
            return np.zeros((len(queries), 0), np.float32)
        qt = [self.vocab.encode(tokenize(q)) for q in queries]
        return self._fw.score(qt, normalize=normalize, device=self.device)
