"""Text utilities the ported slice needs: the BM25 word tokenizer and the
note -> embedding-text rule.

Copied from anorag_tpu/utils/text.py (tokenize, note_embedding_text) so
that BM25 terms and embedding inputs are identical in both packages.
"""
from __future__ import annotations

import functools
import re
from typing import Dict, List

_WORD_RE = re.compile(r"\b\w+\b", re.UNICODE)

# CJK has no spaces, so \b\w+\b returns whole clauses as one "token";
# split CJK runs into character unigrams
_CJK_RE = re.compile(r"[㐀-鿿豈-﫿぀-ヿ가-힯]")


def _expand_cjk(tok: str) -> List[str]:
    if not _CJK_RE.search(tok):
        return [tok]
    out: List[str] = []
    buf: List[str] = []
    for ch in tok:
        if _CJK_RE.match(ch):
            if buf:
                out.append("".join(buf))
                buf = []
            out.append(ch)
        else:
            buf.append(ch)
    if buf:
        out.append("".join(buf))
    return out


@functools.lru_cache(maxsize=65536)
def _tokenize_cached(text: str) -> tuple:
    return tuple(t2 for t in _WORD_RE.findall(text.lower())
                 for t2 in _expand_cjk(t))


def tokenize(text: str) -> List[str]:
    """Lowercased word tokens (the BM25 contract tokenizer), cached on the
    text; returns a fresh list so callers may mutate."""
    return list(_tokenize_cached(text or ""))


def note_embedding_text(note: Dict, include_entities: bool = True,
                        max_chars: int = 2000) -> str:
    """Canonical note -> embedding-input text: `title || content ||
    ENTITIES: ...`."""
    title = note.get("title") or ""
    content = note.get("content") or note.get("text") or ""
    parts = [p for p in (title, content) if p]
    if include_entities:
        ents = note.get("entities") or []
        if ents:
            parts.append("ENTITIES: " + ", ".join(str(e) for e in ents[:16]))
    return " || ".join(parts)[:max_chars]
