"""Counterpart of anorag_tpu/utils/text.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Text utilities: tokenization, sentence splitting, entity fallback.

The word tokenizer matches the reference's BM25 tokenizer semantics
(upstream utils/bm25_search.py:237-241: lowercase `\\b\\w+\\b`) so BM25
scores are bit-comparable with the reference pipeline.
"""
from __future__ import annotations

import functools
import re
from typing import Dict, Iterable, List, Optional

_WORD_RE = re.compile(r"\b\w+\b", re.UNICODE)
# also split when the space after [.!?] is MISSING ("married.Denver is"):
# unsplit boundaries let one sentence's cue steal the next one's entities.
# The no-space branch requires a lowercase letter OR digit before the
# period ("married.Denver", "1947.Zagor") so initials ("J.R.R.Tolkien")
# and org dots stay intact.
_SENT_RE = re.compile(r"(?<=[.!?])\s+(?=[A-Z0-9\"'(])|(?<=[。！？])"
                      r"|(?<=[a-z0-9][.!?])(?=[A-Z])")
# connectors are infix-only (must be followed by a capitalized word) so an
# entity never ends on a connector or on a prefix of a lowercase word
# ("Gustave Eiffel designed" must not yield "Gustave Eiffel de")
# A token may contain a period ONLY as an abbreviation (initials "J.R.R.",
# honorifics "Dr." followed by another capital) — a bare `.` in the class
# let "Gorza Mosaic. Gorza Mosaic" bridge a sentence boundary into one
# entity, which broke per-sentence key extraction on merged notes
_CAP_TOKEN = (r"(?:[A-Z]\.(?:[A-Z]\.)+"              # initials J.R.R.
              r"|[A-Z][a-z]{0,2}\.(?=\s+[A-Z])"      # Dr. / St. / Mt.
              r"|[A-Z][\w'&-]*)")
_CAP_SPAN_RE = re.compile(
    _CAP_TOKEN + r"(?:\s+(?:(?:of|the|de|von|van|da|and|&)\s+)*" + _CAP_TOKEN + r")*"
)
_QUOTED_RE = re.compile(r'"([^"]{2,80})"|“([^”]{2,80})”')
_YEAR_RE = re.compile(r"\b(1[0-9]{3}|20[0-9]{2})\b")
# month names are calendar vocabulary, not entities: inside "released on
# 17 June 2014" the cap-span "June" must not become an entity, or it sits
# between the release cue and the year and steals the released_in tail
_MONTHS = frozenset(
    "january february march april may june july august september october "
    "november december".split()
)

STOPWORDS = frozenset(
    """a an the and or but if then else of in on at by for with to from as is are was
    were be been being do does did have has had this that these those it its he she
    they them his her their we you i not no yes which who whom whose what when where
    why how all any both each few more most other some such only own same so than too
    very can will just should now""".split()
)


# CJK has no spaces, so \b\w+\b returns whole clauses as one "token";
# split CJK runs into character unigrams (the standard no-segmenter BM25
# fallback — parity: the reference pairs its Chinese cue lexicons with a
# multilingual tokenizer, config_loader.py:17-45)
_CJK_RE = re.compile(r"[㐀-鿿豈-﫿぀-ヿ가-힯]")


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
    """Lowercased word tokens (the BM25 contract tokenizer). Cached on the
    text — note/sentence texts are static across queries, and the answer
    stages re-tokenize them per query (profiled: ~14k calls/batch64).
    Returns a fresh list so callers may mutate."""
    return list(_tokenize_cached(text or ""))


@functools.lru_cache(maxsize=65536)
def _tokenize_no_stop_cached(text: str) -> tuple:
    return tuple(t for t in _tokenize_cached(text) if t not in STOPWORDS)


def tokenize_no_stop(text: str) -> List[str]:
    return list(_tokenize_no_stop_cached(text or ""))


# a full stop followed by a LOWERCASE word is still a sentence boundary
# when the word before the stop isn't an abbreviation ("... the label
# Corhol Sound. fifteen tracks make up the album." — sloppy prose drops
# the capital, and gluing the sentences hides the second fact from
# per-sentence extraction). Single letters (initials) and common
# abbreviations never split.
_LOWER_BOUND_RE = re.compile(r"([A-Za-z0-9'\")]{2,})([.!?])\s+(?=[a-z])")
_ABBREVS = frozenset((
    "mr", "mrs", "ms", "dr", "st", "vs", "etc", "e.g", "i.e", "no",
    "jr", "sr", "prof", "inc", "ltd", "co", "fig", "al", "cf", "ca"))


def _split_lower_bound(part: str) -> List[str]:
    out, last = [], 0
    for m in _LOWER_BOUND_RE.finditer(part):
        if m.group(1).lower().rstrip(".") in _ABBREVS:
            continue
        out.append(part[last:m.end(2)])
        last = m.end()
    out.append(part[last:])
    return [s for s in (p.strip() for p in out) if s]


@functools.lru_cache(maxsize=65536)
def _split_sentences_cached(text: str) -> tuple:
    parts = [p for s in _SENT_RE.split(text) if s and s.strip()
             for p in _split_lower_bound(s.strip())]
    return tuple(parts) or ((text.strip(),) if text.strip() else ())


def split_sentences(text: str) -> List[str]:
    """Cached on the text (note texts are static across queries); returns a
    fresh list so callers may mutate."""
    return list(_split_sentences_cached(text or ""))


def split_paragraphs(text: str) -> List[str]:
    return [p.strip() for p in re.split(r"\n\s*\n", text or "") if p.strip()]


@functools.lru_cache(maxsize=65536)
def normalize_entity(ent: str) -> str:
    ent = re.sub(r"\s+", " ", (ent or "").strip().strip("\"'"))
    # sentence-final punctuation is never part of an entity; keep internal
    # dots (e.g. "Dr. Who") but drop trailing ones so the same entity
    # extracted mid-sentence and sentence-finally compares equal
    ent = ent.rstrip(".,;:!?")
    # possessive marker is never part of an entity: "Migor Tolin's place
    # of birth ..." must key the same graph node as "Migor Tolin"
    if ent.endswith("'s") or ent.endswith("’s"):
        ent = ent[:-2].rstrip()
    return ent


def extract_entities_fallback(text: str, min_len: int = 2, max_entities: int = 16) -> List[str]:
    """Rule-based entity extraction when no LLM/NER is available.

    Capitalized multiword spans, quoted titles, and years — the same signal
    classes the reference's TextUtils fallback targets
    (upstream llm/atomic_note_generator.py:638-650). Cached on the
    text (note texts are static across queries; profiled ~4k calls/batch64);
    returns a fresh list so callers may mutate.
    """
    return list(_extract_entities_cached(text or "", min_len, max_entities))


# A SINGLE capitalized token that opens a sentence and is an ordinary
# English predicate/connective is capitalized by position, not by being a
# name: "Released in 1987 on the label L, W is ..." must not make
# "Released" an entity (it then becomes the sentence SUBJECT and corrupts
# every triple). Stems cover participle/gerund variants.
_SENT_OPENER_STEMS = frozenset({
    "releas", "recor", "record", "found", "establish", "issu", "born",
    "marri", "marry", "direct", "base", "accord", "form", "creat",
    "launch", "produc", "written", "wrote", "sign", "original", "initial",
    "later", "today", "currently", "although", "while", "when", "where",
    "there", "during", "after", "before", "following", "starting",
    "beginning", "perform", "debut", "appear", "nam", "locat", "situat",
    "early", "critic", "listen", "dat", "play", "set", "runn"})


def _is_positional_capital(text: str, start: int, span: str) -> bool:
    if " " in span:
        return False
    prefix = text[:start].rstrip()
    if prefix and prefix[-1] not in ".!?。":
        return False
    from anorag_tpu_torch.utils.lexnorm import stem
    return stem(span.lower()) in _SENT_OPENER_STEMS


@functools.lru_cache(maxsize=32768)
def _extract_entities_cached(text: str, min_len: int, max_entities: int) -> tuple:
    seen: Dict[str, None] = {}
    for m in _QUOTED_RE.finditer(text or ""):
        ent = normalize_entity(m.group(1) or m.group(2) or "")
        if len(ent) >= min_len:
            seen.setdefault(ent)
    for m in _CAP_SPAN_RE.finditer(text or ""):
        raw = m.group(0)
        # a sentence-initial preposition is usually capitalized by position
        # and glues onto the entity span behind it: "On Kesti River, the
        # performance ..." should yield "Kesti River" — but works genuinely
        # titled with a leading preposition ("In Utero") open sentences
        # too, so BOTH surfaces stay candidates, stripped
        # form first (the commonly-correct one).
        variants = [raw]
        first, _, rest = raw.partition(" ")
        if rest and first in ("On", "In", "At", "From", "With", "By",
                              "After", "Before", "During", "Under"):
            prefix = (text or "")[:m.start()].rstrip()
            if not prefix or prefix[-1] in ".!?。":
                variants = [rest, raw]
        for v in variants:
            ent = normalize_entity(v)
            low = ent.lower()
            if (len(ent) >= min_len and low not in STOPWORDS
                    and not all(w in _MONTHS for w in low.split())
                    and not _is_positional_capital(text, m.start(), ent)):
                seen.setdefault(ent)
                # a trailing 's may be the name itself ("McDonald's"), not
                # a possessive marker: keep the unstripped surface as a
                # candidate too so such titles remain extractable
                #; graph keying still normalizes.
                kept = re.sub(r"\s+", " ", v.strip().strip("\"'")).rstrip(".,;:!?")
                if kept != ent and re.search(r"['’]s$", kept):
                    seen.setdefault(kept)
    for m in _YEAR_RE.finditer(text or ""):
        seen.setdefault(m.group(0))
    return tuple(list(seen)[:max_entities])


def jaccard(a: Iterable[str], b: Iterable[str]) -> float:
    sa, sb = set(a), set(b)
    if not sa or not sb:
        return 0.0
    return len(sa & sb) / len(sa | sb)


@functools.lru_cache(maxsize=16384)
def normalize_answer(s: str) -> str:
    """SQuAD/MuSiQue-style answer normalization for EM/F1. Cached — answer
    stages normalize the same candidate strings repeatedly per batch."""
    s = (s or "").lower()
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    s = re.sub(r"[^\w\s]", " ", s)
    s = re.sub(r"\s+", " ", s).strip()
    return s


def estimate_tokens(text: str) -> int:
    """Cheap token-count estimate used by context budgeting."""
    return max(1, len(text or "") // 4)


def truncate_text(text: str, max_chars: int, strategy: str = "end") -> str:
    if text is None or len(text) <= max_chars:
        return text or ""
    if strategy == "middle":
        half = max_chars // 2
        return text[:half] + " ... " + text[-(max_chars - half):]
    return text[:max_chars]


def note_embedding_text(note: Dict, include_entities: bool = True, max_chars: int = 2000) -> str:
    """Canonical note -> embedding-input text.

    Mirrors the reference strategy `title || content || ENTITIES: ...`
    (upstream vector_store/embedding_manager.py:467-498).
    """
    title = note.get("title") or ""
    content = note.get("content") or note.get("text") or ""
    parts = [p for p in (title, content) if p]
    if include_entities:
        ents = note.get("entities") or []
        if ents:
            parts.append("ENTITIES: " + ", ".join(str(e) for e in ents[:16]))
    return truncate_text(" || ".join(parts), max_chars)
