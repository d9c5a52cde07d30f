"""Counterpart of anorag_tpu/answer/comparative.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Deterministic exact-math answering over resolved facts: pairwise
comparatives ("Which was released first, A or B?"), temporal differences
("How many years after the release of A was B released?"), yes/no
polarity ("Was A released before B?"), and label-set aggregation
(superlative "Which album on the label L was released first?" and count
"How many albums were released on the label L?").

Parity target: the reference has no exact comparative/aggregate math — it
routes these question types to the LLM via the query-type classification
in upstream llm/prompts/__init__.py:235 and answers from
generation. This module is the LLM-free exact equivalent, in the same
spirit as answer/efsa.py (reference answer/efsa_answer.py: do exact span
math before generation): parse the options/set named in the question,
resolve each compared attribute (a year) from the note graph's triples —
falling back to a regex scan of the retrieved candidates — then compare,
subtract, argmin/argmax, or count.

No relation chain solves these questions (the compared facts are
parallel, not nested), and the answer is either an entity named in the
question (comparative/superlative — EFSA's question-entity exclusion
would veto it), a computed number present in no paragraph (difference,
count), or a bare polarity (yes/no) — so the stage must run before the
rel-chain selector and EFSA.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

from anorag_tpu_torch.graph.note_graph import NoteGraph

# superlative/ comparative ordinal -> pick min or max of the attribute
_ORD_MIN = r"first|earliest|earlier|oldest"
_ORD_MAX = r"last|latest|later|newest|most\s+recent(?:ly)?"

# "Which (album|work|...) was released first, A or B?"  /
# "Which was founded earlier: A or B?"
_CMP_RE = re.compile(
    r"\bwhich\b[^,:?]*?\b(?P<verb>released|founded|established|formed|"
    r"created|published|recorded|built|made)\b[^,:?]*?"
    r"\b(?P<ord>" + _ORD_MIN + r"|" + _ORD_MAX + r")\b"
    r"\s*[,:]\s*(?P<a>.+?)\s+or\s+(?P<b>.+?)\s*\??\s*$",
    re.IGNORECASE)

# "Which of A or/and B was released first?"
_CMP_RE_PREFIX = re.compile(
    r"\bwhich\s+of\s+(?P<a>.+?)\s+(?:or|and)\s+(?P<b>.+?)\s+"
    r"(?:was|is|were|got)\b[^?]*?\b(?P<verb>released|founded|established|"
    r"formed|created|published|recorded|built|made)\b[^?]*?"
    r"\b(?P<ord>" + _ORD_MIN + r"|" + _ORD_MAX + r")\b",
    re.IGNORECASE)

# verb stem -> note-graph relations that carry its year attribute
_VERB_RELS = {
    "released": ("released_in",),
    "founded": ("founded_in", "established_in"),
    "established": ("established_in", "founded_in"),
    "formed": ("formed_in", "founded_in"),
    "created": ("created_in",),
    "published": ("published_in", "released_in"),
    "recorded": ("recorded_in", "released_in"),
    "built": ("built_in",),
    "made": ("made_in", "released_in"),
}

_YEAR_RE = re.compile(r"\b(1[0-9]{3}|20[0-9]{2})\b")


def parse_comparative(question: str) -> Optional[Dict[str, Any]]:
    """{options: [a, b], verb, pick: 'min'|'max'} or None."""
    q = (question or "").strip()
    m = _CMP_RE.search(q) or _CMP_RE_PREFIX.search(q)
    if not m:
        return None
    ordinal = re.sub(r"\s+", " ", m.group("ord").lower())
    pick = "min" if re.fullmatch(_ORD_MIN, ordinal) else "max"
    opts = [m.group("a").strip().strip('"'), m.group("b").strip().strip('"')]
    if not all(opts):
        return None
    return {"options": opts, "verb": m.group("verb").lower(), "pick": pick}


_OFFSET_TAIL_RE = re.compile(r"(\d{1,3})\s+years?\s+(after|before)\s+(.+)")


def _year_from_graph(option: str, rels: Sequence[str],
                     graph: NoteGraph, _depth: int = 0
                     ) -> Optional[Tuple[int, str]]:
    """(year, note_id) for `option`'s attribute triple, or None. Head keys
    are matched case-insensitively; the option may carry a type suffix the
    note key lacks ("W (album)"). A work dated only RELATIVELY ("released
    ... 55 years after W2", note_generator released_offset triples)
    resolves through its anchor's absolute year, one hop deep."""
    key = graph.resolve_head(option)
    if key is None:
        return None
    want = set(rels)
    for rel, tail, note_id, _w, _p in graph.neighbors(key):
        if rel in want:
            m = _YEAR_RE.search(str(tail))
            if m:
                return int(m.group(1)), note_id
    if "released_in" in want and _depth < 2:
        for rel, tail, note_id, _w, _p in graph.neighbors(key):
            if rel != "released_offset":
                continue
            m = _OFFSET_TAIL_RE.fullmatch(str(tail).strip())
            if not m:
                continue
            anchor = _year_from_graph(m.group(3), ("released_in",),
                                      graph, _depth + 1)
            if anchor is not None:
                delta = int(m.group(1))
                y = anchor[0] + delta if m.group(2) == "after" \
                    else anchor[0] - delta
                return y, note_id
    return None


def _year_from_candidates(option: str, verb: str,
                          candidates: Sequence[Dict[str, Any]]
                          ) -> Optional[Tuple[int, Dict[str, Any]]]:
    """Regex fallback over retrieved notes: a sentence naming the option
    and the verb stem, carrying a year."""
    opt = option.lower()
    stem = verb[:6]
    for c in candidates or ():
        text = f"{c.get('title', '')} {c.get('content', '')}"
        low = text.lower()
        if opt not in low and opt not in str(c.get("title", "")).lower():
            continue
        for sent in re.split(r"(?<=[.!?])\s+", text):
            sl = sent.lower()
            if stem not in sl:
                continue
            m = _YEAR_RE.search(sent)
            if m:
                return int(m.group(1)), c
    return None


# a comparative OPTION may be a description needing a hop of its own:
# "the album performed by P" (v9 kind 20)
_DESC_OPT_RE = re.compile(
    r"^the\s+(?:album|work|record|song|release)\s+"
    r"(?:(?P<verb>performed|recorded|released|made|written)\s+by|by)\s+"
    r"(?P<who>.+)$", re.IGNORECASE)

_DESC_RELS = ("performed_by",)


def _resolve_option_surface(option: str, graph: Optional[NoteGraph]) -> str:
    """A descriptive option resolves to the one work it names (reverse
    performed_by edge); a plain title passes through unchanged."""
    m = _DESC_OPT_RE.match(option.strip())
    if not m or graph is None:
        return option
    key = graph.resolve_tail(m.group("who").strip())
    if key is None:
        return option
    works = {head for rel, head, _n in graph.rheads(key)
             if rel in _DESC_RELS}
    if len(works) == 1:
        return next(iter(works))
    return option


def answer_comparative(
    question: str,
    note_graph: Optional[NoteGraph],
    candidates: Sequence[Dict[str, Any]],
) -> Optional[Dict[str, Any]]:
    """{answer, support_idxs, years, method} for a comparative question,
    or None when the question isn't comparative / an option's attribute
    can't be resolved (callers fall through to the regular stages)."""
    parsed = parse_comparative(question)
    if not parsed:
        return None
    rels = _VERB_RELS.get(parsed["verb"], ())
    resolved: List[Tuple[str, int, List[int]]] = []   # (option, year, paras)
    options = [_resolve_option_surface(o, note_graph)
               for o in parsed["options"]]
    for opt in options:
        got = _year_from_graph(opt, rels, note_graph) if note_graph else None
        if got is not None:
            year, note_id = got
            note = note_graph.notes.get(note_id, {})
            paras = list(note.get("paragraph_idxs") or [])
        else:
            fb = _year_from_candidates(opt, parsed["verb"], candidates)
            if fb is None:
                return None
            year, note = fb
            paras = list(note.get("paragraph_idxs") or [])
        resolved.append((opt, year, paras))
    ya, yb = resolved[0][1], resolved[1][1]
    if ya == yb:
        return None                      # tie: exact math can't order them
    best = min(resolved, key=lambda t: t[1]) if parsed["pick"] == "min" \
        else max(resolved, key=lambda t: t[1])
    support = list(dict.fromkeys(resolved[0][2] + resolved[1][2]))
    return {"answer": best[0], "support_idxs": support,
            "years": {o: y for o, y, _ in resolved}, "method": "comparative"}


# ---------------------------------------------------------------- temporal
# "How many years after (the release of) A was B released?"
_TDIFF_RE = re.compile(
    r"\bhow\s+many\s+years\s+(?P<dir>after|before)\s+"
    r"(?:the\s+(?:release|founding|publication)\s+of\s+)?"
    r"(?P<a>.+?)\s+(?:was|did|were)\s+(?P<b>.+?)\s+"
    r"(?P<verb>released|founded|established|formed|created|published|"
    r"recorded|built|made)\s*\??\s*$",
    re.IGNORECASE)

# "Was A released before/after B?"
_YESNO_RE = re.compile(
    r"\b(?:was|were|is|did)\s+(?P<a>.+?)\s+"
    r"(?P<verb>released|founded|established|formed|created|published|"
    r"recorded|built|made)\s+(?P<dir>before|after|earlier\s+than|"
    r"later\s+than)\s+(?P<b>.+?)\s*\??\s*$",
    re.IGNORECASE)

# "Which album on the label L was released first / most recently?"
_SUPERL_RE = re.compile(
    r"\bwhich\s+(?:album|work|record|song|release)s?\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+(?:was|were|got|came)\s+[^?]*?"
    r"\b(?P<ord>" + _ORD_MIN + r"|" + _ORD_MAX + r")\b",
    re.IGNORECASE)

# "How many albums were released on the label L?"
_COUNT_RE = re.compile(
    r"\bhow\s+many\s+(?:album|work|record|song|release)s?\s+"
    r"(?:was|were)\s+(?P<verb>released|published|recorded|put\s+out|made)\s+"
    r"(?:on|by|through|under)\s+(?:the\s+label\s+)?(?P<set>.+?)\s*\??\s*$",
    re.IGNORECASE)

# relations whose TAIL is the set anchor for label aggregation
_SET_RELS = ("released_on_label",)
# v10: a set anchor may also be a PERFORMER ("Which album by P was
# released first?") — a label surface never appears as a performed_by
# tail, so widening is unambiguous for _label_set (NOT for the
# intersection stage, which must stay label-only)
_SET_RELS_WIDE = _SET_RELS + ("performed_by",)


# a temporal-diff option may itself be a superlative over a set:
# "the first album on the label L" (v10 kind 24) — resolve it to the
# extremum work before the year lookup
_SUPERL_OPT_RE = re.compile(
    r"^the\s+(?P<ord>" + _ORD_MIN + r"|" + _ORD_MAX + r")\s+"
    r"(?:album|work|record|song|release)\s+(?:released\s+)?"
    r"(?:on|by|through|under)\s+(?:the\s+label\s+)?(?P<set>.+)$",
    re.IGNORECASE)


def _resolve_superl_option(option: str, graph: Optional[NoteGraph]
                           ) -> Optional[Tuple[int, List[int]]]:
    m = _SUPERL_OPT_RE.match(option.strip())
    if not m or graph is None:
        return None
    entries = [e for e in _label_set(m.group("set").strip(), graph)
               if e[1] >= 0]
    if len(entries) < 2:
        return None
    ordinal = re.sub(r"\s+", " ", m.group("ord").lower())
    pick = min(entries, key=lambda t: t[1]) \
        if re.fullmatch(_ORD_MIN, ordinal) else max(entries, key=lambda t: t[1])
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    return pick[1], support


def _resolve_year(option: str, verb: str, graph: Optional[NoteGraph],
                  candidates: Sequence[Dict[str, Any]]
                  ) -> Optional[Tuple[int, List[int]]]:
    """(year, support paragraph idxs) for option's <verb>-year attribute,
    graph triples first, candidate regex fallback."""
    nested = _resolve_superl_option(option, graph)
    if nested is not None:
        return nested
    rels = _VERB_RELS.get(verb, ())
    if graph is not None:
        got = _year_from_graph(option, rels, graph)
        if got is not None:
            year, note_id = got
            note = graph.notes.get(note_id, {})
            return year, list(note.get("paragraph_idxs") or [])
    fb = _year_from_candidates(option, verb, candidates)
    if fb is None:
        return None
    year, note = fb
    return year, list(note.get("paragraph_idxs") or [])


def answer_temporal_diff(question: str, graph: Optional[NoteGraph],
                         candidates: Sequence[Dict[str, Any]]
                         ) -> Optional[Dict[str, Any]]:
    m = _TDIFF_RE.search((question or "").strip())
    if not m:
        return None
    ra = _resolve_year(m.group("a").strip(), m.group("verb").lower(),
                       graph, candidates)
    rb = _resolve_year(m.group("b").strip(), m.group("verb").lower(),
                       graph, candidates)
    if ra is None or rb is None:
        return None
    diff = rb[0] - ra[0] if m.group("dir").lower() == "after" \
        else ra[0] - rb[0]
    if diff <= 0:
        return None          # ill-posed premise: fall through to LLM stages
    support = list(dict.fromkeys(ra[1] + rb[1]))
    return {"answer": str(diff), "support_idxs": support,
            "method": "temporal_diff"}


def answer_yesno(question: str, graph: Optional[NoteGraph],
                 candidates: Sequence[Dict[str, Any]]
                 ) -> Optional[Dict[str, Any]]:
    m = _YESNO_RE.search((question or "").strip())
    if not m:
        return None
    ra = _resolve_year(m.group("a").strip(), m.group("verb").lower(),
                       graph, candidates)
    rb = _resolve_year(m.group("b").strip(), m.group("verb").lower(),
                       graph, candidates)
    if ra is None or rb is None or ra[0] == rb[0]:
        return None
    earlier = re.sub(r"\s+", " ", m.group("dir").lower()) in (
        "before", "earlier than")
    yes = (ra[0] < rb[0]) if earlier else (ra[0] > rb[0])
    support = list(dict.fromkeys(ra[1] + rb[1]))
    return {"answer": "yes" if yes else "no", "support_idxs": support,
            "method": "yesno"}


def _note_paras(graph: NoteGraph, note_id: Any) -> List[int]:
    """Support paragraphs of one note — used when an anchor resolves via
    _year_from_graph (off-set anchor) so its evidence still lands in
    support_idxs, matching what _label_set does for in-set members."""
    note = graph.notes.get(note_id, {})
    return list(note.get("paragraph_idxs") or [])


# a set anchor may be a DESCRIPTOR instead of a name: "the label founded
# by F" / "... founded by the spouse of P" (v29 kind 100) — resolve the
# founder NP (itself possibly a spouse hop), then walk AGAINST the
# founded_by edge to the label
_LABEL_DESC_RE = re.compile(
    r"^(?:the\s+label\s+)?(?:founded|started|established|created|"
    r"launched|set\s+up)\s+by\s+(?P<f>.+)$", re.IGNORECASE)
_SPOUSE_NP_RE = re.compile(
    r"^the\s+(?:spouse|wife|husband)\s+of\s+(?P<p>.+)$", re.IGNORECASE)


def _resolve_label_descriptor(surface: str, graph: NoteGraph
                              ) -> Optional[Tuple[str, List[int]]]:
    m = _LABEL_DESC_RE.match((surface or "").strip().rstrip("?. "))
    if not m:
        return None
    founder = m.group("f").strip().rstrip("?. ")
    paras: List[int] = []
    sm = _SPOUSE_NP_RE.match(founder)
    if sm:
        hop = _hop_tail(graph, sm.group("p").strip(), ("spouse_of",))
        if hop is None:
            return None
        founder = hop[0]
        paras += hop[1]
    fkey = graph.resolve_tail(founder)
    if fkey is None:
        return None
    for rel, head, note_id in graph.rheads(fkey):
        if rel == "founded_by":
            note = graph.notes.get(note_id, {})
            paras += [p for p in (note.get("paragraph_idxs") or [])
                      if p not in paras]
            return str(head), paras
    return None


def _label_set(set_surface: str, graph: Optional[NoteGraph]
               ) -> List[Tuple[str, int, List[int]]]:
    """All (work, year, support paras) anchored to set_surface — a label
    (reverse released_on_label) or a performer (reverse performed_by) —
    via reverse edges + each head's released_in triple. The anchor may be
    a descriptor ("the label founded by the spouse of P"); its resolution
    evidence rides into every member's paras."""
    if graph is None:
        return []
    anchor_paras: List[int] = []
    key = graph.resolve_tail(set_surface)
    if key is None:
        desc = _resolve_label_descriptor(set_surface, graph)
        if desc is None:
            return []
        key, anchor_paras = desc
    out = []
    for rel, head, note_id in graph.rheads(key):
        if rel not in _SET_RELS_WIDE:
            continue
        # a member the graph types as a PERSON (born_in/spouse_of edges as
        # head and NO work-shaped edges) is a corrupt extraction, not a
        # work: one year-less person member otherwise vetoes every
        # count/superlative over the set ("every member must have a
        # resolvable year"). A work polluted by one junk born_in edge
        # still carries release/performer edges and must stay.
        out_rels = {r for r, *_ in graph.neighbors(head)}
        if (out_rels & {"born_in", "spouse_of"}
                and not out_rels & {"released_in", "released_on_label",
                                    "performed_by"}):
            continue
        got = _year_from_graph(head, ("released_in",), graph)
        note = graph.notes.get(note_id, {})
        paras = list(note.get("paragraph_idxs") or [])
        if got is not None:
            ynote = graph.notes.get(got[1], {})
            paras += [p for p in (ynote.get("paragraph_idxs") or [])
                      if p not in paras]
            out.append((head, got[0], paras))
        else:
            out.append((head, -1, paras))
    # one entry per distinct work (a work can carry several label notes)
    seen: Dict[str, Tuple[str, int, List[int]]] = {}
    for w, y, p in out:
        if w not in seen or (seen[w][1] < 0 <= y):
            seen[w] = (w, y, anchor_paras
                       + [q for q in p if q not in anchor_paras]
                       if anchor_paras else p)
    return list(seen.values())


def answer_superlative(question: str, graph: Optional[NoteGraph],
                       candidates: Sequence[Dict[str, Any]]
                       ) -> Optional[Dict[str, Any]]:
    m = _SUPERL_RE.search((question or "").strip())
    if not m:
        return None
    entries = [e for e in _label_set(m.group("set").strip(), graph)
               if e[1] >= 0]
    if len(entries) < 2:
        return None
    ordinal = re.sub(r"\s+", " ", m.group("ord").lower())
    best = min(entries, key=lambda t: t[1]) \
        if re.fullmatch(_ORD_MIN, ordinal) else max(entries, key=lambda t: t[1])
    years = sorted(y for _, y, _ in entries)
    if years.count(best[1]) > 1:
        return None                              # tied extremum: ambiguous
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    return {"answer": best[0], "support_idxs": support,
            "method": "superlative"}


# "Who performed the first album released on the label L?" (v14 kind 38)
# — the superlative resolves to a WORK, then the performer hop runs on
# the RESOLVED work (every other superlative ends at the work title)
_SUPERL_HOP_RE = re.compile(
    r"\bwho\s+(?P<verb>performed|recorded|made|released|wrote)\s+the\s+"
    r"(?P<ord>" + _ORD_MIN + r"|" + _ORD_MAX + r")\s+"
    r"(?:album|work|record|song|release)\s+"
    r"(?:released\s+|recorded\s+|put\s+out\s+)?"
    r"(?:on|by|through|under)\s+(?:the\s+label\s+)?(?P<set>.+?)\s*\??\s*$",
    re.IGNORECASE)

_HOP_RELS = {"performed": ("performed_by",), "recorded": ("performed_by",),
             "made": ("performed_by",), "wrote": ("performed_by",),
             "released": ("released_on_label",)}


def _hop_tail(graph: NoteGraph, head_surface: str, rels
              ) -> Optional[Tuple[str, List[int]]]:
    """(tail, its note's paras) for the first edge of `rels` out of the
    head — the generic one-hop taken on a RESOLVED set member."""
    key = graph.resolve_head(head_surface)
    if key is None:
        return None
    for rel, tail, note_id, _w, _p in graph.neighbors(key):
        if rel in rels:
            note = graph.notes.get(note_id, {})
            return str(tail), list(note.get("paragraph_idxs") or [])
    return None


def answer_superlative_hop(question: str, graph: Optional[NoteGraph],
                           candidates: Sequence[Dict[str, Any]]
                           ) -> Optional[Dict[str, Any]]:
    m = _SUPERL_HOP_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    entries = [e for e in _label_set(m.group("set").strip(), graph)
               if e[1] >= 0]
    if len(entries) < 2:
        return None
    ordinal = re.sub(r"\s+", " ", m.group("ord").lower())
    best = min(entries, key=lambda t: t[1]) \
        if re.fullmatch(_ORD_MIN, ordinal) else max(entries, key=lambda t: t[1])
    if [y for _, y, _ in entries].count(best[1]) > 1:
        return None                              # tied extremum: ambiguous
    want = _HOP_RELS.get(m.group("verb").lower(), ("performed_by",))
    hop = _hop_tail(graph, best[0], want)
    if hop is None:
        return None
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    support += [p for p in hop[1] if p not in support]
    return {"answer": hop[0], "support_idxs": support,
            "method": "superlative_hop"}


# "Where was the performer of the first/last album released on the
# label L born?" (v16 kind 46) — TWO hops on the superlative's output:
# superlative -> performed_by -> born_in
_SUPERL_HOP2_RE = re.compile(
    r"\bwhere\s+was\s+the\s+(?P<role>performer|artist|singer)\s+of\s+"
    r"the\s+(?P<ord>" + _ORD_MIN + r"|" + _ORD_MAX + r")\s+"
    r"(?:album|work|record|song|release)\s+"
    r"(?:released\s+|recorded\s+|put\s+out\s+)?"
    r"(?:on|by|through|under)\s+(?:the\s+label\s+)?(?P<set>.+?)\s+"
    r"born\s*\??\s*$",
    re.IGNORECASE)


def answer_superlative_hop2(question: str, graph: Optional[NoteGraph],
                            candidates: Sequence[Dict[str, Any]]
                            ) -> Optional[Dict[str, Any]]:
    m = _SUPERL_HOP2_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    entries = [e for e in _label_set(m.group("set").strip(), graph)
               if e[1] >= 0]
    if len(entries) < 2:
        return None
    ordinal = re.sub(r"\s+", " ", m.group("ord").lower())
    best = min(entries, key=lambda t: t[1]) \
        if re.fullmatch(_ORD_MIN, ordinal) else max(entries, key=lambda t: t[1])
    if [y for _, y, _ in entries].count(best[1]) > 1:
        return None
    hop1 = _hop_tail(graph, best[0], ("performed_by",))
    if hop1 is None:
        return None
    hop2 = _hop_tail(graph, hop1[0], ("born_in",))
    if hop2 is None:
        return None
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    support += [p for p in hop1[1] + hop2[1] if p not in support]
    return {"answer": hop2[0].split(",")[0].strip(),
            "support_idxs": support, "method": "superlative_hop2"}


# "Which label released the first album by P?" (v16 kind 47) — the set
# anchors on a PERFORMER; the answer is the resolved member's LABEL
_LABEL_OF_SUPERL_RE = re.compile(
    r"\b(?:what|which)\s+(?:record\s+)?(?:label|company)\s+"
    r"(?:released|put\s+out|issued|published)\s+the\s+"
    r"(?P<ord>" + _ORD_MIN + r"|" + _ORD_MAX + r")\s+"
    r"(?:album|work|record|song|release)\s+by\s+(?P<who>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_label_of_superlative(question: str, graph: Optional[NoteGraph],
                                candidates: Sequence[Dict[str, Any]]
                                ) -> Optional[Dict[str, Any]]:
    m = _LABEL_OF_SUPERL_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    entries = [e for e in _label_set(m.group("who").strip(), graph)
               if e[1] >= 0]
    if len(entries) < 2:
        return None
    ordinal = re.sub(r"\s+", " ", m.group("ord").lower())
    best = min(entries, key=lambda t: t[1]) \
        if re.fullmatch(_ORD_MIN, ordinal) else max(entries, key=lambda t: t[1])
    if [y for _, y, _ in entries].count(best[1]) > 1:
        return None
    hop = _hop_tail(graph, best[0], ("released_on_label",))
    if hop is None:
        return None
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    support += [p for p in hop[1] if p not in support]
    return {"answer": hop[0], "support_idxs": support,
            "method": "label_of_superlative"}


# "How many tracks do the albums on the label L have in total?" (v16
# kind 48) — SUM of word-number counts over the whole set
_ATTR_SUM_RE = re.compile(
    r"\bhow\s+many\s+(?P<attr>tracks|songs|discs|minutes)"
    r"(?P<tot1>\s+in\s+total)?\s+do\s+the\s+"
    r"(?:album|work|record|song|release)s\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)"
    r"(?:\s+in\s+the\s+(?P<dec>1[0-9]{2}|20[0-9])0s)?"
    r"\s+have(?P<tot2>\s+in\s+total)?\s*\??\s*$",
    re.IGNORECASE)


def answer_attr_sum(question: str, graph: Optional[NoteGraph],
                    candidates: Sequence[Dict[str, Any]]
                    ) -> Optional[Dict[str, Any]]:
    m = _ATTR_SUM_RE.search((question or "").strip())
    if not m or graph is None or not (m.group("tot1") or m.group("tot2")):
        return None
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < 2:
        return None
    dec = m.group("dec")
    if dec is not None:
        # v20 kind 65: the total runs over the members released in the
        # asked decade; every member needs a year to PROVE membership
        # (the excluded members' year facts are part of the support)
        if any(y < 0 for _, y, _ in entries):
            return None
        lo = int(dec) * 10
        summed = [(w, y, p) for w, y, p in entries if lo <= y < lo + 10]
        if not summed:
            return None
    else:
        summed = entries
    pool = list(candidates or ()) + list(graph.notes.values())
    in_sum = {w for w, _y, _p in summed}
    total = 0
    support: List[int] = []
    for work, _y, paras in entries:
        support += [p for p in paras if p not in support]
        c = _attr_count(work, m.group("attr"), pool)
        if c is None:
            if work in in_sum:
                return None          # incomplete set: the sum is unsound
            continue                 # excluded member: year alone proves it
        if work in in_sum:
            total += c[0]
            support += [p for p in c[1] if p not in support]
    return {"answer": str(total), "support_idxs": support,
            "method": "attr_sum"}


# "Who performed the album released on the label L in 1994?" (v15 kind
# 42) — the member is selected by YEAR EQUALITY, then the hop runs on it
_MEMBER_YEAR_RE = re.compile(
    r"\bwho\s+(?P<verb>performed|recorded|made|wrote)\s+the\s+"
    r"(?:album|work|record|song|release)\s+"
    r"(?:released\s+|put\s+out\s+|recorded\s+)?"
    r"(?:on|by|through|under)\s+(?:the\s+label\s+)?(?P<set>.+?)\s+"
    r"in\s+(?P<year>1[0-9]{3}|20[0-9]{2})\s*\??\s*$",
    re.IGNORECASE)


def answer_member_year_hop(question: str, graph: Optional[NoteGraph],
                           candidates: Sequence[Dict[str, Any]]
                           ) -> Optional[Dict[str, Any]]:
    m = _MEMBER_YEAR_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    entries = [e for e in _label_set(m.group("set").strip(), graph)
               if e[1] >= 0]
    year = int(m.group("year"))
    hits = [e for e in entries if e[1] == year]
    if len(entries) < 2 or len(hits) != 1:
        return None                        # zero or several: ambiguous
    want = _HOP_RELS.get(m.group("verb").lower(), ("performed_by",))
    hop = _hop_tail(graph, hits[0][0], want)
    if hop is None:
        return None
    # uniqueness of the year match is established by enumerating the
    # whole set — every member paragraph is support
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    support += [p for p in hop[1] if p not in support]
    return {"answer": hop[0], "support_idxs": support,
            "method": "member_year_hop"}


# "Where was the performer of the album released on the label L in Y
# born?" (v17 kind 50) — the member-year selection above extended by a
# second hop (role -> person -> born_in); proving the year-equality
# selection still requires citing every member's year fact
_MEMBER_YEAR_BORN_RE = re.compile(
    r"\bwhere\s+(?:was|is)\s+the\s+"
    r"(?P<role>performer|artist|singer|founder|author|writer)\s+of\s+"
    r"the\s+(?:album|work|record|song|release)\s+"
    r"(?:released\s+|put\s+out\s+|recorded\s+)?"
    r"(?:on|by|through|under)\s+(?:the\s+label\s+)?(?P<set>.+?)\s+"
    r"in\s+(?P<year>1[0-9]{3}|20[0-9]{2})\s+born\s*\??\s*$",
    re.IGNORECASE)


def answer_member_year_born(question: str, graph: Optional[NoteGraph],
                            candidates: Sequence[Dict[str, Any]]
                            ) -> Optional[Dict[str, Any]]:
    m = _MEMBER_YEAR_BORN_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    entries = [e for e in _label_set(m.group("set").strip(), graph)
               if e[1] >= 0]
    year = int(m.group("year"))
    hits = [e for e in entries if e[1] == year]
    if len(entries) < 2 or len(hits) != 1:
        return None                        # zero or several: ambiguous
    role = _ROLE_RELS.get(m.group("role").lower(), ("performed_by",))
    person = _hop_tail(graph, hits[0][0], role)
    if person is None:
        return None
    city = _hop_tail(graph, person[0], ("born_in",))
    if city is None:
        return None
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    for hop in (person, city):
        support += [p for p in hop[1] if p not in support]
    return {"answer": city[0], "support_idxs": support,
            "method": "member_year_born"}


# "What was the second album released on the label L?" (v8 kind 15) —
# an ORDINAL over the label's work set, not an extremum
_ORDINAL_WORDS = {"second": 2, "third": 3, "fourth": 4, "fifth": 5,
                  "2nd": 2, "3rd": 3, "4th": 4, "5th": 5}
_ORDINAL_RE = re.compile(
    r"\b(?:what|which)\s+(?:was|is|were)\s+the\s+"
    r"(?P<ord>second|third|fourth|fifth|2nd|3rd|4th|5th)\s+"
    r"(?P<dir>most\s+recent\s+|latest\s+)?"
    r"(?:album|work|record|song|release)\s+"
    r"(?:to\s+be\s+)?(?:released|published|issued|put\s+out)?\s*"
    r"(?:on|by|through|under)\s+(?:the\s+label\s+)?(?P<set>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_ordinal(question: str, graph: Optional[NoteGraph],
                   candidates: Sequence[Dict[str, Any]]
                   ) -> Optional[Dict[str, Any]]:
    m = _ORDINAL_RE.search((question or "").strip())
    if not m:
        return None
    idx = _ORDINAL_WORDS[m.group("ord").lower()] - 1
    entries = [e for e in _label_set(m.group("set").strip(), graph)
               if e[1] >= 0]
    if len(entries) <= idx:
        return None
    entries.sort(key=lambda t: t[1], reverse=bool(m.group("dir")))
    pick = entries[idx]
    # a year tie at the ordinal boundary makes the position ambiguous
    years = [y for _, y, _ in entries]
    if years.count(pick[1]) > 1:
        return None
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    return {"answer": pick[0], "support_idxs": support, "method": "ordinal"}


# "Which record label released both A and B?" (v8 kind 14) — the LABEL is
# the answer, reached by intersecting the two works' released-on edges
_BOTH_RE = re.compile(
    r"\bwhich\s+(?:record\s+)?(?:label|company|publisher|studio)\s+"
    r"(?:released|published|issued|distributed|put\s+out)\s+"
    r"both\s+(?P<a>.+?)\s+and\s+(?P<b>.+?)\s*\??\s*$",
    re.IGNORECASE)


def _labels_of(option: str, graph: NoteGraph) -> Dict[str, List[int]]:
    """{label tail: support paragraph idxs} for option's released-on edges."""
    key = graph.resolve_head(option)
    if key is None:
        return {}
    out: Dict[str, List[int]] = {}
    for rel, tail, note_id, _w, _p in graph.neighbors(key):
        if rel not in _SET_RELS:
            continue
        note = graph.notes.get(note_id, {})
        paras = out.setdefault(str(tail), [])
        paras += [p for p in (note.get("paragraph_idxs") or [])
                  if p not in paras]
    return out


def answer_label_intersection(question: str, graph: Optional[NoteGraph],
                              candidates: Sequence[Dict[str, Any]]
                              ) -> Optional[Dict[str, Any]]:
    m = _BOTH_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    la = _labels_of(m.group("a").strip(), graph)
    lb = _labels_of(m.group("b").strip(), graph)
    common = [k for k in la if k in lb]
    if len(common) != 1:
        return None
    label = common[0]
    support = list(dict.fromkeys(la[label] + lb[label]))
    return {"answer": label, "support_idxs": support,
            "method": "label_intersection"}


# "Which album on the label L was released in the 1970s?" (v9 kind 19) —
# decade membership over the label's work set
_DECADE_RE = re.compile(
    r"\b(?:what|which)\s+(?:album|work|record|song|release)s?\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+(?:was|were|got|came)\s+(?P<neg>not\s+)?[^?]*?"
    r"\bin\s+the\s+(?P<dec>1[0-9]{2}|20[0-9])0s\b",
    re.IGNORECASE)


def answer_decade(question: str, graph: Optional[NoteGraph],
                  candidates: Sequence[Dict[str, Any]]
                  ) -> Optional[Dict[str, Any]]:
    m = _DECADE_RE.search((question or "").strip())
    if not m:
        return None
    lo = int(m.group("dec")) * 10
    entries = [e for e in _label_set(m.group("set").strip(), graph)
               if e[1] >= 0]
    if len(entries) < 2:
        return None
    # v20 kind 63: "was NOT released in the <dec>s" selects the
    # complement — the member outside the decade
    want_outside = bool(m.group("neg"))
    hits = [e for e in entries
            if (lo <= e[1] < lo + 10) != want_outside]
    if len(hits) != 1:
        return None                        # zero or several: ambiguous
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    return {"answer": hits[0][0], "support_idxs": support,
            "method": "decade"}


# "Which album on the label L was released between LO and HI?" (v17
# kind 51) — a two-sided inclusive year window over the label's work
# set; the decade stage above is the one-sided special case
_INTERVAL_RE = re.compile(
    r"\b(?:what|which)\s+(?:album|work|record|song|release)s?\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+(?:was|were|got|came)\s+"
    r"(?:released|out|put\s+out|issued|published)\s+between\s+"
    r"(?P<lo>1[0-9]{3}|20[0-9]{2})\s+and\s+"
    r"(?P<hi>1[0-9]{3}|20[0-9]{2})\b",
    re.IGNORECASE)


def answer_interval(question: str, graph: Optional[NoteGraph],
                    candidates: Sequence[Dict[str, Any]]
                    ) -> Optional[Dict[str, Any]]:
    m = _INTERVAL_RE.search((question or "").strip())
    if not m:
        return None
    lo, hi = int(m.group("lo")), int(m.group("hi"))
    if hi < lo:
        return None
    entries = [e for e in _label_set(m.group("set").strip(), graph)
               if e[1] >= 0]
    if len(entries) < 2:
        return None
    hits = [e for e in entries if lo <= e[1] <= hi]
    if len(hits) != 1:
        return None                        # zero or several: ambiguous
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    return {"answer": hits[0][0], "support_idxs": support,
            "method": "interval"}


# "Which album by P was released on the label L?" (v9 kind 18) — BOTH
# constraints must bind (the corpus carries single-constraint foils)
_CONJ_RE = re.compile(
    r"\b(?:what|which)\s+(?:album|work|record|song|release)\s+by\s+"
    r"(?P<who>.+?)\s+(?:was|were|got|came)\s+(?P<neg>not\s+)?"
    r"(?:released|put\s+out|published|issued|out)\s+"
    r"(?:on|by|through|under)\s+(?:the\s+label\s+)?(?P<set>.+?)\s*\??\s*$",
    re.IGNORECASE)


_CONJ_SPOUSE_RE = re.compile(
    r"^the\s+(?:spouse|wife|husband|partner)\s+of\s+(?P<p>.+)$",
    re.IGNORECASE)


def answer_conjunctive(question: str, graph: Optional[NoteGraph],
                       candidates: Sequence[Dict[str, Any]]
                       ) -> Optional[Dict[str, Any]]:
    m = _CONJ_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    who = m.group("who").strip()
    hop_paras: List[int] = []
    sm = _CONJ_SPOUSE_RE.match(who)
    if sm:
        # v19 kind 58: the performer operand itself resolves through
        # spouse_of before the conjunction runs; the marriage note is
        # part of the proof
        sp = _spouse_tail(graph, sm.group("p").strip())
        if sp is None:
            return None
        who, hop_paras = sp
    pkey = graph.resolve_tail(who)
    lkey = graph.resolve_tail(m.group("set").strip())
    if pkey is None or lkey is None:
        return None
    by_p = {head: nid for rel, head, nid in graph.rheads(pkey)
            if rel in _DESC_RELS}
    on_l = {head: nid for rel, head, nid in graph.rheads(lkey)
            if rel in _SET_RELS}
    if m.group("neg"):
        # v10 set difference: "was NOT released on L" — the excluded
        # works' on-L notes are part of the proof
        hits = [wk for wk in by_p if wk not in on_l]
        if len(hits) != 1:
            return None
        wk = hits[0]
        nids = [by_p[wk]] + [on_l[x] for x in by_p if x in on_l]
    else:
        hits = [wk for wk in by_p if wk in on_l]
        if len(hits) != 1:
            return None
        wk = hits[0]
        nids = [by_p[wk], on_l[wk]]
    support: List[int] = list(hop_paras)
    for nid in nids:
        note = graph.notes.get(nid, {})
        support += [p for p in (note.get("paragraph_idxs") or [])
                    if p not in support]
    return {"answer": wk, "support_idxs": support, "method": "conjunctive"}


# "How many albums on the label L were released in the 1990s?" (v10
# kind 23) — cardinality AFTER a decade filter; every set member must
# have a resolvable year or the count is unsafe
_COUNT_FILTER_RE = re.compile(
    r"\bhow\s+many\s+(?:album|work|record|song|release)s?\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+(?:was|were)\s+released\s+in\s+the\s+"
    r"(?P<dec>1[0-9]{2}|20[0-9])0s\b",
    re.IGNORECASE)


def answer_count_filtered(question: str, graph: Optional[NoteGraph],
                          candidates: Sequence[Dict[str, Any]]
                          ) -> Optional[Dict[str, Any]]:
    m = _COUNT_FILTER_RE.search((question or "").strip())
    if not m:
        return None
    entries = _label_set(m.group("set").strip(), graph)
    if not entries or any(y < 0 for _, y, _ in entries):
        return None
    lo = int(m.group("dec")) * 10
    hits = [e for e in entries if lo <= e[1] < lo + 10]
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    return {"answer": str(len(hits)), "support_idxs": support,
            "method": "count_filtered"}


# strict AND non-strict threshold comparators (v17 kind 52 strict,
# v19 kind 60 at-least/at-most — a member sitting exactly ON the cut
# flips the answer between the readings)
_THRESH_DIR = (r"(?:(?P<dir>more|fewer|less)\s+than|"
               r"(?P<nsdir>at\s+least|at\s+most|no\s+more\s+than|"
               r"no\s+fewer\s+than|no\s+less\s+than))")


def _threshold_cmp(m: "re.Match"):
    """count-vs-threshold predicate from a _THRESH_DIR match, or None."""
    d = (m.group("dir") or "").lower()
    ns = re.sub(r"\s+", " ", (m.group("nsdir") or "").lower())
    if d == "more":
        return lambda c, t: c > t
    if d in ("fewer", "less"):
        return lambda c, t: c < t
    if ns in ("at least", "no fewer than", "no less than"):
        return lambda c, t: c >= t
    if ns in ("at most", "no more than"):
        return lambda c, t: c <= t
    return None


def _parse_num(tok: str) -> Optional[int]:
    tok = tok.lower()
    if tok.isdigit():
        return int(tok)
    return _WORD_NUMS.get(tok)


# "How many albums on the label L have more than eight tracks?" (v17
# kind 52) — cardinality after a word-number ATTRIBUTE threshold (the
# filtered count above thresholds on the release DECADE); every member
# must carry a resolvable count or the cardinality is unsound
_COUNT_THRESH_RE = re.compile(
    r"\bhow\s+many\s+(?:album|work|record|song|release)s?\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+(?:have|contain|feature)\s+"
    + _THRESH_DIR + r"\s+(?P<t>\d{1,3}|[a-z]+)\s+"
    r"(?P<attr>tracks|songs|discs|minutes)\b",
    re.IGNORECASE)


def answer_count_threshold(question: str, graph: Optional[NoteGraph],
                           candidates: Sequence[Dict[str, Any]]
                           ) -> Optional[Dict[str, Any]]:
    m = _COUNT_THRESH_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    t = _parse_num(m.group("t"))
    cmp_fn = _threshold_cmp(m)
    if t is None or cmp_fn is None:
        return None
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < 2:
        return None
    pool = list(candidates or ()) + list(graph.notes.values())
    over = 0
    support: List[int] = []
    for work, _y, paras in entries:
        support += [p for p in paras if p not in support]
        c = _attr_count(work, m.group("attr"), pool)
        if c is None:
            return None          # a member without a count: unsound
        if cmp_fn(c[0], t):
            over += 1
        support += [p for p in c[1] if p not in support]
    return {"answer": str(over), "support_idxs": support,
            "method": "count_threshold"}


# "Which album on the label L has more than eight tracks?" (v18 kind
# 55) — the threshold filter above reused as a SELECTION: exactly one
# member sits on the asked side of the cut
_ATTR_WHICH_RE = re.compile(
    r"\b(?:what|which)\s+(?:album|work|record|song|release)\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+(?:has|contains|features)\s+"
    + _THRESH_DIR + r"\s+(?P<t>\d{1,3}|[a-z]+)\s+"
    r"(?P<attr>tracks|songs|discs|minutes)\b",
    re.IGNORECASE)


def answer_attr_threshold_which(question: str, graph: Optional[NoteGraph],
                                candidates: Sequence[Dict[str, Any]]
                                ) -> Optional[Dict[str, Any]]:
    m = _ATTR_WHICH_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    t = _parse_num(m.group("t"))
    cmp_fn = _threshold_cmp(m)
    if t is None or cmp_fn is None:
        return None
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < 2:
        return None
    pool = list(candidates or ()) + list(graph.notes.values())
    hits: List[str] = []
    support: List[int] = []
    for work, _y, paras in entries:
        support += [p for p in paras if p not in support]
        c = _attr_count(work, m.group("attr"), pool)
        if c is None:
            return None          # a member without a count: unsound
        if cmp_fn(c[0], t):
            hits.append(work)
        support += [p for p in c[1] if p not in support]
    if len(hits) != 1:
        return None                        # zero or several: ambiguous
    return {"answer": hits[0], "support_idxs": support,
            "method": "attr_threshold_which"}


# "How many tracks does the album performed by the spouse of P have?"
# (v18 kind 56) — spouse resolves FORWARD, the work is reached AGAINST
# the performed_by edge (kind 53's inverse hop), then the answer is a
# word-number attribute stated only in the hopped-to paragraph
_INV_HOP_ATTR_RE = re.compile(
    r"\bhow\s+many\s+(?P<attr>tracks|songs|discs|minutes)\s+does\s+the\s+"
    r"(?:album|work|record|song|release)\s+"
    r"(?:performed|recorded|written|made)\s+by\s+the\s+"
    r"(?:spouse|wife|husband|partner)\s+of\s+(?P<p>.+?)\s+"
    r"(?:have|contain|feature)\s*\??\s*$",
    re.IGNORECASE)


def _spouse_tail(graph: NoteGraph, person: str
                 ) -> Optional[Tuple[str, List[int]]]:
    """(spouse, marriage-note paras) resolved forward or reverse."""
    key = graph.resolve_head(person)
    if key is not None:
        for rel, tail, nid, _w, _p in graph.neighbors(key):
            if rel == "spouse_of":
                note = graph.notes.get(nid, {})
                return str(tail), list(note.get("paragraph_idxs") or [])
    key = graph.resolve_tail(person)
    if key is not None:
        for rel, head, nid in graph.rheads(key):
            if rel == "spouse_of":
                note = graph.notes.get(nid, {})
                return str(head), list(note.get("paragraph_idxs") or [])
    return None


def answer_inverse_hop_attr(question: str, graph: Optional[NoteGraph],
                            candidates: Sequence[Dict[str, Any]]
                            ) -> Optional[Dict[str, Any]]:
    m = _INV_HOP_ATTR_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    sp = _spouse_tail(graph, m.group("p").strip())
    if sp is None:
        return None
    skey = graph.resolve_tail(sp[0])
    if skey is None:
        return None
    by_work: Dict[str, List[str]] = {}
    for rel, head, nid in graph.rheads(skey):
        if rel == "performed_by":
            by_work.setdefault(head, []).append(nid)
    if len(by_work) != 1:      # several DISTINCT works: ambiguous
        return None
    work, nids = next(iter(by_work.items()))
    pool = list(candidates or ()) + list(graph.notes.values())
    c = _attr_count(work, m.group("attr"), pool)
    if c is None:
        return None
    support = list(sp[1])
    wparas = [p for nid in nids
              for p in (graph.notes.get(nid, {}).get("paragraph_idxs") or ())]
    for p in wparas + c[1]:
        if p not in support:
            support.append(p)
    return {"answer": str(c[0]), "support_idxs": support,
            "method": "inverse_hop_attr"}


# "Which album was released both on the label L1 and on the label L2?"
# (v18 kind 57) — intersection of two reverse label sets; the second
# edge is typically a REISSUE (the kind-17 trap wants the primary edge
# for "which label released W", but membership unions both)
_DUAL_LABEL_RE = re.compile(
    r"\b(?:what|which)\s+(?:album|work|record|song|release)\s+was\s+"
    r"(?:released|put\s+out|issued|reissued|published)\s+both\s+"
    r"(?:on|by|through|under)\s+the\s+label\s+(?P<a>.+?)\s+and\s+"
    r"(?:on|by|through|under)\s+the\s+label\s+(?P<b>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_dual_label(question: str, graph: Optional[NoteGraph],
                      candidates: Sequence[Dict[str, Any]]
                      ) -> Optional[Dict[str, Any]]:
    m = _DUAL_LABEL_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    sets = []
    for surf in (m.group("a").strip(), m.group("b").strip()):
        entries = _label_set(surf, graph)
        if not entries:
            return None
        sets.append({w: paras for w, _y, paras in entries})
    hits = [w for w in sets[0] if w in sets[1]]
    if len(hits) != 1:
        return None                        # zero or several: ambiguous
    # uniqueness of the intersection is established by enumerating both
    # sets — every member paragraph is support
    support: List[int] = []
    for s in sets:
        for paras in s.values():
            support += [p for p in paras if p not in support]
    return {"answer": hits[0], "support_idxs": support,
            "method": "dual_label"}


# "How many tracks does the first album released on the label L have?"
# (v19 kind 59) — the attribute read runs on the ARGMIN of the release
# years, so the proof cites every member's year fact (establishing the
# extremum) plus the winner's count sentence
_SUPERL_ATTR_RE = re.compile(
    r"\bhow\s+many\s+(?P<attr>tracks|songs|discs|minutes)\s+does\s+the\s+"
    r"(?P<ord>" + _ORD_MIN + r"|" + _ORD_MAX + r")\s+"
    r"(?:album|work|record|song|release)\s+"
    r"(?:released\s+|recorded\s+|put\s+out\s+)?"
    r"(?:on|by|through|under)\s+(?:the\s+label\s+)?(?P<set>.+?)\s+"
    r"(?:have|contain|feature)\s*\??\s*$",
    re.IGNORECASE)


def answer_superlative_attr(question: str, graph: Optional[NoteGraph],
                            candidates: Sequence[Dict[str, Any]]
                            ) -> Optional[Dict[str, Any]]:
    m = _SUPERL_ATTR_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    entries = [e for e in _label_set(m.group("set").strip(), graph)
               if e[1] >= 0]
    if len(entries) < 2:
        return None
    ordinal = re.sub(r"\s+", " ", m.group("ord").lower())
    best = min(entries, key=lambda t: t[1]) \
        if re.fullmatch(_ORD_MIN, ordinal) else max(entries, key=lambda t: t[1])
    if [y for _, y, _ in entries].count(best[1]) > 1:
        return None                              # tied extremum: ambiguous
    pool = list(candidates or ()) + list(graph.notes.values())
    c = _attr_count(best[0], m.group("attr"), pool)
    if c is None:
        return None
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    support += [p for p in c[1] if p not in support]
    return {"answer": str(c[0]), "support_idxs": support,
            "method": "superlative_attr"}


# "Do all albums on the label L have more than N tracks?" (v19 kind 61)
# — universal quantification over a word-number ATTRIBUTE (the decade
# forall quantifies over release years); a single counterexample flips
# the answer, so every member must carry a resolvable count
_ALL_ATTR_RE = re.compile(
    r"\b(?:do|does)\s+all\s+(?:of\s+)?(?:the\s+)?"
    r"(?:album|work|record|song|release)s?\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+(?:have|contain|feature)\s+"
    + _THRESH_DIR + r"\s+(?P<t>\d{1,3}|[a-z]+)\s+"
    r"(?P<attr>tracks|songs|discs|minutes)\s*\??\s*$",
    re.IGNORECASE)


def answer_forall_attr(question: str, graph: Optional[NoteGraph],
                       candidates: Sequence[Dict[str, Any]]
                       ) -> Optional[Dict[str, Any]]:
    m = _ALL_ATTR_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    t = _parse_num(m.group("t"))
    cmp_fn = _threshold_cmp(m)
    if t is None or cmp_fn is None:
        return None
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < 2:
        return None
    pool = list(candidates or ()) + list(graph.notes.values())
    ok = True
    support: List[int] = []
    for work, _y, paras in entries:
        support += [p for p in paras if p not in support]
        c = _attr_count(work, m.group("attr"), pool)
        if c is None:
            return None          # a member without a count: unsound
        if not cmp_fn(c[0], t):
            ok = False
        support += [p for p in c[1] if p not in support]
    return {"answer": "yes" if ok else "no", "support_idxs": support,
            "method": "forall_attr"}


# "Which label's first album has more tracks, L1 or L2?" (v21 kind 66)
# — a per-OPTION superlative feeding the attribute comparator; unlike
# attr_comparative the options are LABELS and the answer echoes one
_LABEL_ATTR_CMP_RE = re.compile(
    r"\bwhich\s+label'?s\s+(?P<ord>" + _ORD_MIN + r"|" + _ORD_MAX + r")\s+"
    r"(?:album|work|record|song|release)\s+has\s+"
    r"(?P<dir>more|fewer|less)\s+(?P<attr>tracks|songs|discs|minutes)\s*"
    r"[,:]?\s*(?P<a>.+?)\s+or\s+(?P<b>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_label_attr_comparative(question: str,
                                  graph: Optional[NoteGraph],
                                  candidates: Sequence[Dict[str, Any]]
                                  ) -> Optional[Dict[str, Any]]:
    m = _LABEL_ATTR_CMP_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    ordinal = re.sub(r"\s+", " ", m.group("ord").lower())
    pickfn = min if re.fullmatch(_ORD_MIN, ordinal) else max
    pool = list(candidates or ()) + list(graph.notes.values())
    got: List[Tuple[str, int]] = []
    support: List[int] = []
    for opt in (m.group("a").strip(), m.group("b").strip()):
        entries = [e for e in _label_set(opt, graph) if e[1] >= 0]
        if not entries:
            return None
        best = pickfn(entries, key=lambda t: t[1])
        if [y for _, y, _ in entries].count(best[1]) > 1:
            return None                          # tied extremum
        c = _attr_count(best[0], m.group("attr"), pool)
        if c is None:
            return None
        got.append((opt, c[0]))
        for _, _, paras in entries:
            support += [p for p in paras if p not in support]
        support += [p for p in c[1] if p not in support]
    if got[0][1] == got[1][1]:
        return None
    more = m.group("dir").lower() == "more"
    idx = 0 if (got[0][1] > got[1][1]) == more else 1
    return {"answer": got[idx][0], "support_idxs": support,
            "method": "label_attr_comparative"}


# "How many albums were released on the label that released W?" (v21
# kind 67) — the count's set anchor is never NAMED; it resolves through
# the member's forward released_on_label edge before the count runs
_COUNT_HOP_RE = re.compile(
    r"\bhow\s+many\s+(?:album|work|record|song|release)s?\s+"
    r"(?:was|were)\s+(?:released|published|put\s+out)\s+"
    r"(?:on|by|through|under)\s+the\s+label\s+that\s+"
    r"(?:released|put\s+out|published)\s+(?P<w>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_count_hop(question: str, graph: Optional[NoteGraph],
                     candidates: Sequence[Dict[str, Any]]
                     ) -> Optional[Dict[str, Any]]:
    m = _COUNT_HOP_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    hop = _hop_tail(graph, m.group("w").strip(), ("released_on_label",))
    if hop is None:
        return None
    entries = _label_set(hop[0], graph)
    if not entries:
        return None
    support: List[int] = list(hop[1])
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    return {"answer": str(len(entries)), "support_idxs": support,
            "method": "count_hop"}


# "In what year was the album with the most tracks on the label L
# released?" (v21 kind 68) — a temporal read on the attribute ARGMAX
# (attr_superlative answers the work itself; here the winner's year is
# the answer, so every member still needs a resolvable count)
_ATTR_ARGMAX_YEAR_RE = re.compile(
    r"\b(?:in\s+(?:what|which)\s+year\s+was|when\s+was)\s+the\s+"
    r"(?:album|work|record|song|release)\s+with\s+the\s+"
    r"(?P<dir>most|fewest|least)\s+(?P<attr>tracks|songs|discs|minutes)\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+released\s*\??\s*$",
    re.IGNORECASE)


def answer_attr_argmax_year(question: str, graph: Optional[NoteGraph],
                            candidates: Sequence[Dict[str, Any]]
                            ) -> Optional[Dict[str, Any]]:
    m = _ATTR_ARGMAX_YEAR_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < 2:
        return None
    pool = list(candidates or ()) + list(graph.notes.values())
    got: List[Tuple[str, int, int]] = []
    support: List[int] = []
    for work, y, paras in entries:
        support += [p for p in paras if p not in support]
        c = _attr_count(work, m.group("attr"), pool)
        if c is None:
            return None          # a member without a count: argmax unsound
        got.append((work, y, c[0]))
        support += [p for p in c[1] if p not in support]
    pickfn = max if m.group("dir").lower() == "most" else min
    best = pickfn(got, key=lambda t: t[2])
    if [n for _, _, n in got].count(best[2]) > 1 or best[1] < 0:
        return None              # tied extremum / winner's year unknown
    return {"answer": str(best[1]), "support_idxs": support,
            "method": "attr_argmax_year"}


# "Did any album on the label L released in the 1960s have more than
# thirteen tracks?" (v21 kind 69) — existential over attribute AND
# decade; the decade filter must bind BEFORE the threshold (the
# out-of-decade member is built to exceed the cut)
_EXISTS_ATTR_DEC_RE = re.compile(
    r"\bdid\s+any\s+(?:album|work|record|song|release)s?\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+released\s+in\s+the\s+(?P<dec>1[0-9]{2}|20[0-9])0s\s+"
    r"(?:have|contain|feature)\s+" + _THRESH_DIR +
    r"\s+(?P<t>\d{1,3}|[a-z]+)\s+"
    r"(?P<attr>tracks|songs|discs|minutes)\s*\??\s*$",
    re.IGNORECASE)


def answer_exists_attr_decade(question: str, graph: Optional[NoteGraph],
                              candidates: Sequence[Dict[str, Any]]
                              ) -> Optional[Dict[str, Any]]:
    m = _EXISTS_ATTR_DEC_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    t = _parse_num(m.group("t"))
    cmp_fn = _threshold_cmp(m)
    if t is None or cmp_fn is None:
        return None
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < 2 or any(y < 0 for _, y, _ in entries):
        return None             # unknown year: the decade filter is unsound
    lo = int(m.group("dec")) * 10
    sel = [e for e in entries if lo <= e[1] < lo + 10]
    pool = list(candidates or ()) + list(graph.notes.values())
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    hit = unknown = False
    for work, _y, _paras in sel:
        c = _attr_count(work, m.group("attr"), pool)
        if c is None:
            unknown = True
            continue
        support += [p for p in c[1] if p not in support]
        if cmp_fn(c[0], t):
            hit = True
    if not hit and unknown:
        return None             # a member without a count: 'no' is unsound
    return {"answer": "yes" if hit else "no", "support_idxs": support,
            "method": "exists_attr_decade"}


# "Who performed the last album released on the label that released W?"
# (v22 kind 70) — the set anchor is UNNAMED and resolves through a
# member's forward released_on_label edge before the superlative and
# the performer hop run (every solved superlative names its label)
_SUPERL_HOP_UNNAMED_RE = re.compile(
    r"\bwho\s+(?P<verb>performed|recorded|made|released|wrote)\s+the\s+"
    r"(?P<ord>" + _ORD_MIN + r"|" + _ORD_MAX + r")\s+"
    r"(?:album|work|record|song|release)\s+"
    r"(?:released\s+|put\s+out\s+|recorded\s+)?"
    r"(?:on|by|through|under)\s+the\s+label\s+that\s+"
    r"(?:released|put\s+out|published)\s+(?P<w>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_superlative_hop_unnamed(question: str,
                                   graph: Optional[NoteGraph],
                                   candidates: Sequence[Dict[str, Any]]
                                   ) -> Optional[Dict[str, Any]]:
    m = _SUPERL_HOP_UNNAMED_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    anchor = _hop_tail(graph, m.group("w").strip(), ("released_on_label",))
    if anchor is None:
        return None
    entries = [e for e in _label_set(anchor[0], graph) if e[1] >= 0]
    if len(entries) < 2:
        return None
    ordinal = re.sub(r"\s+", " ", m.group("ord").lower())
    best = min(entries, key=lambda t: t[1]) \
        if re.fullmatch(_ORD_MIN, ordinal) else max(entries, key=lambda t: t[1])
    if [y for _, y, _ in entries].count(best[1]) > 1:
        return None                              # tied extremum
    want = _HOP_RELS.get(m.group("verb").lower(), ("performed_by",))
    hop = _hop_tail(graph, best[0], want)
    if hop is None:
        return None
    support: List[int] = list(anchor[1])
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    support += [p for p in hop[1] if p not in support]
    return {"answer": hop[0], "support_idxs": support,
            "method": "superlative_hop_unnamed"}


# "Were more albums on the label L released in the 1980s than in the
# 1990s?" (v22 kind 71) — two decade-filtered counts over ONE label
# compared as yes/no (count_filtered counts a single decade)
_DEC_CMP_RE = re.compile(
    r"\b(?:were|was)\s+(?P<dir>more|fewer|less)\s+"
    r"(?:album|work|record|song|release)s?\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+released\s+in\s+the\s+(?P<d0>1[0-9]{2}|20[0-9])0s\s+"
    r"than\s+in\s+the\s+(?P<d1>1[0-9]{2}|20[0-9])0s\s*\??\s*$",
    re.IGNORECASE)


def answer_decade_count_compare(question: str,
                                graph: Optional[NoteGraph],
                                candidates: Sequence[Dict[str, Any]]
                                ) -> Optional[Dict[str, Any]]:
    m = _DEC_CMP_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < 2 or any(y < 0 for _, y, _ in entries):
        return None             # unknown year: the bucket counts are unsound
    lo0, lo1 = int(m.group("d0")) * 10, int(m.group("d1")) * 10
    n0 = sum(1 for _, y, _ in entries if lo0 <= y < lo0 + 10)
    n1 = sum(1 for _, y, _ in entries if lo1 <= y < lo1 + 10)
    more = m.group("dir").lower() == "more"
    ok = (n0 > n1) if more else (n0 < n1)
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    return {"answer": "yes" if ok else "no", "support_idxs": support,
            "method": "decade_count_compare"}


# "Which label's albums have more tracks in total, L1 or L2?" (v22 kind
# 72) — a per-label attribute SUM feeding the comparator (the v21
# label comparison reads one superlative member per label)
_LABEL_SUM_CMP_RE = re.compile(
    r"\bwhich\s+label'?s\s+(?:album|work|record|song|release)s\s+have\s+"
    r"(?P<dir>more|fewer|less)\s+(?P<attr>tracks|songs|discs|minutes)\s+"
    r"in\s+total\s*[,:]?\s*(?P<a>.+?)\s+or\s+(?P<b>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_label_attr_sum_compare(question: str,
                                  graph: Optional[NoteGraph],
                                  candidates: Sequence[Dict[str, Any]]
                                  ) -> Optional[Dict[str, Any]]:
    m = _LABEL_SUM_CMP_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    pool = list(candidates or ()) + list(graph.notes.values())
    got: List[Tuple[str, int]] = []
    support: List[int] = []
    for opt in (m.group("a").strip(), m.group("b").strip()):
        entries = _label_set(opt, graph)
        if not entries:
            return None
        total = 0
        for work, _y, paras in entries:
            support += [p for p in paras if p not in support]
            c = _attr_count(work, m.group("attr"), pool)
            if c is None:
                return None      # a member without a count: sum unsound
            total += c[0]
            support += [p for p in c[1] if p not in support]
        got.append((opt, total))
    if got[0][1] == got[1][1]:
        return None
    more = m.group("dir").lower() == "more"
    idx = 0 if (got[0][1] > got[1][1]) == more else 1
    return {"answer": got[idx][0], "support_idxs": support,
            "method": "label_attr_sum_compare"}


# "How many albums on the label L have the same number of tracks as W?"
# (v22 kind 73) — the threshold is another MEMBER's attribute, not a
# literal, and the reference member itself must not be counted
_ATTR_EQ_COUNT_RE = re.compile(
    r"\bhow\s+many\s+(?:album|work|record|song|release)s?\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+have\s+the\s+same\s+number\s+of\s+"
    r"(?P<attr>tracks|songs|discs|minutes)\s+as\s+(?P<w>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_attr_equal_count(question: str, graph: Optional[NoteGraph],
                            candidates: Sequence[Dict[str, Any]]
                            ) -> Optional[Dict[str, Any]]:
    m = _ATTR_EQ_COUNT_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    ref = m.group("w").strip()
    pool = list(candidates or ()) + list(graph.notes.values())
    cref = _attr_count(ref, m.group("attr"), pool)
    if cref is None:
        return None
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < 2:
        return None
    ref_low = re.sub(r"\s*\([^)]*\)\s*$", "", ref).strip().lower()
    support: List[int] = list(cref[1])
    n_eq = 0
    for work, _y, paras in entries:
        support += [p for p in paras if p not in support]
        base = re.sub(r"\s*\([^)]*\)\s*$", "", work).strip().lower()
        if base == ref_low:
            continue                             # the reference member
        c = _attr_count(work, m.group("attr"), pool)
        if c is None:
            return None          # a member without a count: unsound
        support += [p for p in c[1] if p not in support]
        if c[0] == cref[0]:
            n_eq += 1
    return {"answer": str(n_eq), "support_idxs": support,
            "method": "attr_equal_count"}


# "Which album on the label L was performed by someone born in C?"
# (v23 kind 74) — member selection through a 2-hop performer-attribute
# join: the filter fact (the performer's birth city) lives in a
# separate paragraph per member, so each member walks
# performed_by -> born_in before the equality test
_MEMBER_BORN_RE = re.compile(
    r"\b(?:which|what)\s+(?:album|work|record|song|release)\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+was\s+(?:performed|recorded|made)\s+by\s+"
    r"(?:someone|a\s+person|an?\s+(?:artist|musician|singer))\s+"
    r"born\s+in\s+(?P<city>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_member_born_join(question: str, graph: Optional[NoteGraph],
                            candidates: Sequence[Dict[str, Any]]
                            ) -> Optional[Dict[str, Any]]:
    m = _MEMBER_BORN_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < 2:
        return None
    want = m.group("city").strip().lower()
    support: List[int] = []
    matches: List[str] = []
    for work, _y, paras in entries:
        support += [p for p in paras if p not in support]
        perf = _hop_tail(graph, work, ("performed_by",))
        if perf is None:
            continue
        support += [p for p in perf[1] if p not in support]
        city = _hop_tail(graph, perf[0], ("born_in",))
        if city is None:
            continue
        support += [p for p in city[1] if p not in support]
        if city[0].strip().lower() == want:
            matches.append(work)
    if len(matches) != 1:
        return None                  # zero or ambiguous: selection unsound
    return {"answer": matches[0], "support_idxs": support,
            "method": "member_born_join"}


# "How many more tracks does the first album released on the label L1
# have than the first album released on the label L2?" (v23 kind 75) —
# attr_difference over two SUPERLATIVE-resolved operands (the named
# version subtracts two stated counts)
_SUPERL_ATTR_DIFF_RE = re.compile(
    r"\bhow\s+many\s+(?P<dir>more|fewer|less)\s+"
    r"(?P<attr>tracks|songs|discs|minutes)\s+does\s+the\s+"
    r"(?P<orda>" + _ORD_MIN + r"|" + _ORD_MAX + r")\s+"
    r"(?:album|work|record|song|release)\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<a>.+?)\s+have\s+than\s+the\s+"
    r"(?P<ordb>" + _ORD_MIN + r"|" + _ORD_MAX + r")\s+"
    r"(?:album|work|record|song|release)\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<b>.+?)\s*\??\s*$",
    re.IGNORECASE)


def _superl_member_count(label: str, ordinal: str, attr: str,
                         graph: NoteGraph, pool
                         ) -> Optional[Tuple[int, List[int]]]:
    """(count, support) of the ordinal-extremum member of `label`."""
    entries = [e for e in _label_set(label, graph) if e[1] >= 0]
    if not entries:
        return None
    ordinal = re.sub(r"\s+", " ", ordinal.lower())
    best = min(entries, key=lambda t: t[1]) \
        if re.fullmatch(_ORD_MIN, ordinal) else max(entries, key=lambda t: t[1])
    if [y for _, y, _ in entries].count(best[1]) > 1:
        return None                              # tied extremum
    c = _attr_count(best[0], attr, pool)
    if c is None:
        return None
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    support += [p for p in c[1] if p not in support]
    return c[0], support


def answer_superl_attr_difference(question: str,
                                  graph: Optional[NoteGraph],
                                  candidates: Sequence[Dict[str, Any]]
                                  ) -> Optional[Dict[str, Any]]:
    m = _SUPERL_ATTR_DIFF_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    pool = list(candidates or ()) + list(graph.notes.values())
    got_a = _superl_member_count(m.group("a").strip(), m.group("orda"),
                                 m.group("attr"), graph, pool)
    got_b = _superl_member_count(m.group("b").strip(), m.group("ordb"),
                                 m.group("attr"), graph, pool)
    if got_a is None or got_b is None:
        return None
    diff = got_a[0] - got_b[0] if m.group("dir").lower() == "more" \
        else got_b[0] - got_a[0]
    if diff <= 0:
        return None              # phrasing contradicts the facts
    support = list(dict.fromkeys(got_a[1] + got_b[1]))
    return {"answer": str(diff), "support_idxs": support,
            "method": "superl_attr_difference"}


# "How many albums on the label L were not released in the D0s?" (v23
# kind 76) — the COMPLEMENT of the decade filter over the full
# membership (count_filtered counts the decade itself)
_COUNT_NOT_DEC_RE = re.compile(
    r"\bhow\s+many\s+(?:album|work|record|song|release)s?\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+(?:was|were)\s+not\s+released\s+in\s+the\s+"
    r"(?P<dec>1[0-9]{2}|20[0-9])0s\b",
    re.IGNORECASE)


def answer_count_not_decade(question: str, graph: Optional[NoteGraph],
                            candidates: Sequence[Dict[str, Any]]
                            ) -> Optional[Dict[str, Any]]:
    m = _COUNT_NOT_DEC_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < 2 or any(y < 0 for _, y, _ in entries):
        return None             # unknown year: the complement is unsound
    lo = int(m.group("dec")) * 10
    n_out = sum(1 for _, y, _ in entries if not lo <= y < lo + 10)
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    return {"answer": str(n_out), "support_idxs": support,
            "method": "count_not_decade"}


# "Which album on the label L released in the 1980s has the most
# tracks?" (v23 kind 77) — the attribute argmax runs only over
# IN-DECADE members; the out-of-decade trap carries the global max
_DEC_ATTR_SUPERL_RE = re.compile(
    r"\b(?:which|what)\s+(?:album|work|record|song|release)\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+released\s+in\s+the\s+(?P<dec>1[0-9]{2}|20[0-9])0s\s+"
    r"has\s+the\s+(?P<dir>most|fewest|least)\s+"
    r"(?P<attr>tracks|songs|discs|minutes)\s*\??\s*$",
    re.IGNORECASE)


def answer_decade_attr_superlative(question: str,
                                   graph: Optional[NoteGraph],
                                   candidates: Sequence[Dict[str, Any]]
                                   ) -> Optional[Dict[str, Any]]:
    m = _DEC_ATTR_SUPERL_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < 2 or any(y < 0 for _, y, _ in entries):
        return None             # unknown year: the decade filter is unsound
    lo = int(m.group("dec")) * 10
    sel = [e for e in entries if lo <= e[1] < lo + 10]
    if len(sel) < 2:
        return None             # argmax over <2 members: trivial/unsound
    pool = list(candidates or ()) + list(graph.notes.values())
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    got: List[Tuple[str, int]] = []
    for work, _y, _paras in sel:
        c = _attr_count(work, m.group("attr"), pool)
        if c is None:
            return None          # an in-decade member without a count
        got.append((work, c[0]))
        support += [p for p in c[1] if p not in support]
    pickfn = max if m.group("dir").lower() == "most" else min
    best = pickfn(got, key=lambda t: t[1])
    if [n for _, n in got].count(best[1]) > 1:
        return None                              # tied extremum
    return {"answer": best[0], "support_idxs": support,
            "method": "decade_attr_superlative"}


# "Which album on the label L has the second most tracks?" (v24 kind
# 78) — an ORDINAL over the attribute ranking (the solved ordinal
# ranks release years; attr_superlative takes only the extremum)
_ATTR_ORDINAL_RE = re.compile(
    r"\b(?:which|what)\s+(?:album|work|record|song|release)\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+has\s+the\s+(?P<ord>second|third|fourth|fifth)\s+"
    r"(?P<dir>most|fewest|least)\s+"
    r"(?P<attr>tracks|songs|discs|minutes)\s*\??\s*$",
    re.IGNORECASE)


def answer_attr_ordinal(question: str, graph: Optional[NoteGraph],
                        candidates: Sequence[Dict[str, Any]]
                        ) -> Optional[Dict[str, Any]]:
    m = _ATTR_ORDINAL_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    k = _ORDINAL_WORDS.get(m.group("ord").lower())
    if k is None:
        return None
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < k:
        return None
    pool = list(candidates or ()) + list(graph.notes.values())
    got: List[Tuple[str, int]] = []
    support: List[int] = []
    for work, _y, paras in entries:
        support += [p for p in paras if p not in support]
        c = _attr_count(work, m.group("attr"), pool)
        if c is None:
            return None          # a member without a count: rank unsound
        got.append((work, c[0]))
        support += [p for p in c[1] if p not in support]
    rev = m.group("dir").lower() == "most"
    got.sort(key=lambda t: t[1], reverse=rev)
    pick = got[k - 1]
    if [n for _, n in got].count(pick[1]) > 1:
        return None                              # tied rank: ambiguous
    return {"answer": pick[0], "support_idxs": support,
            "method": "attr_ordinal"}


# "In which decade were the most albums on the label L released?" (v24
# kind 79) — the MODE over decade buckets, answered as a decade
# surface (every solved decade stage filters or compares)
_DECADE_MODE_RE = re.compile(
    r"\bin\s+which\s+decade\s+(?:was|were)\s+the\s+most\s+"
    r"(?:album|work|record|song|release)s?\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+released\s*\??\s*$",
    re.IGNORECASE)


def answer_decade_mode(question: str, graph: Optional[NoteGraph],
                       candidates: Sequence[Dict[str, Any]]
                       ) -> Optional[Dict[str, Any]]:
    m = _DECADE_MODE_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < 2 or any(y < 0 for _, y, _ in entries):
        return None             # unknown year: the bucket counts are unsound
    buckets: Dict[int, int] = {}
    for _, y, _ in entries:
        buckets[(y // 10) * 10] = buckets.get((y // 10) * 10, 0) + 1
    best = max(buckets.items(), key=lambda kv: kv[1])
    if list(buckets.values()).count(best[1]) > 1:
        return None                              # tied mode: ambiguous
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    return {"answer": f"{best[0]}s", "support_idxs": support,
            "method": "decade_mode"}


# "Does the first album released on the label L have more tracks than
# the last album released on the label L?" (v24 kind 80) — yes/no
# attribute comparison of two SUPERLATIVE-resolved operands (the
# solved yesno compares release years of NAMED options)
_SUPERL_ATTR_YESNO_RE = re.compile(
    r"\bdoes\s+the\s+(?P<orda>" + _ORD_MIN + r"|" + _ORD_MAX + r")\s+"
    r"(?:album|work|record|song|release)\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<a>.+?)\s+have\s+(?P<dir>more|fewer|less)\s+"
    r"(?P<attr>tracks|songs|discs|minutes)\s+than\s+the\s+"
    r"(?P<ordb>" + _ORD_MIN + r"|" + _ORD_MAX + r")\s+"
    r"(?:album|work|record|song|release)\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<b>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_superl_attr_yesno(question: str, graph: Optional[NoteGraph],
                             candidates: Sequence[Dict[str, Any]]
                             ) -> Optional[Dict[str, Any]]:
    m = _SUPERL_ATTR_YESNO_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    pool = list(candidates or ()) + list(graph.notes.values())
    got_a = _superl_member_count(m.group("a").strip(), m.group("orda"),
                                 m.group("attr"), graph, pool)
    got_b = _superl_member_count(m.group("b").strip(), m.group("ordb"),
                                 m.group("attr"), graph, pool)
    if got_a is None or got_b is None:
        return None
    more = m.group("dir").lower() == "more"
    ok = (got_a[0] > got_b[0]) if more else (got_a[0] < got_b[0])
    support = list(dict.fromkeys(got_a[1] + got_b[1]))
    return {"answer": "yes" if ok else "no", "support_idxs": support,
            "method": "superl_attr_yesno"}


# "How many albums were released on the labels L1 and L2 combined?"
# (v24 kind 81) — the counted set is a UNION of two memberships (every
# solved count anchors one label)
_COUNT_UNION_RE = re.compile(
    r"\bhow\s+many\s+(?:album|work|record|song|release)s?\s+"
    r"(?:was|were)\s+(?:released|published|put\s+out)\s+"
    r"(?:on|by|through|under)\s+the\s+labels\s+"
    r"(?P<a>.+?)\s+and\s+(?P<b>.+?)\s+"
    r"(?:combined|in\s+total|altogether|together)\s*\??\s*$",
    re.IGNORECASE)


def answer_count_union(question: str, graph: Optional[NoteGraph],
                       candidates: Sequence[Dict[str, Any]]
                       ) -> Optional[Dict[str, Any]]:
    m = _COUNT_UNION_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    support: List[int] = []
    works: set = set()
    for opt in (m.group("a").strip(), m.group("b").strip()):
        entries = _label_set(opt, graph)
        if not entries:
            return None
        for work, _y, paras in entries:
            works.add(work)
            support += [p for p in paras if p not in support]
    return {"answer": str(len(works)), "support_idxs": support,
            "method": "count_union"}


# "How many years apart were the first and last albums released on the
# label L?" (v20 kind 62) — the difference runs between TWO
# superlative-resolved operands (years_apart subtracts two NAMED
# options); a tie at either extremum leaves the span itself exact, so
# no ambiguity gate is needed
_SUPERL_SPAN_RE = re.compile(
    r"\bhow\s+many\s+years\s+(?:apart|separate[d]?)\s+"
    r"(?:were|are|was)\s+the\s+(?:" + _ORD_MIN + r")\s+and\s+"
    r"(?:the\s+)?(?:" + _ORD_MAX + r")\s+"
    r"(?:album|work|record|song|release)s?\s+"
    r"(?:released\s+|recorded\s+|put\s+out\s+)?"
    r"(?:on|by|through|under)\s+(?:the\s+label\s+)?(?P<set>.+?)"
    r"(?:\s+released)?\s*\??\s*$",
    re.IGNORECASE)


def answer_superlative_span(question: str, graph: Optional[NoteGraph],
                            candidates: Sequence[Dict[str, Any]]
                            ) -> Optional[Dict[str, Any]]:
    m = _SUPERL_SPAN_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < 2 or any(y < 0 for _, y, _ in entries):
        return None                  # an unresolved year hides an extremum
    years = [y for _, y, _ in entries]
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    return {"answer": str(max(years) - min(years)),
            "support_idxs": support, "method": "superlative_span"}


# "Who is the spouse of the performer of the first album released on
# the label L?" (v20 kind 64) — THREE steps on the resolved extremum:
# superlative -> performed_by -> spouse_of (hop2 machinery ends at
# born_in; this chain ends at the marriage edge)
_SUPERL_SPOUSE_RE = re.compile(
    r"\bwho\s+(?:is|was)\s+the\s+(?:spouse|wife|husband|partner)\s+of\s+"
    r"the\s+(?P<role>performer|artist|singer)\s+of\s+the\s+"
    r"(?P<ord>" + _ORD_MIN + r"|" + _ORD_MAX + r")\s+"
    r"(?:album|work|record|song|release)\s+"
    r"(?:released\s+|recorded\s+|put\s+out\s+)?"
    r"(?:on|by|through|under)\s+(?:the\s+label\s+)?(?P<set>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_superlative_spouse(question: str, graph: Optional[NoteGraph],
                              candidates: Sequence[Dict[str, Any]]
                              ) -> Optional[Dict[str, Any]]:
    m = _SUPERL_SPOUSE_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    entries = [e for e in _label_set(m.group("set").strip(), graph)
               if e[1] >= 0]
    if len(entries) < 2:
        return None
    ordinal = re.sub(r"\s+", " ", m.group("ord").lower())
    best = min(entries, key=lambda t: t[1]) \
        if re.fullmatch(_ORD_MIN, ordinal) else max(entries, key=lambda t: t[1])
    if [y for _, y, _ in entries].count(best[1]) > 1:
        return None                              # tied extremum: ambiguous
    hop = _hop_tail(graph, best[0], ("performed_by",))
    if hop is None:
        return None
    sp = _spouse_tail(graph, hop[0])
    if sp is None:
        return None
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    for p in hop[1] + sp[1]:
        if p not in support:
            support.append(p)
    return {"answer": sp[0], "support_idxs": support,
            "method": "superlative_spouse"}


# "In which city was the spouse of the performer of the most recent
# album released on the label L born?" (v27 kind 91) — FOUR steps on the
# resolved extremum: superlative -> performed_by -> spouse_of -> born_in
# (superlative_spouse stops at the marriage edge)
_SUPERL_SPOUSE_CITY_RE = re.compile(
    r"\b(?:in\s+)?(?:which|what)\s+(?:city|town|place)\s+was\s+the\s+"
    r"(?:spouse|wife|husband|partner)\s+of\s+the\s+"
    r"(?P<role>performer|artist|singer)\s+of\s+the\s+"
    r"(?P<ord>" + _ORD_MIN + r"|" + _ORD_MAX + r")\s+"
    r"(?:album|work|record|song|release)\s+"
    r"(?:released\s+|recorded\s+|put\s+out\s+)?"
    r"(?:on|by|through|under)\s+(?:the\s+label\s+)?(?P<set>.+?)\s+"
    r"born\s*\??\s*$",
    re.IGNORECASE)


def answer_superlative_spouse_city(question: str,
                                   graph: Optional[NoteGraph],
                                   candidates: Sequence[Dict[str, Any]]
                                   ) -> Optional[Dict[str, Any]]:
    m = _SUPERL_SPOUSE_CITY_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    entries = [e for e in _label_set(m.group("set").strip(), graph)
               if e[1] >= 0]
    if len(entries) < 2:
        return None
    ordinal = re.sub(r"\s+", " ", m.group("ord").lower())
    best = min(entries, key=lambda t: t[1]) \
        if re.fullmatch(_ORD_MIN, ordinal) else max(entries, key=lambda t: t[1])
    if [y for _, y, _ in entries].count(best[1]) > 1:
        return None                              # tied extremum: ambiguous
    hop = _hop_tail(graph, best[0], ("performed_by",))
    if hop is None:
        return None
    sp = _spouse_tail(graph, hop[0])
    if sp is None:
        return None
    skey = graph.resolve_head(sp[0])
    if skey is None:
        return None
    city = None
    for rel, tail, nid, _w, _p in graph.neighbors(skey):
        if rel == "born_in":
            note = graph.notes.get(nid, {})
            city = (str(tail), list(note.get("paragraph_idxs") or []))
            break
    if city is None:
        return None
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    for p in hop[1] + sp[1] + city[1]:
        if p not in support:
            support.append(p)
    return {"answer": city[0], "support_idxs": support,
            "method": "superlative_spouse_city"}


# "Were the performer of A and the performer of B born in the same city?"
# (v9 kind 21) — two chains resolved independently, compared for identity.
# v13 kind 35 asks same STATE: city surfaces may differ while the states
# match, so the attribute word is captured and cities coerce through
# their geography facts before comparison.
_SAME_RE = re.compile(
    r"\b(?:were|are|was|is)\s+the\s+(?P<ra>performer|artist|singer|"
    r"founder|author|writer)s?\s+of\s+(?P<a>.+?)\s+and\s+the\s+"
    r"(?P<rb>performer|artist|singer|founder|author|writer)s?\s+of\s+"
    r"(?P<b>.+?)\s+born\s+in\s+the\s+same\s+(?P<attr>city|town|place|state)\b",
    re.IGNORECASE)

_ROLE_RELS = {
    "performer": ("performed_by",), "artist": ("performed_by",),
    "singer": ("performed_by",), "founder": ("founded_by",),
    "author": ("written_by",), "writer": ("written_by",),
}


def _chain_city(anchor: str, role: str, graph: NoteGraph
                ) -> Optional[Tuple[str, List[int]]]:
    """(birth city, support paras) via anchor --role--> person --born_in."""
    key = graph.resolve_head(anchor)
    if key is None:
        return None
    paras: List[int] = []
    for rel, person, note_id, _w, _p in graph.neighbors(key):
        if rel not in _ROLE_RELS.get(role, ()):
            continue
        note = graph.notes.get(note_id, {})
        pp = list(note.get("paragraph_idxs") or [])
        pkey = graph.resolve_head(str(person))
        if pkey is None:
            continue
        for rel2, city, nid2, _w2, _p2 in graph.neighbors(pkey):
            if rel2 != "born_in":
                continue
            n2 = graph.notes.get(nid2, {})
            paras = pp + [p for p in (n2.get("paragraph_idxs") or [])
                          if p not in pp]
            return str(city), paras
    return None


def _city_state(city: str, graph: Optional[NoteGraph],
                candidates: Sequence[Dict[str, Any]]
                ) -> Optional[Tuple[str, List[int]]]:
    """(state, support paras) for a city: its located_in edge first, then
    a '<city> is a city in (the state of) <state>' evidence sentence."""
    key = graph.resolve_head(city) if graph is not None else None
    if key is not None:
        for rel, tail, nid, _w, _p in graph.neighbors(key):
            if rel == "located_in":
                note = graph.notes.get(nid, {})
                return str(tail), list(note.get("paragraph_idxs") or [])
    pat = re.compile(re.escape(city)
                     + r"\s+is\s+a\s+(?:city|town)\s+in\s+"
                     + r"(?:the\s+state\s+of\s+)?" + _ENT_SPAN)
    for c in candidates or ():
        m = pat.search(f"{c.get('title', '')} {c.get('content', '')}")
        if m:
            return m.group(1), list(c.get("paragraph_idxs") or [])
    return None


def answer_same_attribute(question: str, graph: Optional[NoteGraph],
                          candidates: Sequence[Dict[str, Any]]
                          ) -> Optional[Dict[str, Any]]:
    m = _SAME_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    ca = _chain_city(m.group("a").strip(), m.group("ra").lower(), graph)
    cb = _chain_city(m.group("b").strip(), m.group("rb").lower(), graph)
    if ca is None or cb is None:
        return None
    support = list(dict.fromkeys(ca[1] + cb[1]))
    if m.group("attr").lower() == "state":
        # v13: "Boston" and "Cambridge" are the same STATE — each city
        # must coerce through its geography fact before comparing
        vals = []
        for city, _ in (ca, cb):
            base = city.split(",")[0].strip()
            got = _city_state(base, graph, candidates)
            if got is not None:
                st, extra = got
            else:
                parts = [p.strip() for p in city.split(",")]
                if len(parts) != 2 or not parts[1]:
                    return None
                st, extra = parts[1], []
            vals.append(st.strip().lower())
            support += [p for p in extra if p not in support]
    else:
        # "Boston, Massachusetts" and "Boston" are the same city surface
        vals = [ca[0].split(",")[0].strip().lower(),
                cb[0].split(",")[0].strip().lower()]
    return {"answer": "yes" if vals[0] == vals[1] else "no",
            "support_idxs": support, "method": "same_attribute"}


# "How many years apart were A and B released?" (v11 kind 27) —
# absolute difference, no before/after direction
_APART_RE = re.compile(
    r"\bhow\s+many\s+years\s+(?:apart|separate[d]?)\s+(?:were|are|was)?\s*"
    r"(?P<a>.+?)\s+and\s+(?P<b>.+?)\s+"
    r"(?P<verb>released|founded|established|formed|created|published|"
    r"recorded|built|made)\s*\??\s*$",
    re.IGNORECASE)


def answer_years_apart(question: str, graph: Optional[NoteGraph],
                       candidates: Sequence[Dict[str, Any]]
                       ) -> Optional[Dict[str, Any]]:
    m = _APART_RE.search((question or "").strip())
    if not m:
        return None
    ra = _resolve_year(m.group("a").strip(), m.group("verb").lower(),
                       graph, candidates)
    rb = _resolve_year(m.group("b").strip(), m.group("verb").lower(),
                       graph, candidates)
    if ra is None or rb is None:
        return None
    support = list(dict.fromkeys(ra[1] + rb[1]))
    return {"answer": str(abs(ra[0] - rb[0])), "support_idxs": support,
            "method": "years_apart"}


# "Which label released more albums, L1 or L2?" (v11 kind 28) — compare
# two set cardinalities; the answer is a label named in the question
_COUNT_CMP_RE = re.compile(
    r"\bwhich\s+(?:record\s+)?(?:label|company|publisher|artist|"
    r"performer)\s+(?:released|published|issued|recorded|put\s+out)\s+"
    r"(?P<dir>more|fewer|less)\s+(?:album|work|record|song|release)s?\s*"
    r"[,:]?\s*(?P<a>.+?)\s+or\s+(?P<b>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_count_comparative(question: str, graph: Optional[NoteGraph],
                             candidates: Sequence[Dict[str, Any]]
                             ) -> Optional[Dict[str, Any]]:
    m = _COUNT_CMP_RE.search((question or "").strip())
    if not m:
        return None
    opts = [m.group("a").strip(), m.group("b").strip()]
    sets = [_label_set(o, graph) for o in opts]
    if not all(sets) or len(sets[0]) == len(sets[1]):
        return None                                # unresolved or tied
    more = m.group("dir").lower() == "more"
    idx = 0 if (len(sets[0]) > len(sets[1])) == more else 1
    support: List[int] = []
    for entries in sets:
        for _, _, paras in entries:
            support += [p for p in paras if p not in support]
    return {"answer": opts[idx], "support_idxs": support,
            "method": "count_comparative"}


# "Which album on the label L was released closest to W?" (v11 kind 29)
# — argmin |year - anchor_year|, the anchor excluded from its own set
_CLOSEST_RE = re.compile(
    r"\b(?:what|which)\s+(?:album|work|record|song|release)s?\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+(?:was|were|got|came)\s+[^?]*?"
    r"\bclosest\s+(?:in\s+time\s+)?to\s+(?P<anchor>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_closest_release(question: str, graph: Optional[NoteGraph],
                           candidates: Sequence[Dict[str, Any]]
                           ) -> Optional[Dict[str, Any]]:
    m = _CLOSEST_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    anchor = m.group("anchor").strip()
    ra = _resolve_year(anchor, "released", graph, candidates)
    if ra is None:
        return None
    akey = graph.resolve_head(anchor)
    entries = [e for e in _label_set(m.group("set").strip(), graph)
               if e[1] >= 0 and e[0] != akey
               and e[0].lower() != anchor.lower()]
    if not entries:
        return None
    dists = sorted(abs(y - ra[0]) for _, y, _ in entries)
    if len(dists) > 1 and dists[0] == dists[1]:
        return None                                # tied distance
    pick = min(entries, key=lambda t: abs(t[1] - ra[0]))
    support = list(ra[1])
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    return {"answer": pick[0], "support_idxs": support,
            "method": "closest_release"}


# "Which album on the label L was released immediately after W?" (v13
# kind 36) — the MINIMUM year strictly greater than the anchor's (not an
# extremum, not a distance); proving "immediately" needs every set
# member's year, so all entries ride in the support
_SUCC_RE = re.compile(
    r"\b(?:what|which)\s+(?:album|work|record|song|release)s?\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+(?:was|were|got|came)\s+[^?]*?"
    r"\b(?:immediately|right|directly)\s+(?P<dir>after|before)\s+"
    r"(?P<anchor>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_successor(question: str, graph: Optional[NoteGraph],
                     candidates: Sequence[Dict[str, Any]]
                     ) -> Optional[Dict[str, Any]]:
    m = _SUCC_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    anchor = m.group("anchor").strip()
    ra = _resolve_year(anchor, "released", graph, candidates)
    if ra is None:
        return None
    akey = graph.resolve_head(anchor)
    entries = [e for e in _label_set(m.group("set").strip(), graph)
               if e[1] >= 0 and e[0] != akey
               and e[0].lower() != anchor.lower()]
    after = m.group("dir").lower() == "after"
    pool = [e for e in entries if (e[1] > ra[0]) == after and e[1] != ra[0]]
    if not pool:
        return None
    pick = min(pool, key=lambda t: t[1]) if after \
        else max(pool, key=lambda t: t[1])
    if sum(1 for _, y, _ in pool if y == pick[1]) > 1:
        return None                                # tied successor
    support = list(ra[1])
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    return {"answer": pick[0], "support_idxs": support,
            "method": "successor"}


# "How many albums by P were released on the label L?" (v13 kind 37) —
# cardinality of an INTERSECTION: P has works off L, L has works not by
# P, so both constraint edges must bind per counted work
_CONJ_COUNT_RE = re.compile(
    r"\bhow\s+many\s+(?:album|work|record|song|release)s?\s+by\s+"
    r"(?P<who>.+?)\s+(?:was|were)\s+"
    r"(?:released|put\s+out|published|issued)\s+"
    r"(?:on|by|through|under)\s+(?:the\s+label\s+)?(?P<set>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_count_conjunctive(question: str, graph: Optional[NoteGraph],
                             candidates: Sequence[Dict[str, Any]]
                             ) -> Optional[Dict[str, Any]]:
    m = _CONJ_COUNT_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    pkey = graph.resolve_tail(m.group("who").strip())
    lkey = graph.resolve_tail(m.group("set").strip())
    if pkey is None or lkey is None:
        return None
    by_p = {head: nid for rel, head, nid in graph.rheads(pkey)
            if rel in _DESC_RELS}
    on_l = {head: nid for rel, head, nid in graph.rheads(lkey)
            if rel in _SET_RELS}
    hits = [wk for wk in by_p if wk in on_l]
    if not hits:
        return None
    support: List[int] = []
    for wk in hits:
        for nid in (by_p[wk], on_l[wk]):
            note = graph.notes.get(nid, {})
            support += [p for p in (note.get("paragraph_idxs") or [])
                        if p not in support]
    return {"answer": str(len(hits)), "support_idxs": support,
            "method": "count_conjunctive"}


# "Who was the spouse of P at the time W was released?" (v12 kind 30) —
# temporal join: marriage/divorce events parsed from the evidence text,
# the interval containing W's release year wins
_AT_TIME_RE = re.compile(
    r"\bwho\s+(?:was|is)\s+the\s+(?:spouse|wife|husband|partner)\s+of\s+"
    r"(?P<p>.+?)\s+(?:at\s+the\s+time(?:\s+that)?|when)\s+(?P<w>.+?)\s+"
    r"(?:was\s+released|came\s+out|was\s+put\s+out)\s*\??\s*$",
    re.IGNORECASE)

_ENT_SPAN = r"([A-Z][\w'&-]*(?:\s+[A-Z][\w'&-]*)*)"

# v13 kind 34: the person in the temporal join may itself be a
# description needing a hop ("the performer of W")
_PERSON_DESC_RE = re.compile(
    r"^the\s+(?P<role>performer|artist|singer|founder|author|writer)\s+"
    r"of\s+(?P<w>.+)$", re.IGNORECASE)


def _resolve_person_surface(person: str, graph: Optional[NoteGraph]
                            ) -> Tuple[str, List[int]]:
    """('the performer of W') -> (person name, resolving-note paras) via
    the anchor's role edge; a literal name passes through unchanged."""
    m = _PERSON_DESC_RE.match(person.strip())
    if not m or graph is None:
        return person, []
    key = graph.resolve_head(m.group("w").strip())
    if key is None:
        return person, []
    for rel, tail, nid, _w, _p in graph.neighbors(key):
        if rel in _ROLE_RELS.get(m.group("role").lower(), ()):
            note = graph.notes.get(nid, {})
            return str(tail), list(note.get("paragraph_idxs") or [])
    return person, []


def answer_spouse_at_time(question: str, graph: Optional[NoteGraph],
                          candidates: Sequence[Dict[str, Any]]
                          ) -> Optional[Dict[str, Any]]:
    m = _AT_TIME_RE.search((question or "").strip())
    if not m:
        return None
    person, ppars = _resolve_person_surface(m.group("p").strip(), graph)
    rw = _resolve_year(m.group("w").strip(), "released", graph, candidates)
    if rw is None:
        return None
    year = rw[0]
    p_esc = re.escape(person)
    married_re = re.compile(p_esc + r"\s+(?:married|wed)\s+" + _ENT_SPAN
                            + r"\s+in\s+(\d{4})")
    divorce_re = re.compile(p_esc + r"\s+and\s+" + _ENT_SPAN
                            + r"\s+(?:divorced|separated)\s+in\s+(\d{4})")
    # events join ACROSS notes: a per-sentence note may carry the
    # marriage while its divorce sits in a sibling note. When the person
    # was REACHED by a hop (v13 kind 34) the question never names them,
    # so retrieval may miss the marriage history — and the divorce
    # sentence ("A and B divorced in Y") extracts a GLUED "A and B"
    # pseudo-entity as head, so the divorce note is graph-adjacent to
    # NEITHER spouse (v17: one missed divorce made two marriages qualify
    # and the join bailed as ambiguous). Widen the scan to the whole
    # note store — the person-substring filter below keeps it cheap.
    pool: List[Dict[str, Any]] = list(candidates or ())
    if graph is not None:
        seen_ids = {id(c) for c in pool}
        for n in graph.notes.values():
            if id(n) in seen_ids:
                continue
            pool.append({"title": n.get("title", ""),
                         "content": n.get("text") or n.get("content", ""),
                         "paragraph_idxs": n.get("paragraph_idxs")})
    marriages: List[Tuple[str, int, List[int]]] = []
    divorces: Dict[str, int] = {}
    for c in pool:
        text = f"{c.get('title', '')} {c.get('content', '')}"
        if person.lower() not in text.lower():
            continue
        paras = list(c.get("paragraph_idxs") or [])
        for sp, y in divorce_re.findall(text):
            divorces[sp] = int(y)
        for sp, y in married_re.findall(text):
            marriages.append((sp, int(y), paras))
    hits = [(sp, my, paras) for sp, my, paras in marriages
            if my <= year and (sp not in divorces or year < divorces[sp])]
    spouses = {sp for sp, _, _ in hits}
    if len(spouses) != 1:
        return None
    sp, _, paras = hits[0]
    support = list(dict.fromkeys(ppars + paras + rw[1]))
    return {"answer": sp, "support_idxs": support,
            "method": "spouse_at_time"}


# "Which album has more tracks, A or B?" (v12 kind 31) — a numeric
# attribute no triple carries, often written as a NUMBER WORD
_ATTR_CMP_RE = re.compile(
    r"\b(?:what|which)\s+(?:album|work|record|song|release)\s+has\s+"
    r"(?P<dir>more|fewer|less)\s+(?P<attr>tracks|songs|discs|minutes)\s*"
    r"[,:]?\s*(?P<a>.+?)\s+or\s+(?P<b>.+?)\s*\??\s*$",
    re.IGNORECASE)

_WORD_NUMS = {w: n for n, w in {
    1: "one", 2: "two", 3: "three", 4: "four", 5: "five", 6: "six",
    7: "seven", 8: "eight", 9: "nine", 10: "ten", 11: "eleven",
    12: "twelve", 13: "thirteen", 14: "fourteen", 15: "fifteen",
    16: "sixteen", 17: "seventeen", 18: "eighteen", 19: "nineteen",
    20: "twenty"}.items()}


def _attr_count(option: str, attr: str,
                candidates: Sequence[Dict[str, Any]]
                ) -> Optional[Tuple[int, List[int]]]:
    """The '<n> <attr>' count stated in a sentence of a candidate naming
    `option` (digits or number words)."""
    opt = option.lower()
    stem = attr.rstrip("s").lower()
    nums = r"(\d{1,3}|" + "|".join(_WORD_NUMS) + r")"
    num_re = re.compile(
        r"\b" + nums + r"\s+" + stem + r"s?\b", re.IGNORECASE)
    # reversed order: the count may FOLLOW the attribute noun ("Its
    # tracklist numbers twelve", "The track count is 12") — general
    # nominal phrasing, same sentence, number within a short window
    rev_re = re.compile(
        r"\b" + stem + r"(?:s|list|[- ]?count(?:ing)?)?\b[^.;]{0,24}?\b"
        + nums + r"\b", re.IGNORECASE)
    for c in candidates or ():
        text = f"{c.get('title', '')} {c.get('content', '')}"
        if opt not in text.lower():
            continue
        m = num_re.search(text) or rev_re.search(text)
        if m:
            tok = m.group(1).lower()
            n = int(tok) if tok.isdigit() else _WORD_NUMS[tok]
            return n, list(c.get("paragraph_idxs") or [])
    return None


def answer_attr_comparative(question: str, graph: Optional[NoteGraph],
                            candidates: Sequence[Dict[str, Any]]
                            ) -> Optional[Dict[str, Any]]:
    m = _ATTR_CMP_RE.search((question or "").strip())
    if not m:
        return None
    opts = [m.group("a").strip(), m.group("b").strip()]
    got = [_attr_count(o, m.group("attr"), candidates) for o in opts]
    if None in got or got[0][0] == got[1][0]:
        return None
    more = m.group("dir").lower() == "more"
    idx = 0 if (got[0][0] > got[1][0]) == more else 1
    support = list(dict.fromkeys(got[0][1] + got[1][1]))
    return {"answer": opts[idx], "support_idxs": support,
            "method": "attr_comparative"}


# "How many more tracks does A have than B?" (v14 kind 39) — a computed
# DIFFERENCE of word-number attribute counts (kind 31 only compares)
_ATTR_DIFF_RE = re.compile(
    r"\bhow\s+many\s+(?P<dir>more|fewer|less)\s+"
    r"(?P<attr>tracks|songs|discs|minutes)\s+does\s+(?P<a>.+?)\s+"
    r"(?:have|contain|feature)\s+than\s+(?P<b>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_attr_difference(question: str, graph: Optional[NoteGraph],
                           candidates: Sequence[Dict[str, Any]]
                           ) -> Optional[Dict[str, Any]]:
    m = _ATTR_DIFF_RE.search((question or "").strip())
    if not m:
        return None
    got = [_attr_count(o.strip(), m.group("attr"), candidates)
           for o in (m.group("a"), m.group("b"))]
    if None in got:
        return None
    diff = got[0][0] - got[1][0]
    if m.group("dir").lower() != "more":
        diff = -diff
    if diff <= 0:
        return None          # premise contradicts the facts: fall through
    support = list(dict.fromkeys(got[0][1] + got[1][1]))
    return {"answer": str(diff), "support_idxs": support,
            "method": "attr_difference"}


# "How many years apart were the first and the last albums released on
# the label L?" (v14 kind 40) — BOTH ends resolved from the set, then
# subtracted (answer_years_apart takes two NAMED works)
_ORD_ANY = _ORD_MIN + r"|" + _ORD_MAX + r"|most\s+recent"
_RANGE_RE = re.compile(
    r"\bhow\s+many\s+years\s+(?:apart|separate[d]?)\s+(?:were|are|was)?\s*"
    r"the\s+(?:" + _ORD_ANY + r")\s+and\s+the\s+(?:" + _ORD_ANY + r")\s+"
    r"(?:album|work|record|song|release)s?\s+"
    r"(?:released\s+|put\s+out\s+|recorded\s+)?"
    r"(?:on|by|through|under)\s+(?:the\s+label\s+)?(?P<set>.+?)\s*"
    r"(?:released\s*)?\??\s*$",
    re.IGNORECASE)


def answer_year_range(question: str, graph: Optional[NoteGraph],
                      candidates: Sequence[Dict[str, Any]]
                      ) -> Optional[Dict[str, Any]]:
    m = _RANGE_RE.search((question or "").strip())
    if not m:
        return None
    entries = [e for e in _label_set(m.group("set").strip(), graph)
               if e[1] >= 0]
    if len(entries) < 2:
        return None
    years = sorted(y for _, y, _ in entries)
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    return {"answer": str(years[-1] - years[0]), "support_idxs": support,
            "method": "year_range"}


# "Which album on the label L has the most tracks?" (v15 kind 43) —
# argmax over a word-number attribute carried by every member's
# paragraph (the attr stages above are pairwise)
_ATTR_SUPERL_RE = re.compile(
    r"\b(?:what|which)\s+(?:album|work|record|song|release)\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+has\s+the\s+(?P<dir>most|fewest|least)\s+"
    r"(?P<attr>tracks|songs|discs|minutes)\s*\??\s*$",
    re.IGNORECASE)


def answer_attr_superlative(question: str, graph: Optional[NoteGraph],
                            candidates: Sequence[Dict[str, Any]]
                            ) -> Optional[Dict[str, Any]]:
    m = _ATTR_SUPERL_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < 2:
        return None
    # counts may live in notes retrieval never surfaced: scan the whole
    # note store behind the candidates
    pool = list(candidates or ()) + list(graph.notes.values())
    got = []
    support: List[int] = []
    for work, _y, paras in entries:
        support += [p for p in paras if p not in support]
        c = _attr_count(work, m.group("attr"), pool)
        if c is None:
            return None              # incomplete set: argmax unsound
        got.append((work, c[0], c[1]))
        support += [p for p in c[1] if p not in support]
    pickfn = max if m.group("dir").lower() == "most" else min
    best = pickfn(got, key=lambda t: t[1])
    if [n for _, n, _ in got].count(best[1]) > 1:
        return None                              # tied extremum
    return {"answer": best[0], "support_idxs": support,
            "method": "attr_superlative"}


# "Did any album on the label L come out in the 1980s?" (v15 kind 44) —
# existential quantification, the forall stage's dual
_ANY_DECADE_RE = re.compile(
    r"\b(?:did|do|does|was|were|has|have)\s+any\s+"
    r"(?:album|work|record|song|release)s?\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+"
    r"(?:come\s+out|appear|be\s+released|get\s+released|released)\s+"
    r"in\s+the\s+(?P<dec>1[0-9]{2}|20[0-9])0s\s*\??\s*$",
    re.IGNORECASE)


def answer_exists_decade(question: str, graph: Optional[NoteGraph],
                         candidates: Sequence[Dict[str, Any]]
                         ) -> Optional[Dict[str, Any]]:
    m = _ANY_DECADE_RE.search((question or "").strip())
    if not m:
        return None
    entries = [e for e in _label_set(m.group("set").strip(), graph)
               if e[1] >= 0]
    if len(entries) < 2:
        return None
    lo = int(m.group("dec")) * 10
    ok = any(lo <= y < lo + 10 for _, y, _ in entries)
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    return {"answer": "yes" if ok else "no", "support_idxs": support,
            "method": "exists_decade"}


# "Were A and B released on the same label?" (v15 kind 45) — attribute
# equality on WORKS via their released_on_label edges (the same-
# attribute stage above keys PERSONS through role chains)
_SAME_LABEL_RE = re.compile(
    r"\b(?:were|are|was|is)\s+(?P<a>.+?)\s+and\s+(?P<b>.+?)\s+"
    r"(?:released|put\s+out|issued|published)\s+"
    r"(?:on|by|through|under)\s+the\s+same\s+"
    r"(?:record\s+)?(?:label|company)\s*\??\s*$",
    re.IGNORECASE)


def answer_same_label(question: str, graph: Optional[NoteGraph],
                      candidates: Sequence[Dict[str, Any]]
                      ) -> Optional[Dict[str, Any]]:
    m = _SAME_LABEL_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    got = [_hop_tail(graph, m.group(g).strip(), ("released_on_label",))
           for g in ("a", "b")]
    if None in got:
        return None
    same = got[0][0].strip().lower() == got[1][0].strip().lower()
    support = list(dict.fromkeys(got[0][1] + got[1][1]))
    return {"answer": "yes" if same else "no", "support_idxs": support,
            "method": "same_label"}


# "Were all of the albums on the label L released in the 1990s?" (v14
# kind 41) — universal quantification over the set; the 'no' case hides
# a single counterexample (answer_decade finds the one member IN the
# decade and requires a which-question)
_ALL_DECADE_RE = re.compile(
    r"\bwere\s+all\s+(?:of\s+)?the\s+(?:album|work|record|song|release)s\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+released\s+in\s+the\s+(?P<dec>1[0-9]{2}|20[0-9])0s"
    r"\s*\??\s*$",
    re.IGNORECASE)


def answer_forall_decade(question: str, graph: Optional[NoteGraph],
                         candidates: Sequence[Dict[str, Any]]
                         ) -> Optional[Dict[str, Any]]:
    m = _ALL_DECADE_RE.search((question or "").strip())
    if not m:
        return None
    entries = [e for e in _label_set(m.group("set").strip(), graph)
               if e[1] >= 0]
    if len(entries) < 2:
        return None
    lo = int(m.group("dec")) * 10
    ok = all(lo <= y < lo + 10 for _, y, _ in entries)
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    return {"answer": "yes" if ok else "no", "support_idxs": support,
            "method": "forall_decade"}


def answer_count(question: str, graph: Optional[NoteGraph],
                 candidates: Sequence[Dict[str, Any]]
                 ) -> Optional[Dict[str, Any]]:
    m = _COUNT_RE.search((question or "").strip())
    if not m:
        return None
    entries = _label_set(m.group("set").strip(), graph)
    if not entries:
        return None
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    return {"answer": str(len(entries)), "support_idxs": support,
            "method": "count"}


# "(In) which/what state ..." answered with a CITY needs one more hop
# (v12 kind 32): the containment fact lives in a geography paragraph the
# question never names
_STATE_Q_RE = re.compile(r"\b(?:which|what)\s+state\b", re.IGNORECASE)


def coerce_state_answer(question: str, answer: str,
                        graph: Optional[NoteGraph],
                        candidates: Sequence[Dict[str, Any]]
                        ) -> Tuple[str, List[int]]:
    """(answer, extra support paras). 'City, State' surfaces split; bare
    cities follow the located_in edge, else a '<city> is a city in (the
    state of) <state>' sentence in the evidence."""
    if not answer or not _STATE_Q_RE.search(question or ""):
        return answer, []
    parts = [p.strip() for p in answer.split(",")]
    if len(parts) == 2 and parts[1]:
        return parts[1], []
    got = _city_state(answer, graph, candidates)
    if got is not None:
        return got
    return answer, []


# "What is the average number of tracks across the albums on the label
# L?" (v25 kind 82) — the MEAN over the set's attribute counts; every
# solved aggregate is a sum, difference, count, or extremum
_ATTR_AVG_RE = re.compile(
    r"\b(?:what\s+is\s+)?the\s+(?P<op>average|mean|median)\s+number\s+of\s+"
    r"(?P<attr>tracks|songs|discs|minutes)\s+"
    r"(?:across|over|among|of|for)\s+the\s+"
    r"(?:album|work|record|song|release)s\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_attr_average(question: str, graph: Optional[NoteGraph],
                        candidates: Sequence[Dict[str, Any]]
                        ) -> Optional[Dict[str, Any]]:
    """Mean OR median (v29 kind 98 — an order statistic, so the counts
    are sorted, not summed) over the set's attribute counts."""
    m = _ATTR_AVG_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < 2:
        return None
    pool = list(candidates or ()) + list(graph.notes.values())
    counts: List[int] = []
    support: List[int] = []
    for work, _y, paras in entries:
        c = _attr_count(work, m.group("attr"), pool)
        if c is None:
            return None      # a member without a count: the stat is unsound
        counts.append(c[0])
        support += [p for p in paras if p not in support]
        support += [p for p in c[1] if p not in support]
    n = len(counts)
    if m.group("op").lower() == "median":
        cs = sorted(counts)
        if n % 2:
            ans = str(cs[n // 2])
        else:
            tot = cs[n // 2 - 1] + cs[n // 2]
            ans = str(tot // 2) if tot % 2 == 0 else f"{tot / 2:g}"
        method = "attr_median"
    else:
        total = sum(counts)
        ans = str(total // n) if total % n == 0 else f"{total / n:g}"
        method = "attr_average"
    return {"answer": ans, "support_idxs": support, "method": method}


# "Which albums on the label L were released in the D0s?" (v25 kind 83)
# — PLURAL enumeration: the gold is the full decade membership joined
# with "and" (the singular decade stage requires a unique hit)
_DECADE_ENUM_RE = re.compile(
    r"\b(?:which|what)\s+(?:album|work|record|song|release)s\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+(?:was|were|got|came)\s+"
    r"(?:released|out|put\s+out|issued|published)\s+in\s+the\s+"
    r"(?P<dec>1[0-9]{2}|20[0-9])0s\s*\??\s*$",
    re.IGNORECASE)


def answer_decade_enum(question: str, graph: Optional[NoteGraph],
                       candidates: Sequence[Dict[str, Any]]
                       ) -> Optional[Dict[str, Any]]:
    m = _DECADE_ENUM_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < 2 or any(y < 0 for _, y, _ in entries):
        return None
    lo = int(m.group("dec")) * 10
    hits = sorted([e for e in entries if lo <= e[1] < lo + 10],
                  key=lambda e: e[1])
    if len(hits) < 2:
        return None          # unique hit: the singular decade stage's case
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    return {"answer": " and ".join(w for w, _, _ in hits),
            "support_idxs": support, "method": "decade_enum"}


# "Did P release an album on the label L?" (v25 kind 84) — existence of
# a performer->work->label path; the "no" polarity asserts the ABSENCE
# of an edge, so it requires the asked label to be a live in-corpus
# anchor (an unknown label falls through to the unanswerable gates)
_EXISTS_RELEASE_RE = re.compile(
    r"\bdid\s+(?P<p>.+?)\s+(?:release|put\s+out|issue|record)\s+"
    r"(?:an?\s+)?(?:album|work|record|song|release)\s+"
    r"(?:on|through|under|with)\s+(?:the\s+label\s+)?"
    r"(?P<label>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_release_existence(question: str, graph: Optional[NoteGraph],
                             candidates: Sequence[Dict[str, Any]]
                             ) -> Optional[Dict[str, Any]]:
    m = _EXISTS_RELEASE_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    person, label = m.group("p").strip(), m.group("label").strip()
    pkey = graph.resolve_tail(person)
    lkey = graph.resolve_tail(label)
    if pkey is None or lkey is None:
        return None
    works = [(head, nid) for rel, head, nid in graph.rheads(pkey)
             if rel == "performed_by"]
    if not works:
        return None
    lbase = re.sub(r"\s*\([^)]*\)\s*$", "", label).strip().lower()
    support: List[int] = []
    yes = False
    for w, nid in works:
        note = graph.notes.get(nid, {})
        support += [p for p in (note.get("paragraph_idxs") or [])
                    if p not in support]
        wkey = graph.resolve_head(w)
        for rel, tail, nid2, _wt, _pp in graph.neighbors(wkey or w):
            if rel not in _SET_RELS:
                continue
            n2 = graph.notes.get(nid2, {})
            support += [p for p in (n2.get("paragraph_idxs") or [])
                        if p not in support]
            if tail == lkey or str(tail).lower() == lbase:
                yes = True
    if not yes:
        # absence: the asked label's own roster notes prove the claim
        roster = [nid for rel, _h, nid in graph.rheads(lkey)
                  if rel in _SET_RELS]
        if not roster:
            return None          # label never anchors a release: unsound
        for nid in roster:
            n2 = graph.notes.get(nid, {})
            support += [p for p in (n2.get("paragraph_idxs") or [])
                        if p not in support]
    return {"answer": "yes" if yes else "no", "support_idxs": support,
            "method": "release_existence"}


# "How many albums on the label L were released after W?" (v25 kind 85)
# — threshold count whose cut year is HOP-RESOLVED from the anchor
# member (solved threshold counts take a literal year/count from the
# question)
_COUNT_AFTER_RE = re.compile(
    r"\bhow\s+many\s+(?:album|work|record|song|release)s?\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+(?:was|were|got|came)\s+"
    r"(?:released|out|put\s+out|issued|published)\s+"
    r"(?P<dir>after|before)\s+(?P<anchor>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_count_after_anchor(question: str, graph: Optional[NoteGraph],
                              candidates: Sequence[Dict[str, Any]]
                              ) -> Optional[Dict[str, Any]]:
    m = _COUNT_AFTER_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    anchor = m.group("anchor").strip()
    if re.fullmatch(r"(?:1[0-9]{3}|20[0-9]{2})", anchor):
        return None              # literal-year cut: the solved stages' case
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < 2 or any(y < 0 for _, y, _ in entries):
        return None
    abase = anchor.lower()
    anchor_paras: List[int] = []
    anchor_y = next((y for w, y, _ in entries if w.lower() == abase), None)
    if anchor_y is None:
        got = _year_from_graph(anchor, ("released_in",), graph)
        if got is None:
            return None
        anchor_y = got[0]
        anchor_paras = _note_paras(graph, got[1])
    after = m.group("dir").lower() == "after"
    hits = [e for e in entries
            if e[0].lower() != abase
            and ((e[1] > anchor_y) if after else (e[1] < anchor_y))]
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    support += [p for p in anchor_paras if p not in support]
    return {"answer": str(len(hits)), "support_idxs": support,
            "method": "count_after_anchor"}


# "How many albums on the label L were released within N years of W?"
# (v26 kind 88) — TWO-sided hop-resolved interval |year - anchor| <= N;
# the anchor member itself is not counted (ref parity target:
# main_musique.py answer scoring — exact numeric strings)
_COUNT_WITHIN_RE = re.compile(
    r"\bhow\s+many\s+(?:album|work|record|song|release)s?\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+(?:was|were|got|came)\s+"
    r"(?:released|out|put\s+out|issued|published)\s+"
    r"within\s+(?P<n>\d{1,3})\s+years?\s+of\s+(?P<anchor>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_count_within_anchor(question: str, graph: Optional[NoteGraph],
                               candidates: Sequence[Dict[str, Any]]
                               ) -> Optional[Dict[str, Any]]:
    m = _COUNT_WITHIN_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    anchor = m.group("anchor").strip()
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < 2 or any(y < 0 for _, y, _ in entries):
        return None
    abase = anchor.lower()
    anchor_paras: List[int] = []
    anchor_y = next((y for w, y, _ in entries if w.lower() == abase), None)
    if anchor_y is None:
        got = _year_from_graph(anchor, ("released_in",), graph)
        if got is None:
            return None
        anchor_y = got[0]
        anchor_paras = _note_paras(graph, got[1])
    nwin = int(m.group("n"))
    hits = [e for e in entries
            if e[0].lower() != abase and abs(e[1] - anchor_y) <= nwin]
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    support += [p for p in anchor_paras if p not in support]
    return {"answer": str(len(hits)), "support_idxs": support,
            "method": "count_within_anchor"}


# "How many albums on the label L were released between W1 and W2?"
# (v27 kind 90) — BOTH interval bounds hop-resolved from anchor members,
# exclusive of the anchors (the literal-year interval count and the
# one-anchor window stages each resolve at most one bound)
_COUNT_BETWEEN_RE = re.compile(
    r"\bhow\s+many\s+(?:album|work|record|song|release)s?\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+(?:was|were|got|came)\s+"
    r"(?:released|out|put\s+out|issued|published)\s+"
    r"between\s+(?P<a>.+?)\s+and\s+(?P<b>.+?)\s*\??\s*$",
    re.IGNORECASE)

_LITERAL_YEAR = r"(?:1[0-9]{3}|20[0-9]{2})"


def answer_count_between_anchors(question: str,
                                 graph: Optional[NoteGraph],
                                 candidates: Sequence[Dict[str, Any]]
                                 ) -> Optional[Dict[str, Any]]:
    m = _COUNT_BETWEEN_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    a, b = m.group("a").strip(), m.group("b").strip()
    if re.fullmatch(_LITERAL_YEAR, a) or re.fullmatch(_LITERAL_YEAR, b):
        return None              # literal bounds: the solved stages' case
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < 2 or any(y < 0 for _, y, _ in entries):
        return None
    bases = {a.lower(), b.lower()}
    bounds = []
    anchor_paras: List[int] = []
    for surf in (a, b):
        y = next((y for w, y, _ in entries
                  if w.lower() == surf.lower()), None)
        if y is None:
            got = _year_from_graph(surf, ("released_in",), graph)
            if got is None:
                return None
            y = got[0]
            anchor_paras += _note_paras(graph, got[1])
        bounds.append(y)
    lo, hi = min(bounds), max(bounds)
    hits = [e for e in entries
            if e[0].lower() not in bases and lo < e[1] < hi]
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    support += [p for p in anchor_paras if p not in support]
    return {"answer": str(len(hits)), "support_idxs": support,
            "method": "count_between_anchors"}


# "In how many different cities were the performers of the albums on
# the label L born?" (v27 kind 92) — the tally DEDUPLICATES the
# hop-resolved attribute (solved counts tally members directly)
_DISTINCT_CITY_RE = re.compile(
    r"\b(?:in\s+)?how\s+many\s+(?:different|distinct)\s+"
    r"(?:cities|towns|places)\s+(?:were|are)\s+the\s+"
    r"(?:performer|artist|singer|musician)s\s+of\s+the\s+"
    r"(?:album|work|record|song|release)s\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+born\s*\??\s*$",
    re.IGNORECASE)


def _born_city(graph: NoteGraph, person: str
               ) -> Optional[Tuple[str, List[int]]]:
    """(birth city, note paras) off the person's born_in edge."""
    key = graph.resolve_head(person)
    if key is None:
        return None
    for rel, city, nid, _w, _p in graph.neighbors(key):
        if rel == "born_in":
            note = graph.notes.get(nid, {})
            return str(city), list(note.get("paragraph_idxs") or [])
    return None


def answer_distinct_birth_cities(question: str,
                                 graph: Optional[NoteGraph],
                                 candidates: Sequence[Dict[str, Any]]
                                 ) -> Optional[Dict[str, Any]]:
    m = _DISTINCT_CITY_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < 2:
        return None
    cities = set()
    support: List[int] = []
    for work, _y, paras in entries:
        hop = _hop_tail(graph, work, ("performed_by",))
        if hop is None:
            return None          # a member without a performer: bail
        got = _born_city(graph, hop[0])
        if got is None:
            return None          # a performer without a birth fact
        # Dedupe on the FULL normalized city string: gold tallies raw
        # distinct surfaces, so "Springfield, OH" != "Springfield, IL".
        cities.add(got[0].strip().lower())
        for p in paras + hop[1] + got[1]:
            if p not in support:
                support.append(p)
    return {"answer": str(len(cities)), "support_idxs": support,
            "method": "distinct_birth_cities"}


# "Which album on the label L was released in the same year as W?" (v27
# kind 93) — the filter year is hop-resolved AND the selection needs the
# tied pair every solved superlative/ordinal refuses
_SAME_YEAR_RE = re.compile(
    r"\b(?:which|what)\s+(?:album|work|record|song|release)\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+(?:was|were|got|came)\s+"
    r"(?:released|out|put\s+out|issued|published)\s+"
    r"in\s+the\s+same\s+year\s+as\s+(?P<anchor>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_same_year_member(question: str, graph: Optional[NoteGraph],
                            candidates: Sequence[Dict[str, Any]]
                            ) -> Optional[Dict[str, Any]]:
    m = _SAME_YEAR_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    anchor = m.group("anchor").strip()
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < 2:
        return None
    abase = anchor.lower()
    anchor_paras: List[int] = []
    anchor_y = next((y for w, y, _ in entries if w.lower() == abase), None)
    if anchor_y is None:
        got = _year_from_graph(anchor, ("released_in",), graph)
        if got is None:
            return None
        anchor_y = got[0]
        anchor_paras = _note_paras(graph, got[1])
    hits = [e for e in entries
            if e[0].lower() != abase and e[1] == anchor_y]
    if len(hits) != 1:
        return None                        # zero or several: ambiguous
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    support += [p for p in anchor_paras if p not in support]
    return {"answer": hits[0][0], "support_idxs": support,
            "method": "same_year_member"}


# "Which performer released albums on both the labels L1 and L2?" (v26
# kind 87) — the intersection runs person -> {labels}: reverse each
# label to its works, hop each work to its performer, intersect the
# performer sets (answer_label_intersection goes works -> label)
_PERF_BOTH_RE = re.compile(
    r"\b(?:which|what)\s+(?:performer|artist|singer|musician)\s+"
    r"(?:released|recorded|put\s+out|issued)\s+"
    r"(?:album|work|record|song|release)s?\s+on\s+"
    r"both\s+(?:the\s+labels?\s+)?(?P<a>.+?)\s+and\s+(?P<b>.+?)\s*\??\s*$",
    re.IGNORECASE)


def _performers_on(label: str, graph: NoteGraph) -> Dict[str, List[int]]:
    """{performer: support paras} over a label's roster — each reverse
    released_on_label work hopped through its performed_by edge."""
    key = graph.resolve_tail(label)
    if key is None:
        return {}
    out: Dict[str, List[int]] = {}
    for rel, work, note_id in graph.rheads(key):
        if rel not in _SET_RELS_WIDE:
            continue
        hop = _hop_tail(graph, str(work), ("performed_by",))
        if hop is None:
            continue
        note = graph.notes.get(note_id, {})
        paras = out.setdefault(hop[0], [])
        paras += [p for p in (note.get("paragraph_idxs") or []) + hop[1]
                  if p not in paras]
    return out


def answer_performer_intersection(question: str,
                                  graph: Optional[NoteGraph],
                                  candidates: Sequence[Dict[str, Any]]
                                  ) -> Optional[Dict[str, Any]]:
    m = _PERF_BOTH_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    # each option may carry its own "the label" determiner ("on both the
    # label A and the label B", v28 kind 94)
    a = re.sub(r"^the\s+labels?\s+", "", m.group("a").strip(), flags=re.I)
    b = re.sub(r"^the\s+labels?\s+", "", m.group("b").strip(), flags=re.I)
    pa = _performers_on(a, graph)
    pb = _performers_on(b, graph)
    common = [k for k in pa if k in pb]
    if len(common) != 1:
        return None
    person = common[0]
    support = list(dict.fromkeys(pa[person] + pb[person]))
    return {"answer": person, "support_idxs": support,
            "method": "performer_intersection"}


# "How many performers released albums on both the label L1 and the
# label L2?" (v29 kind 101) — the COUNT of the roster intersection;
# citing only the shared performers' paras would hide the rosters the
# absence-side of the count depends on, so every member paragraph of
# both rosters rides in support
_PERF_BOTH_COUNT_RE = re.compile(
    r"\bhow\s+many\s+(?:performer|artist|singer|musician)s?\s+"
    r"(?:released|recorded|put\s+out|issued|have|had)\s+"
    r"(?:album|work|record|song|release)s?\s+on\s+"
    r"both\s+(?:the\s+labels?\s+)?(?P<a>.+?)\s+and\s+(?P<b>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_performer_intersection_count(
        question: str, graph: Optional[NoteGraph],
        candidates: Sequence[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    m = _PERF_BOTH_COUNT_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    a = re.sub(r"^the\s+labels?\s+", "", m.group("a").strip(), flags=re.I)
    b = re.sub(r"^the\s+labels?\s+", "", m.group("b").strip(), flags=re.I)
    pa = _performers_on(a, graph)
    pb = _performers_on(b, graph)
    if not pa or not pb:
        return None
    common = [k for k in pa if k in pb]
    support: List[int] = []
    for paras in list(pa.values()) + list(pb.values()):
        support += [p for p in paras if p not in support]
    return {"answer": str(len(common)), "support_idxs": support,
            "method": "performer_intersection_count"}


# "Which album on the label L was released after A but before B?" (v29
# kind 99) — two-anchor interval SELECTION: both anchors resolve to
# years (in-set members or anywhere in the graph), and exactly one
# member's year must lie strictly inside the open interval
_BETWEEN_WHICH_RE = re.compile(
    r"\bwhich\s+(?:album|work|record|song|release)\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+(?:was|were|came|got)\s+"
    r"(?:released|out|issued|put\s+out)\s+"
    r"after\s+(?P<a>.+?)\s+(?:but|and|yet)\s+before\s+"
    r"(?P<b>.+?)\s*\??\s*$",
    re.IGNORECASE)


def answer_between_which(question: str, graph: Optional[NoteGraph],
                         candidates: Sequence[Dict[str, Any]]
                         ) -> Optional[Dict[str, Any]]:
    m = _BETWEEN_WHICH_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    entries = [e for e in _label_set(m.group("set").strip(), graph)
               if e[1] >= 0]
    if len(entries) < 2:
        return None
    ra = _resolve_year(m.group("a").strip(), "released", graph, candidates)
    rb = _resolve_year(m.group("b").strip(), "released", graph, candidates)
    if ra is None or rb is None:
        return None
    lo, hi = sorted((ra[0], rb[0]))
    inside = [e for e in entries if lo < e[1] < hi]
    if len(inside) != 1:
        return None          # empty or ambiguous interval: unsound
    support: List[int] = []
    for _, _, paras in entries:
        support += [p for p in paras if p not in support]
    support += [p for p in ra[1] + rb[1] if p not in support]
    return {"answer": inside[0][0], "support_idxs": support,
            "method": "between_which"}


# "In which city were most of the performers of the albums on the label
# L born?" (v28 kind 97) — MODAL value of the hop-resolved attribute:
# kind 92 counts the distinct cities, this ranks them by multiplicity
# and must refuse ties (no strict majority -> unsound)
_MODAL_CITY_RE = re.compile(
    r"\bin\s+(?:which|what)\s+(?:city|town|place)\s+were\s+most\s+of\s+"
    r"the\s+(?:performer|artist|singer|musician)s\s+of\s+the\s+"
    r"(?:album|work|record|song|release)s\s+"
    r"(?:released\s+)?(?:on|by|through|under)\s+(?:the\s+label\s+)?"
    r"(?P<set>.+?)\s+born\s*\??\s*$",
    re.IGNORECASE)


def answer_modal_birth_city(question: str, graph: Optional[NoteGraph],
                            candidates: Sequence[Dict[str, Any]]
                            ) -> Optional[Dict[str, Any]]:
    m = _MODAL_CITY_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    entries = _label_set(m.group("set").strip(), graph)
    if len(entries) < 2:
        return None
    counts: Dict[str, int] = {}
    support: List[int] = []
    for work, _y, paras in entries:
        hop = _hop_tail(graph, work, ("performed_by",))
        if hop is None:
            return None          # a member without a performer: bail
        got = _born_city(graph, hop[0])
        if got is None:
            return None          # a performer without a birth fact
        # modal bucketing on the SHORT surface: "Austin, Texas" and
        # "Austin" are the same city (unlike kind 92's raw-surface tally)
        city = got[0].split(",")[0].strip()
        counts[city] = counts.get(city, 0) + 1
        for p in paras + hop[1] + got[1]:
            if p not in support:
                support.append(p)
    ranked = sorted(counts.items(), key=lambda kv: -kv[1])
    if len(ranked) < 2 or ranked[0][1] == ranked[1][1]:
        return None              # tied mode: "most" has no referent
    return {"answer": ranked[0][0], "support_idxs": support,
            "method": "modal_birth_city"}


# "Whose spouse was born in C: P1 or P2?" (v26 kind 89) — each OPTION
# resolves spouse_of -> born_in before the filter picks the one whose
# resolved city matches (the solved same-city kind compares two resolved
# cities for a yes/no; here the comparison SELECTS an option)
_OPTION_SPOUSE_RE = re.compile(
    r"\bwhose\s+(?:spouse|wife|husband|partner)\s+was\s+born\s+in\s+"
    r"(?P<c>.+?)\s*[:,]\s*(?P<p1>.+?)\s+or\s+(?P<p2>.+?)\s*\??\s*$",
    re.IGNORECASE)


def _spouse_birth_city(graph: NoteGraph, person: str
                       ) -> Optional[Tuple[str, List[int]]]:
    """(spouse's birth city, support paras): spouse_of then born_in."""
    sp = _spouse_tail(graph, person)
    if sp is None:
        return None
    skey = graph.resolve_head(sp[0])
    if skey is None:
        return None
    for rel, city, nid, _w, _p in graph.neighbors(skey):
        if rel != "born_in":
            continue
        note = graph.notes.get(nid, {})
        paras = sp[1] + [p for p in (note.get("paragraph_idxs") or [])
                         if p not in sp[1]]
        return str(city), paras
    return None


def answer_option_spouse_born(question: str, graph: Optional[NoteGraph],
                              candidates: Sequence[Dict[str, Any]]
                              ) -> Optional[Dict[str, Any]]:
    m = _OPTION_SPOUSE_RE.search((question or "").strip())
    if not m or graph is None:
        return None
    want = m.group("c").split(",")[0].strip().lower()
    opts = [m.group("p1").strip(), m.group("p2").strip()]
    resolved = []
    for p in opts:
        got = _spouse_birth_city(graph, p)
        if got is None:
            return None
        resolved.append(got)
    hits = [i for i, (city, _) in enumerate(resolved)
            if city.split(",")[0].strip().lower() == want]
    if len(hits) != 1:
        return None
    # BOTH options' chains are evidence: the loser's resolved city is
    # what rules it out
    support: List[int] = []
    for _, paras in resolved:
        support += [p for p in paras if p not in support]
    return {"answer": opts[hits[0]], "support_idxs": support,
            "method": "option_spouse_born"}


def answer_exact_math(question: str, note_graph: Optional[NoteGraph],
                      candidates: Sequence[Dict[str, Any]]
                      ) -> Optional[Dict[str, Any]]:
    """Dispatcher over every exact-math family; None = not such a question
    or unresolvable (callers fall through to the regular stages)."""
    for fn in (answer_spouse_at_time,
               answer_superl_attr_difference, answer_attr_difference,
               answer_decade_attr_superlative, answer_attr_ordinal,
               answer_attr_average,
               answer_attr_superlative, answer_attr_argmax_year,
               answer_member_born_join, answer_count_not_decade,
               answer_decade_mode, answer_superl_attr_yesno,
               answer_count_union,
               answer_label_attr_sum_compare,
               answer_label_attr_comparative, answer_attr_comparative,
               answer_comparative, answer_temporal_diff,
               answer_exists_attr_decade, answer_decade_count_compare,
               answer_forall_decade, answer_exists_decade,
               answer_attr_equal_count,
               answer_superlative_hop_unnamed,
               answer_forall_attr, answer_superlative_attr,
               answer_same_label, answer_release_existence, answer_yesno,
               answer_superlative_span, answer_superlative_spouse_city,
               answer_superlative_spouse,
               answer_year_range, answer_years_apart,
               answer_same_attribute,
               answer_closest_release, answer_successor,
               answer_member_year_hop, answer_member_year_born,
               answer_superlative_hop2,
               answer_label_of_superlative, answer_attr_sum,
               answer_superlative_hop, answer_superlative, answer_ordinal,
               answer_decade_enum,
               answer_decade, answer_interval, answer_label_intersection,
               answer_performer_intersection,
               answer_performer_intersection_count, answer_between_which,
               answer_option_spouse_born,
               answer_count_within_anchor, answer_count_between_anchors,
               answer_modal_birth_city,
               answer_distinct_birth_cities, answer_same_year_member,
               answer_attr_threshold_which, answer_inverse_hop_attr,
               answer_dual_label,
               answer_count_after_anchor,
               answer_count_comparative, answer_conjunctive,
               answer_count_conjunctive, answer_count_threshold,
               answer_count_filtered, answer_count_hop, answer_count):
        res = fn(question, note_graph, candidates)
        if res:
            return res
    return None
