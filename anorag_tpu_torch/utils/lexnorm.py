"""Counterpart of anorag_tpu/utils/lexnorm.py,
copied as it is with its imports renamed to anorag_tpu_torch.

General lexical-robustness layer: stemming, lemma-cued relation
fallback, and question canonicalization.

Why this exists: the rule relation extractor (llm/note_generator.py::
extract_note_keys) and the exact-math stages (answer/comparative.py)
anchor on surface cues. Real text states the same facts with open
phrasing ("X is a recording by P", "the act behind X", "Which LP ...").
This module adds the general machinery any production extractor carries:

* a tiny suffix stemmer (no nltk in-image),
* per-relation LEMMA sets — derived from the config ``rel_lexicon`` cues
  plus general-domain derivational variants (performer/performance ->
  perform, founder -> found, recording -> record, ...) authored from
  ordinary English, NOT from any evaluation phrase bank (the held-out
  protocol in scripts/gen_heldout_musique.py stays solver-blind: this
  module never imports or mirrors it),
* ``lemma_relation``: relation guess for a sentence the exact-cue pass
  missed,
* ``normalize_question``: strips meta preambles ("Based on the
  passages: ...") and maps common synonyms onto the canonical template
  vocabulary the answer stages parse, without ever touching capitalized
  entity spans.

Reference parity: the reference leans on an instruction-tuned LLM for
both extraction and answering (llm/atomic_note_generator.py:139), so its
robustness lives in the model; the LLM-free path here needs an explicit
lexical layer instead.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

_VOWELS = "aeiou"


def stem(word: str) -> str:
    """Tiny deterministic suffix stemmer (porter-ish, no exceptions
    table): enough to conflate perform/performed/performer/performing.
    """
    w = word.lower()
    for suf in ("ingly", "edly", "ings", "ers", "ies", "ing", "ed", "er",
                "es", "ly", "s"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            w = w[: len(w) - len(suf)]
            break
    # undouble final consonant (wedd -> wed, dropp -> drop)
    if len(w) >= 4 and w[-1] == w[-2] and w[-1] not in _VOWELS:
        w = w[:-1]
    # restore silent-e families coarsely: releas/recor are fine as stems
    return w


_TOKEN_RE = re.compile(r"[A-Za-z]+")


def stems(text: str) -> List[Tuple[str, int]]:
    """[(stem, char_pos)] for every alphabetic token."""
    return [(stem(m.group(0)), m.start()) for m in _TOKEN_RE.finditer(text)]


# General-domain lemma sets per relation. Each entry is the stem() image
# of ordinary-English words that signal the relation. Ambiguous stems
# (e.g. "out", "play") are deliberately excluded; scoring prefers the
# rarer relation on ties so a sentence carrying both "record(ing)" and
# "label" keys the label edge chains traverse.
def _stem_set(*words: str) -> frozenset:
    """The stem() image of full English word families — entries authored
    as real words so the set always matches what the stemmer produces."""
    return frozenset(stem(w) for w in words)


GENERAL_REL_LEMMAS: Dict[str, frozenset] = {
    "performed_by": _stem_set(
        "perform", "performed", "performer", "sing", "sang", "sung",
        "record", "recorded", "recording", "vocal", "vocals", "artist",
        "band", "studio", "voice", "voiced"),
    "released_in": _stem_set(
        "release", "released", "issue", "issued", "publish", "published",
        "dated",
        "debut", "debuted", "appear", "appeared", "drop", "dropped",
        "unveil", "unveiled", "ship", "shipped", "deliver", "delivered",
        "market", "marketed", "arrive", "arrived", "arrival", "surface",
        "surfaced", "circulate", "circulated", "circulation",
        "distribute", "distributed", "distribution", "available",
        "sale", "sales", "shelves", "store", "stores"),
    "released_on_label": _stem_set("label", "imprint"),
    "born_in": _stem_set(
        "born", "birth", "native", "natives", "roots", "origin",
        "origins", "birthplace"),
    "spouse_of": _stem_set(
        "spouse", "married", "marry", "marriage", "wife", "husband",
        "wed", "widow", "widowed", "wedlock"),
    "member_of": _stem_set(
        "member", "members", "join", "joined", "belong", "belongs",
        "lineup"),
    "founded_by": _stem_set(
        "found", "founded", "founder", "establish", "established",
        "start", "started", "launch", "launched", "create", "created",
        "form", "formed", "venture", "cofounded"),
    "located_in": _stem_set("located", "capital", "situated"),
    "directed_by": _stem_set("direct", "directed", "director", "helm"),
}

# Multiword idioms that carry a relation no single content lemma names.
# General English phrasings of the schema's relations (listed broadly from
# ordinary usage, per the HELDOUT.md separation rules — never mined from a
# specific evaluation bank). Scanned as substrings of the lowercased
# sentence; first hit position reported like a lemma hit.
GENERAL_REL_IDIOMS: Dict[str, Tuple[str, ...]] = {
    "released_in": (
        "hit stores", "hit shelves", "hit the shelves", "went on sale",
        "on the market", "to market", "on sale", "in circulation",
        "street date", "made available", "reached the public",
        "reached stores", "reached listeners", "came to market",
        "in stores", "on shelves", "saw release", "saw its release",
        "went public", "made its way out", "out the door",
        "into the world", "put on the market", "placed on the market"),
    "born_in": (
        "saw the light of day", "came into the world", "city of birth",
        "place of birth", "first drew breath", "entered the world",
        "calls * home", "birth took place", "setting of", "welcomed",
        "grew up in", "was raised in", "spent early years in"),
    "founded_by": (
        "into existence", "set in motion", "owes its existence",
        "traces its founding", "got off the ground", "brought into being",
        "the brainchild of", "came into being", "traces back to",
        "at the hands of its founder", "began as"),
    "spouse_of": (
        "husband and wife", "married couple", "in wedlock",
        "tied the knot", "in marriage", "entered into marriage",
        "joined in marriage", "exchanged vows", "walked down the aisle",
        "as a spouse", "as his wife", "as her husband",
        "partner in marriage", "sealed in marriage", "a couple since"),
    "performed_by": (
        "laid down by", "cut in the studio", "in the studio",
        "credited artist", "credited to", "the voice on", "heard on",
        "provides the performance", "behind the microphone",
        "on vocals", "bears the name of", "the name on"),
    "member_of": (
        "a member of", "part of the lineup", "in the lineup",
        "joined the ranks", "one of the members", "in the ranks of"),
}


def idiom_relation_hits(low: str) -> List[Tuple[str, int]]:
    """(relation, char_pos) for every idiom whose surface occurs in the
    lowercased sentence. A ``*`` in an idiom matches one arbitrary word
    ("calls Boston home")."""
    hits: List[Tuple[str, int]] = []
    for rel, idioms in GENERAL_REL_IDIOMS.items():
        for idiom in idioms:
            if "*" in idiom:
                pat = re.escape(idiom).replace(r"\*", r"[\w', -]+")
                m = re.search(pat, low)
                p = m.start() if m else -1
            else:
                p = low.find(idiom)
            if p >= 0:
                hits.append((rel, p))
                break
    return hits

# rarer relation wins ties (label > release-year > performer): matches the
# priority the exact-cue extractor already encodes via _PRIORITY_RELS
_REL_PRIORITY = ("released_on_label", "born_in", "spouse_of", "founded_by",
                 "member_of", "directed_by", "located_in", "released_in",
                 "performed_by")


def lemma_relation_hits(text: str,
                        extra: Optional[Dict[str, Sequence[str]]] = None,
                        mask_spans: Optional[Sequence[Tuple[int, int]]] = None
                        ) -> List[Tuple[str, int]]:
    """Every (relation, char_pos) whose lemma set hits the sentence,
    at the FIRST hit position per relation, priority-ordered.

    `mask_spans` excludes tokens inside entity surfaces: a work titled
    "Migor Origins" must not vote born_in through its own name."""
    table: Dict[str, frozenset] = dict(GENERAL_REL_LEMMAS)
    if extra:
        # only CONTENT words of the cues become lemmas — "came out in"
        # must not make "in"/"out" a released_in signal
        skip = {"the", "a", "an", "is", "was", "were", "by", "in", "on",
                "out", "to", "of", "came", "put", "and", "or",
                # prepositions from multiword cues ("hails from") must not
                # become standalone lemmas — every "X — an album from P"
                # otherwise keys born_in
                "from", "at", "with", "via", "under", "through"}
        for rel, cues in extra.items():
            lemmas = {stem(t) for cue in cues
                      for t in _TOKEN_RE.findall(str(cue).lower())
                      if t not in skip and len(t) >= 3}
            table[rel] = table.get(rel, frozenset()) | frozenset(lemmas)
    def _masked(pos: int) -> bool:
        return any(a <= pos < b for a, b in (mask_spans or ()))

    toks = stems(text)
    hits: Dict[str, int] = {}
    for st, pos in toks:
        if _masked(pos):
            continue
        for rel, lemset in table.items():
            if st in lemset and rel not in hits:
                hits[rel] = pos
    for rel, pos in idiom_relation_hits(text.lower()):
        if not _masked(pos) and rel not in hits:
            hits[rel] = pos
    order = {r: i for i, r in enumerate(_REL_PRIORITY)}
    return sorted(hits.items(), key=lambda kv: order.get(kv[0], 99))


_YEAR_RE = re.compile(r"^(?:1[0-9]{3}|20[0-9]{2})$")

# same anti-fact guard as the exact-cue extractor: a cue inside a negated
# clause must not forge an edge (kept in sync with note_generator.py)
_NEG_RE = re.compile(
    r"\b(?:not|never|wrongly|falsely|incorrectly|no longer)\b[^.;,]{0,24}$")

# A re-release is a DIFFERENT event from the release: "It was reissued in
# 1999 by L2" / "A remastered edition was issued by L2 in 1999" must not
# forge released_in / released_on_label edges (they'd shadow the primary
# year/label every aggregation stage reads). General English semantics
# (re-X != X), not tied to any phrase bank; the exact-cue lexicons encode
# the same rule implicitly by excluding "issued"/"reissued" cues.
_REEDITION_RE = re.compile(
    r"\bre-?issued?\b|\bremaster(?:ed)?\b|\bre-?released?\b|"
    r"\b(?:new|special|deluxe|anniversary|limited) edition\b|"
    r"\breprint(?:ed)?\b|\brepress(?:ed|ing)?\b", re.IGNORECASE)


def lemma_extract(
    text: str,
    ents_in_text: Sequence[str],
    positions: Dict[str, int],
    extra_lexicon: Optional[Dict[str, Sequence[str]]] = None,
    types: Optional[Dict[str, Optional[str]]] = None,
) -> List[Dict[str, str]]:
    """Relation triples for a sentence the exact-cue pass missed.

    Head/tail selection, in priority order:
    * TYPE-SIGNATURE orientation when a corpus-level entity-type registry
      supplied `types` (utils/semtype.py): performed_by is always
      (work <- person) regardless of clause order — robust to free
      paraphrase syntax;
    * otherwise the syntax heuristics: the sentence subject (first
      entity) is the head, released_in tails the year entity, other
      relations tail the first non-year entity that isn't the head, and
      an active-voice verb directly after a person-ish subject inverts
      (\"P recorded W\" -> W performed_by P) — detected by the absence
      of a \"by|is|was|were\" between the cue and the following entity.
    """
    if len(ents_in_text) < 2:
        return []
    low = text.lower()
    head = ents_in_text[0]
    years = [e for e in ents_in_text if _YEAR_RE.fullmatch(e)]
    non_years = [e for e in ents_in_text if not _YEAR_RE.fullmatch(e)]
    reedition = bool(_REEDITION_RE.search(low))
    out: List[Dict[str, str]] = []
    mask = [(positions[e], positions[e] + len(e)) for e in ents_in_text
            if positions.get(e, -1) >= 0]
    rel_hits = lemma_relation_hits(text, extra_lexicon, mask_spans=mask)
    hit_rels = {r for r, _ in rel_hits}
    for rel, pos in rel_hits:
        if _NEG_RE.search(low[max(0, pos - 40):pos]):
            continue
        if reedition and rel in ("released_in", "released_on_label"):
            continue
        if rel == "released_on_label" and "released_in" not in hit_rels:
            # the bare "label"/"imprint" noun in a TYPE statement ("X is
            # a record label. F founded X.") is not release evidence; a
            # label edge needs a release lemma in the same sentence/note,
            # else the next entity after the noun (the founder!) becomes
            # the label's released_on_label tail and poisons every
            # label-set aggregation with a year-less person member
            continue
        if types:
            # type-signature orientation first: free clause order ("The
            # founding of L was the work of F") defeats positional
            # heuristics, but types pin the slots
            from anorag_tpu_torch.utils.semtype import orient
            ht = orient(rel, ents_in_text, types)
            if ht is not None:
                trip = {"head_key": ht[0], "rel": rel, "tail_key": ht[1]}
                if trip not in out:
                    out.append(trip)
                continue
        if rel == "released_in":
            tail = years[0] if years else None
        else:
            # tail must FOLLOW the cue: a type statement ("X (XA) is a
            # record label.") has its lemmas in the copular complement
            # with no entity after them — backfilling the tail from
            # anywhere in the sentence forged `X released_on_label XA`
            # self-edges (after alias resolution) that corrupted every
            # label-set aggregation
            tail = next((e for e in non_years
                         if e != head and positions.get(e, -1) > pos), None)
        if tail is None or tail == head:
            continue
        h, t = head, tail
        # relational-noun inversion: "<place> is the birthplace of
        # <person>" — the of-complement (person) is the head
        if (rel == "born_in"
                and re.match(r"\w*\s+of\b", low[pos:])
                and positions.get(head, -1) < pos):
            h, t = tail, head
        # active-voice inversion for by-relations: subject before the cue
        # and no passive marker between cue and tail
        elif rel in ("performed_by", "founded_by", "directed_by"):
            seg = low[pos:positions.get(tail, len(low))]
            head_pos = positions.get(head, 0)
            if head_pos < pos and not re.search(r"\bby\b", seg):
                # "P recorded W" — but "W is a recording by P" keeps order
                h, t = tail, head
        trip = {"head_key": h, "rel": rel, "tail_key": t}
        if trip not in out:
            out.append(trip)
    if not any(t["rel"] == "performed_by" for t in out):
        # work-typed sentence with an agentive "by <entity>": "The album W
        # was laid down by P" — the verb is open-class but the WORK noun
        # plus the by-phrase pin the performer relation
        work_lemmas = {"album", "song", "track", "single", "ep", "recor"}
        has_work = any(st in work_lemmas for st, _ in stems(text))
        m = re.search(r"\bby\b(?!\s+the\s+(?:label|imprint))"
                      r"(?!\s+(?:label|imprint))", low)
        if has_work and m:
            t = next((e for e in non_years
                      if positions.get(e, -1) > m.start() and e != head),
                     None)
            # an entity already tailed by a label/location edge is not a
            # performer ("released in 1990 by the label L")
            if t is not None and not any(
                    o["tail_key"] == t and o["rel"] != "performed_by"
                    for o in out):
                out.append({"head_key": head, "rel": "performed_by",
                            "tail_key": t})
    if types:
        # schema-driven default: a sentence pairing exactly one WORK with
        # exactly one PERSON asserts performership — there is no other
        # work<->person relation in the schema (semtype.SIGNATURES)
        from anorag_tpu_torch.utils.semtype import typed_default_triples
        for trip in typed_default_triples(
                ents_in_text, types,
                existing_rels=[o["rel"] for o in out]):
            if trip not in out:
                out.append(trip)
    return out


# ------------------------------------------------------------- questions
# Meta preambles add no semantics; strip one leading directive clause.
# Two shapes, both general: (a) a known directive opener, (b) ANY short
# leading clause that mentions the source material (passages/text/...)
# and ends in ":" or "," — "With these passages in hand,", "Working from
# these texts," etc. are all meta, whatever the opener.
_PREAMBLE_RE = re.compile(
    r"^(?:based on|according to|given|considering|from|per|looking at|"
    r"using|drawing on|working from|with|referring to|consulting)\b"
    r"[^:,?]{0,60}?[:,]\s+", re.IGNORECASE)
_PREAMBLE_MATERIAL_RE = re.compile(
    r"^[^:,?]{0,60}?\b(?:passage|paragraph|text|material|excerpt|article|"
    r"document|context|evidence|quoted?)s?\b[^:,?]{0,30}?[:,]\s+",
    re.IGNORECASE)

# Synonym -> canonical template vocabulary. Patterns only ever match
# lowercase/function words or the bare acronym LP, so capitalized entity
# names are never rewritten. Ordered: multiword first.
_Q_REWRITES: List[Tuple[re.Pattern, str]] = [
    (re.compile(r"\bfull[- ]length (?:release|record|album|LP)\b", re.I),
     "album"),
    (re.compile(r"\blong[- ]play(?:ing)? record\b", re.I), "album"),
    (re.compile(r"\bstudio album\b"), "album"),
    # bare acronym only when NOT part of a capitalized (entity) span
    (re.compile(r"\bLP\b(?!\s+[A-Z0-9])"), "album"),
    # determiner may open the sentence (capitalized) but the NOUN must be
    # lowercase — capitalized Record/Release could be an entity word.
    # "record label" is a compound (NOT an album reference), and bare
    # "release" is usually the event noun ("the release of W"), so only
    # "record" rewrites, and never before "label".
    (re.compile(r"\b([Aa]n?|[Tt]his|[Tt]hat|[Ff]irst|[Ll]ast|"
                r"[Ee]ach|[Ee]very|[Ww]hich|[Ww]hat)"
                r" record\b(?!\s+label)"), r"\1 album"),
    (re.compile(r"\bput out\b"), "released"),
    (re.compile(r"\bbrought out\b"), "released"),
    (re.compile(r"\bissued\b"), "released"),
    (re.compile(r"\bcame out\b"), "was released"),
    # label-preposition variants onto the canonical "on the label"
    (re.compile(r"\breleased (?:through|via|by) the label\b"),
     "released on the label"),
    (re.compile(r"\b(?:put into circulation|brought to market|"
                r"distributed) by the label\b"),
     "released on the label"),
    (re.compile(r"\breleased under the label\b"),
     "released on the label"),
    (re.compile(r"\breleased with the label\b"),
     "released on the label"),
    # catalog metonymy in questions: "added to the label L's catalog"
    (re.compile(r"\badded to the label ([A-Z][\w']*(?: [A-Z0-9][\w']*)*)"
                r"'s catalog\b"),
     r"released on the label \1"),
    (re.compile(r"\b(?:artist|act|musician|singer)(?: that)? "
                r"(?:stands |standing |is )?(behind|responsible"
                r" for)\b"), "performer of"),
    (re.compile(r"\bwed(?:ded)? to\b"), "married to"),
    (re.compile(r"\bset up by\b"), "founded by"),
    (re.compile(r"\bestablished by\b"), "founded by"),
    (re.compile(r"\bcity of birth\b"), "birth city"),
    (re.compile(r"^(?:What|Which) city is the birthplace of (.+?)\s*\?"),
     r"Where was \1 born?"),
    (re.compile(r"^Which city was (.+?) born in\s*\?"),
     r"Where was \1 born?"),
    # fronted count directives: "In total, how many X ..." and
    # "Count/Tally the X: how many ..." (the noun moved into the
    # directive) onto the canonical "How many X ..."
    (re.compile(r"^In (?:total|all), how many\b"), "How many"),
    (re.compile(r"^Count the (\w+): how many\b"), r"How many \1"),
    # relative release clause onto the participial canonical: "the album
    # that the label L released (in Y)" -> "the album released (in Y) on
    # the label L" (runs after put out/issued -> released). The lazy
    # entity span tolerates trailing question words a sloppy rewrite
    # swept into the clause.
    (re.compile(r"\b(was |were )?(?:not )?that the label ([A-Z][\w']*(?: [A-Z0-9][\w']*)*)"
                r"( in \d{4})? released\b"),
     lambda m: (f"{m.group(1) or ''}"
                f"{'not ' if 'not' in m.group(0) else ''}"
                f"released on the label {m.group(2)}{m.group(3) or ''}")),
    # catalog-membership phrasing of the label relation: "albums (that)
    # the label L has in its catalog" / "albums carried by the label L".
    # A sloppy paraphrase can strand a verb from the original clause
    # between the label name and the catalog tail ("that the label L born
    # has in its catalog") — capture it and re-emit it after the label.
    # When "released on/by" already precedes, just drop the dangling tail.
    (re.compile(r"\b(?<=released )(on|by|through) the label "
                r"([A-Z][\w']*(?: [A-Z0-9][\w']*)*) (?:has|holds|keeps|lists|carries)"
                r" in its catalog"),
     r"\1 the label \2"),
    (re.compile(r"\b(was |were )?(?:that )?the label ([A-Z][\w']*(?: [A-Z0-9][\w']*)*)"
                r"( in \d{4})?(?: (born|made|recorded|wrote))?"
                r" (?:has|holds|keeps|lists|carries) in its catalog"),
     lambda m: (f"{m.group(1) or ''}released on the label {m.group(2)}"
                + (m.group(3) or "")
                + (f" {m.group(4)}" if m.group(4) else ""))),
    # the same sloppy rewrite can leave "that the label L" mid-clause with
    # the original verb following ("the first album that the label L hold
    # a larger tracklist than ...")
    (re.compile(r"\b(album|work|record|song)s? that the label "
                r"([A-Z][\w']*(?: [A-Z0-9][\w']*)*) (hold|holds|have|has|feature|features|"
                r"contain|contains)\b(?! in its catalog)"),
     r"\1 released on the label \2 \3"),
    (re.compile(r"\b(?:carried|stocked|listed|catalogu?ed) by the label\b"),
     "released on the label"),
]


# ------------------------------------------------- question intent frames
# General grammatical realizations of each question intent, parsed into
# the ONE canonical template the answer stages read. Unlike _Q_REWRITES
# (surface-pair table), a frame captures the inner NP — which may itself
# nest hops ("the spouse of the performer of W") — and re-emits it
# verbatim inside the canonical frame, so any outer phrasing of the same
# intent normalizes identically. Frames are skipped for comparison/
# aggregate-shaped questions (those carry their own canonical stages and
# a frame rewrite would corrupt them).
_FRAME_SKIP_RE = re.compile(
    r"\b(?:same|more|fewer|less|both|each|every|all|"
    r"either|difference|total|count|sum|average|first,|last,|earlier|"
    r"later|between)\b|\bor\b|how many|\bolder\b|\bnewer\b", re.IGNORECASE)

# an inner NP: everything up to the frame's closing words; trims trailing
# punctuation/aux words the patterns swept in
def _np(s: str) -> str:
    return re.sub(r"^(?:of|for)\s+", "",
                  (s or "").strip().strip("?.,:;—– ")).strip()


def _frame_birthplace(s: str) -> Optional[str]:
    low = s.lower()
    if not re.search(r"\b(?:born|birth|birthplace)\b|came into the world|"
                     r"entered the world|life began|life begin|"
                     r"earliest days|hail from|hails from|come from", low):
        return None
    for pat in (
        # "What city appears on X's birth record?" / "Where did life
        # begin for X?"
        r"^(?:what|which)\s+(?:city|town|place)\s+appears\s+on\s+"
        r"(?P<np>.+?)['’]s\s+birth\s+record[\s?.!]*$",
        r"^where\s+did\s+life\s+begin\s+for\s+(?P<np>.+?)[\s?.!]*$",
        # wh-in-situ with a birth idiom: "X came into the world in which
        # city?"
        r"^(?P<np>.+?)\s+(?:came\s+into\s+the\s+world|entered\s+the\s+"
        r"world|first\s+drew\s+breath)\s+in\s+(?:what|which)\s+"
        r"(?:city|town|place)[\s?.!]*$",
        # origin wh-fronted: "Which city does X (originally) hail from?"
        r"^(?:which|what)\s+(?:city|town|place)\s+does\s+(?P<np>.+?)\s+"
        r"(?:originally\s+)?(?:hail|come)\s+from[\s?.!]*$",
        # "What city saw X's earliest days?"
        r"^(?:what|which)\s+(?:city|town|place)\s+saw\s+(?P<np>.+?)['’]s"
        r"\s+earliest\s+days[\s?.!]*$",
        # imperative: "Name/State/Identify ... city ... X was born" /
        # "... birth city of X" / "... X's city of birth"
        r"^(?:name|state|identify|give|provide|tell me)\b[^A-Za-z0-9]*(?:the\s+)?"
        r"(?:city|town|place)\b[^?]*?\bwhere\s+(?P<np>.+?)\s+was\s+born[\s?.!]*$",
        r"^(?:name|state|identify|give|provide|tell me)\b[^?]*?"
        r"\b(?:birth\s+(?:city|town|place)|birthplace)\s+of\s+(?P<np>.+?)[\s?.!]*$",
        r"^(?:name|state|identify|give|provide|tell me)\b[^?]*?"
        r"(?P<np>.+?)['’]s\s+(?:city|town|place)\s+of\s+birth[\s?.!]*$",
        r"^(?:name|state|identify|give|provide|tell me)\b[^?]*?"
        r"(?P<np>.+?)['’]s\s+(?:birthplace|birth\s+(?:city|town|place))"
        r"[\s?.!]*$",
        # wh-in-situ: "X was born in what city?"
        r"^(?P<np>.+?)\s+was\s+born\s+in\s+(?:what|which)\s+"
        r"(?:city|town|place)[\s?.!]*$",
        # "What/Which city welcomed X at birth?" and kin
        r"^(?:what|which)\s+(?:city|town|place)\s+"
        r"(?:welcomed|received|saw)\s+(?P<np>.+?)"
        r"(?:\s+at\s+birth|['’]s\s+birth)[\s?.!]*$",
        # "What is the city of birth of X?" / "the birth city of X"
        r"^(?:what|which)\s+(?:is|was)\s+(?:the\s+)?"
        r"(?:city|town|place)\s+of\s+birth\s+of\s+(?P<np>.+?)[\s?.!]*$",
        r"^(?:what|which)\s+(?:is|was)\s+(?:the\s+)?birth\s+"
        r"(?:city|town|place)\s+of\s+(?P<np>.+?)[\s?.!]*$",
        # possessive interrogative: "What is X's city of birth?"
        r"^(?:what|which)\s+(?:is|was)\s+(?P<np>.+?)['’]s\s+"
        r"(?:city|town|place)\s+of\s+birth[\s?.!]*$",
        r"^(?:what|which)\s+(?:is|was)\s+(?P<np>.+?)['’]s\s+"
        r"(?:birthplace|birth\s+(?:city|town|place))[\s?.!]*$",
    ):
        m = re.match(pat, s, re.IGNORECASE)
        if m:
            return f"Where was {_np(m.group('np'))} born?"
    return None


def _frame_performer(s: str) -> Optional[str]:
    for pat in (
        r"^(?P<np>.+?)\s+was\s+performed\s+by\s+whom[\s?.!]*$",
        r"^(?:the\s+)?(?:performer|artist|singer|voice)\s+(?:of|on|behind)\s+"
        r"(?P<np>.+?)\s+(?:is|was)\s+who(?:m)?[\s?.!]*$",
        r"^(?:which|what)\s+(?:artist|singer|musician|performer|act)\s+"
        r"(?:is\s+heard\s+on|performs?|performed|recorded|made|sang|sings)\s+"
        r"(?P<np>.+?)[\s?.!]*$",
        r"^who(?:m)?\s+(?:sang|sings|recorded|made|voiced)\s+"
        r"(?:the\s+album\s+)?(?P<np>.+?)[\s?.!]*$",
        r"^who\s+(?:is|was)\s+(?:heard|featured)\s+"
        r"(?:singing\s+|playing\s+)?on\s+(?P<np>.+?)[\s?.!]*$",
        # "Whose voice fills W?"
        r"^whose\s+voice\s+(?:fills|carries|anchors)\s+"
        r"(?P<np>.+?)[\s?.!]*$",
        # "Which act stands behind W?" normalizes to "Which performer of
        # W?" via _Q_REWRITES; parse that and the unrewritten original
        r"^(?:which|what)\s+(?:is\s+the\s+)?performer\s+of\s+"
        r"(?P<np>.+?)[\s?.!]*$",
        r"^(?:which|what)\s+(?:artist|act|musician|singer|performer)\s+"
        r"(?:stands?\s+|is\s+)?behind\s+(?P<np>.+?)[\s?.!]*$",
        # "Whose performance is captured on W?"
        r"^whose\s+performance\s+is\s+(?:captured|heard|featured)\s+"
        r"(?:on|in|throughout)\s+(?P<np>.+?)[\s?.!]*$",
        # imperative credit: "Name the act credited on W."
        r"^(?:name|state|identify|give)\s+the\s+(?:act|artist|performer|"
        r"singer|musician)\s+(?:credited\s+)?(?:on|behind|for)\s+"
        r"(?P<np>.+?)[\s?.!]*$",
    ):
        m = re.match(pat, s, re.IGNORECASE)
        if m:
            return f"Who performed {_np(m.group('np'))}?"
    return None


def _frame_spouse(s: str) -> Optional[str]:
    for pat in (
        r"^to\s+whom\s+(?:is|was)\s+(?P<np>.+?)\s+(?:married|wed)[\s?.!]*$",
        r"^who(?:m)?\s+did\s+(?P<np>.+?)\s+(?:marry|wed)[\s?.!]*$",
        r"^(?P<np>.+?)\s+(?:is|was)\s+(?:married|wed)\s+to\s+"
        r"who(?:m)?[\s?.!]*$",
        r"^who\s+(?:is|was)\s+(?P<np>.+?)['’]s\s+"
        r"(?:wife|husband|spouse|partner)[\s?.!]*$",
        r"^(?P<np>.+?)['’]s\s+(?:wife|husband|spouse)\s+(?:is|was)\s+"
        r"who(?:m)?[\s?.!]*$",
        r"^name\s+the\s+(?:wife|husband|spouse)\s+of\s+(?P<np>.+?)[\s?.!]*$",
        # "Who shares married life with X?"
        r"^who\s+shares\s+(?:married\s+life|a\s+marriage|wedlock)\s+"
        r"with\s+(?P<np>.+?)[\s?.!]*$",
        # "Who is X's other half in marriage?"
        r"^who\s+(?:is|was)\s+(?P<np>.+?)['’]s\s+other\s+half"
        r"(?:\s+in\s+marriage)?[\s?.!]*$",
    ):
        m = re.match(pat, s, re.IGNORECASE)
        if m:
            return f"Who is the spouse of {_np(m.group('np'))}?"
    return None


def _frame_release_year(s: str) -> Optional[str]:
    for pat in (
        r"^(?:in\s+)?(?:what|which)\s+year\s+(?:did|was)\s+(?P<np>.+?)\s+"
        r"(?:first\s+)?(?:released|come\s+out|appear|arrive|surface|"
        r"debut|reach\s+the\s+public|reach\s+(?:record\s+)?"
        r"(?:shops|stores|shelves)|hit\s+stores|go\s+on\s+sale)[\s?.!]*$",
        r"^(?:what|which)\s+year\s+saw\s+(?:the\s+release\s+of\s+)?"
        r"(?P<np>.+?)(?:\s+released)?[\s?.!]*$",
        r"^(?:what|which)\s+year\s+marks\s+the\s+release\s+of\s+"
        r"(?P<np>.+?)[\s?.!]*$",
        r"^the\s+release\s+of\s+(?P<np>.+?)\s+dates?\s+to\s+"
        r"(?:what|which)\s+year[\s?.!]*$",
        r"^when\s+did\s+(?P<np>.+?)\s+(?:come\s+out|appear|arrive|"
        r"surface|debut|reach\s+the\s+public|hit\s+stores|"
        r"go\s+on\s+sale)[\s?.!]*$",
        r"^(?P<np>.+?)\s+(?:came\s+out|was\s+released|appeared|arrived|"
        r"debuted|surfaced|reached\s+the\s+public|hit\s+stores|"
        r"went\s+on\s+sale|entered\s+circulation)\s+in\s+"
        r"(?:what|which)\s+year[\s?.!]*$",
    ):
        m = re.match(pat, s, re.IGNORECASE)
        if m:
            return f"When was {_np(m.group('np'))} released?"
    return None


def _frame_released_first(s: str) -> Optional[str]:
    for pat in (
        r"^(?:of|between)\s+(?P<a>.+?)\s+and\s+(?P<b>.+?)[,:]?\s+which"
        r"(?:\s+one)?\s+(?:came|appeared|arrived|was\s+released|"
        r"surfaced|debuted)\s+(?:earlier|first|sooner)[\s?.!]*$",
        r"^which\s+of\s+the\s+(?:two|pair)\s*[—–-]?\s*(?P<a>.+?)\s+or\s+"
        r"(?P<b>.+?)\s*[—–-]?\s*(?:predates\s+the\s+other|came\s+first|"
        r"appeared\s+(?:first|sooner))[\s?.!]*$",
        r"^which\s+(?:came|appeared|arrived|debuted)\s+first[,:]?\s+"
        r"(?P<a>.+?)\s+or\s+(?P<b>.+?)[\s?.!]*$",
        # partitive with a comparative nominal: "Out of A and B, which
        # has the earlier release date?"
        r"^(?:of|out\s+of|between)\s+(?P<a>.+?)\s+and\s+(?P<b>.+?)[,:]?"
        r"\s+which(?:\s+one)?\s+(?:has|carries|bears|shows)\s+the\s+"
        r"(?:earlier|earliest)\s+release\s+(?:date|year)[\s?.!]*$",
        # "Between A and B, which predates the other in release?"
        r"^(?:of|out\s+of|between)\s+(?P<a>.+?)\s+and\s+(?P<b>.+?)[,:]?"
        r"\s+which(?:\s+one)?\s+predates\s+the\s+other"
        r"(?:\s+in\s+release)?[\s?.!]*$",
        # "Which of A and B was on shelves sooner?"
        r"^which\s+of\s+(?P<a>.+?)\s+and\s+(?P<b>.+?)\s+was\s+on\s+"
        r"(?:the\s+)?shelves\s+(?:sooner|first|earlier)[\s?.!]*$",
    ):
        m = re.match(pat, s, re.IGNORECASE)
        if m:
            return (f"Which was released first, {_np(m.group('a'))} or "
                    f"{_np(m.group('b'))}?")
    return None


# count directives onto "How many <noun> ...": imperative and nominal forms
_COUNT_FRAMES: List[Tuple[re.Pattern, object]] = [
    (re.compile(r"^(?:Give|State|Provide|Tell me)\b[^:]*?\b(?:number|count|"
                r"total)\s+of\s+(?:the\s+)?(\w+)[:,]?\s*", re.IGNORECASE),
     r"How many \1 "),
    (re.compile(r"^What\s+(?:is\s+the\s+)?(?:total\s+)?(?:count|number)\s+"
                r"of\s+(?:the\s+)?(\w+)[:,]?\s*", re.IGNORECASE),
     r"How many \1 "),
    (re.compile(r"^State\s+how\s+many\b", re.IGNORECASE), "How many"),
    (re.compile(r"^What\s+number\s+of\b", re.IGNORECASE), "How many"),
    (re.compile(r"^(?:Tally|Count)(?:\s+up)?\s+the\s+(\w+)[:,]?\s*how\s+many\b",
                re.IGNORECASE), r"How many \1"),
    (re.compile(r"^(?:Tally|Count)(?:\s+up)?\s+the\s+(\w+)[:,]?\s*", re.IGNORECASE),
     r"How many \1 "),
    (re.compile(r"^What(?:'s|\s+is)\s+the\s+(?:tally|count|number|total)"
                r"\s+of\s+(?:the\s+)?(\w+)[:,]?\s*", re.IGNORECASE),
     r"How many \1 "),
    (re.compile(r"^What\s+figure\s+gives\s+the\s+(?:count|number|total|"
                r"tally)\s+of\s+(?:the\s+)?(\w+)[:,]?\s*", re.IGNORECASE),
     r"How many \1 "),
]

# track-count comparison phrasings onto the canonical comparative verbs.
# The leading verb is an explicit alternation (NOT \w+ wildcards — those
# swallow entity words); the emitted verb keeps the subject's number.
_TRACK_VERB = (r"(?P<verb>boasts?|carr(?:y|ies)|holds?|contains?|"
               r"features?|packs?|offers?|has|have|with|counts?)")


def _track_cmp_emit(direction: str):
    def _sub(m: re.Match) -> str:
        verb = (m.group("verb") or "").lower()
        if verb == "with":
            return f"with {direction} tracks than"
        v = "has" if verb.endswith("s") else "have"
        return f"{v} {direction} tracks than"
    return _sub


_TRACK_CMP_FRAMES: List[Tuple[re.Pattern, object]] = [
    (re.compile(_TRACK_VERB + r"\s+(?:a\s+)?(?:more|greater|higher|"
                r"larger|longer)[^?]{0,28}?\btrack(?:s|list)?\b"
                r"[^?]{0,18}?\bthan\b", re.IGNORECASE),
     _track_cmp_emit("more")),
    (re.compile(_TRACK_VERB + r"\s+(?:a\s+)?(?:fewer|smaller|lower|"
                r"shorter)[^?]{0,28}?\btrack(?:s|list)?\b[^?]{0,18}?\bthan\b",
                re.IGNORECASE),
     _track_cmp_emit("fewer")),
    (re.compile(r"\bfalls?\s+short\b[^?]{0,24}?\btracks?\b[^?]{0,12}?\bof\b",
                re.IGNORECASE),
     "have fewer tracks than"),
    (re.compile(r"\brun(?:s)?\s+longer[^?]{0,24}?\btrack[^?]{0,12}?\bthan\b",
                re.IGNORECASE),
     "have more tracks than"),
    (re.compile(r"\bcomes?\s+up\s+shorter[^?]{0,20}?\btrack(?:s|list)?\b"
                r"[^?]{0,12}?\bthan\b", re.IGNORECASE),
     "have fewer tracks than"),
    # "come in under the track total of W"
    (re.compile(r"\bcomes?\s+in\s+under\s+the\s+track\s+total\s+of\b",
                re.IGNORECASE),
     "have fewer tracks than"),
    # parenthetical dimension adverbial: "outstrip, in track count, W"
    (re.compile(r"\b(outstrips?|trails?)\b,?\s+in\s+track\s+count,?\s*",
                re.IGNORECASE),
     lambda m: "{} {} tracks than ".format(
         "has" if m.group(1).lower().endswith("s") else "have",
         "more" if m.group(1).lower().startswith("outstrip")
         else "fewer")),
]

_FRAMES = (_frame_birthplace, _frame_performer, _frame_spouse,
           _frame_release_year)


def frame_canonicalize(s: str) -> str:
    """Intent-frame pass: map general grammatical realizations of the
    simple question intents onto their canonical templates. Conservative:
    comparison/aggregate-shaped questions only get the scoped rewrites
    (count directives, track-comparison verbs, the released-first frame),
    never the whole-question frames."""
    for pat, rep in _COUNT_FRAMES:
        new = pat.sub(rep, s)
        if new != s:
            s = re.sub(r"\s+", " ", new).strip()
            if s.endswith("."):  # an imperative directive became a question
                s = s[:-1] + "?"
            break
    for pat, rep in _TRACK_CMP_FRAMES:
        s = pat.sub(rep, s)
    first = _frame_released_first(s)
    if first:
        return first
    if _FRAME_SKIP_RE.search(s):
        return s
    for frame in _FRAMES:
        out = frame(s)
        if out:
            return out
    return s


def normalize_question(q: str) -> str:
    """Canonical template surface for a paraphrased question.

    Idempotent; never touches capitalized entity spans (all rewrite
    patterns match lowercase template words or the bare acronym LP)."""
    s = (q or "").strip()
    m = _PREAMBLE_RE.match(s) or _PREAMBLE_MATERIAL_RE.match(s)
    if m:
        s = s[m.end():]
        if s and s[0].islower():
            s = s[0].upper() + s[1:]
    for pat, rep in _Q_REWRITES:
        s = pat.sub(rep, s)
    return frame_canonicalize(s)


# ------------------------------------------------------------- evidence
# Sentence canonicalization BEFORE rule extraction: the same idea as
# normalize_question, applied to evidence surfaces. Every rewrite maps an
# open English phrasing onto the cue vocabulary the extractor parses;
# entity spans survive verbatim (patterns capture them whole). Authored
# from general English + the DEV paraphrase sheet only (the v2 held-out
# bank stays solver-blind per HELDOUT.md).
# a capitalized entity span: capitalized words only — permitting dots or
# lowercase words lets a rule span sentence boundaries and merge two
# different facts ("A and B divorced in 1947.A and C in 1950 married."
# once rewrote into a single wrong marriage)
_ENT = r"[A-Z][\w'&-]*(?: [A-Z0-9][\w'&-]*)*"
# a date/year tail: "1996", "4 March 1972", "March 4, 1972"
_DATE = r"[\w]+(?:[ ,]+[\w]+){0,3}"
_S_REWRITES: List[Tuple[re.Pattern, str]] = [
    # expletive-it clefts: "It was in the studio that P made W." — the
    # leading "It" is NOT anaphoric; strip the cleft so pronoun coref
    # never resolves it and the inner clause parses on its own
    (re.compile(r"^It (?:is|was) to (" + _ENT + r") that (" + _ENT
                + r") (?:traces|owes) its (?:founding|existence|"
                r"establishment|creation)\.", re.M),
     r"\2 was founded by \1."),
    (re.compile(r"^It (?:is|was) (?:in|at) the \w+ that (\w)", re.M),
     lambda m: m.group(1).upper()),
    # conjoined-subject marriage statements: "X and Y became a married
    # couple / were joined in marriage / tied the knot", with an optional
    # "The union/marriage of" head noun
    (re.compile(r"^(?:The (?:union|marriage) of )?(" + _ENT + r") and ("
                + _ENT + r")(?: in (\d{4}))?"
                r" (?:became a married couple|became husband and wife|"
                r"tied the knot|exchanged vows|entered into marriage|"
                r"(?:was|were) (?:joined|united|sealed|bound) in "
                r"(?:marriage|wedlock|matrimony))\.", re.M),
     lambda m: (f"{m.group(1)} married {m.group(2)}"
                + (f" in {m.group(3)}" if m.group(3) else "") + ".")),
    # founding nominals: "Credit for establishing L rests with F",
    # "F brought L into existence", "L traces back to F, who started it"
    (re.compile(r"^Credit for (?:establishing|founding|starting|creating|"
                r"launching) (" + _ENT + r") (?:rests with|goes to|"
                r"belongs to|lies with) (" + _ENT + r")\.", re.M),
     r"\1 was founded by \2."),
    (re.compile(r"^(" + _ENT + r") brought (" + _ENT
                + r") into (?:existence|being)\.", re.M),
     r"\1 founded \2."),
    (re.compile(r"^(" + _ENT + r") traces back to (" + _ENT
                + r"), who (?:started|founded|created|established|"
                r"launched) (?:it|the \w+)\.", re.M),
     r"\1 was founded by \2."),
    # performer predicates: "P is responsible for recording W", "As
    # performer, P anchors W", "W bears P's name", "P is the name on W",
    # "P provides the performance on W", "W is P's work"
    (re.compile(r"\bis responsible for (record|perform|sing|play|writ)ing\b"),
     lambda m: {"sing": "sang", "writ": "wrote"}.get(
         m.group(1), m.group(1) + "ed")),
    (re.compile(r"^As (?:a |the )?performer, (" + _ENT
                + r") (?:anchors|carries|leads|fronts) the "
                r"(album|record|song) (" + _ENT + r")\.", re.M),
     r"\1 recorded the \2 \3."),
    (re.compile(r"^The (album|record|song) (" + _ENT + r") bears ("
                + _ENT + r")'s name\.", re.M),
     r"\2 is an \1 by \3."),
    (re.compile(r"^(" + _ENT + r") is the name on the "
                r"(album|record|song) (" + _ENT + r")\.", re.M),
     r"\3 is an \2 by \1."),
    (re.compile(r"(" + _ENT + r") provides the performance on the "
                r"(album|record|song) (" + _ENT + r")\."),
     r"\3 is an \2 performed by \1."),
    (re.compile(r"\bis (" + _ENT + r")'s work\b"),
     r"is an album by \1"),
    (re.compile(r"\bis the work of (" + _ENT + r")\b"),
     r"is an album by \1"),
    # appositive participial release clause on a work subject: pull the
    # clause out into its own sentence so both facts parse ("The album W,
    # released in Y on the label L, is an album by P.")
    (re.compile(r"^The (album|record|song) (" + _ENT + r"), "
                r"((?:put|placed|released|issued|brought)[^,]{0,80}?), "
                r"(is|was) ([^.]+)\.", re.M),
     r"\2 was \3. The \1 \2 \4 \5."),
    # release idioms with the label as agent/adjunct; the object may be a
    # pronoun (resolved upstream by topic coref) or the work itself
    (re.compile(r"\b(?:put|placed) on the market (in|on) (" + _DATE
                + r") by the label (" + _ENT + r")"),
     r"released \1 \2 on the label \3"),
    (re.compile(r"^The label (" + _ENT + r") (?:placed|put) (it|them|"
                + _ENT + r") on the market (in|on) (" + _DATE + r")\.",
                re.M),
     r"\2 was released \3 \4 on the label \1."),
    (re.compile(r"^(It|" + _ENT + r") entered circulation (in|on) ("
                + _DATE + r") (?:by way of|via|through|courtesy of|"
                r"thanks to) the label (" + _ENT + r")\.", re.M),
     r"\1 was released \2 \3 on the label \4."),
    (re.compile(r"^(It|" + _ENT + r") hit (?:stores|shelves|the shelves|"
                r"the market) (in|on) (" + _DATE + r") (?:courtesy of|"
                r"thanks to|via|through|by way of) the label ("
                + _ENT + r")\.", re.M),
     r"\1 was released \2 \3 on the label \4."),
    (re.compile(r"^In (\d{4}),? the label (" + _ENT + r") made (it|them|"
                + _ENT + r") available\.", re.M),
     r"\3 was released in \1 on the label \2."),
    (re.compile(r"^The label (" + _ENT + r") (?:circulated|distributed) "
                r"(it|them|" + _ENT + r") (?:starting|from|beginning) ("
                + _DATE + r")\.", re.M),
     r"\2 was released on \3 on the label \1."),
    (re.compile(r"^(?:Its|(" + _ENT + r")'s) street date, set by the "
                r"label (" + _ENT + r"), was (" + _DATE + r")\.", re.M),
     lambda m: (f"{m.group(1) or 'It'} was released on {m.group(3)} "
                f"on the label {m.group(2)}.")),
    (re.compile(r"^(" + _ENT + r")'s (album|record|song) (" + _ENT
                + r") entered the catalog of the label (" + _ENT
                + r") (in|on) (" + _DATE + r")\.", re.M),
     r"\3, a \2 by \1, came out \5 \6 on the label \4."),
    # catalog metonymy, label side: "in the label L's catalog" is the
    # released_on_label adjunct; "with P credited" the performer
    (re.compile(r"^The (album|record|song) (" + _ENT + r") appeared "
                r"(in|on) (" + _DATE + r") (?:in|on) the label (" + _ENT
                + r")'s catalog(?:, with (" + _ENT + r") credited)?\.",
                re.M),
     lambda m: (f"{m.group(2)}, an {m.group(1)} by {m.group(6)}, "
                if m.group(6) else f"{m.group(2)} ")
     + f"was released {m.group(3)} {m.group(4)} on the label "
     + f"{m.group(5)}."),
    (re.compile(r"^(It|They|" + _ENT + r") joined the label (" + _ENT
                + r")'s catalog (in|on) (" + _DATE + r")\.", re.M),
     r"\1 was released \3 \4 on the label \2."),
    (re.compile(r"^The label (" + _ENT + r") added (it|them|" + _ENT
                + r") to its catalog (in|on) (" + _DATE + r")\.", re.M),
     r"\2 was released \3 \4 on the label \1."),
    # catalog metonymy, person side = discography
    (re.compile(r"^(" + _ENT + r") sits in (" + _ENT + r")'s catalog\.",
                re.M),
     r"\1 is an album by \2."),
    # sleeve/voice metonymy performer statements
    (re.compile(r"^(" + _ENT + r")'s name appears on the sleeve of ("
                + _ENT + r")\.", re.M),
     r"\2 is an album by \1."),
    (re.compile(r"^(" + _ENT + r") carries (" + _ENT
                + r")'s voice throughout\.", re.M),
     r"\1 is an album performed by \2."),
    (re.compile(r"^Every track on (" + _ENT + r") is sung by (" + _ENT
                + r")\.", re.M),
     r"\1 is an album performed by \2."),
    (re.compile(r"^Studio work on the (album|record|song) (" + _ENT
                + r") was handled by (" + _ENT + r")\.", re.M),
     r"\3 recorded the \1 \2."),
    (re.compile(r"^The (album|record|song) (" + _ENT
                + r") took shape with (" + _ENT
                + r") at the microphone\.", re.M),
     r"\3 recorded the \1 \2."),
    # shelf-stocking releases with the label as agent
    (re.compile(r"^In (\d{4}),? the label (" + _ENT + r") put (it|them|"
                + _ENT + r") on (?:record-store |store |the )?shelves\.",
                re.M),
     r"\3 was released in \1 on the label \2."),
    (re.compile(r"^(?:Its|(" + _ENT + r")'s) first day of sale, ("
                + _DATE + r"), came (?:courtesy of|thanks to|via|"
                r"through) the label (" + _ENT + r")\.", re.M),
     lambda m: (f"{m.group(1) or 'It'} was released on {m.group(2)} "
                f"on the label {m.group(3)}.")),
    (re.compile(r"^The label (" + _ENT + r") set (" + _DATE
                + r") as (?:its|the) release date\.", re.M),
     r"It was released on \2 on the label \1."),
    (re.compile(r"^Record shops first stocked (it|them|" + _ENT
                + r") (in|on) (" + _DATE + r"), a release of the label ("
                + _ENT + r")\.", re.M),
     r"\1 was released \2 \3 on the label \4."),
    # em-dash appositive with a possessive: "W — P's album — reached
    # shelves ..." onto the comma-appositive shape the expansion pass
    # splits ("W, an album by P, ...")
    (re.compile(r"^(" + _ENT + r") [—–-]+ (" + _ENT
                + r")'s (album|record|song) [—–-]+ (.+)$", re.M),
     r"\1, an \3 by \2, \4"),
    # relative-clause performer: "W, which P made, went on sale ..."
    (re.compile(r"^(" + _ENT + r"), which (" + _ENT
                + r") (?:made|created|recorded|wrote), (.+)$", re.M),
     r"\1, an album by \2, \3"),
    # possessive predicative: "W is P's album." — also fires as the main
    # clause after a fronted participial ("Issued in Y on the label L,
    # W is P's album.")
    (re.compile(r"(^|, )(" + _ENT + r") (?:is|was) (" + _ENT
                + r")'s (album|record|song)\.", re.M),
     r"\1\2 is an \4 by \3."),
    (re.compile(r"^(" + _ENT + r") (?:is|was) (" + _ENT
                + r")'s creation\.", re.M),
     r"\1 was founded by \2."),
    # partitive possession: "W is one of P's albums." / "Among P's
    # albums is W."
    (re.compile(r"^(" + _ENT + r") is one of (" + _ENT
                + r")'s (album|record|song)s\.", re.M),
     r"\1 is an \3 by \2."),
    (re.compile(r"^Among (" + _ENT + r")'s (album|record|song)s is ("
                + _ENT + r")\.", re.M),
     r"\3 is an \2 by \1."),
    # duty-nominal performer: "Recording duties on the album W fell to P."
    (re.compile(r"^Recording duties (?:on|for) the (album|record|song) ("
                + _ENT + r") (?:fell|went) to (" + _ENT + r")\.", re.M),
     r"\3 recorded the \1 \2."),
    # specificational performer: "The artist heard throughout W is P." /
    # "W showcases a performance by P."
    (re.compile(r"^The (?:artist|performer|singer|act) heard "
                r"(?:throughout|on|across) (" + _ENT + r") (?:is|was) ("
                + _ENT + r")\.", re.M),
     r"\1 is an album performed by \2."),
    (re.compile(r"^(" + _ENT + r") showcases? a performance by ("
                + _ENT + r")\.", re.M),
     r"\1 is an album performed by \2."),
    # recording-session event nominal with agentive by-phrase: "The
    # sessions for the album W were led by P."
    (re.compile(r"^(?:The )?(?:recording )?[Ss]essions for the "
                r"(album|record|song) (" + _ENT + r") were "
                r"(?:led|headed|overseen|directed) by (" + _ENT + r")\.",
                re.M),
     r"\3 recorded the \1 \2."),
    # light-verb performer statements: "P laid down the album W." (active
    # counterpart of the passive idiom below)
    (re.compile(r"^(" + _ENT + r") laid down the (album|record|song) ("
                + _ENT + r")\.", re.M),
     r"\1 recorded the \2 \3."),
    # credit-nominal: "On the album W, the performing credit goes to P."
    (re.compile(r"^On the (album|record|song) (" + _ENT + r"), the "
                r"performing credits? (?:go|goes|went) to (" + _ENT
                + r")\.", re.M),
     r"\2 is an \1 performed by \3."),
    # role-apposition object: "W features P as its performer."
    (re.compile(r"^(" + _ENT + r") features (" + _ENT + r") as its "
                r"(?:performer|artist|singer|vocalist)\.", re.M),
     r"\1 is an album performed by \2."),
    # discography possession = performership: "W belongs to P's
    # discography" / "P's discography includes the album W"
    (re.compile(r"\bbelongs? to (" + _ENT + r")'s discography\b"),
     r"is an album by \1"),
    (re.compile(r"^(" + _ENT + r")'s discography includes the "
                r"(album|record|song) (" + _ENT + r")\.", re.M),
     r"\3 is an \2 by \1."),
    # clause-final possessive predicative naming the artist: "W arrived
    # ...; the album is P's." — repeat the sentence subject rather than
    # emitting a pronoun (this rewrite runs after the coref pass, so an
    # introduced "It" would never resolve)
    (re.compile(r"^(" + _ENT + r")([^;]*); the (album|record|song) is ("
                + _ENT + r")'s\.", re.M),
     r"\1\2. \1 is an \3 by \4."),
    (re.compile(r"; the (album|record|song) is (" + _ENT + r")'s\."),
     r". It is an \1 by \2."),
    # release event-nominal subject: "Its release, through the label L,
    # happened in Y."
    (re.compile(r"^(?:Its|(" + _ENT + r")'s) release, "
                r"(?:through|via|under|on) the label (" + _ENT
                + r"), (?:happened|came|took place|followed) (in|on) ("
                + _DATE + r")\.", re.M),
     lambda m: (f"{m.group(1) or 'It'} was released {m.group(3)} "
                f"{m.group(4)} on the label {m.group(2)}.")),
    # manufacturing-verb release: "The label L pressed and released it
    # during Y."
    (re.compile(r"^The label (" + _ENT + r") (?:pressed and released|"
                r"pressed|manufactured and released) (it|them|" + _ENT
                + r") (?:during|in) (" + _DATE + r")\.", re.M),
     r"\2 was released in \3 on the label \1."),
    # audience-acquisition release: "Listeners first got it in Y from the
    # label L."
    (re.compile(r"^(?:Listeners|The public|Audiences|Fans|Buyers) first "
                r"(?:got|heard|received|bought) (it|them|" + _ENT
                + r") (in|on) (" + _DATE + r") from the label ("
                + _ENT + r")\.", re.M),
     r"\1 was released \2 \3 on the label \4."),
    # retail-delivery release: "The label L delivered it to shops in Y."
    (re.compile(r"^The label (" + _ENT + r") (?:delivered|shipped|sent) "
                r"(it|them|" + _ENT + r") to (?:shops|stores|"
                r"retail(?:ers)?) (in|on) (" + _DATE + r")\.", re.M),
     r"\2 was released \3 \4 on the label \1."),
    # distribution event-nominal subject: "Shipping began D under the
    # label L."
    (re.compile(r"^(?:Shipping|Distribution|Circulation|Sales) began "
                r"(?:(in|on) )?(" + _DATE + r") under the label ("
                + _ENT + r")\.", re.M),
     lambda m: (f"It was released {m.group(1) or 'on'} {m.group(2)} "
                f"on the label {m.group(3)}.")),
    # year-subject release: "The year Y saw its arrival via the label L."
    # (tolerates a doubled determiner — "The year the year 1991 saw" —
    # from sloppy rewriting of an "in the year Y" source)
    (re.compile(r"^The year (?:the year )?(\d{4}) saw (?:its|the) arrival "
                r"(?:via|through|on|under) the label (" + _ENT + r")\.",
                re.M),
     r"It was released in \1 on the label \2."),
    # release-nominal subject variants: "Release came in Y, with L as the
    # issuing label." / "Release day was D, with the label L behind it."
    (re.compile(r"^Release came (in|on) (" + _DATE + r"), with ("
                + _ENT + r") as the issuing label\.", re.M),
     r"It was released \1 \2 on the label \3."),
    (re.compile(r"^Release day was (" + _DATE + r"), with the label ("
                + _ENT + r") behind it\.", re.M),
     r"It was released on \1 on the label \2."),
    # fronted label adjunct: "Under the label L, it went public in Y."
    (re.compile(r"^Under the label (" + _ENT + r"), (it|they|" + _ENT
                + r") went public (in|on) (" + _DATE + r")\.", re.M),
     r"\2 was released \3 \4 on the label \1."),
    # buyer-acquisition release: "Copies went out to buyers in Y under
    # the label L."
    (re.compile(r"^Copies went out to (?:buyers|shops|stores|the public) "
                r"(in|on) (" + _DATE + r") under the label (" + _ENT
                + r")\.", re.M),
     r"It was released \1 \2 on the label \3."),
    # label-agent idiom: "The label L sent it into the world on D."
    (re.compile(r"^The label (" + _ENT + r") sent (it|them|" + _ENT
                + r") into the world (in|on) (" + _DATE + r")\.", re.M),
     r"\2 was released \3 \4 on the label \1."),
    (re.compile(r"\bwent on sale\b"), "was released"),
    # "put X before the public" = release idiom; the absolutive label
    # adjunct (", with the label L handling release") names the label
    (re.compile(r"\b(?:put|placed|brought) (it|them|" + _ENT
                + r") before the public\b"),
     r"released \1"),
    (re.compile(r",? with the label (" + _ENT + r") handling "
                r"(?:the )?(?:release|distribution|pressing)\."),
     r" on the label \1."),
    (re.compile(r"\bin the year (\d{4})\b"), r"in \1"),
    # track-count nominals
    (re.compile(r"^A total of ([\w-]+) tracks fill (?:it|the \w+)\.",
                re.M),
     r"It features \1 tracks."),
    (re.compile(r"^The (?:count|number|total|tally) of tracks "
                r"(?:stands at|comes to|is|reaches) ([\w-]+)\.", re.M),
     r"It features \1 tracks."),
    (re.compile(r"^([\w-]+) tracks make up the (?:album|record|release)\.",
                re.M),
     r"It features \1 tracks."),
    # listening/sleeve metonymy counts: "Play it end to end and you pass
    # N tracks." / "The sleeve lists N tracks."
    (re.compile(r"^Play (?:it|the \w+) end to end and you pass "
                r"([\w-]+) tracks\.", re.M),
     r"It features \1 tracks."),
    (re.compile(r"^The sleeve lists ([\w-]+) tracks\.", re.M),
     r"It features \1 tracks."),
    # locative-inversion count: "Running through it are N tracks."
    (re.compile(r"^Running through (?:it|the \w+) are ([\w-]+) tracks\.",
                re.M),
     r"It features \1 tracks."),
    # "Its track listing runs to N entries."
    (re.compile(r"^(?:Its|(" + _ENT + r")'s) track listing runs to "
                r"([\w-]+) (?:entries|tracks|songs|cuts)\.", re.M),
     lambda m: (f"{m.group(1) or 'It'} features {m.group(2)} tracks.")),
    (re.compile(r"^(?:Its|(" + _ENT + r")'s) tracklist numbers "
                r"([\w-]+)\.", re.M),
     lambda m: (f"{m.group(1) or 'It'} features {m.group(2)} tracks.")),
    # birthplace idiom with a possibly comma-carrying place
    (re.compile(r"^(" + _ENT + r") calls ([^.]+?) home\.", re.M),
     r"\1 hails from \2."),
    # specificational birthplace cleft: "C is where P's life began."
    (re.compile(r"^(" + _ENT + r"(?:, [A-Z][\w']*)?) is where ("
                + _ENT + r")'s life (?:began|started)\.", re.M),
     r"\2 was born in \1."),
    # "entered life in C" (cf. the "entered the world" idiom)
    (re.compile(r"^(" + _ENT + r") (?:entered|began|started) life in "
                r"([^.]+)\.", re.M),
     r"\1 was born in \2."),
    # possessive-host origin nominal: "P's beginnings lie in C."
    (re.compile(r"^(" + _ENT + r")'s (?:beginnings|origins|roots) "
                r"(?:lie|lay|are|were) in ([^.]+)\.", re.M),
     r"\1 was born in \2."),
    (re.compile(r"\bis originally from\b"), "hails from"),
    # possessive-host life nominals: "P's earliest years were spent in
    # C." / "P's story starts in C."
    (re.compile(r"^(" + _ENT + r")'s (?:earliest|early|first) years "
                r"were spent in ([^.]+)\.", re.M),
     r"\1 was born in \2."),
    (re.compile(r"^(" + _ENT + r")'s story (?:starts|started|begins|"
                r"began) in ([^.]+)\.", re.M),
     r"\1 was born in \2."),
    # place-subject roster: "C counts P among its natives." (the person
    # slot may be a pronoun — topic coref resolves it after this pass)
    (re.compile(r"^(" + _ENT + r"(?:, [A-Z][\w']*)?) counts ([^.]+?) "
                r"among its natives\.", re.M),
     r"\2 is a native of \1."),
    # "Life for P began in C." (fronted benefactive of the life-began
    # idiom)
    (re.compile(r"^Life for (" + _ENT + r") began in ([^.]+)\.", re.M),
     r"\1 was born in \2."),
    # street metonymy: "P grew up on C's streets." (subject may be a
    # pronoun the topic-coref pass resolves after this rewrite)
    (re.compile(r"^([A-Z][\w' ]*?) grew up on (" + _ENT
                + r"(?:, [A-Z][\w']*)?)'s streets\.", re.M),
     r"\1 was born in \2."),
    # "P's childhood unfolded in C."
    (re.compile(r"^([A-Z][\w' ]*?)'s childhood unfolded in ([^.]+)\.",
                re.M),
     r"\1 was born in \2."),
    # "C appears on P's birth record."
    (re.compile(r"^(" + _ENT + r"(?:, [A-Z][\w']*)?) appears on ("
                + _ENT + r")'s birth record\.", re.M),
     r"\2 was born in \1."),
    # registry nominal: "The record books list C as P's birthplace."
    (re.compile(r"^The record books? lists? ([^.]+?) as (" + _ENT
                + r")'s (?:birthplace|birth (?:city|town|place))\.",
                re.M),
     r"\2 was born in \1."),
    # reversed birthplace with a possessive person: "Madison, Wisconsin
    # was the setting of Fenkes's birth." — place first (possibly with a
    # state suffix), person in the of-complement
    (re.compile(r"^(" + _ENT + r"(?:, [A-Z][\w']*)?) (?:was|is) the "
                r"setting of (" + _ENT + r")'s birth\.", re.M),
     r"\2 was born in \1."),
    (re.compile(r"^(" + _ENT + r"(?:, [A-Z][\w']*)?) (?:saw|witnessed|"
                r"hosted|marked) (?:the birth of|(" + _ENT
                + r")'s birth)", re.M),
     lambda m: (f"{m.group(2)} was born in {m.group(1)}"
                if m.group(2) else f"{m.group(1)} was the birthplace of")),
    # topicalized birthplace: "As for X, the city of birth is C."
    (re.compile(r"^As for (" + _ENT + r"), the (?:city|town|place) of "
                r"birth is ([^.]+)\.", re.M),
     r"\1 was born in \2."),
    # perform — copular appositions naming the artist late: orient the
    # triple as (work, performed_by, person) regardless of clause order
    (re.compile(r"; the performing artist is ([^.;]+)\."),
     r" performed by \1."),
    (re.compile(r"\bwhose credited artist is\b"), "performed by"),
    (re.compile(r"\bthe performance is by\b"), "performed by"),
    (re.compile(r"\b(?:was|were) laid down by\b"), "was recorded by"),
    (re.compile(r"\bis a recording by\b"), "is an album by"),
    (re.compile(r"\b(an?) (album|record) from\b"), r"\1 \2 by"),
    # release — split verb phrases around an object ("put it out",
    # "brought W out") and synonyms
    (re.compile(r"\b(?:put|brought) (it|them|" + _ENT + r") out\b"),
     r"released \1"),
    (re.compile(r"\bput out\b"), "released"),
    (re.compile(r"\bbrought out\b"), "released"),
    (re.compile(r"\bcame out\b"), "was released"),
    (re.compile(r"\bissued\b"), "released"),
    # founded
    (re.compile(r"\bset up by\b"), "founded by"),
    (re.compile(r"^(" + _ENT + r") set up (" + _ENT + r")\.", re.M),
     r"\1 founded \2."),
    (re.compile(r"^(" + _ENT + r") got (" + _ENT + r") off the ground\.",
                re.M),
     r"\1 founded \2."),
    # origin-locative founder: "F stands at the origin of Org."
    (re.compile(r"^(" + _ENT + r") (?:stands|stood|is|was) at the "
                r"origin of (" + _ENT + r")\.", re.M),
     r"\2 was founded by \1."),
    # nominalized founding with agentive adjunct: "The establishment of
    # Org happened under F's hand."
    (re.compile(r"^The (?:establishment|founding|creation|launch) of ("
                + _ENT + r") (?:happened|came|took place|occurred) "
                r"(?:under|at|through) (" + _ENT + r")'s "
                r"(?:hand|hands|direction|initiative|leadership)\.", re.M),
     r"\1 was founded by \2."),
    # institutional-opening idiom: "Org opened its doors under F."
    (re.compile(r"^(" + _ENT + r") opened its doors under (" + _ENT
                + r")\.", re.M),
     r"\1 was founded by \2."),
    # causative-start idioms: "F gave Org its start." / "Org began as
    # F's venture." / "Org exists because F launched it."
    (re.compile(r"^(" + _ENT + r") gave (" + _ENT + r") its start\.",
                re.M),
     r"\2 was founded by \1."),
    (re.compile(r"^(" + _ENT + r") began as (" + _ENT
                + r")'s (?:venture|project|enterprise|undertaking)\.",
                re.M),
     r"\1 was founded by \2."),
    (re.compile(r"^(" + _ENT + r") exists because (" + _ENT
                + r") (?:launched|started|founded|created) it\.", re.M),
     r"\1 was founded by \2."),
    # document nominal: "The founding papers of Org bear F's signature."
    (re.compile(r"^The founding papers of (" + _ENT + r") bears? ("
                + _ENT + r")'s signature\.", re.M),
     r"\1 was founded by \2."),
    # gratitude/cleft founder idioms: "Org exists thanks to F's founding
    # work." / "It was F who set Org going." / "Org got going when F
    # opened it." / "Setting up Org was F's doing." / "Org has F to
    # thank for its existence."
    (re.compile(r"^(" + _ENT + r") exists thanks to (" + _ENT
                + r")'s (?:founding|foundational) (?:work|efforts?)\.",
                re.M),
     r"\1 was founded by \2."),
    (re.compile(r"^It was (" + _ENT + r") who (?:set|got) (" + _ENT
                + r") going\.", re.M),
     r"\2 was founded by \1."),
    (re.compile(r"^(" + _ENT + r") got going when (" + _ENT
                + r") opened it\.", re.M),
     r"\1 was founded by \2."),
    (re.compile(r"^Setting up (" + _ENT + r") was (" + _ENT
                + r")'s doing\.", re.M),
     r"\1 was founded by \2."),
    (re.compile(r"^(" + _ENT + r") has (" + _ENT + r") to thank for "
                r"its (?:existence|founding|start)\.", re.M),
     r"\1 was founded by \2."),
    # spouse — conjoined subject and nominal statements
    (re.compile(r"^(" + _ENT + r") and (" + _ENT + r")(?: in (\d{4}))?"
                r" (?:married|wed)\.", re.M),
     lambda m: (f"{m.group(1)} married {m.group(2)}"
                + (f" in {m.group(3)}" if m.group(3) else "") + ".")),
    (re.compile(r"(" + _ENT + r")'s marriage is to ([^.]+)\."),
     r"\1 married \2."),
    # abstract-noun subject: "Marriage ties A to B." / "Matrimony linked
    # A and B." / "Marriage links the household of A and B."
    (re.compile(r"^(?:Marriage|Matrimony|Wedlock) (?:ties|tied|links|"
                r"linked|joins|joined|binds|bound|unites|united) "
                r"(?:the households? of )?("
                + _ENT + r") (?:to|and|with) (" + _ENT + r")\.", re.M),
     r"\1 married \2."),
    # "At home, P's other half is S." / "S is P's other half (in
    # marriage)."
    (re.compile(r"^(?:At home, )?(" + _ENT + r")'s other half "
                r"(?:in marriage )?(?:is|was) (" + _ENT + r")\.", re.M),
     r"\1 married \2."),
    (re.compile(r"^(" + _ENT + r") (?:is|was) (" + _ENT
                + r")'s other half(?: in marriage)?\.", re.M),
     r"\2 married \1."),
    # wedding event subjects: "A wedding (in Y) made A and B a pair." /
    # "A and B swapped rings (in Y)."
    (re.compile(r"^A wedding(?: in (\d{4}))? made (" + _ENT + r") and ("
                + _ENT + r")(?: in (\d{4}))? a (?:pair|couple)\.", re.M),
     lambda m: (f"{m.group(2)} married {m.group(3)}"
                + (f" in {m.group(1) or m.group(4)}"
                   if m.group(1) or m.group(4) else "") + ".")),
    (re.compile(r"^(" + _ENT + r") and (" + _ENT + r")(?: in (\d{4}))?"
                r" swapped rings(?: in (\d{4}))?\.", re.M),
     lambda m: (f"{m.group(1)} married {m.group(2)}"
                + (f" in {m.group(3) or m.group(4)}"
                   if m.group(3) or m.group(4) else "") + ".")),
    (re.compile(r"^(" + _ENT + r") and (" + _ENT + r") share a "
                r"household and a marriage\.", re.M),
     r"\1 married \2."),
    # possessive-host marriage nominal: "A's partner in marriage is B."
    (re.compile(r"^(" + _ENT + r")'s partner in (?:marriage|wedlock) "
                r"(?:is|was) (" + _ENT + r")\.", re.M),
     r"\1 married \2."),
    # light-verb marriage: "A took B as a spouse." / "A shares a marriage
    # with B."
    (re.compile(r"^(" + _ENT + r") took (" + _ENT + r")(?: in (\d{4}))? "
                r"as (?:a|his|her|their) spouse\.", re.M),
     lambda m: (f"{m.group(1)} married {m.group(2)}"
                + (f" in {m.group(3)}" if m.group(3) else "") + ".")),
    (re.compile(r"^(" + _ENT + r") shares? (?:a marriage|married life) "
                r"with (" + _ENT + r")\.", re.M),
     r"\1 married \2."),
    # "Married life pairs A with B."
    (re.compile(r"^Married life pairs (" + _ENT + r") with (" + _ENT
                + r")\.", re.M),
     r"\1 married \2."),
    # fronted marriage adverbial: "In marriage, A is joined to B."
    (re.compile(r"^In (?:marriage|wedlock|matrimony), (" + _ENT
                + r") (?:is|was) (?:joined|united|bound) to (" + _ENT
                + r")\.", re.M),
     r"\1 married \2."),
    # "A has B for a spouse."
    (re.compile(r"^(" + _ENT + r") (?:has|had) (" + _ENT
                + r") for a (?:spouse|wife|husband)\.", re.M),
     r"\1 married \2."),
    # reciprocal: "A and B are wed to each other." / "became spouses"
    (re.compile(r"^(" + _ENT + r") and (" + _ENT + r") (?:are|were) "
                r"(?:wed|married) to (?:each other|one another)\.", re.M),
     r"\1 married \2."),
    (re.compile(r"^(" + _ENT + r") and (" + _ENT + r") became spouses"
                r"(?: in (\d{4}))?\.", re.M),
     lambda m: (f"{m.group(1)} married {m.group(2)}"
                + (f" in {m.group(3)}" if m.group(3) else "") + ".")),
    # born — nominal birthplace statements
    (re.compile(r"([\w'. -]+?)'s home ?town is ([^.]+)\."),
     r"\1 was born in \2."),
    (re.compile(r"([\w'. -]+?)'s place of birth is ([^.]+)\."),
     r"\1 was born in \2."),
    (re.compile(r"\bcomes from\b"), "hails from"),
    # tracks — nominal count statements onto the "features N tracks" cue
    (re.compile(r"^The track (?:count|total|listing) is ([\w-]+)\.", re.M),
     r"It features \1 tracks."),
    (re.compile(r"^There are ([\w-]+) tracks on it\.", re.M),
     r"It features \1 tracks."),
    (re.compile(r"^There are ([\w-]+) tracks on ([^.]+)\.", re.M),
     r"\2 features \1 tracks."),
    # active label-release clause onto the passive canonical shape the
    # extractor keys (work subject; label cue after the year): applied
    # AFTER pronoun-object coref, so the object may be an entity
    (re.compile(r"^The label (" + _ENT + r") released (it|them|" + _ENT
                + r")(?: to the public| worldwide| broadly)? (in|on) "
                r"([\w ,]+)\.", re.M),
     r"\2 was released \3 \4 on the label \1."),
    # active artist-subject release naming the label: "P released W in Y
    # on the label L." (downstream appositive expansion splits the two
    # facts; "The label L released ..." cannot match — lowercase "label"
    # breaks the leading entity span)
    (re.compile(r"^(" + _ENT + r") released (" + _ENT + r") (in|on) ("
                + _DATE + r") on the label (" + _ENT + r")\.", re.M),
     r"\2, an album by \1, was released \3 \4 on the label \5."),
]


def normalize_sentence(s: str) -> str:
    """Canonical cue surface for a paraphrased evidence sentence.

    Idempotent. Applied by the rule note generator before entity/triple
    extraction; a rewrite never adds or removes an entity span."""
    # collapse doubled spaces first: an upstream rewrite that captured a
    # leading space leaves "got  Nehol Audio off the ground", which no
    # single-space pattern matches
    t = re.sub(r"  +", " ", s or "")
    for pat, rep in _S_REWRITES:
        t = pat.sub(rep, t)
    # a rewrite may move a lowercase pronoun object to sentence-initial
    # position ("it was released ..."); capitalize so downstream topic
    # coref (which keys sentence-initial "It") still resolves it
    t = re.sub(r"(^|[.!?] )(it|its|they|she|he)\b",
               lambda m: m.group(1) + m.group(2).capitalize(), t)
    return t
