"""Counterpart of anorag_tpu/utils/semtype.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Corpus-level entity typing and type-signature triple orientation.

Why this exists: the lemma fallback (utils/lexnorm.py) recovers the
RELATION of an openly-phrased sentence, but head/tail orientation from
word order alone cracks on free clause order ("The founding of L was the
work of F", "Behind the album W stands P", "For a spouse, X has Y").
Entity TYPES pin the orientation regardless of syntax: performed_by is
always (work <- person), released_on_label always (work <- label),
born_in always (person <- place). Types are inferred once per corpus
from adjacency cues that survive paraphrase — a fluent rewrite of
"W is an album by P" still calls W an album somewhere — then every
sentence reuses the registry, so one clearly-typed mention anywhere in
the corpus disambiguates every other mention.

Reference parity: the reference delegates extraction to an
instruction-tuned LLM whose world knowledge carries entity types
implicitly (upstream llm/atomic_note_generator.py:139); an
LLM-free rule path needs them explicitly. The type nouns and signatures
below are general English / general schema knowledge, NOT mined from any
evaluation phrase bank (HELDOUT.md separation rules).
"""
from __future__ import annotations

import re
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PERSON = "person"
WORK = "work"
LABEL = "label"
PLACE = "place"
YEAR = "year"

_YEAR_RE = re.compile(r"^(?:1[0-9]{3}|20[0-9]{2})$")

# type nouns (general domain vocabulary; compounds handled before atoms:
# "record label" is a LABEL even though "record" alone is a work noun)
_LABEL_NOUN_RE = re.compile(
    r"\b(?:record label|label|imprint|record company)\b", re.IGNORECASE)
_WORK_NOUN_RE = re.compile(
    r"\b(?:album|single|song|ep|lp|recording|record|compilation|release)\b",
    re.IGNORECASE)
_PLACE_NOUN_RE = re.compile(
    r"\b(?:city|town|village|capital|municipality|borough|birthplace)\b",
    re.IGNORECASE)
_PERSON_NOUN_RE = re.compile(
    r"\b(?:singer|musician|artist|performer|songwriter|composer|founder|"
    r"producer|director|actor|actress|author|writer|vocalist|drummer|"
    r"guitarist|pianist)\b", re.IGNORECASE)

# clause-level lemmas whose AGENT ("by <ent>", possessive) is a person
_AGENTIVE_RE = re.compile(
    r"\b(?:record|perform|sang|sung|sing|found|establish|direct|start|"
    r"creat|wrote|written|compos|launch)\w*\b", re.IGNORECASE)

# marriage context: every non-year entity in such a sentence is a person
_MARRIAGE_RE = re.compile(
    r"\b(?:marri\w*|wed|wedding|wedlock|spouse|husband|wife|widow\w*|"
    r"divorc\w*)\b", re.IGNORECASE)

# birth context: the subject is a person; an "in <ent>" complement is a place
_BORN_RE = re.compile(r"\b(?:born|birth|native\w*)\b", re.IGNORECASE)


def _left_context(text: str, pos: int, width: int = 28) -> str:
    return text[max(0, pos - width):pos]

def _right_context(text: str, end: int, width: int = 44) -> str:
    return text[end:end + width]


class EntityTypeRegistry:
    """Accumulates per-entity type votes across a corpus, then answers
    ``type_of``. Voting is deliberately conservative: only adjacency
    patterns that are near-unambiguous in English get a strong vote, and
    conflicting strong votes resolve to the majority (ties -> untyped).
    """

    def __init__(self) -> None:
        self._votes: Dict[str, Counter] = defaultdict(Counter)

    # -------------------------------------------------------------- votes
    def observe(self, text: str, entities: Sequence[str],
                positions: Optional[Dict[str, int]] = None) -> None:
        """Record type evidence for every entity occurrence in one
        sentence. `positions` maps entity -> char offset (computed here
        when absent)."""
        if not text or not entities:
            return
        low = text.lower()
        if positions is None:
            positions = {}
            for e in entities:
                m = re.search(r"(?<!\w)" + re.escape(str(e).lower()) +
                              r"(?!\w)", low)
                positions[e] = m.start() if m else -1
        marriage = bool(_MARRIAGE_RE.search(low))
        born = bool(_BORN_RE.search(low))
        for e in entities:
            e = str(e)
            if _YEAR_RE.fullmatch(e):
                self._votes[e][YEAR] += 100
                continue
            pos = positions.get(e, -1)
            if pos < 0:
                continue
            end = pos + len(e)
            left = _left_context(low, pos)
            right = _right_context(low, end)
            # (1) type noun directly BEFORE the entity: "the album W",
            # "the record label L", possibly through a possessive
            # ("P's album W") or "titled/called/named"
            lm = re.search(
                r"\b([\w-]+(?: [\w-]+)?)\s+(?:titled\s+|called\s+|named\s+)?"
                r"[\"']?$", left)
            if lm:
                noun = lm.group(1)
                self._vote_noun(e, noun, strength=3)
            # (2) copular / appositive type noun AFTER the entity:
            # "W is an album ...", "W, an album by P, ...", "W — P's album"
            rm = re.match(
                r"^[\"']?\s*(?:\([^)]*\)\s*)?(?:,|—|–|-|\bis\b|\bwas\b|"
                r"\bare\b|\bwere\b)\s*(?:(?:an?|the|one|his|her|their)\s+)?"
                r"(?:[\w-]+\s+){0,2}?(record label|label|imprint|album|"
                r"single|song|ep|lp|recording|record|city|town|village|"
                r"capital|singer|musician|artist|performer|songwriter|"
                r"composer|founder|band)\b", right)
            if rm:
                self._vote_noun(e, rm.group(1), strength=3)
            # (3) agent: "by <ent>" after an agentive lemma, with no label
            # noun between the "by" and the entity ("by the label L" is a
            # label, not a person)
            bym = re.search(r"\bby\s+[\"']?$", left)
            if bym and _AGENTIVE_RE.search(low[:pos]) and \
                    not re.search(r"\b(?:label|imprint)\s*[\"']?$",
                                  left.rstrip()):
                self._votes[e][PERSON] += 2
            # (4) possessive agent: "<ent>'s album/record/..." types the
            # OWNER as a person (the owned noun votes the next entity via
            # rule 1)
            if re.match(r"^[\"']?['’]s\s+(?:\w+\s+){0,1}?(?:album|"
                        r"single|song|ep|recording|record|output|work|"
                        r"catalog|spouse|wife|husband|marriage|birth)\b",
                        right):
                self._votes[e][PERSON] += 2
            # (5) marriage sentences: non-year entities are persons
            if marriage:
                self._votes[e][PERSON] += 1
            # (6) birth sentences: subject-side person, "in <ent>" place
            if born:
                bm = _BORN_RE.search(low)
                if bm and pos < bm.start():
                    self._votes[e][PERSON] += 1
                elif re.search(r"\b(?:in|of)\s+[\"']?$", left):
                    self._votes[e][PLACE] += 1

    def _vote_noun(self, ent: str, noun: str, strength: int) -> None:
        if _LABEL_NOUN_RE.fullmatch(noun) or noun == "record label":
            self._votes[ent][LABEL] += strength
        elif _WORK_NOUN_RE.fullmatch(noun):
            self._votes[ent][WORK] += strength
        elif _PLACE_NOUN_RE.fullmatch(noun):
            self._votes[ent][PLACE] += strength
        elif _PERSON_NOUN_RE.fullmatch(noun) or noun == "band":
            self._votes[ent][PERSON] += strength

    # ------------------------------------------------------------- lookup
    def type_of(self, ent: str) -> Optional[str]:
        c = self._votes.get(str(ent))
        if not c:
            return None
        top = c.most_common(2)
        if len(top) > 1 and top[0][1] == top[1][1]:
            return None  # conflicting evidence -> untyped (safe)
        return top[0][0]

    def types_for(self, entities: Iterable[str]) -> Dict[str, Optional[str]]:
        return {str(e): self.type_of(e) for e in entities}

    def __len__(self) -> int:
        return len(self._votes)


def build_registry(sentences_with_entities:
                   Iterable[Tuple[str, Sequence[str]]]
                   ) -> EntityTypeRegistry:
    reg = EntityTypeRegistry()
    for text, ents in sentences_with_entities:
        reg.observe(text, ents)
    return reg


# ------------------------------------------------------------- signatures
# (head_type, tail_type) per relation. Orientation by signature replaces
# word-order heuristics whenever both slots resolve unambiguously.
SIGNATURES: Dict[str, Tuple[str, str]] = {
    "performed_by": (WORK, PERSON),
    "released_in": (WORK, YEAR),
    "released_on_label": (WORK, LABEL),
    "born_in": (PERSON, PLACE),
    "spouse_of": (PERSON, PERSON),
    "founded_by": (LABEL, PERSON),
    "member_of": (PERSON, LABEL),
    "located_in": (PLACE, PLACE),
    "directed_by": (WORK, PERSON),
}


def orient(rel: str, ents_in_order: Sequence[str],
           types: Dict[str, Optional[str]]
           ) -> Optional[Tuple[str, str]]:
    """(head, tail) for `rel` chosen by type signature, or None when the
    types cannot disambiguate (caller falls back to syntax heuristics).

    A slot accepts an UNTYPED entity only when no typed candidate fits it
    and the untyped entity is not claimed by the other slot — so
    "X first saw the light of day in Ludham" orients person<-place even
    though the city was never explicitly typed.
    """
    sig = SIGNATURES.get(rel)
    if not sig or len(ents_in_order) < 2:
        return None
    head_t, tail_t = sig
    if head_t == tail_t:
        return None  # symmetric (spouse_of): syntax/subject order decides
    ents = [str(e) for e in ents_in_order]
    heads = [e for e in ents if types.get(e) == head_t]
    tails = [e for e in ents if types.get(e) == tail_t]
    untyped = [e for e in ents if types.get(e) is None]
    if not heads and len(untyped) == 1 and tails:
        heads = untyped
    if not tails and len(untyped) == 1 and heads:
        tails = untyped
    # the year slot never falls back to untyped except the regex
    if tail_t == YEAR:
        tails = [e for e in ents if _YEAR_RE.fullmatch(e)]
    heads = [e for e in heads if e not in tails]
    tails = [e for e in tails if e not in heads]
    if len(heads) >= 1 and len(tails) >= 1:
        # first-in-sentence-order of each slot: the subject of its type
        return heads[0], tails[0]
    return None


def typed_default_triples(ents_in_order: Sequence[str],
                          types: Dict[str, Optional[str]],
                          existing_rels: Sequence[str] = ()
                          ) -> List[Dict[str, str]]:
    """Schema-driven defaults when no relation lemma fired at all: in this
    domain a sentence pairing a WORK with a PERSON asserts performership
    ("Among P's output is the record W", "The record W bears P's name") —
    there is no other work<->person relation in the schema. Only fires for
    unambiguous single-pair sentences."""
    def _canon(e: str) -> str:
        # "Zavel Tomarmar" and "Zavel Tomarmar's" are one entity —
        # extraction keeps both surfaces (apostrophe-s titles stay
        # extractable), but the uniqueness precondition here must count
        # them once or every possessive sentence has "two persons"
        return e[:-2].rstrip() if e.endswith(("'s", "’s")) else e

    ents = [str(e) for e in ents_in_order]
    works: List[str] = []
    persons: List[str] = []
    for e in ents:
        t = types.get(e)
        bucket = works if t == WORK else persons if t == PERSON else None
        if bucket is not None and _canon(e) not in [_canon(x)
                                                    for x in bucket]:
            # prefer the non-possessive surface as the graph key
            bucket.append(_canon(e) if _canon(e) in ents else e)
    out: List[Dict[str, str]] = []
    if (len(works) == 1 and len(persons) == 1
            and "performed_by" not in existing_rels):
        out.append({"head_key": works[0], "rel": "performed_by",
                    "tail_key": persons[0]})
    return out
