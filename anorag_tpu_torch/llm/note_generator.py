"""Counterpart of anorag_tpu/llm/note_generator.py,
copied as it is with its imports renamed to anorag_tpu_torch.

AtomicNoteGenerator: chunks -> validated atomic notes via LLM.

Parity target: upstream llm/atomic_note_generator.py — per-chunk v2
prompt, sentinel fast path ('~' = no notes), robust JSON parse with ONE
retry on a shortened chunk (:404-474), rule fallback notes
(:enable_rule_fallback), completeness/quality filtering, stable note ids,
raw_span evidence, entity fallback extraction, predicate normalization, and
bucketed per-paragraph note limits (notes_llm.limit).
"""
from __future__ import annotations

import functools
import hashlib
import re
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence

from anorag_tpu_torch.llm.early_stop import StreamingEarlyStop
from anorag_tpu_torch.llm.prompts import ATOMIC_NOTE_SENTINEL, build_atomic_note_prompt
from anorag_tpu_torch.utils.json_parser import extract_json
from anorag_tpu_torch.utils.lexnorm import normalize_sentence
from anorag_tpu_torch.utils.logging import get_logger
from anorag_tpu_torch.utils.text import extract_entities_fallback, split_sentences
from anorag_tpu_torch.validators.note_validator import normalize_note

logger = get_logger("anorag.notes")

_PREDICATE_NORM = {
    "performs": "performed_by", "performed by": "performed_by", "sung by": "performed_by",
    "spouse": "spouse_of", "married to": "spouse_of", "wife of": "spouse_of",
    "husband of": "spouse_of", "born": "born_in", "birthplace": "born_in",
    "member": "member_of", "released": "released_in", "located": "located_in",
}


def stable_note_id(doc_id: str, chunk_index: int, text: str) -> str:
    h = hashlib.sha1(f"{doc_id}|{chunk_index}|{text}".encode()).hexdigest()[:12]
    return f"note_{h}"


def normalize_predicate(rel: Optional[str]) -> str:
    r = (rel or "").strip().lower().replace("-", "_").replace(" ", "_")
    return _PREDICATE_NORM.get((rel or "").strip().lower(), r or "related_to")


_DEFAULT_REL_LEXICON = {
    "performed_by": ["performed by", "the performer is", "sung by", "sings",
                     "album by", "record by", "recorded the album"],
    "spouse_of": ["spouse", "married", "wife", "husband", "partner", " wed "],
    "born_in": ["born in", "birthplace", "was born", "native of",
                "hails from"],
    "released_in": ["released in", "released", "came out in", "came out on",
                    "put out in", "put out on"],
    "member_of": ["member of", "joined"],
    "founded_by": ["founded by", "founded", "established by", "established",
                   "started by"],
    "located_in": ["located in", "capital of", "is a city in",
                   "is a town in"],
    "directed_by": ["directed by", "directed"],
}
_DEFAULT_SPLITTERS = [" is ", " was ", " were ", " by ", " in ", " of "]

# relations whose cue outranks position: "released in 2006 on the label X"
# carries BOTH released_in and the (rarer, more discriminative) label
# relation — the label edge is the one multi-hop chains traverse
_PRIORITY_RELS = {
    "released_on_label": ["on the label", "released on", "on label",
                          "by the label", "through the label"],
}

_YEAR_ONLY_RE = re.compile(r"(?:1[0-9]{3}|20[0-9]{2})")

# a relation cue preceded (within the clause) by a polarity inverter is an
# ANTI-fact: "It was not released on L" / "wrongly credited the label L"
# must not forge an edge into L's (live) chain
_NEG_GUARD_RE = re.compile(
    r"\b(?:not|never|wrongly|falsely|incorrectly|no longer)\b[^.;,]{0,24}$")

# relative release dating: "released ... 55 years after <anchor work>" —
# the absolute year appears nowhere, so the triple carries the offset
# expression verbatim and answer-side math resolves it through the
# anchor's released_in edge (answer/comparative.py::_year_from_graph)
_OFFSET_RE = re.compile(r"\b(\d{1,3})\s+years?\s+(after|before)\s+")


def _negated(low: str, p: int) -> bool:
    return bool(_NEG_GUARD_RE.search(low[max(0, p - 40):p]))


@functools.lru_cache(maxsize=4096)
def _cue_re(cue: str):
    return re.compile(r"(?<!\w)" + re.escape(cue) + r"(?!\w)")


def _find_cue(low: str, cue: str) -> int:
    """Cue position: single ASCII words match at WORD BOUNDARIES (a bare
    substring find let 'sings' fire inside 'pressings' and forge a
    performer edge); multiword cues carry their own boundaries and CJK
    cues have none, so both keep substring find."""
    cue = cue.lower()
    if " " not in cue and cue.isascii() and cue.isalpha():
        m = _cue_re(cue).search(low)
        return m.start() if m else -1
    return low.find(cue)

# active-voice cues name the relation from the OBJECT's perspective:
# "X founded Y" = Y founded_by X (head/tail invert); the passive "by"
# forms keep subject-side heads. "P recorded the album W" likewise keys
# W performed_by P.
_ACTIVE_INVERT_CUES = {"founded", "established", "created", "directed",
                       "recorded the album",
                       # zh active-voice verbs: subject is the agent, so
                       # the object heads the by-relation, same as English
                       "创立", "成立", "创办", "执导", "演奏", "演出"}


def extract_note_keys(
    text: str,
    entities: Sequence[str],
    rel_lexicon: Optional[Dict[str, List[str]]] = None,
    fallback_splitters: Optional[List[str]] = None,
    default_rel: str = "related_to",
    types: Optional[Dict[str, Optional[str]]] = None,
) -> Dict[str, str]:
    """Rule extraction of (head_key, rel, tail_key) from a note sentence.

    Implements the reference's note_keys contract (config/config_loader.py
    note_keys section: rel_lexicon cues + fallback_splitters): the first
    relation cue found in the text names the relation; the entity before the
    cue is the head, the first entity after it the tail. Lets LLM-free rule
    notes feed the literal-keyed NoteGraph so relation-chain answering works.
    """
    low = (text or "").lower()
    ents = [str(e) for e in entities if str(e).strip()]
    if len(ents) < 2:
        return {}
    # word-boundary search, NOT substring find: a short entity ("BA",
    # "1983") otherwise matches inside another token ("Balu") and its
    # phantom position corrupts head/tail assignment. CJK entities have no
    # word boundaries (\w matches the neighboring hanzi), so they use a
    # plain find.
    def _pos(e: str) -> int:
        el = e.lower()
        from anorag_tpu_torch.utils.text import _CJK_RE
        if _CJK_RE.search(el):
            return low.find(el)
        m = re.search(r"(?<!\w)" + re.escape(el) + r"(?!\w)", low)
        return m.start() if m else -1

    positions = {e: _pos(e) for e in ents}
    ents_in_text = sorted((e for e in ents if positions[e] >= 0),
                          key=lambda e: positions[e])
    if len(ents_in_text) < 2:
        ents_in_text = ents[:2]
        positions = {ents_in_text[0]: 0, ents_in_text[1]: len(low)}

    # relative release offset rides as an extra secondary triple on
    # whatever the sentence otherwise yields
    offset = None
    om = _OFFSET_RE.search(low)
    if om and any(c in low for c in ("released", "came out", "put out")):
        anchor = next((e for e in ents_in_text
                       if positions[e] >= om.end()), None)
        if anchor is not None and anchor != ents_in_text[0]:
            offset = {"head_key": ents_in_text[0], "rel": "released_offset",
                      "tail_key": f"{om.group(1)} years {om.group(2)} "
                                  f"{anchor}"}

    def _with_offset(result):
        if offset is None:
            return result
        if not result:
            return offset
        sks = list(result.get("secondary_keys") or [])
        if offset not in sks:
            sks.append(offset)
        result["secondary_keys"] = sks
        return result

    # priority relations first: their cue wins regardless of position, and
    # the head is the sentence SUBJECT (first entity) — "W was released in
    # 2006 on the label L" must key W --released_on_label--> L even though
    # the year entity sits closer to the cue
    priority = None
    for rel, cues in _PRIORITY_RELS.items():
        for cue in cues:
            p = _find_cue(low, cue)
            if p < 0 or _negated(low, p):
                continue
            # a label tail is never a bare year: "released on 4 March 1967"
            # must not key the date as the work's label
            tail = next((e for e in ents_in_text
                         if positions[e] > p
                         and not _YEAR_ONLY_RE.fullmatch(e)), None)
            # a label/release head is never a bare year: a fronted date
            # ("Dated on 17 June 1967, the album W ...") puts the year
            # first by position, but the WORK is the subject
            head = next((e for e in ents_in_text
                         if not _YEAR_ONLY_RE.fullmatch(e)),
                        ents_in_text[0])
            if tail is not None and tail != head:
                priority = {"head_key": head, "rel": normalize_predicate(rel),
                            "tail_key": tail}
                break
        if priority:
            break

    lexicon = rel_lexicon or _DEFAULT_REL_LEXICON
    best_rel, best_pos, best_cue = None, len(low) + 1, ""
    for rel, cues in lexicon.items():
        for cue in cues:
            p = _find_cue(low, cue)
            if 0 <= p < best_pos and not _negated(low, p):
                best_rel, best_pos, best_cue = rel, p, cue.lower()
    if best_rel is None:
        # lemma-cued fallback BEFORE the generic splitters: open phrasings
        # ("W is a recording by P", "the imprint behind W") carry the
        # relation in a content word the exact-cue pass missed; a stemmed
        # lemma hit recovers the typed edge instead of a junk default_rel
        from anorag_tpu_torch.utils.lexnorm import lemma_extract
        lemma_triples = lemma_extract(text, ents_in_text, positions, lexicon,
                                      types=types)
        if lemma_triples:
            if priority is not None:
                # the priority (label) triple keys the note, lemma triples
                # ride as secondary edges — same convention as the exact
                # cue path below
                result = dict(priority)
                result["secondary_keys"] = [
                    t for t in lemma_triples if t["rel"] != result["rel"]]
                if not result["secondary_keys"]:
                    result.pop("secondary_keys")
            else:
                result = dict(lemma_triples[0])
                if len(lemma_triples) > 1:
                    result["secondary_keys"] = lemma_triples[1:]
            return _with_offset(result)
    if best_rel is None:
        for sp in (fallback_splitters or _DEFAULT_SPLITTERS):
            p = low.find(sp)
            if p >= 0:
                best_rel, best_pos, best_cue = default_rel, p, sp
                break
    if best_rel is None:
        return _with_offset(priority or {})
    head = next((e for e in reversed(ents_in_text) if positions[e] < best_pos),
                ents_in_text[0])
    tail = next((e for e in ents_in_text if positions[e] > best_pos and e != head),
                None)
    if tail is None:
        tail = next((e for e in ents_in_text if e != head), None)
    if tail is None:
        return _with_offset(priority or {})
    if (best_rel == "born_in"
            and low[best_pos + len(best_cue):].lstrip().startswith("of")
            and positions.get(head, -1) < best_pos
            and positions.get(tail, len(low)) > best_pos):
        # relational-noun inversion: "<place> is the birthplace of <person>"
        # possesses the relation through "of" — the person is the head
        head, tail = tail, head
        # "Tucson, Arizona is the birthplace of P": the place is the
        # comma-run's FIRST member (the city), not the nearest entity
        # before the cue (the state)
        changed = True
        while changed:
            changed = False
            for e in ents_in_text:
                gap = low[positions[e] + len(e):positions.get(tail, 0)]
                if (e != tail and e != head
                        and 0 <= positions[e] < positions.get(tail, 0)
                        and gap.strip() == ","):
                    tail = e
                    changed = True
                    break
    elif (best_cue in _ACTIVE_INVERT_CUES
            and not low[best_pos + len(best_cue):].lstrip().startswith("by")):
        # active voice: "X founded Y" -> Y founded_by X
        head, tail = tail, head
    regular = {"head_key": head, "rel": normalize_predicate(best_rel),
               "tail_key": tail}

    def _merge_lemma(result: Dict[str, str]) -> Dict[str, str]:
        # ADDITIVE lemma/typed pass: an exact cue claiming the sentence
        # must not hide the facts only a lemma or the type signature can
        # see ("W — P's album — reached shelves in Y on the label L" has
        # an exact label cue, but the performed_by edge exists only via
        # the work+person type default). Only relations the exact pass
        # did NOT already assert ride in.
        from anorag_tpu_torch.utils.lexnorm import lemma_extract
        lts = lemma_extract(text, ents_in_text, positions,
                            rel_lexicon or _DEFAULT_REL_LEXICON,
                            types=types)
        have = {result.get("rel")} | {
            s.get("rel") for s in result.get("secondary_keys") or ()}
        extra = [t for t in lts if t["rel"] not in have
                 and t["head_key"] != t["tail_key"]]
        if extra:
            sks = list(result.get("secondary_keys") or [])
            for t in extra:
                if t not in sks:
                    sks.append(t)
            result["secondary_keys"] = sks
        return result

    if priority is None:
        return _with_offset(_merge_lemma(regular))
    # the sentence asserts BOTH facts ("W was released in 2006 on the
    # label L" = released_on_label AND released_in): the priority triple
    # keys the note; the regular one rides along as a secondary edge so
    # set-aggregation questions can resolve the year from the graph
    if regular["rel"] != priority["rel"]:
        priority["secondary_keys"] = [regular]
    return _with_offset(_merge_lemma(priority))


# entity-shaped subject + two commas: "W, an album by P, was released ..."
_APPOS_RE = re.compile(
    r"^([A-Z][\w'&-]*(?:\s+[A-Z][\w'&-]*)*),\s+(an?|the)\s+([^,]+),\s+(.+)$")

# fronted participial clause: "Released in 1987 on the label L, W is an
# album by P." — the grammatical subject lives AFTER the comma; raw cue
# extraction keys the participle (or whatever precedes the comma) as head
_FRONTED_RE = re.compile(
    r"^([A-Z][a-z]+(?:ed|en|ing))\s+([^,]{3,120}),\s+"
    r"((?:(?:the|a|an)\s+(?:album|record|song)\s+)?[A-Z].+)$")
_SUBJ_RE = re.compile(
    r"^(?:(?:the|a|an)\s+(?:album|record|song)\s+)?"
    r"([A-Z][\w'&-]*(?:\s+[A-Z][\w'&-]*)*)")


def expand_fronted_participle(sent: str) -> List[str]:
    """Rewrite a fronted-participial sentence as its two clauses.

    "Released in 1987 on the label L, W is an album by P." asserts the
    main-clause fact AND "W released in 1987 on the label L" — with W,
    the main clause's subject, as head of both."""
    m = _FRONTED_RE.match(sent.strip())
    if not m:
        return [sent]
    part, front, main = m.groups()
    from anorag_tpu_torch.utils.lexnorm import lemma_relation_hits
    if not lemma_relation_hits(part):      # opener isn't a relation verb
        return [sent]
    sm = _SUBJ_RE.match(main)
    if not sm:
        return [sent]
    subj = sm.group(1)
    return [main if main.endswith((".", "!", "?")) else main + ".",
            f"{subj} was {part.lower()} {front}."]


def expand_appositive(sent: str) -> List[str]:
    """Rewrite an appositive sentence as its two underlying clauses.

    "W, an album by P, was released in Y on the label L." asserts a
    copular fact (W is an album by P) AND a main-clause fact chain; cue
    extraction on the raw surface takes the nearest-entity head, which
    inside the comma clause is P — keying the PERSON as the release/label
    head. Splitting first restores the subject to both clauses."""
    m = _APPOS_RE.match(sent.strip())
    if not m:
        return [sent]
    subj, det, clause, rest = m.groups()
    return [f"{subj} is {det} {clause}.", f"{subj} {rest}"]


def extract_all_note_keys(
    text: str,
    entities: Sequence[str],
    rel_lexicon: Optional[Dict[str, List[str]]] = None,
    fallback_splitters: Optional[List[str]] = None,
    default_rel: str = "related_to",
    types: Optional[Dict[str, Optional[str]]] = None,
) -> Dict[str, str]:
    """extract_note_keys over EACH sentence of a (possibly merged
    multi-sentence) note, collecting every distinct triple: the first
    keys the note, the rest ride as secondary_keys.

    Whole-text extraction on merged notes is wrong twice over: cue
    competition ACROSS sentences keeps only one sentence's relation
    ("P recorded the album W. W was put out in Y by the label L." loses
    the label/year triples to the earlier performed_by cue), and a
    priority cue takes its head from the first entity of the TEXT, which
    in a merged note belongs to a different sentence (persons were being
    keyed as released_on_label heads, corrupting set aggregation)."""
    sents = [s for s in re.split(r"(?<=[.!?])\s+|(?<=[a-z][.!?])(?=[A-Z])",
                                 text or "") if s.strip()]
    sents = [v for s in sents for v in expand_fronted_participle(s)]
    sents = [v for s in sents for v in expand_appositive(s)]
    if len(sents) <= 1:
        return extract_note_keys(text, entities, rel_lexicon,
                                 fallback_splitters, default_rel, types)
    ents = [str(e) for e in entities if str(e).strip()]
    triples: List[Dict[str, str]] = []
    seen = set()

    def _add(k: Dict[str, str]) -> None:
        sig = (k.get("head_key"), k.get("rel"), k.get("tail_key"))
        if sig[0] == sig[2]:     # self-edges corrupt set aggregation
            return
        if all(sig) and sig not in seen:
            seen.add(sig)
            triples.append({"head_key": sig[0], "rel": sig[1],
                            "tail_key": sig[2]})

    for sent in sents:
        low = sent.lower()
        sent_ents = [e for e in ents if e.lower() in low]
        # no fallback splitters per-sentence: a merged note would sprout a
        # junk default-rel edge per sentence
        k = extract_note_keys(sent, sent_ents, rel_lexicon, [], default_rel,
                              types)
        if k:
            _add(k)
            for sk in k.get("secondary_keys") or ():
                _add(sk)
    if not triples:
        return extract_note_keys(text, entities, rel_lexicon,
                                 fallback_splitters, default_rel, types)
    primary = dict(triples[0])
    if len(triples) > 1:
        primary["secondary_keys"] = triples[1:]
    return primary


# "Full Name (FN)" — a parenthetical whose letters are the full name's
# initials introduces an alias
_ABBR_INTRO_RE = re.compile(
    r"([A-Z][\w'&-]*(?:\s+[A-Z][\w'&-]*)+)\s*\(\s*([A-Z]{2,6})\s*\)")

# "Real Name, known professionally/also as Stage Name" — facts elsewhere
# credit the STAGE surface; chains must resolve it to the real name
_STAGE_INTRO_RE = re.compile(
    r"([A-Z][\w'&-]*(?:\s+[A-Z][\w'&-]*)+),\s+(?:also\s+)?known\s+"
    r"(?:professionally\s+|also\s+)?as\s+"
    r"([A-Z][\w'&-]*(?:\s+[A-Z][\w'&-]*)*)")


def resolve_note_abbreviations(
        notes: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Corpus-level alias pass: facts stated under a bare abbreviation
    ("Denfen Music (DM) is a record label. DM was started by F.") are
    re-keyed under the full name so multi-hop chains survive the alias
    boundary. Mutates and returns `notes`. The full name is also appended
    to the note's entity list (retrieval sees both surfaces); texts are
    left untouched. Parity: the reference resolves such aliases through
    fuzzy entity-index lookups (graph/graph_retriever + EntityInvertedIndex
    fuzzy match); here the alias table is explicit and exact."""
    alias: Dict[str, str] = {}
    for n in notes:
        text = n.get("text") or ""
        for m in _ABBR_INTRO_RE.finditer(text):
            full, ab = m.group(1), m.group(2)
            initials = "".join(w[0] for w in full.split() if w[:1].isupper())
            if ab == initials and ab != full:
                alias.setdefault(ab, full)
        for m in _STAGE_INTRO_RE.finditer(text):
            real, stage = m.group(1), m.group(2)
            if stage != real:
                alias.setdefault(stage, real)
    if not alias:
        return notes
    for n in notes:
        for key in ("head_key", "tail_key"):
            v = n.get(key)
            if v in alias:
                n[key] = alias[v]
        if n.get("head_key") and n.get("head_key") == n.get("tail_key"):
            # aliasing collapsed a forged intro-sentence triple ("X (XA)
            # is a record label" -> X rel X) into a self-edge; neutralize
            # the relation so set aggregations never see it
            n["rel"] = "related_to"
        sks = []
        for sk in n.get("secondary_keys") or ():
            for key in ("head_key", "tail_key"):
                v = sk.get(key)
                if v in alias:
                    sk[key] = alias[v]
            if sk.get("head_key") != sk.get("tail_key"):
                sks.append(sk)
        if n.get("secondary_keys") is not None:
            n["secondary_keys"] = sks
        ents = n.get("entities")
        if ents:
            extra = [alias[e] for e in ents if e in alias]
            n["entities"] = ents + [e for e in extra if e not in ents]
    return notes


class NoteQualityFilter:
    """Completeness/quality gates (parity: utils/note_validator.py,
    note_completeness.py, notes_quality_filter.py in the reference)."""

    def __init__(self, min_chars: int = 20, max_chars: int = 400,
                 min_salience: float = 0.3, require_entities: bool = False,
                 require_sentence_terminal: bool = True, min_word_count: int = 4):
        self.min_chars = min_chars
        self.max_chars = max_chars
        self.min_salience = min_salience
        self.require_entities = require_entities
        self.require_sentence_terminal = require_sentence_terminal
        self.min_word_count = min_word_count

    def check(self, note: Dict[str, Any]) -> List[str]:
        issues = []
        text = (note.get("text") or note.get("content") or "").strip()
        if len(text) < self.min_chars:
            issues.append("too_short")
        if len(text) > self.max_chars:
            issues.append("too_long")
        if len(text.split()) < self.min_word_count:
            issues.append("too_few_words")
        if self.require_sentence_terminal and text and text[-1] not in ".!?\"'":
            issues.append("no_sentence_terminal")
        if self.require_entities and not note.get("entities"):
            issues.append("no_entities")
        sal = note.get("salience")
        if sal is not None and float(sal) < self.min_salience:
            issues.append("low_salience")
        return issues

    def passes(self, note: Dict[str, Any]) -> bool:
        return not self.check(note)


class AtomicNoteGenerator:
    def __init__(self, llm, cfg: Optional[Any] = None):
        from anorag_tpu_torch.config import config as global_config

        self.llm = llm
        self.cfg = cfg or global_config
        nl = self.cfg.get("notes_llm", {}) or {}
        self.sentinel = nl.get("sentinel_char", ATOMIC_NOTE_SENTINEL)
        self.retry_on_parse_error = nl.get("retry_once_on_parse_error", True)
        self.shorten_chars = nl.get("shorten_on_retry_chars", 1000)
        self.max_notes_per_chunk = nl.get("max_notes_per_chunk", 12)
        self.max_note_chars = nl.get("max_note_chars", 200)
        self.enable_rule_fallback = nl.get("enable_rule_fallback", True)
        self.entities_fallback = (nl.get("entities_fallback") or {}).get("enabled", True)
        limit = nl.get("limit") or {}
        self.limit_strategy = limit.get("strategy", "bucketed")
        self.quota_per_bucket = ((limit.get("bucket") or {}).get("quota_per_bucket", 1))
        qf = self.cfg.get("quality_filter", {}) or {}
        nc = self.cfg.get("note_completeness", {}) or {}
        nk = self.cfg.get("note_keys", {}) or {}
        self.rel_lexicon = nk.get("rel_lexicon") or None
        self.fallback_splitters = nk.get("fallback_splitters") or None
        self.default_rel = nk.get("default_rel", "related_to")
        self.filter = NoteQualityFilter(
            min_chars=nl.get("min_chars", qf.get("min_chars", 20)),
            max_chars=nl.get("max_chars", 400),
            min_salience=nl.get("min_salience", qf.get("min_salience", 0.3)),
            require_entities=qf.get("require_entities", False),
            require_sentence_terminal=nc.get("require_sentence_terminal", True),
            min_word_count=nc.get("min_word_count_en", 4),
        )
        gr = nl.get("grounding") or {}
        self.grounding_enabled = gr.get("enabled", True)
        self.grounding_min_len = int(gr.get("min_entity_len", 3))
        rp = gr.get("repair") or {}
        self.repair_enabled = rp.get("enabled", True)
        self.repair_min_ratio = float(rp.get("min_ratio", 0.66))
        self.repair_augment = rp.get("augment_uncovered", True)
        self.repair_retry = rp.get("retry", True)
        self.early_stop = StreamingEarlyStop(self.sentinel)
        self.stats = defaultdict(int)

    # --------------------------------------------------------------- entry
    def generate_atomic_notes(self, chunks: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
        self._build_type_registry(chunks)
        batch_ok = (self.cfg.get("notes_llm.batch.enabled", True)
                    and self.llm is not None
                    and (hasattr(self.llm, "generate_notes_batch")
                         or hasattr(self.llm, "batch_generate")))
        if batch_ok:
            notes = self._generate_batched(list(chunks))
        else:
            notes = []
            for chunk in chunks:
                notes.extend(self.generate_for_chunk(chunk))
        logger.info("generated %d notes from %d chunks (%s)",
                    len(notes), len(chunks), dict(self.stats))
        self.maybe_evaluate_coverage(chunks, notes)
        return notes

    def _build_type_registry(self, chunks: Sequence[Dict[str, Any]]) -> None:
        """Corpus-level entity-type registry (utils/semtype.py): one pass
        over every sentence of every chunk BEFORE note generation, so a
        single clearly-typed mention anywhere ("W is an album by P")
        orients every openly-phrased restatement of the same entities.
        Cheap string scans (the rule path re-does the same splits)."""
        from anorag_tpu_torch.utils.semtype import EntityTypeRegistry
        from anorag_tpu_torch.utils.text import (extract_entities_fallback,
                                           split_sentences)
        reg = EntityTypeRegistry()
        for chunk in chunks or ():
            text = str(chunk.get("text") or chunk.get("content") or "")
            for s in split_sentences(text):
                s = normalize_sentence(s.strip())
                ents = extract_entities_fallback(s)
                if ents:
                    reg.observe(s, ents)
        self._type_registry = reg

    def _types_for(self, entities: Sequence[str]
                   ) -> Optional[Dict[str, Optional[str]]]:
        reg = getattr(self, "_type_registry", None)
        if reg is None or not len(reg) or not entities:
            return None
        return reg.types_for(entities)

    def _generate_batched(self, chunks: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Batched variant of the per-chunk loop: ONE batch_generate call
        per round (all prompts, then all parse-retry prompts) instead of a
        request per chunk. Behavior matches generate_for_chunk exactly —
        sentinel empty, parse retry on a shortened chunk, rule fallback —
        only the transport is amortized (the in-process jax provider turns
        each round into a few compiled device calls; HTTP providers fall
        back to an internal loop)."""
        _EMPTY: List[Any] = []
        prompts: List[str] = []
        idx_map: List[int] = []
        for i, ch in enumerate(chunks):
            text = ch.get("text") or ""
            if not text.strip():
                continue
            sentences = ch.get("sentences") or split_sentences(text)
            prompts.append(build_atomic_note_prompt(
                text, sentences, ch.get("entity_cards") or []))
            idx_map.append(i)
        raws = self._call_batch(prompts)
        parsed_map: Dict[int, Optional[List[Any]]] = {}
        retry_prompts: List[str] = []
        retry_idx: List[int] = []
        for i, raw in zip(idx_map, raws):
            if StreamingEarlyStop.is_empty_result(raw, self.sentinel):
                self.stats["sentinel_empty"] += 1
                parsed_map[i] = _EMPTY
                continue
            parsed = extract_json(raw)
            if isinstance(parsed, list):
                parsed_map[i] = parsed
                continue
            self.stats["parse_fail"] += 1
            if self.retry_on_parse_error:
                short = (chunks[i].get("text") or "")[: self.shorten_chars]
                retry_prompts.append(build_atomic_note_prompt(
                    short, split_sentences(short),
                    chunks[i].get("entity_cards") or []))
                retry_idx.append(i)
            else:
                parsed_map[i] = None
        if retry_prompts:
            for i, raw in zip(retry_idx, self._call_batch(retry_prompts)):
                parsed = extract_json(raw)
                if isinstance(parsed, list):
                    self.stats["parse_retry_ok"] += 1
                    parsed_map[i] = parsed
                else:
                    parsed_map[i] = None
        # grounding: verify -> snap-repair -> one regeneration round ->
        # extractive augment -> only then rule fallback (VERDICT r3 #2:
        # the round-3 gate rejected whole chunks back to rule notes on
        # any slip; repair keeps the model's output in the KB)
        need_fix: List[int] = []
        for i, ch in enumerate(chunks):
            parsed = parsed_map.get(i, _EMPTY)
            if parsed is None or parsed is _EMPTY:
                continue
            if self._llm_notes_verified(parsed, ch):
                continue
            if self.repair_enabled:
                fixed = self._repair_notes(parsed, ch, augment=False)
                if fixed is not None and self._grounding_ok(fixed, ch):
                    parsed_map[i] = fixed
                    self.stats["grounding_repair_ok"] += 1
                    continue
            need_fix.append(i)
        if need_fix and self.repair_enabled and self.repair_retry:
            self.stats["grounding_retry"] += len(need_fix)
            g_prompts = []
            for i in need_fix:
                short = (chunks[i].get("text") or "")[: self.shorten_chars]
                g_prompts.append(build_atomic_note_prompt(
                    short, split_sentences(short),
                    chunks[i].get("entity_cards") or []))
            still: List[int] = []
            for i, raw in zip(need_fix, self._call_batch(g_prompts)):
                p2 = extract_json(raw)
                if isinstance(p2, list) and p2:
                    if self._grounding_ok(p2, chunks[i]):
                        parsed_map[i] = p2
                        self.stats["grounding_retry_ok"] += 1
                        continue
                    f2 = self._repair_notes(p2, chunks[i], augment=False)
                    if f2 is not None and self._grounding_ok(f2, chunks[i]):
                        parsed_map[i] = f2
                        self.stats["grounding_retry_ok"] += 1
                        continue
                still.append(i)
            need_fix = still
        for i in need_fix:
            fixed = (self._repair_notes(parsed_map[i], chunks[i],
                                        augment=True)
                     if self.repair_enabled and self.repair_augment
                     else None)
            if fixed is not None and self._grounding_ok(fixed, chunks[i]):
                parsed_map[i] = fixed
                self.stats["grounding_augment_ok"] += 1
            else:
                self.stats["grounding_fallback"] += 1
                parsed_map[i] = None
        notes: List[Dict[str, Any]] = []
        for i, ch in enumerate(chunks):
            parsed = parsed_map.get(i, _EMPTY)
            from_rule = False
            if parsed is None:
                if not self.enable_rule_fallback:
                    continue
                self.stats["rule_fallback"] += 1
                text = ch.get("text") or ""
                parsed = self._rule_fallback(
                    text, ch.get("sentences") or split_sentences(text),
                    title=ch.get("title") or "")
                from_rule = True
            elif parsed is not _EMPTY:
                parsed = self._merged_raw(parsed)
            if parsed:
                notes.extend(self._post_process(parsed, ch,
                                                lift_quota=from_rule))
        return notes

    @staticmethod
    def _clip_sentences(text: str, max_chars: int) -> str:
        """Clip to max_chars at a SENTENCE boundary. A hard slice cuts
        mid-sentence, the trailing fragment fails the quality filter's
        sentence-terminal gate, and the whole merged note silently
        vanishes (measured: 4-sentence paragraphs lost their merged
        info-complete note and the per-paragraph quota kept one
        arbitrary sentence fact)."""
        text = text.strip()
        if len(text) <= max_chars:
            return text
        sents = re.split(r"(?<=[.!?])\s+", text)
        out = ""
        for s in sents:
            cand = f"{out} {s}".strip()
            if out and len(cand) > max_chars:
                break
            out = cand
        return out[:max_chars] if out else text[:max_chars]

    def _merged_raw(self, parsed: List[Any]) -> List[Any]:
        """Prepend a merged info-complete note to a multi-note LLM output.

        The bucketed per-paragraph quota (notes_llm.limit, quota 1)
        assumes one information-COMPLETE note per paragraph; the rule
        fallback builds that merged note itself, but a multi-note LLM
        output left the quota keeping only the single highest-salience
        fact — measured on the synthetic KB: every release-year/label
        fact vanished and LLM-notes mode answered from distractors. The
        merged note carries the union of the notes' text (keys re-derived
        per sentence by extract_all_note_keys, same as the rule path's
        merged note) and outranks the parts under the quota."""
        notes = [r for r in parsed if isinstance(r, dict)
                 and str(r.get("text") or "").strip()]
        if len(notes) <= 1:
            return parsed
        ents: List[str] = []
        for r in notes:
            for e in (r.get("entities") or []):
                e = str(e)
                if e and e not in ents:
                    ents.append(e)
        sal = max(float(r.get("salience", 0.5) or 0.5) for r in notes)
        merged = {
            "text": self._clip_sentences(
                " ".join(str(r.get("text")).strip() for r in notes),
                self.max_note_chars),
            "entities": ents[:16],
            "source_sent_ids": sorted(
                {int(s) for r in notes
                 for s in (r.get("source_sent_ids") or [])
                 if str(s).lstrip("-").isdigit()}),
            "salience": min(1.0, sal + 0.1),
        }
        self.stats["llm_merged_note"] += 1
        return [merged] + list(parsed)

    # ------------------------------------------------------- grounding gate
    _GROUND_YEAR_RE = re.compile(r"\b(?:1[89]\d{2}|20\d{2})\b")

    def _llm_notes_verified(self, parsed: List[Any],
                            chunk: Dict[str, Any]) -> bool:
        """Grounding + coverage gate on LLM-authored notes.

        Atomic notes are extractive by contract (ref
        llm/atomic_note_generator.py quality filtering +
        llm/summary_auditor.py NER-diff audit): every entity and year a
        note asserts must occur in the source chunk, and every entity
        and year the chunk asserts must be carried by some note.
        Autoregressive note models confabulate typical-shaped
        continuations (an entity or year that fits the template but not
        THIS chunk) and silently drop facts; either failure poisons the
        downstream note graph, so the chunk's LLM output is rejected as
        a whole and the rule fallback takes over (stats:
        ungrounded_note / uncovered_fact -> grounding_fallback)."""
        if not self.grounding_enabled:
            return True
        ungrounded, uncovered = self._grounding_failures(parsed, chunk)
        if ungrounded:
            self.stats["ungrounded_note"] += 1
            return False
        if uncovered:
            self.stats["uncovered_fact"] += 1
            return False
        return True

    def _present(self, surface: str, blob: str) -> bool:
        s = (surface or "").strip().casefold()
        if len(s) < self.grounding_min_len and not s.isdigit():
            return True
        return re.search(r"(?<!\w)" + re.escape(s) + r"(?!\w)",
                         blob) is not None

    def _grounding_failures(self, parsed: List[Any],
                            chunk: Dict[str, Any]):
        """Both gate directions WITHOUT short-circuiting: repair needs the
        full failure lists, not the first offender."""
        src = ((chunk.get("text") or "") + " " +
               (chunk.get("title") or "")).casefold()
        ungrounded: List[str] = []
        note_blob_parts: List[str] = []
        for raw in parsed:
            if not isinstance(raw, dict):
                continue
            ntext = str(raw.get("text") or "")
            note_blob_parts.append(ntext)
            surfaces = [str(e) for e in (raw.get("entities") or [])]
            surfaces += self._GROUND_YEAR_RE.findall(ntext)
            for s in surfaces:
                if s and not self._present(s, src):
                    ungrounded.append(s)
        blob = " ".join(note_blob_parts).casefold()
        text = chunk.get("text") or ""
        required = set(self._GROUND_YEAR_RE.findall(text))
        required.update(e for e in extract_entities_fallback(text)
                        if len(e) >= self.grounding_min_len)
        uncovered = [s for s in required if not self._present(s, blob)]
        return ungrounded, uncovered

    def _grounding_ok(self, parsed: List[Any],
                      chunk: Dict[str, Any]) -> bool:
        """Stat-free re-verification (repair passes call this repeatedly;
        only the FIRST failure should count in stats)."""
        if not self.grounding_enabled:
            return True
        u, c = self._grounding_failures(parsed, chunk)
        return not u and not c

    def _repair_notes(self, parsed: List[Any], chunk: Dict[str, Any],
                      augment: bool) -> Optional[List[Any]]:
        """Repair LLM notes instead of rejecting the chunk wholesale.

        Autoregressive byte-level note models mostly fail by SMALL
        corruption — an entity off by a character, a year off by a
        digit, one fact dropped — and rejecting the whole chunk output
        (the round-3 gate) routed the pipeline back to rule notes on
        every such slip. Repair keeps the model in the loop: (1) snap
        each ungrounded entity to its closest source surface (difflib
        ratio >= notes_llm.grounding.repair.min_ratio) in both the
        entities list and the note text; (2) snap off-by-one-digit years
        to the unique close source year; (3) drop notes whose surfaces
        have no close source match (confabulation, not corruption); and
        optionally (4, augment=True) patch remaining coverage holes with
        extractive notes built from the exact source sentences that
        carry the missing surfaces. Returns the repaired list, or None
        when nothing survives."""
        import difflib

        text = chunk.get("text") or ""
        title = chunk.get("title") or ""
        src = (text + " " + title).casefold()
        src_entities = extract_entities_fallback(text + " " + title)
        if title and title not in src_entities:
            src_entities.append(title)
        src_years = list(dict.fromkeys(self._GROUND_YEAR_RE.findall(text)))
        out: List[Dict[str, Any]] = []
        for raw in parsed:
            if not isinstance(raw, dict):
                continue
            ntext = str(raw.get("text") or "")
            ents = [str(e) for e in (raw.get("entities") or [])]
            ok = True
            for j, e in enumerate(ents):
                if self._present(e, src):
                    continue
                best, best_r = None, 0.0
                for c in src_entities:
                    r = difflib.SequenceMatcher(
                        None, e.casefold(), c.casefold()).ratio()
                    if r > best_r:
                        best, best_r = c, r
                if best is not None and best_r >= self.repair_min_ratio:
                    ents[j] = best
                    ntext = re.sub(
                        r"(?<!\w)" + re.escape(e) + r"(?!\w)",
                        best.replace("\\", r"\\"), ntext,
                        flags=re.IGNORECASE)
                    self.stats["repaired_entity"] += 1
                else:
                    self.stats["dropped_ungrounded_note"] += 1
                    ok = False
                    break
            if not ok:
                continue
            for y in set(self._GROUND_YEAR_RE.findall(ntext)):
                if self._present(y, src):
                    continue
                close = [c for c in src_years if len(c) == len(y)
                         and sum(a != b for a, b in zip(y, c)) <= 1]
                if len(close) == 1:
                    ntext = re.sub(r"(?<!\w)" + y + r"(?!\w)", close[0],
                                   ntext)
                    self.stats["repaired_year"] += 1
                else:
                    self.stats["dropped_ungrounded_note"] += 1
                    ok = False
                    break
            if not ok:
                continue
            fixed = dict(raw)
            fixed["text"] = ntext
            fixed["entities"] = ents
            out.append(fixed)
        if augment:
            sentences = chunk.get("sentences") or split_sentences(text)
            blob = " ".join(str(r.get("text") or "")
                            for r in out).casefold()
            required = set(self._GROUND_YEAR_RE.findall(text))
            required.update(e for e in extract_entities_fallback(text)
                            if len(e) >= self.grounding_min_len)
            add_sids: List[int] = []
            for s in required:
                if self._present(s, blob):
                    continue
                for i, sent in enumerate(sentences):
                    if i not in add_sids and self._present(
                            s, sent.casefold()):
                        add_sids.append(i)
                        break
            for i in sorted(add_sids):
                sent = sentences[i].strip()
                out.append({"text": sent[: self.max_note_chars],
                            "entities": extract_entities_fallback(sent),
                            "source_sent_ids": [i], "salience": 0.45})
                self.stats["augmented_note"] += 1
        return out or None

    def _call_batch(self, prompts: List[str]) -> List[str]:
        if not prompts:
            return []
        try:
            if hasattr(self.llm, "generate_notes_batch"):
                return self.llm.generate_notes_batch(prompts)
            from anorag_tpu_torch.llm.prompts import ATOMIC_NOTE_SYSTEM

            return self.llm.batch_generate(prompts,
                                           system_prompt=ATOMIC_NOTE_SYSTEM)
        except Exception as e:
            logger.warning("note LLM batch call failed: %s", e)
            self.stats["llm_error"] += len(prompts)
            return [""] * len(prompts)

    def maybe_evaluate_coverage(self, chunks, notes) -> None:
        """Source-coverage debug report when evaluation.coverage.enabled
        (ref llm/atomic_note_generator.py:24 -> utils/note_coverage_eval.py:46).
        Called by every generation path, including the LLM-free rule one."""
        cov = self.cfg.get("evaluation.coverage", {}) or {}
        if not cov.get("enabled"):
            return
        from anorag_tpu_torch.llm.note_quality import evaluate_note_coverage

        result = evaluate_note_coverage(
            chunks, notes,
            threshold=float(cov.get("threshold", 0.6)),
            min_sentence_tokens=int(cov.get("min_sentence_tokens", 6)),
            critical_threshold=float(cov.get("critical_threshold", 0.5)),
            report_path=cov.get("report_path"),
            missing_path=cov.get("missing_sentences_path"),
        )
        self.stats["coverage_mean_pct"] = int(100 * result["mean_coverage"])

    def generate_for_chunk(self, chunk: Dict[str, Any]) -> List[Dict[str, Any]]:
        text = chunk.get("text") or ""
        if not text.strip():
            return []
        sentences = chunk.get("sentences") or split_sentences(text)
        prompt = build_atomic_note_prompt(text, sentences,
                                          chunk.get("entity_cards") or [])
        raw = self._call(prompt)
        if StreamingEarlyStop.is_empty_result(raw, self.sentinel):
            self.stats["sentinel_empty"] += 1
            return []
        parsed = extract_json(raw)
        if not isinstance(parsed, list):
            self.stats["parse_fail"] += 1
            if self.retry_on_parse_error:
                short = text[: self.shorten_chars]
                retry_prompt = build_atomic_note_prompt(
                    short, split_sentences(short), chunk.get("entity_cards") or []
                )
                parsed = extract_json(self._call(retry_prompt))
                if isinstance(parsed, list):
                    self.stats["parse_retry_ok"] += 1
        if (isinstance(parsed, list) and parsed
                and not self._llm_notes_verified(parsed, chunk)):
            # repair -> retry -> augment -> fallback (mirror of the
            # batched path; see _generate_batched)
            fixed = (self._repair_notes(parsed, chunk, augment=False)
                     if self.repair_enabled else None)
            if fixed is not None and self._grounding_ok(fixed, chunk):
                self.stats["grounding_repair_ok"] += 1
                parsed = fixed
            else:
                if self.repair_enabled and self.repair_retry:
                    self.stats["grounding_retry"] += 1
                    short = text[: self.shorten_chars]
                    p2 = extract_json(self._call(build_atomic_note_prompt(
                        short, split_sentences(short),
                        chunk.get("entity_cards") or [])))
                    if isinstance(p2, list) and p2:
                        if self._grounding_ok(p2, chunk):
                            self.stats["grounding_retry_ok"] += 1
                            parsed, fixed = p2, p2
                        else:
                            f2 = self._repair_notes(p2, chunk,
                                                    augment=False)
                            if f2 is not None and \
                                    self._grounding_ok(f2, chunk):
                                self.stats["grounding_retry_ok"] += 1
                                parsed, fixed = f2, f2
                if fixed is None or not self._grounding_ok(fixed, chunk):
                    aug = (self._repair_notes(parsed, chunk, augment=True)
                           if self.repair_enabled and self.repair_augment
                           else None)
                    if aug is not None and self._grounding_ok(aug, chunk):
                        self.stats["grounding_augment_ok"] += 1
                        parsed = aug
                    else:
                        self.stats["grounding_fallback"] += 1
                        parsed = None
        from_rule = False
        if not isinstance(parsed, list):
            if self.enable_rule_fallback:
                self.stats["rule_fallback"] += 1
                parsed = self._rule_fallback(text, sentences,
                                             title=chunk.get("title") or "")
                from_rule = True
            else:
                return []
        else:
            parsed = self._merged_raw(parsed)
        return self._post_process(parsed, chunk, lift_quota=from_rule)

    def _call(self, prompt: str) -> str:
        try:
            if hasattr(self.llm, "generate_notes"):
                return self.llm.generate_notes(prompt)
            return self.llm.generate(prompt)
        except Exception as e:
            logger.warning("note LLM call failed: %s", e)
            self.stats["llm_error"] += 1
            return ""

    # ------------------------------------------------------------ fallback
    _LEAD_PRONOUN = re.compile(
        r"^(It|He|She|They|This|The (?:album|song|film|band|label|company))\b")

    def _rule_fallback(self, text: str, sentences: Sequence[str],
                       title: str = "") -> List[Dict[str, Any]]:
        """One note per informative sentence, PLUS a merged chunk-level note
        at higher salience when several sentences qualify.

        The bucketed per-paragraph quota (notes_llm.limit, quota 1 — the
        reference default) assumes the LLM distilled the paragraph into one
        information-COMPLETE note; per-sentence rule notes under that quota
        kept an arbitrary single fact and dropped the rest (measured: every
        'born in <city>' fact vanished from the LLM-free KB, answer EM 0.00
        on where-questions). The merged note carries the union of facts and
        wins the quota; sentence notes still surface when the quota allows.

        Leading pronouns resolve to the running subject (previous
        sentence's first entity, seeded from the title): 'It was released
        on the label L' otherwise keys the YEAR as head and the work's
        label edge never enters the note graph."""
        # seed the subject from the title sans parenthetical ("W (album)").
        # Only an ENTITY-SHAPED title counts — pipeline chunk titles are
        # often ids ("heldout_8", "doc_7"), and seeding those as the topic
        # blocks the folded-first-sentence recovery below
        subject = re.sub(r"\s*\(.*?\)\s*$", "", title or "").strip()
        if not re.fullmatch(r"[A-Z][\w'&.-]*(?:\s+[A-Z0-9][\w'&.-]*)*",
                            subject or ""):
            subject = ""
        # neuter pronouns (It/This/The album ...) refer to the paragraph's
        # TOPIC (the title-seeded subject), not the running subject: in
        # "P recorded the album W. It was put out ... by the label L" the
        # running subject is the person P, but "It" is the work W —
        # resolving to P keyed the person as the label edge's head and the
        # work's label/year facts vanished from the graph
        title_subject = subject
        topic_paren = (re.search(r"\(([^)]*)\)", title or "") or [None, ""])[1]
        if not title_subject and sentences:
            # chunkers fold the paragraph title into the text as a leading
            # "Title (type)." sentence (doc/chunker.py _paragraph_payloads)
            # while chunk.title holds the DOCUMENT title — recover the
            # topic (and its parenthetical type marker) from a title-shaped
            # first sentence
            m = re.fullmatch(
                r"([A-Z][\w'&-]*(?:\s+[A-Z][\w'&-]*)*)\s*(?:\(([^)]*)\))?"
                r"\s*\.?",
                sentences[0].strip())
            if m:
                title_subject = m.group(1)
                topic_paren = m.group(2) or topic_paren
        # surname -> full name, first introduction wins (the paragraph's
        # topic is introduced first): "Aurora Lane married X. Lane was
        # born in Boston." must key born_in under the FULL name or the
        # graph hop through the person breaks
        surname_to_full: Dict[str, str] = {}

        def _learn_fulls(names: Sequence[str]) -> None:
            for e in names:
                parts = str(e).split()
                if len(parts) >= 2 and parts[-1][:1].isupper():
                    surname_to_full.setdefault(parts[-1], str(e))

        _learn_fulls([n for n in (subject, title_subject) if n])
        out = []
        for i, s in enumerate(sentences):
            s = normalize_sentence(s.strip())
            if len(s) < self.filter.min_chars:
                continue
            if title_subject:
                # object/possessive neuter pronouns also refer to the
                # paragraph TOPIC: "The label L released it in 1974" /
                # "Its release came via the label L" otherwise key the
                # label or the year as the work's head and the work's
                # release facts vanish from the graph
                s2 = re.sub(r"\breleased (?:it|them)\b",
                            f"released {title_subject}", s)
                if s2.startswith("Its "):
                    s2 = f"{title_subject}'s " + s2[len("Its "):]
                # on a WORK page every neuter pronoun is the work: "the
                # label L made it available" otherwise keys the year/label
                # as head (d1 kind 8). Gated on the corpus type registry —
                # on person pages "it" may be a mentioned work, so only
                # the verb-specific rule above applies there.
                topic_t = (self._types_for([title_subject]) or {}).get(
                    title_subject)
                if topic_t == "work" or (topic_paren or "").lower() in (
                        "album", "song", "record", "single", "ep"):
                    s2 = re.sub(r"(?<=[\s(])it(?=[\s,.;:!?)])",
                                title_subject, s2)
                    s2 = re.sub(r"(?<=[\s(])its(?=\s)",
                                f"{title_subject}'s", s2)
                # on a PERSON page He/She refers to the topic at ANY
                # position, wiki-style ("By birth, She belongs to Austin"
                # — the fronted adverbial hides the pronoun from the
                # sentence-initial pass below)
                if topic_t == "person" or (topic_t is None
                                           and "(" not in (title or "")):
                    s2 = re.sub(r"\b(?:[Hh]e|[Ss]he)\b", title_subject, s2)
                if s2 != s:
                    # re-canonicalize: the resolved object may now match
                    # an active-voice rewrite (idempotent pass)
                    s = normalize_sentence(s2)
            ents = extract_entities_fallback(s)
            # surname -> full name at ANY position (wiki prose refers back
            # by surname mid-sentence too: "... was the setting of Fento's
            # birth"); only when the surname stands alone — not preceded
            # by another capitalized token (part of a longer name)
            for e in list(ents):
                if " " in e:
                    continue
                full = surname_to_full.get(e)
                if not full or full == e or full in s:
                    continue
                mm = re.search(r"(?<![\w'])" + re.escape(e) + r"(?![\w'])", s)
                if not mm:
                    continue
                prev = re.search(r"([A-Za-z'&-]+)\s*$", s[:mm.start()])
                if prev and prev.group(1)[:1].isupper():
                    continue
                s = s[:mm.start()] + full + s[mm.end():]
                ents = [full if x == e else x for x in ents]
            m = self._LEAD_PRONOUN.match(s)
            # "The album <Entity> ..." is NOT anaphoric — the entity is
            # named right there; replacing doubled the name ("Denon Signal
            # Denon Signal") and the doubled surface defeated the type
            # registry downstream
            if m and m.group(1).startswith("The ") and \
                    re.match(r"\s+[A-Z]", s[m.end():]):
                m = None
            if m and (subject or title_subject):
                neuter = m.group(1) in ("It", "This") or \
                    m.group(1).startswith("The ")
                # He/She on a PERSON page (plain title, no "(album)"-style
                # type suffix) refers to the page topic, wiki-style — the
                # running subject may be a spouse the previous sentence
                # introduced first ("Lutofen is Netosha's spouse. She's
                # place of birth is Atlanta." — She is Netosha)
                person_page = (m.group(1) in ("He", "She")
                               and title_subject
                               and "(" not in (title or ""))
                ref = (title_subject if (neuter or person_page)
                       and title_subject
                       else subject or title_subject)
                s = ref + s[m.end():]
                if ref not in ents:
                    ents = [ref] + ents
            elif ents:
                subject = ents[0]
            _learn_fulls(ents)
            out.append({
                "text": s[: self.max_note_chars],
                "entities": ents,
                "source_sent_ids": [i],
                "salience": 0.5,
            })
        if len(out) > 1:
            merged_ents: List[str] = []
            for n in out:
                for e in n["entities"]:
                    if e not in merged_ents:
                        merged_ents.append(e)
            merged = {
                "text": self._clip_sentences(
                    " ".join(n["text"] for n in out), self.max_note_chars),
                "entities": merged_ents[:16],
                "source_sent_ids": sorted({s for n in out for s in n["source_sent_ids"]}),
                "salience": 0.6,
            }
            out = [merged] + out
        return out[: self.max_notes_per_chunk]

    # -------------------------------------------------------- post process
    def _post_process(self, raw_notes: List[Any], chunk: Dict[str, Any],
                      lift_quota: bool = False) -> List[Dict[str, Any]]:
        doc_id = str(chunk.get("doc_id", "unknown"))
        chunk_index = int(chunk.get("chunk_index", 0))
        allowed = chunk.get("sentence_ids")
        allowed_set = set(int(x) for x in allowed) if allowed else None
        sentences = chunk.get("sentences") or split_sentences(chunk.get("text") or "")

        out: List[Dict[str, Any]] = []
        for raw in raw_notes[: self.max_notes_per_chunk]:
            if not isinstance(raw, dict):
                continue
            text = str(raw.get("text") or "").strip()[: self.max_note_chars]
            if not text:
                continue
            sids_raw = [int(s) for s in (raw.get("source_sent_ids") or [])
                        if str(s).lstrip("-").isdigit()]
            if allowed_set is not None and sids_raw and not set(sids_raw) <= allowed_set:
                self.stats["sent_id_violation"] += 1
                continue
            sids = [s for s in sids_raw if 0 <= s < len(sentences)]
            entities = [str(e) for e in (raw.get("entities") or []) if str(e).strip()]
            if not entities and self.entities_fallback:
                entities = extract_entities_fallback(text)
            raw_span = " ".join(sentences[s] for s in sids) if sids else text
            note = normalize_note({
                "note_id": stable_note_id(doc_id, chunk_index, text),
                "doc_id": doc_id,
                "chunk_index": chunk_index,
                "title": chunk.get("title") or chunk.get("document_title") or "",
                "content": text,
                "text": text,
                "raw_span": raw_span,
                "entities": entities,
                "paragraph_idxs": self._paragraph_idxs(raw, chunk),
                "source_sent_ids": sids,
                "salience": float(raw.get("salience", 0.5) or 0.5),
                "head_key": str(raw.get("head_key") or ""),
                "rel": normalize_predicate(raw.get("rel")),
                "tail_key": str(raw.get("tail_key") or ""),
            })
            # LLM-provided secondary triples (the distilled models emit
            # them; dropping them loses edges)
            extra_triples: List[Dict[str, str]] = []
            for sk in (raw.get("secondary_keys") or []):
                if not isinstance(sk, dict):
                    continue
                sh = str(sk.get("head_key") or "")
                st = str(sk.get("tail_key") or "")
                if sh and st:
                    extra_triples.append(
                        {"head_key": sh,
                         "rel": normalize_predicate(sk.get("rel")),
                         "tail_key": st})
            if not note["head_key"] or not note["tail_key"]:
                keys = extract_all_note_keys(
                    text, entities, self.rel_lexicon,
                    self.fallback_splitters, self.default_rel,
                    types=self._types_for(entities))
                if keys:
                    note.update(keys)
            else:
                # the model named ONE primary triple, but its note text
                # may pack the whole paragraph's facts (the distilled
                # one-note-per-paragraph format): harvest rule triples
                # from the text too, or every fact past the first
                # vanishes from the note graph (measured: LLM-notes KBs
                # carried one edge per paragraph, EM 0.21 vs 1.00 rule)
                keys = extract_all_note_keys(
                    text, entities, self.rel_lexicon,
                    self.fallback_splitters, self.default_rel,
                    types=self._types_for(entities))
                if keys:
                    extra_triples.append(
                        {k: keys[k] for k in
                         ("head_key", "rel", "tail_key")})
                    extra_triples += list(keys.get("secondary_keys") or [])
            if extra_triples:
                prim = (note.get("head_key"), note.get("rel"),
                        note.get("tail_key"))
                sec = list(note.get("secondary_keys") or [])
                seen_sigs = {prim} | {
                    (d.get("head_key"), d.get("rel"), d.get("tail_key"))
                    for d in sec}
                for d in extra_triples:
                    sig = (d.get("head_key"), d.get("rel"),
                           d.get("tail_key"))
                    if all(sig) and sig not in seen_sigs:
                        seen_sigs.add(sig)
                        sec.append(d)
                if sec:
                    note["secondary_keys"] = sec
            if self.filter.passes(note):
                out.append(note)
            else:
                self.stats["quality_filtered"] += 1
        return self._apply_limits(out, lift_quota=lift_quota)

    @staticmethod
    def _paragraph_idxs(raw: Dict[str, Any], chunk: Dict[str, Any]) -> List[int]:
        """chunk.paragraph_idx always leads (the reference's unified
        priority, atomic_note_generator.py:585-607)."""
        cur = [int(x) for x in (raw.get("paragraph_idxs") or [])
               if str(x).lstrip("-").isdigit()]
        pid = chunk.get("paragraph_idx")
        if pid is not None and str(pid).lstrip("-").isdigit():
            pid = int(pid)
            cur = [pid] + [i for i in cur if i != pid]
        return cur

    def _apply_limits(self, notes: List[Dict[str, Any]],
                      lift_quota: bool = False) -> List[Dict[str, Any]]:
        """lift_quota: rule-fallback notes are one-per-sentence atomic
        facts — the per-paragraph quota's premise (one info-complete LLM
        note per paragraph) does not hold for them, and capping drops
        relation triples the note graph needs (the LLM-free path lifts
        the quota the same way, doc/processor.py::_RuleNoteGenerator)."""
        if self.limit_strategy != "bucketed" or not notes:
            return notes
        base_quota = self.quota_per_bucket
        if lift_quota:
            base_quota = max(base_quota, 8)
        buckets: Dict[Any, List[Dict[str, Any]]] = defaultdict(list)
        for n in notes:
            key = (n.get("paragraph_idxs") or [None])[0]
            buckets[key].append(n)
        out = []
        for key, group in buckets.items():
            group.sort(key=lambda n: -float(n.get("salience", 0.5)))
            quota = base_quota if key is not None else len(group)
            out.extend(group[: max(quota, 1)])
        return out
