"""Counterpart of anorag_tpu/answer/answer_selector.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Relation-chain answer selector.

Parity target: upstream pipeline/answer_selector.py:24-130 (+ root
shim answer_selector.py) — extract a relation chain from the question (e.g.
performer -> spouse), beam_search over the NoteGraph from anchor keys, and
answer verbatim with the terminal key of the best completed path. Applied
before the LLM when `answer_selector.apply_before_llm` is on.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

from anorag_tpu_torch.graph.beam_search import beam_search
from anorag_tpu_torch.graph.note_graph import NoteGraph
from anorag_tpu_torch.utils.text import extract_entities_fallback

# question cue -> relation
_CUE_RELS = [
    (r"\bspouse\b|\bmarried\b|\bwife\b|\bhusband\b", "spouse_of|partner_of"),
    (r"\bperform(?:ed|er|s)?\b|\bsing(?:er|s)?\b|\bsang\b"
     # agentive paraphrases: "the artist behind W" names the performer
     # relation without any performance verb
     r"|\b(?:artist|band|musician|group|voice|act)s?\s+behind\b",
     "performed_by"),
    (r"\bborn\b|\bbirthplace\b", "born_in"),
    (r"\bmember\b", "member_of"),
    # an adverb may sit between the relative pronoun and the verb:
    # "the label that ORIGINALLY released W" (re-release questions)
    (r"\blabel (?:that|which) (?:\w+\s+)?released\b|\breleased on\b"
     r"|\bon the label\b",
     "released_on_label"),
    (r"\bfound(?:ed|er)\b|\bestablish(?:ed|er)\b", "founded_by"),
    (r"\breleased?\b", "released_in"),
]

# cue families that fire on the SAME question verb: when the specific form
# matched ("label that released"), the generic one ("released" -> year) is
# a shadow of it, not a second hop
_SHADOWED_BY = {"released_in": "released_on_label"}


def _cue_hits(question: str):
    """[(match_start, rel)] with shadowed generic cues removed (e.g. the
    'released' inside 'label that released X' is not a year-release hop)."""
    low = (question or "").lower()
    hits = []
    for pat, rel in _CUE_RELS:
        m = re.search(pat, low)
        if m:
            hits.append((m.start(), rel))
    rels = {r for _, r in hits}
    return [(p, r) for p, r in hits
            if _SHADOWED_BY.get(r) not in rels]


def relation_cue_count(question: str) -> int:
    """Number of distinct relation cues in the question — the hop-shape
    signal: >= 2 means a nested multi-hop question whose bridge entity is
    an intermediate (and must be excluded from EFSA answers); <= 1 means
    the 'bridge' may BE the answer."""
    return len(_cue_hits(question))


def has_nested_hop_shape(question: str) -> bool:
    """Structural multi-hop signal independent of the cue lexicon: two or
    more genitive/agentive connectives ('of the X of Y', 'by the producer
    of Z') mark a nested question even when its relations (director-of,
    capital-of, ...) are outside _CUE_RELS — so the bridge-exclusion gate
    doesn't mistake a genuine multi-hop question for single-hop."""
    low = (question or "").lower()
    return len(re.findall(r"\b(?:of|by)\s+(?:the\s+)?\w", low)) >= 2


def extract_rel_chain(question: str,
                      configured_chains: Optional[Sequence[Sequence[str]]] = None,
                      relax_last_hop: Optional[Sequence[str]] = None) -> Optional[List[str]]:
    """Order cue hits by the grammatical nesting: in 'spouse of the performer
    of X' the innermost relation (performer) resolves first."""
    low = (question or "").lower()
    hits: List[Tuple[int, str]] = _cue_hits(question)
    if len(hits) == 1:
        # single-relation question ("Who performed X?"): a one-hop chain —
        # the beam answers it structurally from the note graph instead of
        # leaving it to EFSA, whose bridge exclusion would veto the very
        # entity that IS the answer on 1-hop questions
        return [hits[0][1]]
    if len(hits) < 2:
        if configured_chains:
            for chain in configured_chains:
                if all(any(re.search(p, low) for p, r in _CUE_RELS if r.split("|")[0] in c or c in r)
                       for c in chain):
                    return list(chain)
        return None
    # innermost (= later position in "X of the Y of Z") resolves first —
    # EXCEPT a trailing verb after the last entity mention ("Where was the
    # performer of X born?"), which is the OUTERMOST relation applied to
    # the inner chain's result and must resolve last
    ent_end = 0
    for e in extract_entities_fallback(question):
        p = low.rfind(e.lower())
        if p >= 0:
            ent_end = max(ent_end, p + len(e))
    if ent_end == 0:
        # no entity located (lowercase/unrecognized surfaces): without an
        # entity boundary every hit would land in the 'outer' bucket sorted
        # ascending, reversing the nesting — keep the innermost-first order
        chain = [rel for _, rel in sorted(hits, key=lambda t: -t[0])]
    else:
        inner = sorted([h for h in hits if h[0] < ent_end], key=lambda t: -t[0])
        outer = sorted([h for h in hits if h[0] >= ent_end], key=lambda t: t[0])
        chain = [rel for _, rel in inner + outer]
    if relax_last_hop and chain:
        for relaxed in relax_last_hop:
            if chain[-1] in relaxed.split("|"):
                chain[-1] = relaxed
    return chain


def answer_question(
    question: str,
    note_graph: NoteGraph,
    anchor_top_k: int = 5,
    rel_chains: Optional[Sequence[Sequence[str]]] = None,
    relax_last_hop: Optional[Sequence[str]] = None,
    max_hops: int = 4,
    beam_size: int = 8,
    branch: int = 6,
) -> Optional[Dict[str, Any]]:
    """Returns {answer, support_note_ids, path, score} or None."""
    chain = extract_rel_chain(question, rel_chains, relax_last_hop)
    if not chain:
        return None
    # anchors: entities from the question that exist as head keys — or as
    # TAIL keys (an inverse-hop anchor like "the album performed by P"
    # names an entity with only incoming edges) — else seed recall
    anchors = [e for e in extract_entities_fallback(question)
               if note_graph.neighbors(e) or note_graph.rheads(e)]
    if not anchors:
        seed_ids = note_graph.seed_recall(question, top_k=anchor_top_k)
        anchors = [
            note_graph.notes[nid].get("head_key")
            for nid in seed_ids
            if note_graph.notes[nid].get("head_key")
        ][:anchor_top_k]
    if not anchors:
        return None
    paths = beam_search(note_graph, anchors, rel_chain=chain,
                        max_hops=max_hops, beam_size=beam_size, branch=branch)
    complete = [p for p in paths if len(p.rels) == len(chain)]
    if not complete:
        return None
    best = complete[0]
    notes = [_canonical_hop_note(note_graph, best.keys[i], best.rels[i],
                                 best.keys[i + 1], nid)
             for i, nid in enumerate(best.notes)]
    return {
        "answer": best.keys[-1],
        "support_note_ids": notes,
        "path": best.keys,
        "relations": best.rels,
        "score": best.score,
    }


def _hop_note_rank(graph: NoteGraph, head: str, tail: str, nid: str) -> int:
    """0 = the note's text OPENS with the hop's head (its home paragraph
    introduces it as subject), 1 = head precedes tail in the text, 2 =
    anything else."""
    note = graph.notes.get(nid, {})
    txt = str(note.get("text") or note.get("content") or "").lower()
    hp = txt.find(str(head).lower())
    if hp == 0:
        return 0
    tp = txt.find(str(tail).lower())
    if 0 <= hp < (tp if tp >= 0 else 1 << 30):
        return 1
    return 2


def _canonical_hop_note(graph: NoteGraph, head: str, rel: str, tail: str,
                        note_id: str) -> str:
    """Among parallel notes asserting the same (head, rel, tail) triple,
    prefer the one from the head entity's HOME paragraph (text opens with
    the head). A 'label that released W -> founder' hop is stated both by
    the label's own paragraph and the founder's; gold support conventions
    (MuSiQue decompositions) cite the subject's paragraph. Keeps the
    beam's choice on ties."""
    fwd = any(r == rel and t == tail
              for r, t, _n, _w, _p in graph.neighbors(head))
    if not fwd:
        # inverse hop (beam walked the reverse adjacency): the real edge
        # is tail --rel--> head, so canonicalize from the tail side
        head, tail = tail, head
    best_id, best_rank = note_id, _hop_note_rank(graph, head, tail, note_id)
    for r, t, nid, _w, _p in graph.neighbors(head):
        if r != rel or t != tail or nid == note_id:
            continue
        rank = _hop_note_rank(graph, head, tail, nid)
        if rank < best_rank:
            best_rank, best_id = rank, nid
    return best_id
