"""Counterpart of anorag_tpu/answer/efsa.py,
copied as it is with its imports renamed to anorag_tpu_torch.

EFSA: Entity-Focused Score Aggregation short answering.

Parity target: upstream answer/efsa_answer.py (math documented in
README_EFSA.md:40-60). Over the top-N final candidates, every entity
(excluding the bridge entity) accumulates evidence
    w(note) = final_score * 0.85^(hop-1) * (1 + 0.10*coverage + 0.05*consistency)
where coverage = |path_entities ∩ note_entities| / |path_entities| and
consistency = 1 iff the note text mentions a path entity; an entity's total
is then multiplied by the doc-diversity bonus 1 + 0.03*min(n_docs-1, 3); the
argmax entity is the answer and its top-2 contributing notes supply the
support idxs.

TPU shape: the aggregation is a segment-sum over (note, entity) incidence —
vectorized here with numpy over entity ids (the candidate set is tiny, ~20).
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from anorag_tpu_torch.utils.file_io import read_jsonl
from anorag_tpu_torch.utils.text import normalize_entity, tokenize

HOP_DECAY = 0.85
COV_BONUS = 0.10
CONS_BONUS = 0.05
DIVERSITY_STEP = 0.03
DIVERSITY_CAP = 3


def compute_cov_cons(note: Dict[str, Any], path_entities: Sequence[str]) -> Tuple[float, int]:
    pe = {e.lower() for e in (path_entities or [])}
    if not pe:
        return 0.0, 0
    ne = {str(e).lower() for e in (note.get("entities") or [])}
    cov = len(ne & pe) / max(1, len(pe))
    text = f"{note.get('title','')} {note.get('content','')}".lower()
    cons = 1 if any(e in text for e in pe) else 0
    return float(cov), int(cons)


def efsa_answer(
    candidates: Sequence[Dict[str, Any]],
    query: str = "",
    bridge_entity: Optional[str] = None,
    path_entities: Optional[Sequence[str]] = None,
    topN: int = 20,
    exclude_entities: Optional[Sequence[str]] = None,
    who_person_boost: float = 1.0,
    type_gate: bool = True,
    subject_cooc_boost: float = 1.0,
) -> Tuple[Optional[str], List[Any], float]:
    """(answer entity | None, support idxs, score).

    `exclude_entities` extends the bridge-entity exclusion: entities named in
    the question itself cannot be the answer to a wh-question (without this,
    the query's subject — which appears in most retrieved notes — dominates
    the aggregation when no LLM refines the answer).
    `who_person_boost` multiplies person-shaped entity scores for
    who-questions (the reference's answer_bias.who_person_boost, default
    1.10 in config).
    `subject_cooc_boost`: notes that mention one of the question's own
    entities carry extra evidence weight — the answer to "who performed X"
    lives in a note that also mentions X, while distractor entities live in
    notes that never do (measured on the synthetic 200-item set: this is
    the difference between aggregating the right person and the most
    frequent one).
    `type_gate`: wh-type answer gating — a "where" question can never be
    answered by a person-shaped entity, a "when" question needs a
    time-shaped one; place/time-shaped candidates (location-cue or digit
    evidence in the pooled text) are boosted, incompatible shapes squashed.
    """
    pool = list(candidates)[:topN]
    if not pool:
        return None, [], 0.0
    be = normalize_entity(bridge_entity or "").lower()
    excluded = {normalize_entity(str(e)).lower() for e in (exclude_entities or [])}
    if be:
        excluded.add(be)
    pe = list(path_entities or [])
    # a wh-question's answer must add information beyond the question: any
    # entity whose tokens are all contained in the question cannot be it
    # (exact-match exclusion alone misses partial extractions, e.g. query
    # entity "Horizon" vs note entity "Horizon 7")
    qtok = set(tokenize(query)) if query else set()

    def _is_excluded(e: str) -> bool:
        if normalize_entity(e).lower() in excluded:
            return True
        if qtok:
            etok = tokenize(e)
            return bool(etok) and set(etok) <= qtok
        return False

    # note weights (vector)
    hops = np.array([int(n.get("hop_no", 1)) for n in pool], np.float64)
    base = np.array([float(n.get("final_score", 0.0)) for n in pool], np.float64)
    cov_cons = np.array([compute_cov_cons(n, pe) for n in pool], np.float64)
    w = base * (HOP_DECAY ** (hops - 1)) * (1 + COV_BONUS * cov_cons[:, 0] + CONS_BONUS * cov_cons[:, 1])
    if subject_cooc_boost and excluded:
        texts = [f"{n.get('title','')} {n.get('content','')}".lower() for n in pool]
        # word-boundary match: raw containment let short entities ('1983',
        # 2-3 letter names) fire inside unrelated tokens and double the
        # evidence weight of unrelated notes
        pats = [re.compile(r"\b" + re.escape(qe) + r"\b") for qe in excluded if qe]
        cooc = np.array([
            1.0 if any(p.search(t) for p in pats) else 0.0
            for t in texts
        ])
        w = w * (1 + subject_cooc_boost * cooc)

    # (note, entity) incidence -> segment-sum per entity id
    ent_ids: Dict[str, int] = {}
    ent_names: List[str] = []
    rows: List[Tuple[int, int]] = []   # (note_idx, entity_id)
    for i, n in enumerate(pool):
        for e in n.get("entities") or []:
            e = str(e)
            if _is_excluded(e):
                continue
            eid = ent_ids.get(e)
            if eid is None:
                eid = ent_ids[e] = len(ent_names)
                ent_names.append(e)
            rows.append((i, eid))
    if not rows:
        return None, [], 0.0
    note_idx = np.array([r[0] for r in rows])
    eid_arr = np.array([r[1] for r in rows])
    n_ents = len(ent_names)
    score = np.zeros(n_ents, np.float64)
    np.add.at(score, eid_arr, w[note_idx])

    # doc diversity bonus
    docs_per_ent = [set() for _ in range(n_ents)]
    for i, eid in rows:
        docs_per_ent[eid].add(pool[i].get("doc_id"))
    ndocs = np.array([len(d) for d in docs_per_ent], np.float64)
    score *= 1 + DIVERSITY_STEP * np.minimum(np.maximum(ndocs - 1, 0), DIVERSITY_CAP)

    person_shaped = np.array([
        bool(e) and e[0].isupper() and 1 <= len(e.split()) <= 4
        and not any(ch.isdigit() for ch in e)
        for e in ent_names
    ])
    qlead = query.strip().lower().split(" ", 1)[0] if query else ""
    if who_person_boost != 1.0 and qlead in ("who", "whose", "whom"):
        score = np.where(person_shaped, score * who_person_boost, score)
    if type_gate and qlead in ("where", "when"):
        pooled_text = " ".join(
            f"{n.get('title','')} {n.get('content','')}" for n in pool)
        if qlead == "where":
            import re as _re

            # place-shaped: appears after a location cue somewhere in the
            # evidence ("born in Denver", "at Harvard", "from Texas") and
            # carries no digits — years also follow "in" ("released in
            # 1983") but are time-shaped, not places
            shaped = np.array([
                not any(ch.isdigit() for ch in e)
                and bool(_re.search(
                    r"\b(?:in|at|near|from)\s+" + _re.escape(e), pooled_text))
                for e in ent_names
            ])
        else:  # when -> time-shaped: carries a digit (years, dates)
            shaped = np.array([any(ch.isdigit() for ch in e) for e in ent_names])
        score = np.where(shaped, score * 1.5, score)
        # incompatible shapes can never answer the wh-type: persons for
        # where/when, and digit-bearing entities (years) for where
        wrong_shape = person_shaped
        if qlead == "where":
            wrong_shape = wrong_shape | np.array(
                [any(ch.isdigit() for ch in e) for e in ent_names])
        score = np.where(wrong_shape & ~shaped, score * 0.2, score)

    best = int(np.argmax(score))
    answer = ent_names[best]
    # support: top-2 contributing notes for the winning entity
    contrib = [(float(w[i]), pool[i]) for (i, eid) in rows if eid == best]
    contrib.sort(key=lambda t: -t[0])
    support: List[Any] = []
    for _, note in contrib[:2]:
        pidx = note.get("paragraph_idxs")
        key = pidx[0] if pidx else note.get("note_id")
        if key is not None and key not in support:
            support.append(key)
    return answer, support, float(score[best])


def efsa_answer_with_fallback(
    candidates: Optional[Sequence[Dict[str, Any]]] = None,
    query: str = "",
    bridge_entity: Optional[str] = None,
    path_entities: Optional[Sequence[str]] = None,
    topN: int = 20,
    fallback_func: Optional[Callable] = None,
    final_recall_path: Optional[str] = None,
    exclude_entities: Optional[Sequence[str]] = None,
    who_person_boost: float = 1.0,
    type_gate: bool = True,
    subject_cooc_boost: float = 1.0,
) -> Tuple[Optional[str], List[Any], float]:
    if final_recall_path and Path(final_recall_path).exists():
        try:
            candidates = read_jsonl(final_recall_path)
        except Exception:
            candidates = candidates or []
    if not candidates:
        return None, [], 0.0
    answer, support, score = efsa_answer(candidates, query, bridge_entity, path_entities,
                                         topN, exclude_entities=exclude_entities,
                                         who_person_boost=who_person_boost,
                                         type_gate=type_gate,
                                         subject_cooc_boost=subject_cooc_boost)
    if answer is not None:
        return answer, support, score
    if fallback_func:
        fb_answer, fb_support = fallback_func(list(candidates), query)
        return fb_answer, fb_support, 0.0
    first = candidates[0]
    content = (first.get("content") or "")[:50].strip() or None
    pidx = first.get("paragraph_idxs") or []
    return content, pidx[:1], 0.0


def extract_bridge_info_from_candidates(
    candidates: Sequence[Dict[str, Any]],
) -> Tuple[Optional[str], List[str]]:
    bridge = None
    path_entities: List[str] = []
    for c in candidates:
        bridge = bridge or c.get("bridge_entity")
        path_entities.extend(c.get("bridge_path") or [])
    return bridge, sorted(set(path_entities))
