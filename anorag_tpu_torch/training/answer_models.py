"""Counterpart of anorag_tpu/training/answer_models.py,
copied as it is with its imports renamed to anorag_tpu_torch.

train_answer_models: the answer-path heads (SpanPicker, QACoverageScorer,
AnswerVerifier) trained on templated supervision.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from anorag_tpu_torch.answer.span_picker import SpanPicker
from anorag_tpu_torch.answer.verifier import AnswerVerifier
from anorag_tpu_torch.reasoning.qa_coverage import QACoverageScorer

PEOPLE = ["Marcus Webb", "Aurora Lane", "Elena Cortez", "David Kim",
          "Sofia Reyes", "Liam Stone", "Nora Park", "Felix Vance",
          "Iris Bloom", "Hugo Hart", "Maya Frost", "Oscar Quinn"]
WORKS = ["Silent River", "Blue Horizon", "Glass Garden", "Iron Valley",
         "Red Meadow", "Pale Summit", "Green Harbor", "Stone Orchard"]
PLACES = ["Boston", "Lisbon", "Osaka", "Nairobi", "Tromso", "Cusco",
          "Galway", "Adelaide"]
ROLES = ["director", "composer", "producer", "author"]
YEARS = [str(y) for y in range(1961, 2021, 7)]


def _rows(rng, people, works, places, years) -> List[Dict[str, str]]:
    """Templated QA rows: question, gold span+type, answer sentence,
    same-topic distractor sentence."""
    rows = []
    for person in people:
        for work in works:
            role = ROLES[rng.integers(len(ROLES))]
            place = places[rng.integers(len(places))]
            year = years[rng.integers(len(years))]
            rows += [
                {"q": f"Who is the {role} of {work}?", "span": person,
                 "stype": "entity",
                 "sent": f"{person} is the {role} of {work}.",
                 "offtopic": f"{work} received mixed reviews from critics."},
                {"q": f"When was {work} released?", "span": year,
                 "stype": "time",
                 "sent": f"{work} was released in {year}.",
                 "offtopic": f"{work} has a devoted following."},
                {"q": f"Where was {person} born?", "span": place,
                 "stype": "entity",
                 "sent": f"{person} was born in {place}.",
                 "offtopic": f"{person} gave many interviews."},
            ]
    return rows


def _rows_train_alt(rng, people, works, places, years) -> List[Dict[str, str]]:
    """Second TRAINING template family (distinct from _rows and from the
    validation family): surface diversity in training is what buys
    transfer — single-template training left qa_coverage at 0.778 val."""
    rows = []
    for person in people:
        for work in works:
            role = ROLES[rng.integers(len(ROLES))]
            place = places[rng.integers(len(places))]
            year = years[rng.integers(len(years))]
            rows += [
                {"q": f"Who worked as the {role} on {work}?",
                 "span": person, "stype": "entity",
                 "sent": f"On {work}, {person} worked as the {role}.",
                 "offtopic": f"{work} toured several festivals."},
                {"q": f"What year saw the release of {work}?", "span": year,
                 "stype": "time",
                 "sent": f"The release of {work} happened in {year}.",
                 "offtopic": f"{work} inspired several imitators."},
                {"q": f"Which city was {person} born in?", "span": place,
                 "stype": "entity",
                 "sent": f"Born in {place}, {person} grew up by the sea.",
                 "offtopic": f"{person} kept a private life."},
            ]
    return rows


def _rows_train_late(rng, people, works, places, years) -> List[Dict[str, str]]:
    """Third TRAINING family: the gold span sits LATE in a copular
    sentence ("The {role} of {work} is {person}."). Without this family
    the context features (span-after-is/was) learn the early-span word
    order of the other templates and mis-score every late-span positive
    (measured: 22-feature span head val 1.0 -> 0.833). Surfaces remain
    disjoint from the validation family's."""
    rows = []
    for person in people:
        for work in works:
            role = ROLES[rng.integers(len(ROLES))]
            place = places[rng.integers(len(places))]
            year = years[rng.integers(len(years))]
            rows += [
                {"q": f"Who is the {role} of {work}?", "span": person,
                 "stype": "entity",
                 "sent": f"The {role} of {work} is {person}.",
                 "offtopic": f"{work} sold steadily for years."},
                {"q": f"When was {work} released?", "span": year,
                 "stype": "time",
                 "sent": f"The year of {work}'s release was {year}.",
                 "offtopic": f"{work} stayed in print for decades."},
                {"q": f"Where was {person} born?", "span": place,
                 "stype": "entity",
                 "sent": f"The home town of {person} is {place}.",
                 "offtopic": f"{person} seldom toured abroad."},
            ]
    return rows


def _rows_paraphrased(rng, people, works, places, years) -> List[Dict[str, str]]:
    """Validation rows: same fact schema as _rows, DISJOINT surface
    templates for both question and evidence (VERDICT r3 weak #5 — heads
    trained and evaluated on the same templates are circular). These
    phrasings never feed training; val_acc measures surface transfer."""
    rows = []
    for person in people:
        for work in works:
            role = ROLES[rng.integers(len(ROLES))]
            place = places[rng.integers(len(places))]
            year = years[rng.integers(len(years))]
            rows += [
                {"q": f"Which person served as {work}'s {role}?",
                 "span": person, "stype": "entity",
                 "sent": f"The {role} behind {work} is {person}.",
                 "offtopic": f"Critics were divided over {work}."},
                {"q": f"In what year did {work} come out?", "span": year,
                 "stype": "time",
                 "sent": f"{work} first came out in {year}.",
                 "offtopic": f"Fans still celebrate {work} today."},
                {"q": f"What city is {person}'s birthplace?", "span": place,
                 "stype": "entity",
                 "sent": f"{person}'s birthplace is {place}.",
                 "offtopic": f"{person} rarely spoke to the press."},
            ]
    return rows


def _logistic_acc(head, feats_fn, examples) -> float:
    """Accuracy of a trained logistic head on held-out examples."""
    x = np.stack([feats_fn(*e[:-1]) for e in examples])
    y = np.array([e[-1] for e in examples], np.float32)
    p = 1.0 / (1.0 + np.exp(-(x @ head.w + head.b)))
    return float(np.mean((p > 0.5) == (y > 0.5)))


def synthetic_span_examples(rows, rng) -> List[Tuple[str, str, str, str, float, float]]:
    """(question, span, stype, sentence, position, label) — positives are
    gold spans in answer sentences; negatives are question-echo spans
    (the subject the question already names), wrong-type spans, and spans
    from the same-topic non-answer sentence."""
    out = []
    for r in rows:
        out.append((r["q"], r["span"], r["stype"], r["sent"], 0.0, 1.0))
        # question-echo negative: the entity the question itself names
        echo = r["q"].rstrip("?").split(" of ")[-1].split(" was ")[0].strip()
        out.append((r["q"], echo, "entity", r["sent"], 0.0, 0.0))
        # wrong-type negative
        wrong_type = "time" if r["stype"] == "entity" else "entity"
        wrong_span = YEARS[rng.integers(len(YEARS))] if wrong_type == "time" \
            else PEOPLE[rng.integers(len(PEOPLE))]
        out.append((r["q"], wrong_span, wrong_type, r["sent"], 0.0, 0.0))
        # off-topic sentence negative
        out.append((r["q"], r["span"], r["stype"], r["offtopic"], 0.7, 0.0))
    return out


def synthetic_coverage_pairs(rows, rng) -> List[Tuple[str, str, float]]:
    """(question, sentence, label): the answer sentence vs the same-topic
    distractor vs a random other row's answer sentence."""
    out = []
    for i, r in enumerate(rows):
        out.append((r["q"], r["sent"], 1.0))
        out.append((r["q"], r["offtopic"], 0.0))
        other = rows[(i + 7) % len(rows)]
        out.append((r["q"], other["sent"], 0.0))
    return out


def synthetic_verifier_examples(rows, rng) -> List[Tuple[str, str, str, float]]:
    """(question, answer, context, label): gold answer in its context vs
    question-echo answers, wrong-type answers, and hallucinated answers
    absent from the context."""
    out = []
    for i, r in enumerate(rows):
        ctx = f"{r['sent']} {r['offtopic']}"
        out.append((r["q"], r["span"], ctx, 1.0))
        echo = r["q"].rstrip("?").split(" of ")[-1].split(" was ")[0].strip()
        out.append((r["q"], echo, ctx, 0.0))
        other = rows[(i + 5) % len(rows)]
        out.append((r["q"], other["span"], ctx, 0.0))   # not in context
    return out


def train_answer_models(seed: int = 0,
                        people: Sequence[str] = (),
                        works: Sequence[str] = ()) -> Dict[str, Any]:
    """Train all three heads; returns calibration `components` entries."""
    rng = np.random.default_rng(seed)
    rows = _rows(rng, list(people) or PEOPLE[:8], list(works) or WORKS[:6],
                 PLACES, YEARS)
    rows += _rows_train_alt(rng, list(people) or PEOPLE[:8],
                            list(works) or WORKS[:6], PLACES, YEARS)
    rows += _rows_train_late(rng, list(people) or PEOPLE[:8],
                             list(works) or WORKS[:6], PLACES, YEARS)
    # validation: disjoint surface templates AND disjoint entities
    val_rows = _rows_paraphrased(rng, PEOPLE[8:], WORKS[6:], PLACES, YEARS)
    sp = SpanPicker()
    sp_acc = sp.train(synthetic_span_examples(rows, rng))
    sp_val = _logistic_acc(sp, sp.features, synthetic_span_examples(val_rows, rng))
    qc = QACoverageScorer()
    qc_acc = qc.train(synthetic_coverage_pairs(rows, rng))
    qc_val = _logistic_acc(qc, qc.features, synthetic_coverage_pairs(val_rows, rng))
    vf = AnswerVerifier()
    vf_acc = vf.train(synthetic_verifier_examples(rows, rng))
    vf_val = _logistic_acc(vf, vf.features, synthetic_verifier_examples(val_rows, rng))
    return {
        "span_picker": {"w": sp.w.tolist(), "b": float(sp.b),
                        "train_acc": sp_acc, "val_paraphrase_acc": sp_val},
        "qa_coverage": {"w": qc.w.tolist(), "b": float(qc.b),
                        "train_acc": qc_acc, "val_paraphrase_acc": qc_val},
        "verifier": {"w": vf.w.tolist(), "b": float(vf.b),
                     "train_acc": vf_acc, "val_paraphrase_acc": vf_val},
    }
