"""Counterpart of anorag_tpu/answer/verifier.py,
copied as it is with its imports renamed to anorag_tpu_torch.

AnswerVerifier: entailment-style answer verification / correction.

Parity target: upstream answer/verify_shell.py:20-535 — features
(answer-context overlap, answer-type consistency with the question, evidence
quality, linguistic sanity), a trainable entailment head with a heuristic
fallback, and `finalize_answer` which can keep, correct (to the best span),
or mark the answer insufficient.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

from anorag_tpu_torch.answer.span_picker import SpanPicker
from anorag_tpu_torch.reasoning.qa_coverage import question_type
from anorag_tpu_torch.utils.text import normalize_answer, tokenize_no_stop


class AnswerVerifier:
    def __init__(self, accept_threshold: float = 0.45, correct_threshold: float = 0.25,
                 span_picker: Optional[SpanPicker] = None):
        self.accept_threshold = accept_threshold
        self.correct_threshold = correct_threshold
        self.span_picker = span_picker or SpanPicker()
        self.w: Optional[np.ndarray] = None
        self.b = 0.0

    # ------------------------------------------------------------ features
    def features(self, question: str, answer: str, context: str) -> np.ndarray:
        """18-feature entailment bank at the reference's surface
        (upstream answer/verify_shell.py:47-236): base overlap/
        type features, answer-type x question-type consistency, evidence-
        quality statistics, and linguistic sanity checks."""
        import re

        from anorag_tpu_torch.utils.text import split_sentences
        a_toks = set(tokenize_no_stop(answer))
        c_toks = set(tokenize_no_stop(context))
        q_toks = set(tokenize_no_stop(question))
        verbatim = normalize_answer(answer) in normalize_answer(context)
        qt = question_type(question)
        looks_person = bool(answer) and answer[:1].isupper() and 1 <= len(answer.split()) <= 4
        looks_time = any(t.isdigit() and len(t) == 4 for t in answer.split())
        type_ok = {
            "person": looks_person, "time": looks_time, "place": looks_person,
        }.get(qt, True)
        q_low, a_low = question.lower(), answer.lower()
        # answer-type x question-type consistency (ref :146-180)
        who_c = float(any(w in q_low for w in ("who", "whom", "whose"))
                      and bool(re.search(r"\b[A-Z][a-z'’-]+", answer)))
        when_c = float(("when" in q_low or "what year" in q_low)
                       and bool(re.search(r"\b\d{4}\b", answer)))
        howmany_c = float(("how many" in q_low or "how much" in q_low)
                          and bool(re.search(r"\b\d+|\b(?:one|two|three|"
                                             r"four|five|six|seven|eight|"
                                             r"nine|ten)\b", a_low)))
        where_c = float(("where" in q_low or "which city" in q_low)
                        and looks_person)  # place names look like names
        # evidence quality (ref :182-210)
        sents = split_sentences(context)
        n_sents = min(len(sents) / 5.0, 1.0)
        avg_len = (min(float(np.mean([len(s.split()) for s in sents])) / 30.0,
                       1.0) if sents else 0.0)
        c_low = context.lower()
        coverage = (sum(1 for w in a_low.split() if w in c_low)
                    / max(len(a_low.split()), 1))
        # linguistic sanity (ref :211-236)
        is_complete = float(len(answer.split()) > 1)
        is_cap = float(bool(answer) and answer[0].isupper())
        has_punct = float(bool(answer) and answer[-1] in ".!?")
        has_qwords = float(any(w in a_low.split() for w in
                               ("who", "what", "when", "where", "why",
                                "how")))
        return np.array(
            [
                float(verbatim),
                len(a_toks & c_toks) / max(len(a_toks), 1),
                float(type_ok),
                1.0 - len(a_toks & q_toks) / max(len(a_toks), 1),  # not parroting the question
                min(len(answer) / 60.0, 1.0),
                float(0 < len(answer.split()) <= 8),
                who_c, when_c, howmany_c, where_c,
                n_sents, avg_len, coverage,
                is_complete, is_cap, has_punct, has_qwords,
                len(q_toks & a_toks) / max(len(q_toks | a_toks), 1),  # q-a jaccard
            ],
            np.float32,
        )

    def verify_score(self, question: str, answer: str, context: str) -> float:
        f = self.features(question, answer, context)
        if self.w is not None and len(self.w) == len(f):
            return float(1.0 / (1.0 + np.exp(-(f @ self.w + self.b))))
        return float(0.30 * f[0] + 0.25 * f[1] + 0.15 * f[2] + 0.15 * f[3]
                     + 0.05 * f[4] + 0.10 * f[5])

    # ----------------------------------------------------------- training
    def train(self, examples: Sequence[tuple], epochs: int = 300,
              lr: float = 0.5) -> float:
        """examples: (question, answer, context, label). Trains the
        entailment head (ref verify_shell.py trainable head)."""
        x = np.stack([self.features(q, a, c) for q, a, c, _ in examples])
        y = np.array([lab for *_, lab in examples], np.float32)
        w = np.zeros(x.shape[1], np.float32)
        b = 0.0
        for _ in range(epochs):
            p = 1.0 / (1.0 + np.exp(-(x @ w + b)))
            g = p - y
            w -= lr * (x.T @ g) / len(y)
            b -= lr * float(g.mean())
        self.w, self.b = w, b
        p = 1.0 / (1.0 + np.exp(-(x @ w + b)))
        return float(np.mean((p > 0.5) == (y > 0.5)))

    def load_calibration(self, d: Dict[str, Any]) -> bool:
        """Load trained heads from a calibration components dict: its own
        entailment head plus the nested span picker's."""
        ok = False
        v = d.get("verifier") or {}
        if "w" in v:
            w = np.asarray(v["w"], np.float32)
            probe = self.features("Who is A?", "A", "A is.")
            if len(w) == len(probe):  # ignore stale-feature calibrations
                self.w = w
                self.b = float(v.get("b", 0.0))
                ok = True
        if hasattr(self.span_picker, "load_calibration"):
            ok = self.span_picker.load_calibration(d) or ok
        return ok

    # -------------------------------------------------------------- entry
    def finalize_answer(self, question: str, answer: Optional[str],
                        context: str) -> Dict[str, Any]:
        """{answer, verified, corrected, score} — may replace the answer with
        the best extractive span or mark it insufficient."""
        answer = (answer or "").strip()
        score = self.verify_score(question, answer, context) if answer else 0.0
        if answer and score >= self.accept_threshold:
            return {"answer": answer, "verified": True, "corrected": False, "score": score}
        best = self.span_picker.pick_best_span(question, context)
        if best and best["score"] > max(score, self.correct_threshold):
            return {"answer": best["span"], "verified": True, "corrected": True,
                    "score": best["score"]}
        if answer and score >= self.correct_threshold:
            return {"answer": answer, "verified": False, "corrected": False, "score": score}
        return {"answer": answer or "insufficient information", "verified": False,
                "corrected": False, "score": score}
