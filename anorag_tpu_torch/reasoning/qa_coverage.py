"""Counterpart of anorag_tpu/reasoning/qa_coverage.py,
copied as it is with its imports renamed to anorag_tpu_torch.

QACoverageScorer: question <-> sentence answerability scoring.

Parity target: upstream reasoning/qa_coverage.py:19-418 — feature-
based scoring of whether a sentence can answer the question (token overlap,
entity hits, wh-type/answer-type agreement, position), a trainable logistic
head with a heuristic fallback, and best sentence/paragraph selection.
"""
from __future__ import annotations

import functools
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from anorag_tpu_torch.utils.lexnorm import stem as _stem
from anorag_tpu_torch.utils.text import extract_entities_fallback, split_sentences, tokenize_no_stop

_WH_TYPES = {
    "who": "person", "whom": "person", "whose": "person",
    "where": "place", "when": "time", "what": "thing",
    "which": "thing", "how": "manner", "why": "reason",
}
_TIME_RE = re.compile(r"\b(1[0-9]{3}|20[0-9]{2})\b|\b(january|february|march|april|may|june|july|august|september|october|november|december)\b", re.IGNORECASE)
_PERSON_RE = re.compile(r"\b[A-Z][a-z]+ [A-Z][a-z]+\b")
_PLACE_CUES = re.compile(r"\b(in|at|near|city|country|state|town|capital)\b", re.IGNORECASE)


def question_type(question: str) -> str:
    first = (tokenize_no_stop(question)[:1] or [""])[0]
    m = re.match(r"\s*(\w+)", question or "")
    w = (m.group(1).lower() if m else first)
    return _WH_TYPES.get(w, "thing")


@functools.lru_cache(maxsize=4096)
def _question_ctx(question: str):
    return (frozenset(tokenize_no_stop(question)),
            frozenset(e.lower() for e in extract_entities_fallback(question)),
            question_type(question))


@functools.lru_cache(maxsize=65536)
def _sentence_ctx(sentence: str):
    return (frozenset(tokenize_no_stop(sentence)),
            frozenset(e.lower() for e in extract_entities_fallback(sentence)))


class QACoverageScorer:
    def __init__(self):
        self.w: Optional[np.ndarray] = None
        self.b: float = 0.0

    # ------------------------------------------------------------ features
    def _feature_list(self, question: str, sentence: str) -> list:
        # question-side context is cached (the answer stages score every
        # sentence of every candidate against the SAME question — profiled
        # ~1.9k scores/batch64 recomputing it each time)
        q_toks, q_ents, qt = _question_ctx(question)
        s_toks, s_ents = _sentence_ctx(sentence)
        type_hit = {
            "person": bool(_PERSON_RE.search(sentence)),
            "time": bool(_TIME_RE.search(sentence)),
            "place": bool(_PLACE_CUES.search(sentence)),
        }.get(qt, True)
        # answer-bearing evidence: a sentence that merely ECHOES question
        # entities ("Critics were divided over <work>") shares tokens and
        # entities with the question yet answers nothing — the signal is a
        # NEW span of the expected answer type. Token overlap is also
        # re-measured on stems (lexnorm) so inflectional paraphrases
        # ("released" / "release of") don't zero the overlap feature.
        new_ents = s_ents - q_ents
        if qt == "time":
            new_typed = any(m.group(0).lower() not in q_toks
                            for m in _TIME_RE.finditer(sentence))
        elif qt == "person":
            new_typed = any(m.group(0).lower() not in q_ents
                            for m in _PERSON_RE.finditer(sentence))
        else:
            new_typed = bool(new_ents)
        q_stems = frozenset(_stem(t) for t in q_toks)
        s_stems = frozenset(_stem(t) for t in s_toks)
        return [
            len(q_toks & s_toks) / max(len(q_toks), 1),
            len(q_ents & s_ents) / max(len(q_ents), 1) if q_ents else 0.0,
            float(type_hit),
            min(len(s_toks) / 20.0, 1.0),
            float(bool(new_ents) or new_typed),
            len(q_stems & s_stems) / max(len(q_stems), 1),
        ]

    def features(self, question: str, sentence: str) -> np.ndarray:
        return np.array(self._feature_list(question, sentence), np.float32)

    # ------------------------------------------------------------- scoring
    def score(self, question: str, sentence: str) -> float:
        f = self._feature_list(question, sentence)
        if self.w is not None:
            # tolerate calibrations trained before the feature set grew:
            # absent feature weights score 0
            n = min(len(f), len(self.w))
            z = float(np.dot(f[:n], self.w[:n]) + self.b)
            return 1.0 / (1.0 + np.exp(-z))
        # heuristic fallback weights
        return (0.45 * f[0] + 0.25 * f[1] + 0.15 * f[2] + 0.05 * f[3]
                + 0.10 * f[4])

    def best_sentence(self, question: str, text: str) -> Tuple[str, float]:
        sents = split_sentences(text)
        if not sents:
            return "", 0.0
        best_i, best_s = 0, -1.0
        for i, s in enumerate(sents):
            sc = self.score(question, s)
            if sc > best_s:
                best_i, best_s = i, sc
        return sents[best_i], float(best_s)

    def best_paragraphs(self, question: str, paragraphs: Sequence[str],
                        top_k: int = 2) -> List[int]:
        scored = [(i, self.best_sentence(question, p)[1]) for i, p in enumerate(paragraphs)]
        scored.sort(key=lambda t: -t[1])
        return [i for i, _ in scored[:top_k]]

    # --------------------------------------------------------- calibration
    def load_calibration(self, path_or_dict) -> bool:
        """Load a trained head from calibration.json components (mirrors
        SpanPicker.load_calibration)."""
        try:
            d = path_or_dict
            if isinstance(path_or_dict, str):
                import json

                with open(path_or_dict) as fh:
                    d = json.load(fh)
            qc = d.get("qa_coverage") or d
            if "w" in qc:
                self.w = np.asarray(qc["w"], np.float32)
                self.b = float(qc.get("b", 0.0))
                return True
        except Exception:
            pass
        return False

    # ------------------------------------------------------------ training
    def train(self, pairs: Sequence[Tuple[str, str, float]], epochs: int = 300,
              lr: float = 0.5) -> float:
        x = np.stack([self.features(q, s) for q, s, _ in pairs])
        y = np.array([lab for _, _, lab in pairs], np.float32)
        w = np.zeros(x.shape[1], np.float32)
        b = 0.0
        for _ in range(epochs):
            z = x @ w + b
            p = 1.0 / (1.0 + np.exp(-z))
            g = p - y
            w -= lr * (x.T @ g) / len(y)
            b -= lr * float(g.mean())
        self.w, self.b = w, b
        p = 1.0 / (1.0 + np.exp(-(x @ w + b)))
        return float(np.mean((p > 0.5) == (y > 0.5)))
