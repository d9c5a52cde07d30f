"""Counterpart of anorag_tpu/query/subquestion.py,
copied as it is with its imports renamed to anorag_tpu_torch.

SubQuestionPlanner: LLM decomposition of complex queries.

Parity target: upstream query/subquestion_planner.py:11-214 —
complexity heuristic gate (:61), decomposition prompt (:82), strict parse +
validation (:112-214) with rule fallback.
"""
from __future__ import annotations

import re
from typing import Any, List, Optional

from anorag_tpu_torch.llm.prompts import SUBQUESTION_SYSTEM, build_subquestion_prompt
from anorag_tpu_torch.retrieval.query_planner import QueryPlanner
from anorag_tpu_torch.utils.json_parser import extract_json


class SubQuestionPlanner:
    def __init__(self, llm=None, max_sub_questions: int = 3, min_complexity: float = 1.0):
        self.llm = llm
        self.max_sub_questions = max_sub_questions
        self.min_complexity = min_complexity
        self._rule = QueryPlanner(max_sub_queries=max_sub_questions)

    def complexity(self, question: str) -> float:
        q = question or ""
        score = 0.0
        score += len(re.findall(r"\bof the\b", q, re.IGNORECASE))
        score += 0.5 * len(re.findall(r"\b(and|both)\b", q, re.IGNORECASE))
        score += 0.5 * (len(q.split()) > 12)
        # two wh-clauses joined => clearly compound
        if len(re.findall(r"\b(who|what|when|where|which|how|why)\b", q, re.IGNORECASE)) >= 2:
            score += 1.0
        return score

    def should_decompose(self, question: str) -> bool:
        return self.complexity(question) >= self.min_complexity

    def plan(self, question: str) -> List[str]:
        """Sub-questions (>=1; the original when simple or parsing fails)."""
        if not self.should_decompose(question):
            return [question]
        if self.llm is not None:
            try:
                raw = self.llm.generate(build_subquestion_prompt(question),
                                        system_prompt=SUBQUESTION_SYSTEM,
                                        task_type="atomic_note")
                obj = extract_json(raw)
                subs = self._validate(obj, question)
                if subs:
                    return subs
            except Exception:
                pass
        rule = self._rule.plan(question).sub_queries
        return rule if len(rule) > 1 else [question]

    def _validate(self, obj: Any, question: str) -> Optional[List[str]]:
        if not isinstance(obj, dict):
            return None
        subs = obj.get("sub_questions")
        if not isinstance(subs, list):
            return None
        out = [str(s).strip() for s in subs if isinstance(s, str) and len(str(s).strip()) > 5]
        out = out[: self.max_sub_questions]
        return out or None
