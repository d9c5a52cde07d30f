"""Counterpart of anorag_tpu/retrieval/query_planner.py,
copied as it is with its imports renamed to anorag_tpu_torch.

QueryPlanner: rule-based decomposition + LLM rewriting + plan execution.

Parity target: upstream retrieval/query_planner.py — rule splits on
conjunctions / entities / predicates (:168-227), an LLM-backed rewriter used
as the fusion fallback (:228-374), and plan execution with weighted / ranked
/ clustered merge (:445-639).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from anorag_tpu_torch.utils.json_parser import extract_json
from anorag_tpu_torch.utils.text import extract_entities_fallback

_CONJ_RE = re.compile(r"\b(?:and|but|as well as|;)\b", re.IGNORECASE)
_WH_RE = re.compile(r"^(who|what|when|where|which|whose|how|why)\b", re.IGNORECASE)


@dataclass
class QueryPlan:
    original: str
    sub_queries: List[str] = field(default_factory=list)
    strategy: str = "sequential"       # sequential | parallel
    merge: str = "weighted"            # weighted | ranked | clustered


class QueryPlanner:
    def __init__(self, llm_generate: Optional[Callable[[str], str]] = None,
                 max_sub_queries: int = 3):
        self.llm_generate = llm_generate
        self.max_sub_queries = max_sub_queries

    # ---------------------------------------------------------- planning
    def plan(self, query: str) -> QueryPlan:
        subs = self._rule_split(query)
        return QueryPlan(
            original=query,
            sub_queries=subs[: self.max_sub_queries] or [query],
            strategy="parallel" if len(subs) > 1 else "sequential",
        )

    def _rule_split(self, query: str) -> List[str]:
        # conjunction split
        parts = [p.strip(" ,?") for p in _CONJ_RE.split(query) if p.strip(" ,?")]
        if len(parts) > 1 and all(len(p.split()) >= 3 for p in parts):
            return [p if p.endswith("?") else p + "?" for p in parts]
        # entity pivot: "X of the Y of Z" style nesting
        ents = extract_entities_fallback(query, max_entities=4)
        m = re.search(r"\bof the (\w[\w\s]{2,40}?) of\b", query, re.IGNORECASE)
        if m and ents:
            inner = query[query.lower().find(m.group(1).lower()):]
            return [f"What is the {m.group(1).strip()} of {ents[-1]}?", query]
        return [query]

    # ---------------------------------------------------------- rewriting
    def rewrite(self, query: str, missing_entities: Sequence[str] = ()) -> str:
        """LLM rewrite used as the retrieval fallback; rule fallback appends
        the missing entities."""
        if self.llm_generate:
            prompt = (
                "Rewrite this search query to be more specific. Return JSON "
                f'{{"rewritten": "..."}}.\nQuery: {query}\n'
                + (f"Must mention: {', '.join(missing_entities)}\n" if missing_entities else "")
            )
            try:
                obj = extract_json(self.llm_generate(prompt))
                if isinstance(obj, dict) and obj.get("rewritten"):
                    return str(obj["rewritten"])
            except Exception:
                pass
        if missing_entities:
            return f"{query} {' '.join(missing_entities)}"
        return query

    # ---------------------------------------------------------- execution
    def execute(
        self,
        plan: QueryPlan,
        retrieve_fn: Callable[[str], List[Dict[str, Any]]],
        query_emb_fn: Optional[Callable[[str], np.ndarray]] = None,
    ) -> List[Dict[str, Any]]:
        per_sub = [(sq, retrieve_fn(sq) or []) for sq in plan.sub_queries]
        if plan.merge == "ranked" and query_emb_fn is not None:
            return self._merge_ranked(plan.original, per_sub, query_emb_fn)
        return self._merge_weighted(per_sub)

    @staticmethod
    def _merge_weighted(per_sub) -> List[Dict[str, Any]]:
        best: Dict[str, Dict[str, Any]] = {}
        for si, (sq, results) in enumerate(per_sub):
            w = 1.0 / (1 + si)     # earlier sub-queries weigh more
            for r in results:
                nid = r.get("note_id")
                score = w * float(r.get("final_score", r.get("similarity", 0.0)))
                if nid not in best or score > best[nid]["final_score"]:
                    m = dict(r)
                    m["final_score"] = score
                    m["subq_source"] = sq
                    best[nid] = m
        return sorted(best.values(), key=lambda r: -r["final_score"])

    @staticmethod
    def _merge_ranked(original, per_sub, query_emb_fn) -> List[Dict[str, Any]]:
        q = np.asarray(query_emb_fn(original), np.float32).reshape(-1)
        qn = q / max(np.linalg.norm(q), 1e-9)
        seen: Dict[str, Dict[str, Any]] = {}
        for sq, results in per_sub:
            for r in results:
                seen.setdefault(r.get("note_id"), dict(r, subq_source=sq))
        out = list(seen.values())
        for r in out:
            emb = r.get("embedding")
            if emb is not None:
                e = np.asarray(emb, np.float32)
                r["final_score"] = float(e @ qn / max(np.linalg.norm(e), 1e-9))
        out.sort(key=lambda r: -float(r.get("final_score", 0.0)))
        return out


class LLMBasedRewriter:
    """Thin named wrapper kept for API parity with the reference
    (retrieval/query_planner.py:228-374)."""

    def __init__(self, llm_generate: Optional[Callable[[str], str]] = None):
        self._planner = QueryPlanner(llm_generate)

    def rewrite_query(self, query: str, missing_entities: Sequence[str] = ()) -> str:
        return self._planner.rewrite(query, missing_entities)
