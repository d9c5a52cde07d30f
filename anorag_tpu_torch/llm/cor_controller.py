"""Counterpart of anorag_tpu/llm/cor_controller.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Chain of Retrieval (CoR) controller.

Parity target: upstream llm/cor_controller.py:15-173 with config
`cor.*` — iterative retrieval rounds over the NoteGraph: seed recall ->
budget-capped rerank -> coverage-gain & confidence stopping (tau=0.8) ->
query rewrite with missing entities for the next round.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Set

from anorag_tpu_torch.graph.note_graph import NoteGraph
from anorag_tpu_torch.utils.text import extract_entities_fallback, tokenize_no_stop


def _coverage(question: str, note_texts: Sequence[str]) -> float:
    q = set(tokenize_no_stop(question))
    if not q:
        return 1.0
    covered: Set[str] = set()
    for t in note_texts:
        covered |= q & set(tokenize_no_stop(t))
    return len(covered) / len(q)


def chain_of_retrieval(
    question: str,
    graph: NoteGraph,
    max_rounds: int = 3,
    budget: int = 64,
    confidence_tau: float = 0.8,
    top_k_seed: int = 40,
    rerank_fn: Optional[Callable[[str, List[Dict[str, Any]]], List[Dict[str, Any]]]] = None,
    rewrite_fn: Optional[Callable[[str, Sequence[str]], str]] = None,
) -> Dict[str, Any]:
    """Returns {notes, rounds, coverage, stopped_reason}."""
    collected: Dict[str, Dict[str, Any]] = {}
    query = question
    rounds_run = 0
    reason = "max_rounds"
    for rnd in range(max_rounds):
        rounds_run = rnd + 1
        seed_ids = graph.seed_recall(query, top_k=top_k_seed)
        # expand one hop through the note graph
        pool_ids: List[str] = []
        for nid in seed_ids:
            if nid not in pool_ids:
                pool_ids.append(nid)
            for nb in graph.get_neighbors(nid, cap=4):
                if nb not in pool_ids:
                    pool_ids.append(nb)
        pool = [dict(graph.notes[nid]) for nid in pool_ids[:budget]]
        if rerank_fn is not None:
            pool = rerank_fn(query, pool)[:budget]
        for n in pool:
            collected.setdefault(n.get("note_id") or n.get("id"), n)

        texts = [str(n.get("text") or n.get("content") or "") for n in collected.values()]
        cov = _coverage(question, texts)
        if cov >= confidence_tau:
            reason = "confidence"
            break
        # rewrite with missing entities for the next round
        q_ents = extract_entities_fallback(question)
        covered_text = " ".join(texts).lower()
        missing = [e for e in q_ents if e.lower() not in covered_text]
        if not missing:
            reason = "no_missing_entities"
            break
        query = (rewrite_fn(query, missing) if rewrite_fn
                 else f"{question} {' '.join(missing)}")
    return {
        "notes": list(collected.values()),
        "rounds": rounds_run,
        "coverage": _coverage(question, [str(n.get("text") or n.get("content") or "")
                                         for n in collected.values()]),
        "stopped_reason": reason,
    }
