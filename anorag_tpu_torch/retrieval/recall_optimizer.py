"""Counterpart of anorag_tpu/retrieval/recall_optimizer.py,
copied as it is with its imports renamed to anorag_tpu_torch.

EnhancedRecallOptimizer: post-recall cleanup + supplemental retrieval.

Parity target: upstream vector_store/enhanced_recall_optimizer.py —
content-signature dedup, entity disambiguation vs the query's entities,
similarity filtering, completeness analysis with supplement queries,
multi-hop sub-query decomposition + supplemental retrieval (:448-540), and
final re-ranking.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from anorag_tpu_torch.utils.text import extract_entities_fallback, tokenize_no_stop


class EnhancedRecallOptimizer:
    def __init__(
        self,
        retrieve_fn: Optional[Callable[[str], List[Dict[str, Any]]]] = None,
        min_similarity: float = 0.0,
        max_supplements: int = 2,
        multi_hop_enabled: bool = True,
        max_hops: int = 3,
        hop_similarity_threshold: float = 0.15,
        graph_retrieve_fn: Optional[
            Callable[[str], List[Dict[str, Any]]]] = None,
        comprehensive_rerank: bool = True,
    ):
        self.retrieve_fn = retrieve_fn
        self.min_similarity = min_similarity
        self.max_supplements = max_supplements
        self.multi_hop_enabled = multi_hop_enabled
        self.max_hops = max_hops
        self.hop_similarity_threshold = hop_similarity_threshold
        self.graph_retrieve_fn = graph_retrieve_fn
        self.comprehensive_rerank = comprehensive_rerank

    # --------------------------------------------------------------- steps
    @staticmethod
    def _signature(note: Dict[str, Any]) -> str:
        toks = sorted(set(tokenize_no_stop(f"{note.get('title','')} {note.get('content','')}")))
        return hashlib.md5(" ".join(toks).encode()).hexdigest()

    def dedup(self, candidates: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        seen, out = set(), []
        for c in candidates:
            sig = self._signature(c)
            if sig in seen:
                continue
            seen.add(sig)
            out.append(c)
        return out

    def disambiguate_entities(self, query: str, candidates: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Boost candidates whose entities match the query's, demote
        same-name different-entity collisions (crude surface check)."""
        q_ents = set(e.lower() for e in extract_entities_fallback(query))
        if not q_ents:
            return candidates
        for c in candidates:
            c_ents = set(str(e).lower() for e in (c.get("entities") or []))
            exact = len(q_ents & c_ents)
            partial = sum(
                1 for qe in q_ents for ce in c_ents if qe != ce and (qe in ce or ce in qe)
            )
            if exact:
                c["final_score"] = float(c.get("final_score", 0.0)) * (1 + 0.1 * exact)
            elif partial:
                c["final_score"] = float(c.get("final_score", 0.0)) * 0.9
        return candidates

    def similarity_filter(self, candidates: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        return [
            c for c in candidates
            if float(c.get("final_score", c.get("similarity", 0.0))) >= self.min_similarity
        ]

    def completeness_gaps(self, query: str, candidates: List[Dict[str, Any]]) -> List[str]:
        """Query entities with no covering candidate -> supplement queries."""
        q_ents = extract_entities_fallback(query)
        covered = set()
        for c in candidates:
            covered |= set(str(e).lower() for e in (c.get("entities") or []))
        missing = [e for e in q_ents if e.lower() not in covered]
        return [f"{query} {m}" for m in missing[: self.max_supplements]]

    # --------------------------------------------------------- multi-hop
    # Relation cues -> bridging hop queries. The reference hard-codes the
    # spouse family (:483-489); this table carries the same idea across
    # the schema's relations.
    _REL_HOPS = {
        "spouse": ["marriage relationship", "family connection"],
        "married": ["marriage relationship", "family connection"],
        "wife": ["marriage relationship"],
        "husband": ["marriage relationship"],
        "born": ["place of birth"],
        "birth": ["place of birth"],
        "label": ["record label catalog"],
        "released": ["record label catalog"],
        "founded": ["company founder"],
        "founder": ["company founder"],
        "performed": ["album performer"],
        "performer": ["album performer"],
    }

    _YEAR_RE = __import__("re").compile(r"^(?:1[0-9]{3}|20[0-9]{2})$")

    def _bridge_queries(self, query: str,
                        notes: List[Dict[str, Any]],
                        q_ents: set) -> List[str]:
        """Hop queries ANCHORED ON BRIDGE ENTITIES: entities the current
        evidence introduces that the question does not name (the
        founder, the spouse, ... of something the question names),
        combined with the question's relation cues. This is what makes
        the supplement actually multi-hop — the reference chains
        sub-queries through intermediate results
        (enhanced_recall_optimizer.py:491-540); generic relation
        templates alone cannot name the bridge."""
        low = query.lower()
        cues = []
        for cue, hops in self._REL_HOPS.items():
            if cue in low:
                cues.extend(h for h in hops if h not in cues)
        out: List[str] = []
        for c in notes[:10]:
            for e in (c.get("entities") or [])[:8]:
                e = str(e)
                if (e.lower() in q_ents or self._YEAR_RE.fullmatch(e)
                        or len(e) < 3):
                    continue
                for cue in cues[:2] or ["related facts"]:
                    hq = f"{e} {cue}"
                    if hq not in out:
                        out.append(hq)
        return out

    def decompose_multi_hop(self, query: str) -> List[str]:
        """Sub-queries for the bridging hops of a multi-hop question:
        entity-anchored hops first, then relation-cued hops (parity:
        _decompose_multi_hop_query, enhanced_recall_optimizer.py:471-489),
        capped at max_hops."""
        hop_queries = [f"related to {e}"
                       for e in extract_entities_fallback(query)]
        low = query.lower()
        for cue, hops in self._REL_HOPS.items():
            if cue in low:
                hop_queries.extend(h for h in hops if h not in hop_queries)
        return hop_queries[: self.max_hops]

    def multi_hop_supplement(self, query: str,
                             candidates: List[Dict[str, Any]]
                             ) -> List[Dict[str, Any]]:
        """Supplemental retrieval along decomposed hop queries (parity:
        _enhance_with_multi_hop + _execute_multi_hop_retrieval,
        enhanced_recall_optimizer.py:448-540): graph retriever first when
        wired, vector fallback, filtered by hop similarity and dedup'd
        against the existing candidate set."""
        fetch = self.graph_retrieve_fn or self.retrieve_fn
        if not (self.multi_hop_enabled and fetch):
            return candidates
        from anorag_tpu_torch.utils.text import extract_entities_fallback

        out = list(candidates)
        known = {c.get("note_id") for c in out}
        q_ents = {e.lower() for e in extract_entities_fallback(query)}

        def _run(hop_queries: List[str], round_new: List[Dict[str, Any]]):
            for hop_q in hop_queries:
                hits = []
                try:
                    hits = fetch(hop_q) or []
                except Exception:  # a failed hop never kills the stage
                    if self.graph_retrieve_fn and self.retrieve_fn and \
                            fetch is self.graph_retrieve_fn:
                        hits = self.retrieve_fn(hop_q) or []
                for h in hits[:3]:
                    nid = h.get("note_id")
                    sim = float(h.get("similarity",
                                      h.get("final_score",
                                            h.get("similarity_score",
                                                  0.0))))
                    if nid in known or sim < self.hop_similarity_threshold:
                        continue
                    h = dict(h)
                    info = dict(h.get("optimization_info") or {})
                    info["multi_hop"] = hop_q
                    h["optimization_info"] = info
                    out.append(h)
                    round_new.append(h)
                    known.add(nid)

        # round 0: relation-template hops off the query itself
        fresh: List[Dict[str, Any]] = []
        _run(self.decompose_multi_hop(query), fresh)
        # rounds 1..max_hops-1: bridge-entity hops — entities the current
        # evidence introduces (the founder, the spouse, ...) anchor the
        # next sub-queries, chaining through intermediate results the way
        # the reference's _execute_multi_hop_retrieval does
        frontier = out
        for _hop in range(max(0, self.max_hops - 1)):
            hqs = self._bridge_queries(query, frontier, q_ents)[:6]
            if not hqs:
                break
            fresh = []
            _run(hqs, fresh)
            if not fresh:
                break
            frontier = fresh
        return out

    # --------------------------------------------- comprehensive rerank
    def _content_quality(self, content: str, query: str) -> float:
        """length/keyword/entity blend (parity: _assess_content_quality,
        enhanced_recall_optimizer.py:588-610; same 0.3/0.4/0.3 weights)."""
        if not content:
            return 0.0
        length_score = min(len(content) / 200.0, 1.0)
        low = content.lower()
        kws = tokenize_no_stop(query)
        kw_score = (sum(1 for k in set(kws) if k in low) / len(set(kws))
                    if kws else 0.0)
        ents = extract_entities_fallback(query)
        ent_score = (sum(1 for e in ents if e.lower() in low) / len(ents)
                     if ents else 0.0)
        return 0.3 * length_score + 0.4 * kw_score + 0.3 * ent_score

    def final_rerank(self, query: str, candidates: List[Dict[str, Any]]
                     ) -> List[Dict[str, Any]]:
        """Comprehensive score = 0.6*base + 0.3*content-quality +
        optimization bonuses (0.1 supplement / 0.15 multi-hop), then the
        minimum-quality gate (parity: _final_ranking_and_quality_check,
        enhanced_recall_optimizer.py:542-586)."""
        for c in candidates:
            base = float(c.get("final_score", c.get("similarity", 0.0)))
            quality = self._content_quality(str(c.get("content") or ""),
                                            query)
            bonus = 0.0
            info = c.get("optimization_info") or {}
            if (c.get("retrieval_info") or {}).get("method") == "supplement":
                bonus += 0.1
            if "multi_hop" in info:
                bonus += 0.15
            c["comprehensive_score"] = 0.6 * base + 0.3 * quality + bonus
        candidates.sort(key=lambda c: -c.get("comprehensive_score", 0.0))
        return [c for c in candidates
                if len(str(c.get("content") or "").strip()) >= 5]

    # ------------------------------------------------------------ pipeline
    def optimize_recall(self, query: str, candidates: List[Dict[str, Any]],
                        top_k: Optional[int] = None) -> List[Dict[str, Any]]:
        cands = self.dedup(list(candidates))
        cands = self.disambiguate_entities(query, cands)
        cands = self.similarity_filter(cands)
        if self.retrieve_fn:
            known = {c.get("note_id") for c in cands}
            for supp_q in self.completeness_gaps(query, cands):
                for extra in self.retrieve_fn(supp_q) or []:
                    if extra.get("note_id") not in known:
                        extra = dict(extra)
                        extra["retrieval_info"] = {"method": "supplement", "query": supp_q}
                        cands.append(extra)
                        known.add(extra.get("note_id"))
        cands = self.multi_hop_supplement(query, cands)
        if self.comprehensive_rerank:
            cands = self.final_rerank(query, cands)
        else:
            cands.sort(key=lambda c: -float(
                c.get("final_score", c.get("similarity", 0.0))))
        return cands[:top_k] if top_k else cands
