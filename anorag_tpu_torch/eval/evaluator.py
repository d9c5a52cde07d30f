"""Counterpart of anorag_tpu/eval/evaluator.py,
copied as it is with its imports renamed to anorag_tpu_torch.

EnhancedEvaluator: internal retrieval-quality metrics.

Parity target: upstream eval/enhanced_evaluator.py:141-560 — beyond
EM/F1: path recall rate (gold support reachable in the candidate pool),
predicate consistency rate, entity coverage rate, and two-hop metrics
(bridge usage, hop-2 contribution).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from anorag_tpu_torch.eval.musique import evaluate_dataset, gold_support_idxs
from anorag_tpu_torch.retrieval.path_aware_ranker import PathAwareRanker
from anorag_tpu_torch.utils.text import extract_entities_fallback


class EnhancedEvaluator:
    def evaluate_batch(self, results: Sequence[Dict[str, Any]],
                       golds: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        base = evaluate_dataset(results, golds)
        gold_by_id = {g.get("id"): g for g in golds}
        path_recall = predicate_consistency = entity_coverage = 0.0
        bridge_used = hop2_contrib = 0.0
        n = 0
        for r in results:
            g = gold_by_id.get(r.get("id"))
            if g is None:
                continue
            if not (r.get("notes") or r.get("candidate_notes")):
                # prediction-only rows carry no retrieval traces: computing
                # rates over them would silently report 0 — skip instead
                continue
            n += 1
            gsup = set(gold_support_idxs(g))
            cand_paras = set()
            for note in r.get("candidate_notes", r.get("notes", [])) or []:
                cand_paras.update(note.get("paragraph_idxs") or [])
            if gsup:
                path_recall += len(gsup & cand_paras) / len(gsup)
            q_preds = set(PathAwareRanker.extract_predicates(g.get("question", "")))
            if q_preds:
                note_preds = set()
                for note in r.get("notes", []) or []:
                    note_preds.update(
                        PathAwareRanker.extract_predicates(note.get("content") or ""))
                predicate_consistency += float(bool(q_preds & note_preds))
            else:
                predicate_consistency += 1.0
            q_ents = {e.lower() for e in extract_entities_fallback(g.get("question", ""))}
            if q_ents:
                covered = set()
                for note in r.get("notes", []) or []:
                    covered |= q_ents & {
                        str(e).lower() for e in (note.get("entities") or [])}
                entity_coverage += len(covered) / len(q_ents)
            else:
                entity_coverage += 1.0
            notes = r.get("candidate_notes", r.get("notes", [])) or []
            hop2 = [x for x in notes if int(x.get("hop_no", 1)) >= 2]
            bridge_used += float(any(x.get("bridge_entity") for x in notes))
            hop2_contrib += len(hop2) / max(len(notes), 1)
        if n:
            for name, val in (("path_recall_rate", path_recall),
                              ("predicate_consistency_rate", predicate_consistency),
                              ("entity_coverage_rate", entity_coverage),
                              ("bridge_usage_rate", bridge_used),
                              ("hop2_contribution", hop2_contrib)):
                base[name] = val / n
        return base
