"""Counterpart of anorag_tpu/eval/musique.py,
copied as it is with its imports renamed to anorag_tpu_torch.

MuSiQue evaluation: answer EM/F1 + support EM/F1.

Parity target: the official MuSiQue evaluator invoked by
upstream run_evaluation.py:29-60 — implemented natively (no
subprocess): normalized token-F1 and exact match for answers (max over
gold aliases), exact-set EM and set-F1 for predicted support idxs.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Sequence

from anorag_tpu_torch.utils.text import normalize_answer


def answer_em(prediction: str, golds: Sequence[str]) -> float:
    p = normalize_answer(prediction)
    return float(any(p == normalize_answer(g) for g in golds))


def answer_f1(prediction: str, golds: Sequence[str]) -> float:
    p_toks = normalize_answer(prediction).split()
    best = 0.0
    for g in golds:
        g_toks = normalize_answer(g).split()
        if not p_toks or not g_toks:
            best = max(best, float(p_toks == g_toks))
            continue
        common = Counter(p_toks) & Counter(g_toks)
        overlap = sum(common.values())
        if overlap == 0:
            continue
        precision = overlap / len(p_toks)
        recall = overlap / len(g_toks)
        best = max(best, 2 * precision * recall / (precision + recall))
    return best


def support_em(pred_idxs: Sequence[int], gold_idxs: Sequence[int]) -> float:
    return float(set(pred_idxs) == set(gold_idxs))


def support_f1(pred_idxs: Sequence[int], gold_idxs: Sequence[int]) -> float:
    p, g = set(pred_idxs), set(gold_idxs)
    if not p and not g:
        return 1.0
    if not p or not g:
        return 0.0
    overlap = len(p & g)
    if overlap == 0:
        return 0.0
    precision = overlap / len(p)
    recall = overlap / len(g)
    return 2 * precision * recall / (precision + recall)


def gold_aliases(item: Dict[str, Any]) -> List[str]:
    golds = [item.get("answer", "")]
    golds += list(item.get("answer_aliases") or [])
    return [g for g in golds if g]


def gold_support_idxs(item: Dict[str, Any]) -> List[int]:
    if "gold_support_idxs" in item:
        return list(item["gold_support_idxs"])
    return [
        p.get("idx") for p in (item.get("paragraphs") or [])
        if p.get("is_supporting")
    ]


def evaluate_item(pred: Dict[str, Any], gold: Dict[str, Any]) -> Dict[str, float]:
    golds = gold_aliases(gold)
    gsup = gold_support_idxs(gold)
    return {
        "answer_em": answer_em(pred.get("predicted_answer", ""), golds),
        "answer_f1": answer_f1(pred.get("predicted_answer", ""), golds),
        "support_em": support_em(pred.get("predicted_support_idxs", []), gsup),
        "support_f1": support_f1(pred.get("predicted_support_idxs", []), gsup),
    }


def evaluate_dataset(predictions: Sequence[Dict[str, Any]],
                     golds: Sequence[Dict[str, Any]]) -> Dict[str, float]:
    """Answer/support metrics over ANSWERABLE gold items; answerable-
    prediction accuracy over all items carrying a gold `answerable` flag
    (the official evaluator's split; ref main_musique.py:377-382 scores
    predicted_answerable on the full variant)."""
    gold_by_id = {g.get("id"): g for g in golds}
    metrics: Dict[str, float] = {"answer_em": 0, "answer_f1": 0,
                                 "support_em": 0, "support_f1": 0}
    n = 0
    ans_n = ans_correct = 0
    for p in predictions:
        g = gold_by_id.get(p.get("id"))
        if g is None:
            continue
        gold_answerable = bool(g.get("answerable", True))
        if "answerable" in g:
            ans_n += 1
            pred_ans = bool(p.get("predicted_answerable", True))
            ans_correct += int(pred_ans == gold_answerable)
        if not gold_answerable:
            continue
        m = evaluate_item(p, g)
        for k in metrics:
            metrics[k] += m[k]
        n += 1
    if n:
        for k in metrics:
            metrics[k] /= n
    metrics["n_evaluated"] = n
    if ans_n:
        metrics["answerable_acc"] = ans_correct / ans_n
        metrics["n_answerable_scored"] = ans_n
    return metrics


def convert_to_official_format(rows: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Our result rows -> the official MuSiQue prediction jsonl shape
    (parity: upstream convert_to_official_format.py)."""
    return [
        {
            "id": r.get("id") or r.get("qid"),
            "predicted_answer": r.get("predicted_answer", r.get("answer", "")),
            "predicted_support_idxs": r.get("predicted_support_idxs", []),
            "predicted_answerable": bool(r.get("predicted_answerable", True)),
        }
        for r in rows
    ]


def extract_dev_subset(items: Sequence[Dict[str, Any]], n: int = 200,
                       answerable_only: bool = True) -> List[Dict[str, Any]]:
    """First-N answerable dev items (parity: upstream extract_dev200.py)."""
    out = []
    for it in items:
        if answerable_only and not it.get("answerable", True):
            continue
        out.append(it)
        if len(out) >= n:
            break
    return out
