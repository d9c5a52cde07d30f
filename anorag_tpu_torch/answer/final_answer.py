"""Counterpart of anorag_tpu/answer/final_answer.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Final-answer generation: evidence-first LLM answering.

Parity target: upstream answer/final_answer_generator.py:19-171 with
the prompts contract of llm/prompts/final_answer.py — numbered context
lines, the EFSA candidate passed as a NOISY hint, verbatim evidence_spans
required, 'insufficient' fallback, and strict JSON validation.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from anorag_tpu_torch.llm.prompts import FINAL_ANSWER_SYSTEM, build_final_answer_prompt
from anorag_tpu_torch.utils.json_parser import extract_prediction
from anorag_tpu_torch.utils.logging import get_logger
from anorag_tpu_torch.validators.final_answer_validator import validate_final_answer

logger = get_logger("anorag.answer")


def build_numbered_context(notes: Sequence[Dict[str, Any]]) -> Tuple[str, List[int]]:
    """[P{idx}]-numbered context lines + the paragraph idxs used."""
    lines: List[str] = []
    idxs: List[int] = []
    for n in notes:
        pidx_list = n.get("paragraph_idxs") or []
        pidx = int(pidx_list[0]) if pidx_list else -1
        title = n.get("title") or ""
        body = n.get("raw_span") or n.get("content") or ""
        if not body:
            continue
        tag = f"[P{pidx}]" if pidx >= 0 else "[P?]"
        lines.append(f"{tag} {title}: {body}".strip() if title else f"{tag} {body}")
        if pidx >= 0 and pidx not in idxs:
            idxs.append(pidx)
    return "\n".join(lines), idxs


def generate_final_answer(
    llm,
    question: str,
    notes: Sequence[Dict[str, Any]],
    efsa_hint: Optional[str] = None,
    require_verbatim_spans: bool = True,
    force_insufficient_if_no_spans: bool = True,
    max_retries: int = 1,
) -> Dict[str, Any]:
    """Returns {answer, evidence_spans, support_idxs, insufficient, valid,
    issues, context}."""
    context, ctx_idxs = build_numbered_context(notes)
    prompt = build_final_answer_prompt(question, context, efsa_hint=efsa_hint)
    raw = ""
    norm: Dict[str, Any] = {"answer": "insufficient information",
                            "evidence_spans": [], "insufficient": True}
    ok, issues = False, ["no LLM output"]
    for attempt in range(max_retries + 1):
        try:
            raw = llm.generate(prompt, system_prompt=FINAL_ANSWER_SYSTEM,
                               task_type="final_answer")
        except Exception as e:
            logger.warning("final answer generation failed: %s", e)
            continue
        pred = extract_prediction(raw)
        ok, issues, norm = validate_final_answer(
            pred, context,
            require_verbatim_spans=require_verbatim_spans,
            force_insufficient_if_no_spans=force_insufficient_if_no_spans,
        )
        if ok:
            break
    support = [s for s in (extract_prediction(raw).get("support_idxs") or [])
               if isinstance(s, int)] or ctx_idxs[:4]
    return {
        "answer": norm["answer"],
        "evidence_spans": norm["evidence_spans"],
        "support_idxs": support,
        "insufficient": norm["insufficient"],
        "valid": ok,
        "issues": issues,
        "context": context,
    }
