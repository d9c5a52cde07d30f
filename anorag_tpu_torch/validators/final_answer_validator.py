"""Counterpart of anorag_tpu/validators/final_answer_validator.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Final-answer JSON validation.

Parity target: upstream validators/final_answer_validator.py:11-80 —
the answer object must be valid JSON with an `answer` string; every
`evidence_spans` entry must appear verbatim in the packed context; and the
answer must be contained in (or composed of) the evidence spans unless
marked insufficient.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from anorag_tpu_torch.utils.text import normalize_answer


def validate_final_answer(
    obj: Any,
    context: str,
    require_verbatim_spans: bool = True,
    force_insufficient_if_no_spans: bool = True,
) -> Tuple[bool, List[str], Dict[str, Any]]:
    """Returns (ok, issues, normalized answer dict)."""
    issues: List[str] = []
    if not isinstance(obj, dict):
        return False, ["not a JSON object"], {"answer": "insufficient information",
                                              "evidence_spans": [], "insufficient": True}
    answer = obj.get("answer")
    if not isinstance(answer, str) or not answer.strip():
        issues.append("missing answer string")
    spans = obj.get("evidence_spans") or []
    if not isinstance(spans, list):
        issues.append("evidence_spans not a list")
        spans = []
    verbatim_spans = []
    if require_verbatim_spans:
        for s in spans:
            if isinstance(s, str) and s.strip() and s.strip() in context:
                verbatim_spans.append(s.strip())
            else:
                issues.append(f"span not verbatim in context: {str(s)[:60]!r}")
    else:
        verbatim_spans = [s for s in spans if isinstance(s, str)]

    insufficient = bool(obj.get("insufficient"))
    if answer and verbatim_spans and not insufficient:
        a = normalize_answer(answer)
        in_spans = any(a in normalize_answer(s) for s in verbatim_spans)
        composed = all(tok in normalize_answer(" ".join(verbatim_spans)).split()
                       for tok in a.split()) if a else False
        if not (in_spans or composed):
            issues.append("answer not supported by evidence spans")
    if force_insufficient_if_no_spans and not verbatim_spans and not insufficient:
        issues.append("no verbatim spans; forcing insufficient")
        insufficient = True

    ok = not issues
    normalized = {
        "answer": (answer or "").strip() if (answer and not insufficient) else
                  ((answer or "").strip() or "insufficient information"),
        "evidence_spans": verbatim_spans,
        "insufficient": insufficient,
    }
    return ok, issues, normalized
