"""Counterpart of anorag_tpu/llm/summary_auditor.py,
copied as it is with its imports renamed to anorag_tpu_torch.

SummaryAuditor: two-stage note faithfulness audit.

Parity target: upstream utils/summary_auditor.py:13-380 — stage 1
diffs entities between the original text and the note (rule NER); when
entities are missing, stage 2 asks an LLM to judge; notes are flagged
`needs_rewrite`. Batch mode emits an audit report.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from anorag_tpu_torch.llm.prompts import SUMMARY_AUDIT_SYSTEM, build_summary_audit_prompt
from anorag_tpu_torch.utils.json_parser import extract_json
from anorag_tpu_torch.utils.text import extract_entities_fallback


class SummaryAuditor:
    def __init__(self, llm=None, missing_ratio_threshold: float = 0.5):
        self.llm = llm
        self.missing_ratio_threshold = missing_ratio_threshold

    def audit_note(self, original_text: str, note: Dict[str, Any]) -> Dict[str, Any]:
        note_text = str(note.get("content") or note.get("text") or "")
        orig_ents = {e.lower() for e in extract_entities_fallback(original_text)}
        note_ents = {e.lower() for e in extract_entities_fallback(note_text)}
        note_ents |= {str(e).lower() for e in (note.get("entities") or [])}
        missing = sorted(orig_ents - note_ents)
        ratio = len(missing) / max(len(orig_ents), 1)

        result = {
            "note_id": note.get("note_id"),
            "missing_entities": missing,
            "missing_ratio": ratio,
            "needs_rewrite": False,
            "stage": 1,
        }
        if ratio < self.missing_ratio_threshold:
            return result
        # stage 2: LLM judgment (if available); else rule verdict
        if self.llm is not None:
            try:
                raw = self.llm.generate(
                    build_summary_audit_prompt(original_text, note_text),
                    system_prompt=SUMMARY_AUDIT_SYSTEM, task_type="atomic_note",
                )
                obj = extract_json(raw) or {}
                result["stage"] = 2
                result["needs_rewrite"] = bool(obj.get("needs_rewrite",
                                                       not obj.get("faithful", True)))
                result["reason"] = obj.get("reason", "")
                return result
            except Exception:
                pass
        result["needs_rewrite"] = True
        result["reason"] = f"missing {len(missing)} source entities"
        return result

    def audit_batch(self, pairs: Sequence[tuple]) -> Dict[str, Any]:
        """pairs = [(original_text, note)]; returns a report."""
        audits = [self.audit_note(orig, note) for orig, note in pairs]
        flagged = [a for a in audits if a["needs_rewrite"]]
        return {
            "total": len(audits),
            "flagged": len(flagged),
            "flag_rate": len(flagged) / max(len(audits), 1),
            "audits": audits,
        }
