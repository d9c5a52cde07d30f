"""Counterpart of anorag_tpu/llm/prompts.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Prompt templates.

Parity targets: upstream llm/prompts/atomic_note.py:1-35 (strict JSON
list of minimal self-contained facts with full-name entities and sentence
ids) and upstream llm/prompts/final_answer.py:1-35 (evidence-first
answer with verbatim evidence_spans, 'insufficient' fallback, and the EFSA
candidate treated as a noisy hint). The wording is our own; the contracts
(JSON shapes, sentinel, discipline rules) match.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

ATOMIC_NOTE_SENTINEL = "~"

ATOMIC_NOTE_SYSTEM = """You convert a text chunk into ATOMIC NOTES: minimal, self-contained facts.
Rules:
- Output ONLY a JSON list. No prose, no markdown fences.
- Each note: {"text": <one complete factual sentence>, "entities": [<full names>],
  "head_key": <subject entity>, "rel": <relation id like performed_by/spouse_of/born_in>,
  "tail_key": <object entity>, "source_sent_ids": [<sentence numbers used>], "salience": <0..1>}
- Use FULL entity names exactly as written in the chunk (never pronouns or partial names).
- Every note must be verifiable from the chunk alone.
- If the chunk contains no extractable facts, output exactly: ~"""

ATOMIC_NOTE_USER_TMPL = """Chunk (sentences are numbered):
{numbered_chunk}

Known entity cards from earlier chunks (use these full names when the chunk
refers to the same entity): {entity_cards}

Return the JSON list of atomic notes now."""


def build_atomic_note_prompt(chunk_text: str, sentences: Sequence[str],
                             entity_cards: Sequence[str] = ()) -> str:
    numbered = "\n".join(f"[{i}] {s}" for i, s in enumerate(sentences))
    return ATOMIC_NOTE_USER_TMPL.format(
        numbered_chunk=numbered or chunk_text,
        entity_cards=", ".join(entity_cards) if entity_cards else "(none)",
    )


FINAL_ANSWER_SYSTEM = """You answer questions STRICTLY from the numbered context lines.
Output ONLY JSON: {"answer": <short answer>, "evidence_spans": [<verbatim quotes from the
context that prove the answer>], "support_idxs": [<paragraph numbers used>], "insufficient": <bool>}
Rules:
- Every evidence span must be copied VERBATIM from a context line.
- If the context does not prove any answer, set "insufficient": true and answer "insufficient information".
- A candidate hint may be provided; it is NOISY — trust the context over the hint."""

FINAL_ANSWER_USER_TMPL = """Question: {question}

Context:
{context}
{hint_block}
Return the JSON object now."""


def build_final_answer_prompt(question: str, context: str,
                              efsa_hint: Optional[str] = None) -> str:
    hint_block = (
        f"\nNoisy candidate hint (may be wrong): {efsa_hint}\n" if efsa_hint else "\n"
    )
    return FINAL_ANSWER_USER_TMPL.format(question=question, context=context,
                                         hint_block=hint_block)


SUBQUESTION_SYSTEM = """You decompose a multi-hop question into 2-3 simpler sub-questions that can
be answered independently and composed. Output ONLY JSON:
{"sub_questions": ["...", "..."]}. If the question is already simple, return it alone."""


def build_subquestion_prompt(question: str) -> str:
    return f"Question: {question}\nReturn the JSON object now."


RELATION_SYSTEM = """You label the relation between two facts. Output ONLY JSON:
{"relation": one of [causal, temporal, definition, comparison, elaboration, contradiction, none],
 "confidence": <0..1>}"""


def build_relation_prompt(text_a: str, text_b: str) -> str:
    return f"Fact A: {text_a}\nFact B: {text_b}\nReturn the JSON object now."


SUMMARY_AUDIT_SYSTEM = """You audit whether a summary note faithfully covers its source text's key
entities and claim. Output ONLY JSON: {"faithful": <bool>, "missing_entities": [...],
"needs_rewrite": <bool>, "reason": "..."}"""


def build_summary_audit_prompt(original: str, note_text: str) -> str:
    return f"Source text: {original}\nNote: {note_text}\nReturn the JSON object now."
