"""Counterpart of anorag_tpu/utils/json_parser.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Robust JSON extraction from LLM output.

Equivalent of the reference's robust_json_parser
(upstream utils/robust_json_parser.py, used at
query_processor.py:2460): tolerate markdown fences, think-tags, leading
prose, trailing junk, single quotes, and trailing commas.
"""
from __future__ import annotations

import json
import re
from typing import Any, Callable, List, Optional

_FENCE_RE = re.compile(r"```(?:json)?\s*(.*?)```", re.DOTALL)
_THINK_RE = re.compile(r"<think>.*?</think>", re.DOTALL)
_TRAILING_COMMA_RE = re.compile(r",\s*([}\]])")
_CONTROL_RE = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f]")


def _candidates(text: str) -> List[str]:
    text = _THINK_RE.sub("", text or "").strip()
    cands: List[str] = []
    for m in _FENCE_RE.finditer(text):
        cands.append(m.group(1).strip())
    cands.append(text)
    # A truncated top-level list outranks any balanced inner object: the
    # first balanced {...} of a cut-off note list is ONE note, and
    # returning it as a dict silently drops the rest (see _salvage_list).
    lb, ob = text.find("["), text.find("{")
    if lb >= 0 and (ob < 0 or lb < ob):
        salvaged = _salvage_list(text)
        if salvaged is not None:
            cands.append(salvaged)
    # First balanced {...} or [...] span — whichever opener appears first.
    openers = [(text.find(o), o, c) for o, c in (("{", "}"), ("[", "]")) if text.find(o) >= 0]
    for start, opener, closer in sorted(openers):
        depth = 0
        in_str = False
        esc = False
        for i in range(start, len(text)):
            ch = text[i]
            if in_str:
                if esc:
                    esc = False
                elif ch == "\\":
                    esc = True
                elif ch == '"':
                    in_str = False
                continue
            if ch == '"':
                in_str = True
            elif ch == opener:
                depth += 1
            elif ch == closer:
                depth -= 1
                if depth == 0:
                    cands.append(text[start : i + 1])
                    break
    return cands


def _repair(blob: str) -> str:
    blob = _CONTROL_RE.sub("", blob)
    blob = _TRAILING_COMMA_RE.sub(r"\1", blob)
    return blob


def _salvage_list(text: str) -> Optional[str]:
    """Salvage complete leading objects from a TRUNCATED JSON list.

    A bounded generation budget (serve_llm --max-new, jax provider
    max_new) cuts long note lists mid-object; the complete leading
    objects — including the merged info-complete note that leads every
    distilled note list — are still valid. Returns a re-closed list
    literal, or None when the list closed properly (not a truncation)
    or no object completed."""
    start = text.find("[")
    if start < 0:
        return None
    objs: List[str] = []
    depth = 0
    in_str = False
    esc = False
    obj_start = -1
    for i in range(start + 1, len(text)):
        ch = text[i]
        if in_str:
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = False
            continue
        if ch == '"':
            in_str = True
        elif ch == "{":
            if depth == 0:
                obj_start = i
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0 and obj_start >= 0:
                objs.append(text[obj_start : i + 1])
                obj_start = -1
        elif ch == "]" and depth == 0:
            return None
    if not objs:
        return None
    return "[" + ",".join(objs) + "]"


def _close_truncated(text: str) -> Optional[str]:
    """Close a JSON value truncated MID-VALUE at its last stable point.

    _salvage_list needs one complete object; when the generation budget
    cuts inside the FIRST object (e.g. a merged note whose
    secondary_keys overflow max_new), the complete leading fields are
    still recoverable: trim back to the last comma/closer outside a
    string, drop the dangling fragment, and close the open
    bracket/brace stack. Returns the completed literal or None."""
    start_candidates = [i for i in (text.find("["), text.find("{"))
                        if i >= 0]
    if not start_candidates:
        return None
    start = min(start_candidates)
    # single pass: record the opener stack at every cut candidate
    stack: List[str] = []
    in_str = False
    esc = False
    cuts: List[tuple] = []           # (index AFTER the char, stack copy)
    for i in range(start, len(text)):
        ch = text[i]
        if in_str:
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = False
                cuts.append((i + 1, tuple(stack)))
            continue
        if ch == '"':
            in_str = True
        elif ch in "[{":
            stack.append(ch)
        elif ch in "]}":
            if not stack:
                return None
            stack.pop()
            if not stack:
                return None          # closed cleanly — not a truncation
            cuts.append((i + 1, tuple(stack)))
        elif ch == ",":
            cuts.append((i, tuple(stack)))
    closer = {"[": "]", "{": "}"}
    for pos, st in reversed(cuts[-64:]):
        cand = text[start:pos].rstrip().rstrip(",")
        cand += "".join(closer[o] for o in reversed(st))
        try:
            json.loads(cand)
            return cand
        except Exception:
            continue
    return None


def extract_json(text: str) -> Optional[Any]:
    """Best-effort parse of the first JSON value in `text`."""
    for cand in _candidates(text):
        for attempt in (cand, _repair(cand)):
            try:
                return json.loads(attempt)
            except Exception:
                continue
    for salvage in (_salvage_list, _close_truncated):
        salvaged = salvage(text or "")
        if salvaged is not None:
            try:
                return json.loads(_repair(salvaged))
            except Exception:
                pass
    return None


def extract_json_with_retry(
    text: str,
    retry_fn: Optional[Callable[[], str]] = None,
    max_retries: int = 1,
) -> Optional[Any]:
    """Parse; on failure re-ask the producer (usually a shortened re-prompt)."""
    parsed = extract_json(text)
    tries = 0
    while parsed is None and retry_fn is not None and tries < max_retries:
        tries += 1
        try:
            parsed = extract_json(retry_fn())
        except Exception:
            parsed = None
    return parsed


def extract_prediction(text: str) -> dict:
    """Parse a final-answer JSON ({answer, evidence_spans, ...}); fall back to
    treating raw text as the answer."""
    obj = extract_json(text)
    if isinstance(obj, dict) and "answer" in obj:
        return obj
    return {"answer": (text or "").strip(), "evidence_spans": [], "insufficient": not text}
