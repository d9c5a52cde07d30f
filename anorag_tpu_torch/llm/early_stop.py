"""Counterpart of anorag_tpu/llm/early_stop.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Streaming early stop.

Parity target: upstream llm/streaming_early_stop.py:10-95 — when a
streamed note-generation response starts with the sentinel character ('~' =
"this chunk yields 0 notes"), abort the stream immediately to save tokens.
Works over any token iterator.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple


class StreamingEarlyStop:
    def __init__(self, sentinel: str = "~", probe_chars: int = 4):
        self.sentinel = sentinel
        self.probe_chars = probe_chars
        self.stats = {"streams": 0, "early_stopped": 0}

    def consume(self, token_stream: Iterable[str]) -> Tuple[str, bool]:
        """Returns (full text or sentinel prefix, early_stopped)."""
        self.stats["streams"] += 1
        buf = []
        probed = False
        it = iter(token_stream)
        for tok in it:
            buf.append(tok)
            if not probed:
                head = "".join(buf).lstrip()
                if len(head) >= 1:
                    if head.startswith(self.sentinel):
                        self.stats["early_stopped"] += 1
                        return self.sentinel, True
                    if len(head) >= self.probe_chars:
                        probed = True
        return "".join(buf), False

    @staticmethod
    def is_empty_result(text: str, sentinel: str = "~") -> bool:
        return (text or "").strip().startswith(sentinel)
