"""Counterpart of anorag_tpu/llm/notes_io.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Streaming note IO + generation statistics.

Parity targets: upstream utils/note_jsonl_writer.py (crash-safe
incremental note persistence) and utils/notes_stats_logger.py (per-run
generation statistics report).
"""
from __future__ import annotations

import json
import time
from collections import Counter, defaultdict
from pathlib import Path
from typing import Any, Dict, List, Sequence


class NoteJsonlWriter:
    """Append-as-you-go note writer: each flush is a durable line, so a
    crashed generation run resumes from what's on disk."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")
        self.written = 0

    def write(self, note: Dict[str, Any]) -> None:
        self._fh.write(json.dumps(note, ensure_ascii=False) + "\n")
        self._fh.flush()
        self.written += 1

    def write_many(self, notes: Sequence[Dict[str, Any]]) -> None:
        for n in notes:
            self.write(n)

    def existing_ids(self) -> set:
        if not self.path.exists():
            return set()
        out = set()
        with open(self.path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if line:
                    try:
                        out.add(json.loads(line).get("note_id"))
                    except Exception:
                        continue
        return out

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NotesStatsLogger:
    """Aggregates note-generation outcomes into a report."""

    def __init__(self):
        self.t0 = time.time()
        self.per_doc: Dict[str, int] = defaultdict(int)
        self.outcomes: Counter = Counter()
        self.entity_counts: List[int] = []
        self.note_lengths: List[int] = []

    def record_note(self, note: Dict[str, Any]) -> None:
        self.per_doc[str(note.get("doc_id"))] += 1
        self.outcomes["accepted"] += 1
        self.entity_counts.append(len(note.get("entities") or []))
        self.note_lengths.append(len(note.get("content") or ""))

    def record_outcome(self, outcome: str, n: int = 1) -> None:
        self.outcomes[outcome] += n

    def report(self) -> Dict[str, Any]:
        n = self.outcomes.get("accepted", 0)
        return {
            "elapsed_s": round(time.time() - self.t0, 2),
            "n_notes": n,
            "n_docs": len(self.per_doc),
            "notes_per_doc_avg": n / max(len(self.per_doc), 1),
            "avg_entities_per_note": (sum(self.entity_counts) / n) if n else 0.0,
            "avg_note_chars": (sum(self.note_lengths) / n) if n else 0.0,
            "no_entity_ratio": (sum(1 for c in self.entity_counts if c == 0) / n) if n else 0.0,
            "outcomes": dict(self.outcomes),
        }
