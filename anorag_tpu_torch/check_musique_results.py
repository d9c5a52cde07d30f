"""Result sanity checks over a predictions jsonl (host only).

Counterpart of scripts/check_musique_results.py, with its argument and
printed report:

    python -m anorag_tpu_torch.check_musique_results PREDICTIONS.jsonl

forbidden-word ratio, empty-answer ratio, mean support length and the
share of rows whose support has 2-4 paragraphs.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from anorag_tpu_torch.utils.file_io import read_jsonl

FORBIDDEN = ("insufficient information", "i don't know", "cannot answer", "unknown")


def check(rows):
    n = max(len(rows), 1)
    empty = sum(1 for r in rows if not (r.get("predicted_answer") or "").strip())
    forbidden = sum(
        1 for r in rows
        if any(f in (r.get("predicted_answer") or "").lower() for f in FORBIDDEN)
    )
    sup_lens = [len(r.get("predicted_support_idxs") or []) for r in rows]
    in_range = sum(1 for l in sup_lens if 2 <= l <= 4)
    return {
        "n": len(rows),
        "empty_answer_ratio": empty / n,
        "forbidden_ratio": forbidden / n,
        "avg_support_len": sum(sup_lens) / n,
        "support_len_2_to_4_ratio": in_range / n,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("predictions")
    args = ap.parse_args(argv)
    print(json.dumps(check(read_jsonl(args.predictions)), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
