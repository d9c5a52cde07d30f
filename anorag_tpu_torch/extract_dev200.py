"""Extract the first N answerable MuSiQue dev items with the port.

Counterpart of the repo's root extract_dev200.py, with its flags and
printed line:

    python -m anorag_tpu_torch.extract_dev200 DEV.jsonl OUT.jsonl [-n 200] \
        [--include-unanswerable]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from anorag_tpu_torch.eval.musique import extract_dev_subset
from anorag_tpu_torch.utils.file_io import read_jsonl, write_jsonl


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", help="full MuSiQue dev jsonl")
    ap.add_argument("output", help="subset jsonl")
    ap.add_argument("-n", type=int, default=200)
    ap.add_argument("--include-unanswerable", action="store_true")
    args = ap.parse_args(argv)
    items = read_jsonl(args.input)
    subset = extract_dev_subset(items, n=args.n,
                                answerable_only=not args.include_unanswerable)
    write_jsonl(args.output, subset)
    print(f"wrote {len(subset)} items -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
