"""Convert prediction rows to the official MuSiQue format with the port.

Counterpart of the repo's root convert_to_official_format.py, with its
arguments and printed line:

    python -m anorag_tpu_torch.convert_to_official_format PREDS.jsonl OUT.jsonl
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from anorag_tpu_torch.eval.musique import convert_to_official_format
from anorag_tpu_torch.utils.file_io import read_jsonl, write_jsonl


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output")
    args = ap.parse_args(argv)
    rows = convert_to_official_format(read_jsonl(args.input))
    write_jsonl(args.output, rows)
    print(f"wrote {len(rows)} rows -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
