"""Evaluate MuSiQue predictions with the port.

Counterpart of the repo's root run_evaluation.py, with its flags and
output (the metrics as indented JSON):

    python -m anorag_tpu_torch.run_evaluation PREDS.jsonl GOLD.jsonl \
        [--official-out OUT.jsonl] [--enhanced]

Answer EM/F1 and support EM/F1 (eval/musique.py); --enhanced adds the
internal retrieval metrics (eval/evaluator.py); --official-out also writes
the predictions in the official MuSiQue format.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from anorag_tpu_torch.eval.evaluator import EnhancedEvaluator
from anorag_tpu_torch.eval.musique import convert_to_official_format, evaluate_dataset
from anorag_tpu_torch.utils.file_io import read_jsonl, write_jsonl


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("predictions", help="predictions jsonl")
    ap.add_argument("gold", help="gold MuSiQue jsonl")
    ap.add_argument("--official-out", default=None,
                    help="also write official-format predictions here")
    ap.add_argument("--enhanced", action="store_true",
                    help="include internal retrieval metrics")
    args = ap.parse_args(argv)

    preds = read_jsonl(args.predictions)
    golds = read_jsonl(args.gold)
    if args.official_out:
        write_jsonl(args.official_out, convert_to_official_format(preds))
    if args.enhanced:
        metrics = EnhancedEvaluator().evaluate_batch(preds, golds)
    else:
        metrics = evaluate_dataset(preds, golds)
    print(json.dumps(metrics, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
