"""Train the SpanPicker / QACoverageScorer / AnswerVerifier heads on
synthetic supervision and write (or merge into) calibration.json, the file
calibration.path points QueryProcessor at.

Counterpart of scripts/train_answer_models.py, with its flags and printed
lines (training/answer_models.py; numpy on the host, no device):

    python -m anorag_tpu_torch.train_answer_models [--out ./result/calibration.json] \
        [--seed 0]
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

from anorag_tpu_torch.training.answer_models import train_answer_models
from anorag_tpu_torch.utils.file_io import read_json, write_json


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="./result/calibration.json")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    comps = train_answer_models(seed=args.seed)
    out = Path(args.out)
    cal = read_json(out) if out.exists() else {}
    cal.setdefault("components", {}).update(comps)
    write_json(out, cal)
    for name, c in comps.items():
        print(f"{name}: train_acc={c['train_acc']:.3f}")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
