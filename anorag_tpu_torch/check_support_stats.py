"""Support-idx distribution checks and K-estimate agreement (host only).

Counterpart of scripts/check_support_stats.py, with its flags and printed
report:

    python -m anorag_tpu_torch.check_support_stats PREDICTIONS.jsonl [--gold GOLD.jsonl]

the distribution of predicted support lengths and, with --gold, the share
of rows whose length is within one of support/k_estimator.KEstimator's
estimate for the gold question.
"""
from __future__ import annotations

import argparse
import json
from collections import Counter
from typing import Optional, Sequence

from anorag_tpu_torch.support.k_estimator import KEstimator
from anorag_tpu_torch.utils.file_io import read_jsonl


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("predictions")
    ap.add_argument("--gold", default=None, help="gold jsonl with questions")
    args = ap.parse_args(argv)
    rows = read_jsonl(args.predictions)
    lens = Counter(len(r.get("predicted_support_idxs") or []) for r in rows)
    out = {"support_len_distribution": dict(sorted(lens.items()))}
    if args.gold:
        ke = KEstimator()
        golds = {g.get("id"): g for g in read_jsonl(args.gold)}
        agree = total = 0
        for r in rows:
            g = golds.get(r.get("id"))
            if not g:
                continue
            total += 1
            est = ke.estimate_K(g.get("question", ""))
            if abs(est - len(r.get("predicted_support_idxs") or [])) <= 1:
                agree += 1
        out["k_estimate_agreement"] = agree / max(total, 1)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
