"""Run selected synthetic-eval kinds through the full pipeline and print
question / gold / predicted, on the card.

Counterpart of scripts/debug_kinds.py, with its flags and printed lines:

    python -m anorag_tpu_torch.debug_kinds 66 67 68 69 [--n 4] [--seed 9] \
        [--distractors 4] [--verbose] [--device cuda]

--n items of each kind from scripts/gen_synth_musique.py (loaded by
path), through run_heldout's pipeline config (hash embedder, Flat index);
--verbose prints the gold support paragraphs of each miss. --device: cuda
(the default) or cpu, where the root script pins the CPU.
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path
from typing import Optional, Sequence

from anorag_tpu_torch.eval.musique import answer_em, gold_aliases, support_f1
from anorag_tpu_torch.pipeline_musique import process_musique_item
from anorag_tpu_torch.run_heldout import item_kind, pipeline_cfg
from anorag_tpu_torch.training.synth import synth_generator


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("kinds", type=int, nargs="+")
    ap.add_argument("--n", type=int, default=4,
                    help="items per kind")
    ap.add_argument("--seed", type=int, default=9)
    ap.add_argument("--distractors", type=int, default=4)
    ap.add_argument("--verbose", action="store_true",
                    help="print support paragraphs for misses")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    gen = synth_generator()
    cfg = pipeline_cfg(args.device)
    n_cycle = gen.N_KINDS
    total = n_cycle * args.n
    items = gen.make_items(total, distractors=args.distractors, seed=args.seed)
    picked = [it for i, it in enumerate(items)
              if i % n_cycle in set(args.kinds)]
    print(f"{len(picked)} items across kinds {sorted(set(args.kinds))}")
    hits = misses = 0
    with tempfile.TemporaryDirectory() as td:
        for it in picked:
            res = process_musique_item(it, Path(td) / it["id"], cfg=cfg, llm=None,
                                       device=args.device)
            pred = res.get("predicted_answer") or ""
            em = answer_em(pred, gold_aliases(it))
            sf1 = support_f1(res.get("predicted_support_idxs") or [],
                             [p["idx"] for p in it["paragraphs"]
                              if p.get("is_supporting")])
            i = item_kind(it)
            mark = "OK " if em == 1.0 else "MISS"
            print(f"[{mark}] kind={i} supF1={sf1:.2f} "
                  f"q={it['question']!r}\n       gold={it['answer']!r} "
                  f"pred={pred!r}")
            if em == 1.0:
                hits += 1
            else:
                misses += 1
                if args.verbose:
                    for p in it["paragraphs"]:
                        if p.get("is_supporting"):
                            print(f"       SUP[{p['idx']}] {p['title']}: "
                                  f"{p['paragraph_text'][:200]}")
    print(f"\n{hits}/{hits + misses} EM")


if __name__ == "__main__":
    main()
