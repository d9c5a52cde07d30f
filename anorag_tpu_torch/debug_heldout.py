"""Debug selected kinds of a dev held-out bank through the pipeline, on
the card.

Counterpart of scripts/debug_heldout.py, with its flags and printed lines:

    python -m anorag_tpu_torch.debug_heldout 0 8 9 [--bank d1] [--n 188] \
        [--seed 77] [--misses-only] [--notes] [--support] [--device cuda]

Like debug_kinds but over gen_heldout_musique's make_heldout; only a dev
bank (d1-d4, v1) is accepted. It reuses run_heldout's pieces: the
pipeline config (hash embedder, Flat index), the generators loaded by
path and the item's kind. --notes prints the KB's extracted notes of each
miss, --support its gold support paragraphs. --device: cuda (the default)
or cpu, where the root script pins the CPU.
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path
from typing import Optional, Sequence

from anorag_tpu_torch.doc.processor import DocumentProcessor
from anorag_tpu_torch.eval.musique import answer_em, gold_aliases, support_f1
from anorag_tpu_torch.pipeline_musique import musique_item_to_document, process_musique_item
from anorag_tpu_torch.run_heldout import item_kind, pipeline_cfg
from anorag_tpu_torch.training.synth import heldout_generator


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("kinds", type=int, nargs="*")
    ap.add_argument("--bank", default="d1")
    ap.add_argument("--n", type=int, default=188)
    ap.add_argument("--seed", type=int, default=77)
    ap.add_argument("--distractors", type=int, default=4)
    ap.add_argument("--p-evidence", type=float, default=0.8)
    ap.add_argument("--p-question", type=float, default=0.6)
    ap.add_argument("--misses-only", action="store_true")
    ap.add_argument("--notes", action="store_true",
                    help="print the extracted rule notes for each item")
    ap.add_argument("--support", action="store_true",
                    help="print gold support paragraphs")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.bank not in ("d1", "d2", "d3", "d4", "v1"):
        raise SystemExit(f"bank {args.bank} is not a dev bank — refusing")

    cfg = pipeline_cfg(args.device)
    items = heldout_generator().make_heldout(args.n, args.distractors, args.seed,
                                             args.p_evidence, args.p_question,
                                             args.bank)
    want = set(args.kinds)
    picked = [it for it in items if not want or item_kind(it) in want]
    hits = 0
    with tempfile.TemporaryDirectory() as td:
        for it in picked:
            res = process_musique_item(it, Path(td) / it["id"], cfg=cfg, llm=None,
                                       device=args.device)
            pred = res.get("predicted_answer") or ""
            em = answer_em(pred, gold_aliases(it)) if it.get(
                "answerable", True) else float(
                pred.lower().startswith("insufficient"))
            hits += int(em == 1.0)
            if args.misses_only and em == 1.0:
                continue
            sf1 = support_f1(res.get("predicted_support_idxs") or [],
                             [p["idx"] for p in it["paragraphs"]
                              if p.get("is_supporting")])
            i = item_kind(it)
            mark = "OK " if em == 1.0 else "MISS"
            print(f"[{mark}] kind={i} id={it['id']} supF1={sf1:.2f} "
                  f"method={res.get('answer_method')}\n"
                  f"  q={it['question']!r}\n"
                  f"  gold={it['answer']!r} pred={pred!r}")
            if args.support and em < 1.0:
                for p in it["paragraphs"]:
                    if p.get("is_supporting"):
                        print(f"  SUP[{p['idx']}] {p['title']}: "
                              f"{p['paragraph_text']}")
            if args.notes and em < 1.0:
                dp = DocumentProcessor(Path(td) / (it["id"] + "_dbg"),
                                       llm=None, cfg=cfg, device=args.device)
                kb = dp.process_documents(
                    documents=[musique_item_to_document(it)])
                for n in kb["atomic_notes"]:
                    print(f"  NOTE {n.get('head_key')!r} "
                          f"-{n.get('rel')}-> {n.get('tail_key')!r} | "
                          f"{(n.get('content') or '')[:90]!r}")
    print(f"{hits}/{len(picked)} hit")


if __name__ == "__main__":
    main()
