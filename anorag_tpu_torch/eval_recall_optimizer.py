"""Measured effect of the recall-optimizer multi-hop sub-stage, on the card.

Counterpart of scripts/eval_recall_optimizer.py, with its flags, printed
line and report:

    python -m anorag_tpu_torch.eval_recall_optimizer [--n 47] [--seed 11] \
        [--distractors 8] [--report docs/recall_optimizer_ablation.json] \
        [--device cuda]

The measurable is the gold-support coverage of the candidate pool that
QueryProcessor.process() hands downstream. On a multi-hop slice of
scripts/gen_synth_musique.py's items (loaded by path; at least two gold
supports) with the stages that would mask it switched off (two-hop bridge
expansion, graph expansion) and the first hop's budget cut to 3 + 3, each
item's KB is queried twice, recall_optimizer.multi_hop_enabled off and on,
and the pools' coverage compared. --device: cuda (the default) or cpu,
where the root script pins the CPU. The config starts from the port's
defaults and is this run's own.
"""
from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path
from typing import Optional, Sequence

from anorag_tpu_torch.config import Config
from anorag_tpu_torch.doc.processor import DocumentProcessor
from anorag_tpu_torch.pipeline_musique import musique_item_to_document
from anorag_tpu_torch.query.processor import QueryProcessor
from anorag_tpu_torch.training.synth import synth_generator


def _pool_coverage(notes, gold_idxs) -> float:
    got = set()
    for n in notes:
        got.update(int(p) for p in (n.get("paragraph_idxs") or []))
    return len(gold_idxs & got) / len(gold_idxs) if gold_idxs else 1.0


def ablation_cfg(device: str) -> Config:
    """The isolation regime: the hash embedder, a Flat index, first-hop
    recall cut to 3 + 3 and the other recovery stages off."""
    cfg = Config()
    cfg.set("system.device", device)
    cfg.set("embedding.backend", "hash")
    cfg.set("embedding.dim", 128)
    cfg.set("vector_store.index_type", "Flat")
    cfg.set("retrieval.embed_topk_hop1", 3)
    cfg.set("retrieval.bm25_topk_hop1", 3)
    cfg.set("hybrid_search.two_hop.enabled", False)
    cfg.set("retrieval.multi_hop.enabled", False)
    return cfg


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=47)
    ap.add_argument("--distractors", type=int, default=8)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--report", default="docs/recall_optimizer_ablation.json")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = ablation_cfg(args.device)
    items = [it for it in synth_generator().make_items(args.n, args.distractors, args.seed)
             if it.get("answerable", True)
             and sum(1 for p in it["paragraphs"] if p.get("is_supporting")) >= 2]
    cov = {False: [], True: []}
    with tempfile.TemporaryDirectory() as td:
        for it in items:
            dp = DocumentProcessor(Path(td) / it["id"], llm=None, cfg=cfg,
                                   device=args.device)
            kb = dp.process_documents(
                documents=[musique_item_to_document(it)])
            gold = {p["idx"] for p in it["paragraphs"]
                    if p.get("is_supporting")}
            for enabled in (False, True):
                cfg.set("recall_optimizer.multi_hop_enabled", enabled)
                cfg.set("recall_optimizer.comprehensive_rerank", enabled)
                qp = QueryProcessor(kb["atomic_notes"], cfg=cfg, llm=None,
                                    work_dir=Path(td) / f"{it['id']}_q{int(enabled)}",
                                    device=args.device)
                res = qp.process(it["question"])
                cov[enabled].append(
                    _pool_coverage(res.get("candidate_notes") or [], gold))
    off = round(sum(cov[False]) / len(cov[False]), 4)
    on = round(sum(cov[True]) / len(cov[True]), 4)
    report = {
        "protocol": "gold-support coverage of the post-recall-optimizer "
                    "candidate pool; multi-hop slice (>=2 gold supports), "
                    "two-hop/graph expansion disabled, first-hop top-k 3/3, "
                    "8 distractors, hash embedder",
        "n_items": len(items), "seed": args.seed,
        "pool_gold_coverage_off": off,
        "pool_gold_coverage_on": on,
        "delta": round(on - off, 4),
    }
    out = Path(args.report)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
