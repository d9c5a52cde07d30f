"""Run the held-out paraphrase sheet (scripts/gen_heldout_musique.py)
through the full pipeline and report the honest floor, on the card.

Counterpart of scripts/run_heldout.py, with its flags, printed lines and
report:

    python -m anorag_tpu_torch.run_heldout [--n 188] [--seed 77] \
        [--report docs/heldout_report.json] [--embedder hash|trained] \
        [--bank v1] [--verbose] [--device cuda]

Each item is built into a knowledge base of its own in a temporary
directory and answered LLM-free (pipeline_musique.process_musique_item),
then the sheet is scored (eval/musique.evaluate_dataset). The sheet comes
from scripts/gen_heldout_musique.py, loaded by its path.
--embedder trained reads, as the root script does,
checkpoints/encoder_synth_full (relative to the working directory) and
its _report.json: here the torch state dict that
`python -m anorag_tpu_torch.train_retrieval_encoder --out
checkpoints/encoder_synth_full` writes. An orbax directory there (the JAX
package's checkpoint) is refused with an error, as is a checkpoint that
does not load. --device: cuda (the default) or cpu, where the root script
takes cpu or tpu. The config starts from the port's defaults (the root
script's process-wide config also reads ./config.yaml) and is this run's
own.
"""
from __future__ import annotations

import argparse
import json
import tempfile
from collections import defaultdict
from pathlib import Path
from typing import Optional, Sequence

from anorag_tpu_torch.config import Config
from anorag_tpu_torch.eval.musique import answer_em, evaluate_dataset, gold_aliases
from anorag_tpu_torch.models.embedding_manager import EmbeddingManager
from anorag_tpu_torch.pipeline_musique import process_musique_item
from anorag_tpu_torch.training.synth import heldout_generator, synth_generator

TRAINED = Path("checkpoints/encoder_synth_full")


def item_kind(item: dict) -> int:
    """The item's question kind: its id's number modulo the generator's
    N_KINDS."""
    return int(item["id"].split("_")[1]) % synth_generator().N_KINDS


def pipeline_cfg(device: str, embedder: str = "hash") -> Config:
    """The per-item pipeline's config: the hash embedder at 128 wide, or
    the trained encoder of TRAINED's report; a Flat index; on `device`."""
    cfg = Config()
    cfg.set("system.device", device)
    if embedder == "trained":
        rep = json.loads(Path(f"{TRAINED}_report.json").read_text())["config"]
        cfg.set("embedding.backend", "jax")
        cfg.set("embedding.model_name", "")
        cfg.set("embedding.dim", rep["hidden"])
        cfg.set("embedding.checkpoint_path", str(TRAINED.resolve()))
        cfg.set("encoder", {"vocab_size": rep["vocab"],
                            "hidden_size": rep["hidden"],
                            "num_layers": rep["layers"],
                            "num_heads": rep["heads"],
                            "intermediate_size": rep["ffn"],
                            "max_position": rep.get("max_position", 128),
                            "pooling": rep.get("pooling", "mean")})
        cfg.set("embedding.max_length", rep.get("max_position", 128))
    else:
        cfg.set("embedding.backend", "hash")
        cfg.set("embedding.dim", 128)
    cfg.set("vector_store.index_type", "Flat")
    return cfg


def embedding_manager(cfg: Config, device: str) -> EmbeddingManager:
    """One embedding manager for every item. With a checkpoint in the
    config it must be a torch state dict that loads: an orbax directory or
    a file that does not fit raises SystemExit."""
    em = EmbeddingManager(cfg, device=device)
    ckpt = cfg.get("embedding.checkpoint_path", "")
    if ckpt:
        if Path(ckpt).is_dir():
            raise SystemExit(
                f"{ckpt} is a directory, the JAX package's orbax checkpoint; the "
                "port reads a torch state dict there: write one with python -m "
                "anorag_tpu_torch.train_retrieval_encoder --out " + str(TRAINED))
        if not em.load_checkpoint(ckpt):
            raise SystemExit(f"{ckpt}: the encoder checkpoint did not load")
    return em


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=188)
    ap.add_argument("--distractors", type=int, default=4)
    ap.add_argument("--seed", type=int, default=77)
    ap.add_argument("--p-evidence", type=float, default=0.8)
    ap.add_argument("--p-question", type=float, default=0.6)
    ap.add_argument("--report", default="docs/heldout_report.json")
    ap.add_argument("--embedder", default="hash",
                    choices=("hash", "trained"),
                    help="trained = the 24L/1024h checkpoint "
                    "(checkpoints/encoder_synth_full, a torch state dict) "
                    "as the pipeline embedder")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--bank", default="v1",
                    help="paraphrase bank (v1 = dev since round 4; v2 = "
                         "the held-out test bank)")
    ap.add_argument("--verbose", action="store_true",
                    help="print each miss (question/gold/pred)")
    args = ap.parse_args(argv)

    cfg = pipeline_cfg(args.device, args.embedder)
    em = embedding_manager(cfg, args.device)
    items = heldout_generator().make_heldout(args.n, args.distractors, args.seed,
                                             args.p_evidence, args.p_question,
                                             args.bank)
    preds = []
    kind_hits: dict = defaultdict(lambda: [0, 0])
    with tempfile.TemporaryDirectory() as td:
        for it in items:
            res = process_musique_item(it, Path(td) / it["id"], cfg=cfg, llm=None,
                                       embedding_manager=em, device=args.device)
            preds.append(res)
            if it.get("answerable", True):
                i = item_kind(it)
                em_score = answer_em(res.get("predicted_answer") or "",
                                     gold_aliases(it))
                kind_hits[i][0] += int(em_score == 1.0)
                kind_hits[i][1] += 1
                if args.verbose and em_score < 1.0:
                    print(f"MISS kind {i} | {it['question']}\n"
                          f"  gold: {it['answer']} | "
                          f"pred: {res.get('predicted_answer')} "
                          f"({res.get('answer_method')})")
    metrics = evaluate_dataset(preds, items)
    missed = {k: f"{h}/{n}" for k, (h, n) in sorted(kind_hits.items())
              if h < n}
    report = {
        "protocol": "heldout paraphrase sheet (solver-blind bank, "
                    "gen_heldout_musique.py)",
        "bank": args.bank,
        "n_items": args.n, "seed": args.seed,
        "p_evidence": args.p_evidence, "p_question": args.p_question,
        "metrics": {k: round(v, 4) for k, v in metrics.items()},
        "kinds_with_misses": missed,
    }
    out = Path(args.report)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(json.dumps({"bank": args.bank, "heldout_em": report["metrics"].get("answer_em"),
                      "heldout_f1": report["metrics"].get("answer_f1"),
                      "heldout_sup_f1": report["metrics"].get("support_f1"),
                      "n": args.n, "kinds_with_misses": len(missed)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
