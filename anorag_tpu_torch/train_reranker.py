"""Train the listwise cross-encoder reranker on an atomic-notes corpus.

Counterpart of scripts/train_reranker.py, with its flags and printed lines:

    python -m anorag_tpu_torch.train_reranker NOTES.json[l] [--config x.yaml] \
        [--epochs 10] [--batch-size 8] [--slate-size 4] [--negatives 6] \
        [--lr 1e-3] [--max-length 128] [--checkpoint ./result/reranker_ckpt] \
        [--resume CKPT]

Slates of (pseudo-query, positive, negatives) from the notes
(models/cross_encoder.py's slates_from_notes), listwise softmax CE
(CrossEncoderReranker.train), on system.device: cuda by default, cpu only
when the config says so. The checkpoint is the model's state dict
(torch.save), usable as rerank.checkpoint with rerank.backend: jax.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence

from anorag_tpu_torch.config import Config
from anorag_tpu_torch.main import config_device
from anorag_tpu_torch.models.cross_encoder import (CrossEncoderConfig,
                                                   CrossEncoderReranker,
                                                   slates_from_notes)
from anorag_tpu_torch.utils.file_io import read_json, read_jsonl
from anorag_tpu_torch.utils.logging import setup_logging


def main(argv: Optional[Sequence[str]] = None, cfg: Optional[Config] = None) -> int:
    """Parse `argv` and train. `cfg` is the config to start from (the
    defaults when None); --config replaces it with the YAML file's."""
    ap = argparse.ArgumentParser()
    ap.add_argument("notes", help="atomic_notes.json(l)")
    ap.add_argument("--config", default=None)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--slate-size", type=int, default=4)
    ap.add_argument("--negatives", type=int, default=6)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--max-length", type=int, default=128)
    ap.add_argument("--checkpoint", default="./result/reranker_ckpt")
    ap.add_argument("--resume", default=None)
    args = ap.parse_args(argv)
    if args.config:
        from anorag_tpu_torch.serve import load_config

        cfg = load_config(args.config)
    cfg = cfg if cfg is not None else Config()
    setup_logging()

    path = Path(args.notes)
    notes = read_jsonl(path) if path.suffix == ".jsonl" else read_json(path)
    slates = slates_from_notes(notes, n_negatives=args.negatives)
    if not slates:
        print("no trainable slates in the notes file", file=sys.stderr)
        return 1
    xenc_cfg = CrossEncoderConfig.from_config(cfg.get("rerank.model", {}) or {})
    xenc = CrossEncoderReranker(cfg=xenc_cfg, max_length=args.max_length,
                                device=config_device(cfg))
    if args.resume:
        xenc.restore_checkpoint(args.resume)
    hist = xenc.train(slates, epochs=args.epochs, batch_size=args.batch_size,
                      slate_size=args.slate_size, learning_rate=args.lr,
                      max_length=args.max_length)
    if not hist:
        print("no training steps ran (too few slates?)", file=sys.stderr)
        return 1
    ok = xenc.save_checkpoint(Path(args.checkpoint).resolve())
    print(f"trained {len(hist)} steps, final loss {hist[-1]:.4f}, "
          f"checkpoint {'saved to ' + args.checkpoint if ok else 'SAVE FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
