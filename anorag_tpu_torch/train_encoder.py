"""Fine-tune the retrieval encoder on an atomic-notes corpus, on the card.

Counterpart of the repo's root train_encoder.py, with its flags and printed
line:

    python -m anorag_tpu_torch.train_encoder NOTES.json[l] [--config x.yaml] \
        [--epochs 1] [--batch-size 32] [--lr 1e-4] [--max-length 64] \
        [--model-parallel 1] [--devices N] [--checkpoint ./result/encoder_ckpt] \
        [--resume CKPT] [--small]

Contrastive InfoNCE over (pseudo-query, note) pairs (models/train.py) with
the config's encoder (encoder.*; --small for the debug geometry) on
system.device (cuda by default, cpu only when the config says so). --devices
N trains data x tensor parallel over a mesh of N entries that take the
visible devices in turn (a device repeats where fewer are visible); the
reference's mesh spans every chip it sees, but here a mesh over several
cards is slower than one card (PERF.md §6), so the default is the one
device. --model-parallel is the mesh's 'model' axis, clamped to a divisor of
the entry count as the reference clamps it (to 1 on one device). The checkpoint is
the full encoder state dict (torch.save), the file
embedding.checkpoint_path reads; --resume reads one.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

from anorag_tpu_torch.config import Config
from anorag_tpu_torch.main import config_device
from anorag_tpu_torch.models.encoder import EncoderConfig
from anorag_tpu_torch.models.train import EncoderTrainer, pairs_from_notes
from anorag_tpu_torch.parallel.mesh import visible_devices
from anorag_tpu_torch.utils.file_io import read_json, read_jsonl
from anorag_tpu_torch.utils.logging import setup_logging


def main(argv: Optional[Sequence[str]] = None, cfg: Optional[Config] = None) -> int:
    """Parse `argv` and train. `cfg` is the config to start from (the
    defaults when None); --config replaces it with the YAML file's."""
    ap = argparse.ArgumentParser()
    ap.add_argument("notes", help="atomic_notes.json(l)")
    ap.add_argument("--config", default=None)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--max-length", type=int, default=64)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh entries, taken from the visible devices in turn (default: "
                         "the one device; several cards are slower than one for now)")
    ap.add_argument("--checkpoint", default="./result/encoder_ckpt")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--small", action="store_true", help="small debug geometry")
    args = ap.parse_args(argv)
    if args.config:
        from anorag_tpu_torch.serve import load_config

        cfg = load_config(args.config)
    cfg = cfg if cfg is not None else Config()
    setup_logging()

    p = Path(args.notes)
    notes = read_jsonl(p) if p.suffix == ".jsonl" else read_json(p)
    pairs = pairs_from_notes(notes)
    if len(pairs) < args.batch_size:
        print(f"only {len(pairs)} usable pairs (< batch size)")
        return 1

    enc_cfg = (EncoderConfig.small() if args.small
               else EncoderConfig.from_config(cfg.get("encoder", {}) or {}))
    trainer = EncoderTrainer(cfg=enc_cfg, learning_rate=args.lr,
                             model_parallel=args.model_parallel,
                             devices=(visible_devices(config_device(cfg), args.devices)
                                      if args.devices else [config_device(cfg)]))
    if args.resume:
        trainer.restore_checkpoint(args.resume)
    hist = trainer.train(pairs, epochs=args.epochs, batch_size=args.batch_size,
                         max_length=args.max_length)
    ok = trainer.save_checkpoint(args.checkpoint)
    print(f"trained {len(hist)} steps: loss {hist[0]:.4f} -> {hist[-1]:.4f}; "
          f"checkpoint {'saved to ' + args.checkpoint if ok else 'NOT saved'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
