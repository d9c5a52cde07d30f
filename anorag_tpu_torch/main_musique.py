"""MuSiQue batch pipeline entry point of the port.

Counterpart of the repo's root main_musique.py, with its flags and printed
line:

    python -m anorag_tpu_torch.main_musique ITEMS.jsonl PREDS.jsonl \
        [--config cfg.yaml] [--workers 2] [--timeout 300] [--limit N] \
        [--no-resume] [--no-llm] [--enable-cor]

Each item's paragraphs become a fresh knowledge base in its own directory
of a new numbered work dir under storage.result_root, and its question
goes through the port's QueryProcessor.process (pipeline_musique.py); the
rows are appended to PREDS.jsonl as they finish, and a second run skips the
ids already there. The worker threads share one EmbeddingManager and one
LLM. It runs on system.device: cuda by default (the reference's tpu and gpu
name the card too), cpu only when the config says so. --config reads the
YAML file with the port's ConfigLoader (no PyYAML).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence

from anorag_tpu_torch.config import Config
from anorag_tpu_torch.main import config_device
from anorag_tpu_torch.pipeline_musique import MusiqueProcessor
from anorag_tpu_torch.utils.file_io import next_work_dir, read_jsonl, rewire_storage
from anorag_tpu_torch.utils.logging import setup_logging


def main(argv: Optional[Sequence[str]] = None, cfg: Optional[Config] = None) -> int:
    """Parse `argv` and run the dataset. `cfg` is the config to start from
    (the defaults when None); --config replaces it with the YAML file's."""
    ap = argparse.ArgumentParser(description="MuSiQue batch pipeline")
    ap.add_argument("input", help="MuSiQue jsonl (items with paragraphs + question)")
    ap.add_argument("output", help="predictions jsonl")
    ap.add_argument("--config", default=None)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--no-llm", action="store_true")
    ap.add_argument("--enable-cor", action="store_true")
    args = ap.parse_args(argv)

    if args.config:
        from anorag_tpu_torch.serve import load_config

        cfg = load_config(args.config)
    cfg = cfg if cfg is not None else Config()
    work = next_work_dir(Path(cfg.get("storage.result_root", "./result")))
    device = config_device(cfg)
    rewire_storage(cfg, work)
    setup_logging(str(work / "musique.log"))

    items = read_jsonl(args.input)
    if args.limit:
        items = items[: args.limit]

    llm = None
    if not args.no_llm:
        from anorag_tpu_torch.llm.local_llm import LocalLLM

        llm = LocalLLM(cfg=cfg, device=device)
        if not llm.is_available():
            print("warning: LLM endpoint unreachable; running LLM-free", file=sys.stderr)
            llm = None

    from anorag_tpu_torch.models.embedding_manager import EmbeddingManager

    em = EmbeddingManager(cfg, device)  # shared across threads

    mp = MusiqueProcessor(work, llm=llm, cfg=cfg, embedding_manager=em,
                          max_workers=args.workers, item_timeout=args.timeout,
                          enable_cor=args.enable_cor, device=device)
    results = mp.process_dataset(items, args.output, resume=not args.no_resume)
    n_err = sum(1 for r in results if r.get("error"))
    print(f"done: {len(results)} items ({n_err} errors) -> {args.output}; work dir {work}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
