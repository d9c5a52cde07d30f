"""Rebuild the vector index from a notes file, with staleness checks, on
the card.

Counterpart of scripts/rebuild_vector_index.py, with its flags, printed
line and files:

    python -m anorag_tpu_torch.rebuild_vector_index NOTES OUT_DIR \
        [--config x.yaml] [--force]

The index is skipped, {"status": "fresh", ...}, when OUT_DIR's
index_versions.json names the embedding config's signature last and
atomic_notes.json is there; else the notes are embedded and indexed
(VectorRetriever.build_index, vector_store.index_type) and saved, the new
version registered, {"status": "rebuilt", ...}. It starts from the port's
defaults (the root script's process-wide config also reads ./config.yaml)
and runs on system.device: cuda unless the config says cpu.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

from anorag_tpu_torch.config import Config
from anorag_tpu_torch.index.embedding_strategy import EmbeddingConfig, IndexVersionRegistry
from anorag_tpu_torch.main import config_device
from anorag_tpu_torch.models.embedding_manager import EmbeddingManager
from anorag_tpu_torch.retrieval.retriever import VectorRetriever
from anorag_tpu_torch.serve import load_config
from anorag_tpu_torch.utils.file_io import read_json, read_jsonl


def main(argv: Optional[Sequence[str]] = None, cfg: Optional[Config] = None) -> int:
    """Parse `argv` and rebuild. `cfg` is the config to start from (the
    defaults when None); --config replaces it with the YAML file's."""
    ap = argparse.ArgumentParser()
    ap.add_argument("notes", help="atomic_notes.json or .jsonl")
    ap.add_argument("out_dir", help="index output directory")
    ap.add_argument("--config", default=None)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if args.config or cfg is None:
        cfg = load_config(args.config)

    notes_path = Path(args.notes)
    notes = (read_jsonl(notes_path) if notes_path.suffix == ".jsonl"
             else read_json(notes_path))
    emb_cfg_dict = cfg.get("embedding", {}) or {}
    emb_cfg = EmbeddingConfig(
        model_name=emb_cfg_dict.get("model_name", "BAAI/bge-m3"),
        backend=emb_cfg_dict.get("backend", "jax"),
        dim=emb_cfg_dict.get("dim", 1024),
        max_length=emb_cfg_dict.get("max_length", 512),
        normalize=emb_cfg_dict.get("normalize", True),
    )
    out = Path(args.out_dir)
    registry = IndexVersionRegistry(out / "index_versions.json")
    if not args.force and registry.is_compatible(emb_cfg) and (out / "atomic_notes.json").exists():
        print(json.dumps({"status": "fresh", "signature": emb_cfg.signature}))
        return 0

    em = EmbeddingManager(cfg, device=config_device(cfg))
    vr = VectorRetriever(embedding_manager=em,
                         index_type=cfg.get("vector_store.index_type", "IVFFlat"))
    vr.build_index(notes)
    vr.save(out)
    entry = registry.register(emb_cfg, str(out), len(notes))
    print(json.dumps({"status": "rebuilt", "n_notes": len(notes),
                      "signature": entry["signature"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
