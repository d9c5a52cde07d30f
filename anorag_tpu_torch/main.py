"""CLI of the port: offline `process` and online `query`.

Counterpart of the repo's root main.py, with its flags and printed lines:

    python -m anorag_tpu_torch.main [--config cfg.yaml] process FILE... \
        [--new] [--force] [--debug] [--no-llm]
    python -m anorag_tpu_torch.main [--config cfg.yaml] query ["question"] \
        [--work-dir result/N] [--debug] [--no-llm]

`process` builds the knowledge base (doc/processor.py) into a numbered work
dir under storage.result_root, reusing the latest one unless --new is given,
so the artifact caches apply across runs; --force rebuilds every stage.
`query` loads atomic_notes.json, embeddings.npy and graph.json of a work dir
into the port's QueryProcessor and answers one question or, without one,
reads questions from stdin. Both run on system.device: cuda by default (the
reference's "tpu" and "gpu" name the card too), cpu only when the config
says so. --config reads YAML as the port's server does (serve.load_config).
--parallel (the reference's engine-parallel document fan-out) is not ported
yet and raises NotImplementedError.
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from anorag_tpu_torch.config import Config
from anorag_tpu_torch.utils.file_io import (latest_work_dir, next_work_dir, read_json,
                                            rewire_storage)
from anorag_tpu_torch.utils.logging import setup_logging


def config_device(cfg) -> str:
    """system.device as a torch device name: cpu when it says cpu, else
    cuda (the reference's configs say tpu, gpu or cuda for the accelerator)."""
    want = str(cfg.get("system.device", "cuda") or "cuda").lower()
    return "cpu" if want == "cpu" else "cuda"


def _make_llm(args, cfg, device):
    if args.no_llm:
        return None
    from anorag_tpu_torch.llm.local_llm import LocalLLM

    llm = LocalLLM(cfg=cfg, device=device)
    if not llm.is_available():
        print("warning: configured LLM endpoint not reachable; running LLM-free",
              file=sys.stderr)
        return None
    return llm


def process_docs(args, cfg: Config) -> int:
    if args.parallel:
        raise NotImplementedError(
            "process --parallel (the engine-parallel document fan-out) is not "
            "ported yet (ROADMAP: the sharded branch); run without --parallel")
    # default REUSES the latest work dir so the incremental/artifact caches
    # apply across runs; --new forces a fresh numbered dir, --force
    # reprocesses inside the reused dir
    root = Path(cfg.get("storage.result_root", "./result"))
    work = None if args.new else latest_work_dir(root)
    work = Path(work) if work else next_work_dir(root)
    device = config_device(cfg)
    rewire_storage(cfg, work)
    setup_logging(str(work / "run.log"),
                  level=logging.DEBUG if args.debug else logging.INFO)
    llm = _make_llm(args, cfg, device)

    from anorag_tpu_torch.doc.processor import DocumentProcessor

    dp = DocumentProcessor(work, llm=llm, cfg=cfg, device=device)
    result = dp.process_documents(file_paths=[str(p) for p in args.files],
                                  force_reprocess=args.force)
    print(f"processed -> {work}: {result['processing_stats']}")
    return 0


def load_query_processor(work, cfg: Config, llm=None):
    """The port's QueryProcessor over the KB artifacts in `work`, as
    `query` builds it (the work dir also takes the query audit)."""
    from anorag_tpu_torch.query.processor import QueryProcessor

    work = Path(work)
    notes = read_json(work / "atomic_notes.json")
    emb_path = work / "embeddings.npy"
    embeddings = np.load(emb_path) if emb_path.exists() else None
    graph_file = work / "graph.json"
    return QueryProcessor(
        notes, embeddings=embeddings,
        graph_file=str(graph_file) if graph_file.exists() else None,
        llm=llm, cfg=cfg, work_dir=str(work), device=config_device(cfg),
    )


def query_mode(args, cfg: Config) -> int:
    work = Path(args.work_dir) if args.work_dir else latest_work_dir(
        cfg.get("storage.result_root", "./result"))
    if not work or not (Path(work) / "atomic_notes.json").exists():
        print("no knowledge base found; run `main.py process` first", file=sys.stderr)
        return 1
    setup_logging(str(Path(work) / "query.log"),
                  level=logging.DEBUG if getattr(args, "debug", False) else logging.INFO)
    qp = load_query_processor(work, cfg, _make_llm(args, cfg, config_device(cfg)))
    if args.question:
        res = qp.process(args.question)
        print(f"answer: {res['answer']}")
        print(f"support: {res['predicted_support_idxs']}  "
              f"(method: {res['answer_method']})")
        return 0
    print("interactive mode — empty line to exit")
    while True:
        try:
            q = input("query> ").strip()
        except EOFError:
            break
        if not q:
            break
        res = qp.process(q)
        print(f"  {res['answer']}   (support {res['predicted_support_idxs']})")
    return 0


def main(argv: Optional[Sequence[str]] = None, cfg: Optional[Config] = None) -> int:
    """Parse `argv` and run the command. `cfg` is the config to start from
    (the defaults when None); --config replaces it with the YAML file's."""
    ap = argparse.ArgumentParser(description="anorag-tpu (PyTorch port)")
    ap.add_argument("--config", default=None)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("process", help="build the knowledge base")
    p.add_argument("files", nargs="+")
    p.add_argument("--new", action="store_true",
                   help="create a new work directory instead of reusing the latest")
    p.add_argument("--force", action="store_true",
                   help="force reprocess (ignore incremental/artifact caches)")
    p.add_argument("--debug", action="store_true", help="debug logging")
    p.add_argument("--parallel", action="store_true",
                   help="not ported yet: raises NotImplementedError")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--strategy", default="hybrid",
                   choices=["copy", "split", "dispatch", "hybrid"])
    p.add_argument("--no-llm", action="store_true")
    p.set_defaults(fn=process_docs)

    q = sub.add_parser("query", help="query the knowledge base")
    q.add_argument("question", nargs="?", default=None)
    q.add_argument("--work-dir", default=None)
    q.add_argument("--debug", action="store_true", help="debug logging")
    q.add_argument("--no-llm", action="store_true")
    q.set_defaults(fn=query_mode)

    args = ap.parse_args(argv)
    if args.config:
        from anorag_tpu_torch.serve import load_config

        cfg = load_config(args.config)
    return args.fn(args, cfg if cfg is not None else Config())


if __name__ == "__main__":
    raise SystemExit(main())
