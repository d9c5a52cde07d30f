"""HTTP serving front end of the port for a built knowledge base.

Counterpart of the repo's root serve.py (build_processor, make_handler,
main). It loads the KB artifacts once, keeps the corpus on the card, and
serves

  POST /query        {"query": "...", "top_k": 10}      -> answer + notes
  POST /query_batch  {"queries": [...], "top_k": 10}    -> answers (one fused
                     device pass for each sub-batch's retrieval)
  POST /search       {"query": "...", "top_k": 10}      -> ranked notes only
  GET  /healthz                                         -> status + corpus size

    python -m anorag_tpu_torch.serve --work-dir result/N [--config cfg.yaml]
        [--host 127.0.0.1] [--port 8080] [--device cuda]

/query with a "qid", or on a server without an engine (tests), runs the
per-query pipeline (QueryProcessor.process) under a lock; /query without
a qid on a server with an engine goes through the engine's batched path,
as the reference's /query does. --llm wires the configured LLM (LocalLLM;
with `llm.provider: jax` the decoder LM of `llm.jax.model` on the same
device as the KB), and drops it when it is not available.
"""
from __future__ import annotations

import argparse
import json
import socket
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from anorag_tpu_torch.config import Config, as_config
from anorag_tpu_torch.utils.file_io import latest_work_dir, read_json
from anorag_tpu_torch.utils.logging import get_logger, setup_logging

logger = get_logger("anorag.serve")


class Server(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog of SOMAXCONN. The default
    backlog (5) overflows when more clients connect at once than the
    accepting thread takes in time, and the kernel then resets the
    connections that do not fit."""

    request_queue_size = socket.SOMAXCONN


def build_processor(work_dir: str, no_llm: bool = True, cfg=None, device=None):
    """A QueryProcessor over the KB in `work_dir`: atomic_notes.json and,
    when present, embeddings.npy and the note graph graph.json (built from
    the notes when absent); with no_llm False, the configured LLM
    (LocalLLM on `device`) when it is available."""
    from anorag_tpu_torch.query.processor import QueryProcessor

    cfg = as_config(cfg)
    work = Path(work_dir)
    notes = read_json(work / "atomic_notes.json")
    emb_path = work / "embeddings.npy"
    embeddings = np.load(emb_path) if emb_path.exists() else None
    graph_file = work / "graph.json"
    llm = None
    if not no_llm:
        from anorag_tpu_torch.llm.local_llm import LocalLLM

        llm = LocalLLM(cfg=cfg, device=device)
        if not llm.is_available():
            logger.warning("the configured LLM (llm.provider %s) is not "
                           "available; answering without it",
                           llm.cfg.get("llm.provider"))
            llm = None
    return QueryProcessor(
        notes, embeddings=embeddings,
        graph_file=str(graph_file) if graph_file.exists() else None,
        llm=llm, cfg=cfg, device=device)


def make_handler(qp, engine=None):
    """`engine` (ServingEngine) pipelines retrieval across requests: the
    dispatcher thread keeps up to `depth` device batches in flight while
    request threads wait on futures. Without an engine (tests), requests
    serialize behind a lock, and a /query_batch larger than
    serving.stream_batch runs through qp.process_stream. qp.process runs
    behind the lock in either case: it mutates per-call dicts."""
    lock = threading.Lock()

    def note_fields(notes, keys):
        return [{k: n.get(k) for k in keys} for n in notes]

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj) -> None:
            body = json.dumps(obj, ensure_ascii=False, default=str).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            logger.info("%s %s", self.address_string(), fmt % args)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "n_notes": len(qp.notes)})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
            except Exception as e:
                return self._send(400, {"error": f"bad request: {e}"})
            top_k = int(payload.get("top_k", 10))
            if self.path == "/query_batch":
                queries = payload.get("queries")
                if not isinstance(queries, list) or not queries:
                    return self._send(400, {"error": "missing 'queries' list"})
                qs = [str(x) for x in queries]
                try:
                    if engine is not None:
                        rows = engine.process(qs, top_k=top_k)
                    else:
                        with lock:
                            sb = int(qp.cfg.get("serving.stream_batch", 64))
                            if len(qs) > sb:
                                depth = int(qp.cfg.get("serving.stream_depth", 3))
                                chunks = [qs[i:i + sb] for i in range(0, len(qs), sb)]
                                rows = [r for out in qp.process_stream(
                                    chunks, top_k=top_k, depth=depth) for r in out]
                            else:
                                rows = qp.process_batch(qs, top_k=top_k)
                    return self._send(200, {"results": [
                        {"query": r["query"], "answer": r["answer"],
                         "predicted_support_idxs": r["predicted_support_idxs"],
                         "answer_method": r["answer_method"]}
                        for r in rows
                    ]})
                except Exception as e:
                    logger.exception("batch request failed")
                    return self._send(500, {"error": str(e)})
            query = str(payload.get("query") or "")
            if not query:
                return self._send(400, {"error": "missing 'query'"})
            try:
                if self.path == "/search":
                    notes = qp.retriever.retrieve(query, top_k=top_k, threshold=0.0)
                    return self._send(200, {"notes": note_fields(
                        notes, ("note_id", "title", "content", "final_score",
                                "paragraph_idxs"))})
                if self.path == "/query":
                    dataset = payload.get("dataset")
                    if engine is not None and not payload.get("qid"):
                        r = engine.process([query], dataset=dataset)[0]
                    else:
                        with lock:
                            r = qp.process(query, dataset=dataset,
                                           qid=payload.get("qid"))
                    return self._send(200, {
                        "answer": r["answer"],
                        "predicted_support_idxs": r["predicted_support_idxs"],
                        "answer_method": r["answer_method"],
                        "notes": note_fields(
                            r["notes"][:top_k],
                            ("note_id", "title", "content", "final_score")),
                    })
                return self._send(404, {"error": "unknown path"})
            except Exception as e:
                logger.exception("request failed")
                return self._send(500, {"error": str(e)})

    return Handler


def load_config(path):
    """The YAML file at `path` over the port's defaults, read by the port's
    own reader (no PyYAML), aliases synchronised as the reference's
    ConfigLoader does; the defaults alone when `path` is None."""
    cfg = Config()
    if path:
        if not Path(path).exists():
            raise FileNotFoundError(f"--config {path}: no such file")
        cfg.load_config(path)
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Serve a built knowledge base "
                                             "over HTTP on the card.")
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--config", default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--llm", action="store_true", help="wire the configured LLM "
                    "(llm.provider; jax: the decoder LM of llm.jax.model on "
                    "--device)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cfg = load_config(args.config)
    work = args.work_dir or latest_work_dir(cfg.get("storage.result_root", "./result"))
    if not work or not (Path(work) / "atomic_notes.json").exists():
        print("no knowledge base found; build one with main.py process first",
              file=sys.stderr)
        return 1
    setup_logging()
    qp = build_processor(str(work), no_llm=not args.llm, cfg=cfg, device=args.device)
    from anorag_tpu_torch.serving import ServingEngine

    engine = ServingEngine(
        qp,
        sub_batch=int(cfg.get("serving.stream_batch", 64)),
        depth=int(cfg.get("serving.stream_depth", 3)),
        host_workers=int(cfg.get("serving.host_workers", 1)),
    )
    server = Server((args.host, args.port), make_handler(qp, engine))
    print(f"serving KB ({len(qp.notes)} notes) on http://{args.host}:{args.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
