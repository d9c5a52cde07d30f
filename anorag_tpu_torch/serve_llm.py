"""LLM HTTP server of the port: the decoder LM behind Ollama- and
OpenAI-compatible endpoints, on the card.

Counterpart of scripts/serve_llm.py (MicroBatcher, make_handler, main). It
serves a models/decoder_lm.py checkpoint over the wire formats that the
LLM layer's clients speak (llm/clients.py): Ollama's POST /api/generate
and OpenAI's POST /v1/chat/completions, with GET /stats (or /health) for
the batcher's counts. Concurrent requests are micro-batched: a dispatcher
thread drains the queue for a short window and makes one batched
DecoderLM.generate call for the group. A request that asks for at most one
token (a client's health probe) is answered at once with an empty text.

    python -m anorag_tpu_torch.serve_llm --model DIR [--port 11435]
        [--max-batch 8] [--max-new 512] [--device cuda]

Then point the pipeline at it:
  llm: {provider: ollama, ollama: {base_url: http://localhost:11435,
        model: note-lm, timeout: 120}}
"""
from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler
from pathlib import Path

from anorag_tpu_torch.llm.decoder_client import render_prompt
from anorag_tpu_torch.serve import Server

_STOP = object()


class MicroBatcher:
    """Groups concurrent generate requests into one decoder call."""

    def __init__(self, lm, max_batch: int, max_new: int,
                 window_s: float = 0.05):
        self.lm = lm
        self.max_batch = max_batch
        self.max_new = max_new
        self.window_s = window_s
        self.q: "queue.Queue" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "gen_s": 0.0,
                      "errors": 0}
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def submit(self, rendered: str, timeout: float = 600.0) -> str:
        ev = threading.Event()
        slot: dict = {"ev": ev}
        self.q.put((rendered, slot))
        if not ev.wait(timeout):
            raise TimeoutError("generation timed out")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["text"]

    def close(self, timeout: float = 60.0) -> None:
        """Stop the dispatcher thread once the queued requests are served."""
        self.q.put(_STOP)
        self._t.join(timeout)

    def _loop(self):
        while True:
            first = self.q.get()
            if first is _STOP:
                return
            batch = [first]
            stop = False
            t0 = time.time()
            while len(batch) < self.max_batch:
                left = self.window_s - (time.time() - t0)
                if left <= 0:
                    break
                try:
                    item = self.q.get(timeout=left)
                except queue.Empty:
                    break
                if item is _STOP:
                    stop = True
                    break
                batch.append(item)
            self._run(batch)
            if stop:
                return

    def _run(self, batch):
        prompts = [b[0] for b in batch]
        t1 = time.time()
        try:
            texts = self.lm.generate(prompts, max_new=self.max_new,
                                     temperature=0.0)
        except Exception as e:  # deliver the failure, don't hang
            self.stats["errors"] += len(batch)
            for _, slot in batch:
                slot["error"] = str(e)
                slot["ev"].set()
            return
        self.stats["requests"] += len(batch)
        self.stats["batches"] += 1
        self.stats["gen_s"] += time.time() - t1
        for (_, slot), text in zip(batch, texts):
            slot["text"] = text
            slot["ev"].set()


def make_handler(batcher: MicroBatcher, model_name: str):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/stats", "/health"):
                self._json(200, {"model": model_name, **batcher.stats})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length") or 0)
                payload = json.loads(self.rfile.read(n) or b"{}")
            except Exception:
                self._json(400, {"error": "bad json"})
                return
            path = self.path.rstrip("/")
            try:
                if path.endswith("/api/generate"):
                    self._ollama(payload)
                elif path.endswith("/chat/completions"):
                    self._openai(payload)
                else:
                    self._json(404, {"error": f"no route {self.path}"})
            except TimeoutError:
                self._json(504, {"error": "generation timeout"})
            except Exception as e:
                self._json(500, {"error": str(e)})

        # ---- wire formats -------------------------------------------
        def _is_ping(self, max_toks) -> bool:
            """Health probes ask for <= 1 token: answered at once."""
            try:
                return int(max_toks) <= 1
            except (TypeError, ValueError):
                return False

        def _ollama(self, p: dict):
            prompt = str(p.get("prompt") or "")
            system = p.get("system")
            opts = p.get("options") or {}
            if self._is_ping(opts.get("num_predict", 512)):
                self._json(200, {"model": model_name, "response": "",
                                 "done": True})
                return
            text = batcher.submit(render_prompt(prompt, system))
            self._json(200, {"model": model_name, "response": text,
                             "done": True})

        def _openai(self, p: dict):
            system = None
            prompt = ""
            for m in p.get("messages") or []:
                if m.get("role") == "system":
                    system = str(m.get("content") or "")
                elif m.get("role") == "user":
                    prompt = str(m.get("content") or "")
            if self._is_ping(p.get("max_tokens", 512)):
                self._json(200, {"model": model_name, "choices": [
                    {"message": {"role": "assistant", "content": ""},
                     "finish_reason": "stop"}]})
                return
            text = batcher.submit(render_prompt(prompt, system))
            self._json(200, {
                "model": model_name,
                "choices": [{"index": 0,
                             "message": {"role": "assistant",
                                         "content": text},
                             "finish_reason": "stop"}],
                "usage": {"prompt_tokens": len(prompt) // 4,
                          "completion_tokens": len(text) // 4},
            })

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(description="Serve a decoder LM checkpoint "
                                             "over the Ollama and OpenAI wire formats.")
    ap.add_argument("--model", default="checkpoints/note_lm_tpu_large")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=11435)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=512,
                    help="generation byte budget of every request")
    ap.add_argument("--prompt-bucket", type=int, default=0,
                    help="0 = a single bucket at max_prompt")
    ap.add_argument("--window-ms", type=float, default=50.0)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--warmup", type=int, default=1,
                    help="run N batch sizes (1, 2, 4, ... up to max-batch) "
                         "once before serving; 0 skips")
    args = ap.parse_args(argv)

    from anorag_tpu_torch.models.decoder_lm import DecoderLM, load_lm

    params, dcfg = load_lm(args.model, device=args.device)
    bucket = args.prompt_bucket or (dcfg.max_len // 2)
    lm = DecoderLM(params, dcfg, prompt_bucket=bucket)
    print(f"loaded {args.model} on {params.device}: {dcfg.num_layers}L/"
          f"{dcfg.hidden_size}h max_len {dcfg.max_len}, prompt bucket {bucket}",
          flush=True)

    nb = 1
    for _ in range(args.warmup):
        if nb > args.max_batch:
            break
        t0 = time.time()
        lm.generate(["### task: warmup\nping\n### reply:\n"] * nb,
                    max_new=args.max_new)
        print(f"warmup batch={nb}: {time.time() - t0:.1f}s", flush=True)
        nb *= 2

    batcher = MicroBatcher(lm, args.max_batch, args.max_new,
                           window_s=args.window_ms / 1000.0)
    srv = Server((args.host, args.port),
                 make_handler(batcher, Path(args.model).name))
    print(f"serving on http://{args.host}:{args.port} "
          f"(/api/generate, /v1/chat/completions)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        batcher.close()


if __name__ == "__main__":
    main()
