"""ServingEngine: pipelined serving over one QueryProcessor.

Counterpart of anorag_tpu/serving.py (ServingEngine :37). One dispatcher
thread owns the device: it encodes each sub-batch and enqueues its hybrid
search (CUDA work is asynchronous, so the card computes while the host
moves on), with at most `depth` sub-batches in flight. A host worker pool
finalizes each sub-batch as its results land and runs the answer stages on
the rows of the request's dataset namespace (QueryProcessor.
_assemble_batch): one answer dict per query. Callers get a Future per
request; sub-batch results re-assemble in request order. The answer
stages run only on the host workers (the note graph and the processor's
metrics are touched nowhere else); the dispatcher shares only the
tokenizer's cache with them, and functools.lru_cache is thread-safe.
close() drains the queue and joins every thread the engine started.
"""
from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

logger = logging.getLogger("anorag_tpu_torch.serving")

_STOP = object()


class ServingEngine:
    def __init__(self, qp, sub_batch: int = 64, depth: int = 4,
                 host_workers: int = 1):
        self.qp = qp
        self.sub_batch = max(1, int(sub_batch))
        self._inflight = threading.Semaphore(max(1, int(depth)))
        self._q: "queue.Queue" = queue.Queue()
        self._host_pool = ThreadPoolExecutor(max_workers=max(1, int(host_workers)),
                                             thread_name_prefix="anorag-host")
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            name="anorag-dispatch")
        self._closed = False
        self._dispatcher.start()

    # ------------------------------------------------------------ public
    def submit(self, queries: Sequence[str], top_k: Optional[int] = None,
               dataset: Optional[str] = None) -> "Future[List[Dict[str, Any]]]":
        """Enqueue a request; returns a Future resolving to one answer dict
        per query (QueryProcessor.process_batch's), in order, answered from
        the notes of the dataset namespace `dataset` (all when None).
        The request is split into sub_batch chunks that pipeline with every
        other in-flight request's chunks."""
        if self._closed:
            raise RuntimeError("engine closed")
        queries = [str(q) for q in queries]
        chunks = [queries[i:i + self.sub_batch]
                  for i in range(0, len(queries), self.sub_batch)] or [[]]
        subs: List[Future] = [Future() for _ in chunks]
        out: Future = Future()
        pending = [len(subs)]
        lock = threading.Lock()

        def _one_done(_):
            with lock:
                pending[0] -= 1
                if pending[0]:
                    return
            try:
                out.set_result([row for sf in subs for row in sf.result()])
            except Exception as e:               # the first failure
                out.set_exception(e)

        for chunk, sf in zip(chunks, subs):
            sf.add_done_callback(_one_done)
            self._q.put((chunk, top_k, dataset, sf))
        return out

    def process(self, queries: Sequence[str], top_k: Optional[int] = None,
                dataset: Optional[str] = None,
                timeout: Optional[float] = None) -> List[Dict[str, Any]]:
        """Blocking submit()."""
        return self.submit(queries, top_k=top_k, dataset=dataset).result(timeout)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._q.put(_STOP)
            self._dispatcher.join()
            self._host_pool.shutdown(wait=True)

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ internals
    def _dispatch_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is _STOP:
                break
            chunk, top_k, dataset, sf = item
            if not chunk:
                sf.set_result([])
                continue
            self._inflight.acquire()
            try:
                handle = self.qp.retriever.hybrid_search_dispatch(
                    chunk, top_k=top_k or self.qp.default_top_k())
            except Exception as e:
                logger.exception("dispatch failed")
                self._inflight.release()
                sf.set_exception(e)
                continue
            self._host_pool.submit(self._host_stage, handle, chunk, dataset, sf)

    def _host_stage(self, handle, chunk, dataset, sf: Future) -> None:
        try:
            rows = self.qp.retriever.hybrid_search_finalize(handle)
            sf.set_result(self.qp._assemble_batch(rows, chunk, dataset))
        except Exception as e:
            logger.exception("host stage failed")
            sf.set_exception(e)
        finally:
            self._inflight.release()
