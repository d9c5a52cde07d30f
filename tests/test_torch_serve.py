"""The port's HTTP entry point (anorag_tpu_torch/serve.py) against the
repo's root serve.py, on the CPU.

Both make_handler(qp, engine) servers run over the same notes
(tests/conftest.py make_notes plus the multi-hop KB) with the hash
embedder, with and without a ServingEngine, on 127.0.0.1 port 0, and get
the requests of tests/test_serve.py: /healthz, /search, /query,
/query_batch (also above serving.stream_batch), bad requests, concurrent
clients. Responses must be equal, scores to 1e-5. /query without an
engine, and any /query with a qid, run the per-query pipeline
(QueryProcessor.process) in both servers; /query without a qid on a
server with an engine runs the batched path in both.
"""
import concurrent.futures as cf
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from anorag_tpu.config import ConfigLoader
from anorag_tpu.models.embedding_manager import EmbeddingManager as JEmbeddingManager
from anorag_tpu.query.processor import QueryProcessor as JQueryProcessor
from anorag_tpu.serving import ServingEngine as JServingEngine
from anorag_tpu_torch import serve as tserve
from anorag_tpu_torch.query.processor import QueryProcessor
from anorag_tpu_torch.serving import ServingEngine
from anorag_tpu_torch.testing import KB_QUESTIONS, kb_notes

import serve as jserve

from conftest import make_notes

BLUE = KB_QUESTIONS[0][0]


def _loader():
    cfg = ConfigLoader(auto_load=False)
    # the tests' 8 virtual CPU devices would put the reference on its
    # sharded search; the port serves from one card
    cfg.set("tpu.sharded_search", "off")
    cfg.set("embedding.backend", "hash")
    cfg.set("embedding.dim", 64)
    cfg.set("vector_store.index_type", "Flat")
    return cfg


def _start(handler):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def urls():
    """{"ref"|"port": {"plain"|"engine": url}} over the same notes."""
    notes = make_notes(12) + kb_notes()
    loader = _loader()
    jqp = JQueryProcessor(notes, cfg=loader,
                          embedding_manager=JEmbeddingManager(cfg=loader, singleton=False))
    qp = QueryProcessor(notes, cfg=loader.as_dict(), device="cpu")
    engines = [JServingEngine(jqp, sub_batch=4, depth=3), ServingEngine(qp, sub_batch=4, depth=3)]
    servers, out = [], {}
    for name, mod, q, eng in (("ref", jserve, jqp, engines[0]), ("port", tserve, qp, engines[1])):
        plain, plain_url = _start(mod.make_handler(q))
        engined, engine_url = _start(mod.make_handler(q, eng))
        servers += [plain, engined]
        out[name] = {"plain": plain_url, "engine": engine_url}
    yield out
    for srv in servers:
        srv.shutdown()
        srv.server_close()
    for eng in engines:
        eng.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def _post(url, payload, raw=None):
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _same_notes(got, want):
    assert [n["note_id"] for n in got] == [n["note_id"] for n in want]
    np.testing.assert_allclose([n["final_score"] for n in got],
                               [n["final_score"] for n in want], atol=1e-5, rtol=0)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "final_score"} == \
            {k: v for k, v in w.items() if k != "final_score"}


def _same_answer(got, want):
    assert {k: v for k, v in got.items() if k != "notes"} == \
        {k: v for k, v in want.items() if k != "notes"}
    _same_notes(got["notes"], want["notes"])


def test_healthz(urls):
    for kind in ("plain", "engine"):
        assert _get(urls["port"][kind] + "/healthz") == _get(urls["ref"][kind] + "/healthz")
    assert _get(urls["port"]["plain"] + "/healthz") == (200, {"status": "ok", "n_notes": 18})


@pytest.mark.parametrize("query,top_k", [("Aurora Lane Blue Horizon", 3),
                                         ("Nexus Labs founder", 10), (BLUE, 5)])
def test_search_equals_the_reference(urls, query, top_k):
    code, got = _post(urls["port"]["engine"] + "/search", {"query": query, "top_k": top_k})
    want_code, want = _post(urls["ref"]["engine"] + "/search", {"query": query, "top_k": top_k})
    assert code == want_code == 200 and got["notes"]
    _same_notes(got["notes"], want["notes"])


@pytest.mark.parametrize("kind", ["plain", "engine"])
@pytest.mark.parametrize("query", [q for q, *_ in KB_QUESTIONS]
                         + ["Who is the director of Silent River?"])
def test_query_equals_the_reference_engine(urls, kind, query):
    """The port's /query, with an engine (the batched path) or without
    (process()), against the reference's server of the same kind."""
    payload = {"query": query, "top_k": 4}
    code, got = _post(urls["port"][kind] + "/query", payload)
    want_code, want = _post(urls["ref"][kind] + "/query", payload)
    assert code == want_code == 200
    _same_answer(got, want)
    expected = {q: a for q, a, *_ in KB_QUESTIONS}.get(query)
    assert expected is None or got["answer"] == expected
    assert len(got["notes"]) == 4


@pytest.mark.parametrize("kind", ["plain", "engine"])
@pytest.mark.parametrize("query", [q for q, *_ in KB_QUESTIONS]
                         + ["Who is the director of Silent River?"])
def test_query_with_a_qid_runs_process_as_the_reference(urls, kind, query):
    """/query with a qid runs process() in both servers, with an engine or
    without: the reference's answer, support, method and notes."""
    payload = {"query": query, "qid": "q1", "top_k": 6}
    code, got = _post(urls["port"][kind] + "/query", payload)
    want_code, want = _post(urls["ref"][kind] + "/query", payload)
    assert code == want_code == 200
    _same_answer(got, want)
    expected = {q: a for q, a, *_ in KB_QUESTIONS}.get(query)
    assert expected is None or got["answer"] == expected


@pytest.mark.parametrize("dataset", [None, "ds1"])
def test_query_without_an_engine_is_process(urls, dataset):
    """/query on the server without an engine answers as
    QueryProcessor.process does, on the reference's server as on the
    port's, with a dataset too (notes without one count as in it); a qid
    changes nothing."""
    for query in [q for q, *_ in KB_QUESTIONS] + ["Who founded Nexus Labs?"]:
        payload = {"query": query, "top_k": 5, "dataset": dataset}
        code, got = _post(urls["port"]["plain"] + "/query", payload)
        assert (code, got) == _post(urls["port"]["plain"] + "/query",
                                    {**payload, "qid": "q2"})
        want_code, want = _post(urls["ref"]["plain"] + "/query", payload)
        assert code == want_code == 200
        _same_answer(got, want)


@pytest.mark.parametrize("kind", ["plain", "engine"])
def test_query_batch_equals_the_reference(urls, kind):
    payload = {"queries": [q for q, *_ in KB_QUESTIONS]
               + ["Who is the director of Silent River?", "Who founded Nexus Labs?"],
               "top_k": 5}
    code, got = _post(urls["port"][kind] + "/query_batch", payload)
    assert (code, got) == _post(urls["ref"][kind] + "/query_batch", payload)
    assert [r["answer"] for r in got["results"][:3]] == [a for _, a, *_ in KB_QUESTIONS]


def test_query_batch_streams_large_requests(urls):
    """> serving.stream_batch queries without an engine run process_stream:
    complete, in order, equal to the reference's."""
    qs = ["Who is the director of Silent River?", "Who founded Nexus Labs?", BLUE] * 27
    payload = {"queries": qs, "top_k": 5}
    code, got = _post(urls["port"]["plain"] + "/query_batch", payload)
    assert code == 200 and [r["query"] for r in got["results"]] == qs
    assert (code, got) == _post(urls["ref"]["plain"] + "/query_batch", payload)
    assert got["results"][0]["answer"] == got["results"][78]["answer"]


@pytest.mark.parametrize("kind", ["plain", "engine"])
def test_bad_requests_as_the_reference(urls, kind):
    cases = [("/query", {}, None), ("/query", None, b"not json"),
             ("/query_batch", {"queries": []}, None),
             ("/query_batch", {"queries": "x"}, None), ("/search", {}, None),
             ("/nope", {"query": "x"}, None)]
    for path, payload, raw in cases:
        code, body = _post(urls["port"][kind] + path, payload, raw)
        want_code, want = _post(urls["ref"][kind] + path, payload, raw)
        assert code == want_code and code in (400, 404), (path, code)
        assert body.keys() == want.keys() == {"error"}
    code, _ = _post(urls["port"][kind] + "/query", {}, b"not json")
    assert code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(urls["port"][kind] + "/nope", timeout=10)
    assert e.value.code == 404


@pytest.mark.parametrize("kind", ["plain", "engine"])
def test_concurrent_clients(urls, kind):
    """Parallel requests against the threaded server: every client gets a
    complete response, equal to the one it gets alone."""
    url = urls["port"][kind]
    calls = [("/query", {"query": "Who founded Nexus Labs?"}),
             ("/search", {"query": "Silent River", "top_k": 2}),
             ("/query_batch", {"queries": ["Who is the director of Silent River?"] * 6,
                               "top_k": 3})]
    alone = [_post(url + path, payload) for path, payload in calls]
    with cf.ThreadPoolExecutor(max_workers=6) as ex:
        results = list(ex.map(lambda i: _post(url + calls[i % 3][0], calls[i % 3][1]),
                              range(12)))
    for i, (code, body) in enumerate(results):
        assert code == 200
        if calls[i % 3][0] == "/search":
            _same_notes(body["notes"], alone[i % 3][1]["notes"])
        elif calls[i % 3][0] == "/query":
            _same_answer(body, alone[i % 3][1])
        else:
            assert body == alone[i % 3][1]


class _Slow(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
        time.sleep(0.2)
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def test_server_takes_a_burst_above_the_default_backlog():
    """64 clients post at once to a handler that takes 0.2 s: every one
    is queued and answered. ThreadingHTTPServer's backlog of 5 overflows
    when they come faster than the accepting thread takes them, and the
    kernel resets the connections that do not fit."""
    n = 64
    srv = tserve.Server(("127.0.0.1", 0), _Slow)
    assert srv.request_queue_size >= n
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/"
    start = threading.Barrier(n)

    def ask(i):
        data = json.dumps({"client": i, "pad": "x" * 2048}).encode()
        start.wait()
        with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=60) as r:
            return r.status, r.read() == data

    try:
        with cf.ThreadPoolExecutor(max_workers=n) as ex:
            got = list(ex.map(ask, range(n)))
    finally:
        srv.shutdown()
        srv.server_close()
    assert got == [(200, True)] * n


def test_build_processor_and_main(tmp_path, monkeypatch, capsys):
    from anorag_tpu_torch.utils.file_io import write_json

    notes = make_notes(8) + kb_notes()
    write_json(tmp_path / "atomic_notes.json", notes)
    cfg = tserve.load_config(None)
    cfg.set("embedding.backend", "hash")
    cfg.set("embedding.dim", 32)
    cfg.set("vector_store.index_type", "Flat")
    qp = tserve.build_processor(str(tmp_path), cfg=cfg, device="cpu")
    assert len(qp.notes) == 14
    assert qp.process_batch([BLUE])[0]["answer"] == "Chris Reed"
    np.save(tmp_path / "embeddings.npy",
            np.random.default_rng(0).standard_normal((14, 32)).astype(np.float32))
    qp2 = tserve.build_processor(str(tmp_path), cfg=cfg, device="cpu")
    assert qp2.process_batch([BLUE])[0]["answer"] == "Chris Reed"
    # --llm with a provider that is not available (jax without a
    # checkpoint) answers without it, as root serve.py does
    cfg.set("llm.provider", "jax")
    cfg.set("llm.jax.model", str(tmp_path / "no_checkpoint"))
    assert tserve.build_processor(str(tmp_path), no_llm=False, cfg=cfg,
                                  device="cpu").llm is None
    assert tserve.main(["--work-dir", str(tmp_path / "missing"), "--device", "cpu"]) == 1
    assert "no knowledge base" in capsys.readouterr().err


def test_load_config_reads_yaml_or_names_the_missing_package(tmp_path, monkeypatch):
    path = tmp_path / "cfg.yaml"
    path.write_text("serving:\n  stream_batch: 16\nembedding:\n  backend: hash\n")
    try:
        import yaml  # noqa: F401
        cfg = tserve.load_config(str(path))
        assert (cfg.get("serving.stream_batch"), cfg.get("serving.stream_depth"),
                cfg.get("embedding.backend")) == (16, 3, "hash")
    except ImportError:
        pass
    monkeypatch.setitem(__import__("sys").modules, "yaml", None)
    with pytest.raises(SystemExit, match="PyYAML"):
        tserve.load_config(str(path))
    assert tserve.load_config(None).get("serving.stream_batch") == 64


def test_engine_direct_api_answers():
    """ServingEngine directly: futures resolve in order to process_batch's
    answers; empty requests and post-close submissions behave."""
    qp = QueryProcessor(make_notes(8) + kb_notes(), cfg=_loader().as_dict(), device="cpu")
    engine = ServingEngine(qp, sub_batch=2, depth=2)
    try:
        futs = [engine.submit([BLUE, "Who founded Nexus Labs?", BLUE]) for _ in range(4)]
        for f in futs:
            rows = f.result(timeout=60)
            assert [r["answer"] for r in rows] == ["Chris Reed", "David Kim", "Chris Reed"]
        assert engine.process([]) == []
    finally:
        engine.close()
    with pytest.raises(RuntimeError):
        engine.submit(["x"])


def test_engine_with_several_host_workers_answers_as_process_batch():
    """Answer stages on 4 host workers at once (the note graph and the
    text caches shared), with a short switch interval: every request gets
    process_batch's answers, in order."""
    import sys

    qp = QueryProcessor(make_notes(12) + kb_notes(), cfg=_loader().as_dict(), device="cpu")
    queries = [BLUE, "Who founded Nexus Labs?", KB_QUESTIONS[2][0],
               "Who is the director of Silent River?", "Aurora Lane Blue Horizon"]
    want = [r["answer"] for r in qp.process_batch(queries)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ServingEngine(qp, sub_batch=1, depth=8, host_workers=4) as engine:
            futures = [engine.submit(queries) for _ in range(12)]
            got = [[r["answer"] for r in f.result(timeout=120)] for f in futures]
        assert not engine._dispatcher.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert got == [want] * 12
