"""The port's LLM layer (anorag_tpu_torch/llm/) against anorag_tpu's, on
the CPU.

The client modules are copies of the reference's with their imports
renamed: their ASTs are held equal to the originals' (factory.py and
local_llm.py apart from the named functions that take the device). The
clients run through real sockets against tests/fake_llm_server.py
(malformed JSON, 5xx, timeouts, think-tags, failover, the health thread)
and through mock transports (factory, dispatcher, classifier, pool cache).
process() runs in both packages with the decoder LM of
checkpoints/note_lm_cpu_small as the LLM (answer_selector.apply_before_llm
off, llm.max_output_tokens 16 in both): answers, methods, support and the
notes exactly equal, scores to 1e-5; a stub client returning valid JSON
covers the branch where the LLM's own answer stands.
"""
import json
import time
from pathlib import Path

import pytest

from anorag_tpu.config import ConfigLoader
from anorag_tpu.config.defaults import DEFAULT_CONFIG
from anorag_tpu.llm import __all__ as J_ALL
from anorag_tpu.llm.local_llm import LocalLLM as JLocalLLM
from anorag_tpu.query.processor import QueryProcessor as JQueryProcessor
from anorag_tpu_torch import llm as tllm
from anorag_tpu_torch.config import Config
from anorag_tpu_torch.llm.base import clean_response, with_retry
from anorag_tpu_torch.llm.clients import LMStudioClient, OllamaClient, OpenAIClient
from anorag_tpu_torch.llm.decoder_client import DecoderLLMClient
from anorag_tpu_torch.llm.factory import LLMFactory
from anorag_tpu_torch.llm.local_llm import LocalLLM
from anorag_tpu_torch.llm.multi_model import (HybridLLMDispatcher, MultiModelClient,
                                              TaskClassifier)
from anorag_tpu_torch.llm.optimized_client import (OptimizedMultiModelClient,
                                                   debug_endpoints)
from anorag_tpu_torch.query.processor import QueryProcessor
from anorag_tpu_torch.testing import KB_QUESTIONS, kb_notes

from tests.fake_llm_server import Behavior, FakeLLMServer
from test_torch_answer import _DEVICE, assert_copy_equal
from test_torch_process import assert_same_process
from test_torch_slice import _loader, _notes

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "checkpoints" / "note_lm_cpu_small"

# ------------------------------------------------------------- the copies
LLM_COPIED = ("llm/base.py", "llm/clients.py", "llm/multi_model.py",
              "llm/optimized_client.py", "llm/factory.py", "llm/local_llm.py")
LLM_DIFFERS = {
    "llm/factory.py": {
        "LLMFactory.create_from_config": "takes the device (keyword only) and "
                                         "passes it to the in-process provider",
        "_make_jax_client": "builds the port's provider on the torch decoder "
                            "(llm/decoder_client.py)"},
    "llm/local_llm.py": {
        "LocalLLM.__init__": _DEVICE,
        "LocalLLM.client": "passes the device to LLMFactory.create_from_config"},
}


@pytest.mark.parametrize("rel", LLM_COPIED)
def test_copied_llm_module_equals_the_original(rel):
    assert_copy_equal(rel, LLM_DIFFERS.get(rel, {}))


def test_llm_package_exports_the_references_names():
    """AtomicNoteGenerator too, since the offline pipeline was ported."""
    assert tllm.__all__ == J_ALL
    assert all(getattr(tllm, n).__name__ == n for n in tllm.__all__)


@pytest.mark.parametrize("key", sorted(DEFAULT_CONFIG["llm"]))
def test_llm_config_defaults_equal_the_reference(key):
    assert Config().get(f"llm.{key}") == ConfigLoader(auto_load=False).get(f"llm.{key}")


# ------------------------------------------------------ clients on sockets
def test_ollama_wire_roundtrip_cleans_think_tags():
    with FakeLLMServer("ollama") as srv:
        srv.queue(Behavior("ok", text="  <think>chain of thought</think>Paris\x07  "))
        c = OllamaClient(base_url=srv.url, model="qwen2.5:latest", timeout=5)
        assert c.generate("capital of France?", system_prompt="be terse",
                          max_tokens=32, stop=["\n\n"]) == "Paris"
        req = srv.requests[0]
        assert req["path"] == "/api/generate"
        assert req["payload"]["system"] == "be terse"
        assert req["payload"]["options"] == {"temperature": 0.1, "top_p": 0.9,
                                             "num_predict": 32, "stop": ["\n\n"]}
        assert req["payload"]["stream"] is False


@pytest.mark.parametrize("protocol,client", [("ollama", OllamaClient),
                                             ("openai", LMStudioClient)])
def test_malformed_json_raises_and_counts(protocol, client):
    with FakeLLMServer(protocol) as srv:
        srv.queue(Behavior("malformed"))
        c = client(base_url=srv.url, timeout=5)
        with pytest.raises(ValueError):
            c.generate("hi")
        assert c.stats["errors"] == 1 and c.stats["calls"] == 1


def test_http_500_then_retry_recovers():
    with FakeLLMServer("ollama") as srv:
        srv.queue(Behavior("http_error", status=500), Behavior("ok", text="ok now"))
        c = OllamaClient(base_url=srv.url, timeout=5)
        assert with_retry(lambda: c.generate("hi"), max_times=1, backoff=0.01) == "ok now"
        assert len(srv.requests) == 2
        assert c.stats["errors"] == 1 and c.stats["calls"] == 2


def test_timeout_surfaces_as_an_error():
    with FakeLLMServer("ollama") as srv:
        srv.queue(Behavior("slow", text="late", delay=2.0))
        c = OllamaClient(base_url=srv.url, timeout=0.3)
        t0 = time.time()
        with pytest.raises(OSError):
            c.generate("hi")
        assert time.time() - t0 < 1.5


def test_availability_probe_and_empty_response():
    with FakeLLMServer("ollama") as srv:
        c = OllamaClient(base_url=srv.url, timeout=5)
        assert c.is_available()
        srv.queue(Behavior("empty_choices"))
        assert c.generate("hi") == ""
        url = srv.url
    assert not OllamaClient(base_url=url, timeout=0.5).is_available()


def test_lmstudio_wire_pool_accounting_and_empty_choices():
    with FakeLLMServer("openai") as srv:
        c = LMStudioClient(base_url=srv.url, model="qwen2.5-7b-instruct", timeout=5)
        assert c.generate("ping", system_prompt="sys") == "pong"
        req = srv.requests[0]
        assert req["path"] == "/chat/completions"
        assert req["payload"]["messages"][0] == {"role": "system", "content": "sys"}
        srv.queue(Behavior("empty_choices"), Behavior("http_error"))
        assert c.generate("ping") == ""
        with pytest.raises(OSError):
            c.generate("ping")
        stats = c.instance_stats()
        assert stats[0]["errors"] == 1 and stats[0]["in_flight"] == 0


def test_openai_bearer_auth_header():
    with FakeLLMServer("openai") as srv:
        c = OpenAIClient(base_url=srv.url, timeout=5, api_key="sk-test-123")
        assert c.generate("hi") == "pong"
        assert srv.requests[0]["headers"].get("Authorization") == "Bearer sk-test-123"


def test_multi_model_failover_across_servers():
    with FakeLLMServer("ollama") as bad, FakeLLMServer("ollama") as good:
        bad.default = Behavior("http_error")
        good.default = Behavior("ok", text="from-good")
        c1 = OllamaClient(base_url=bad.url, timeout=5)
        c2 = OllamaClient(base_url=good.url, timeout=5)
        pool = MultiModelClient([c1, c2], strategy="round_robin", max_retries=1)
        assert {pool.generate("q") for _ in range(4)} == {"from-good"}
        assert c1.stats["errors"] >= 1
        assert [s["healthy"] for s in pool.pool_stats()] == [False, True]


def test_multi_model_health_thread_recovers_a_client_marked_down():
    """The health thread (every 0.1 s) probes the real socket; the test
    polls for its verdict up to a 5 s deadline."""
    with FakeLLMServer("ollama") as a, FakeLLMServer("ollama") as b:
        c1 = OllamaClient(base_url=a.url, timeout=2)
        c2 = OllamaClient(base_url=b.url, timeout=2)
        pool = MultiModelClient([c1, c2], health_check_interval=0.1)
        try:
            pool._healthy[id(c1)] = False          # an earlier failure
            deadline = time.monotonic() + 5.0
            while not pool._healthy[id(c1)] and time.monotonic() < deadline:
                time.sleep(0.02)
            assert pool._healthy[id(c1)]
            assert any(r["payload"].get("prompt") == "ping" for r in a.requests)
        finally:
            pool.close()
            pool._health_thread.join(5.0)
        assert not pool._health_thread.is_alive()


def _cfg(**kv) -> Config:
    cfg = Config()
    for k, v in kv.items():
        cfg.set(k, v)
    return cfg


def test_local_llm_through_config_and_socket():
    with FakeLLMServer("ollama") as srv:
        llm = LocalLLM(cfg=_cfg(**{"llm.provider": "ollama",
                                   "llm.ollama.base_url": srv.url,
                                   "llm.ollama.timeout": 5}))
        assert llm.is_available()
        srv.queue(Behavior("ok", text="socket says hi"))
        assert llm.generate("hello") == "socket says hi"
        opts = srv.requests[-1]["payload"]["options"]
        assert (opts["temperature"], opts["num_predict"]) == (0.7, 512)


# ------------------------------------------------------ mock transports
def _ollama(text):
    return lambda url, payload, timeout: {
        "response": text(payload) if callable(text) else text}


def _failing(url, payload, timeout):
    raise ConnectionError("down")


def test_factory_providers_and_unknown_name():
    assert LLMFactory.providers() == ["jax", "lmstudio", "ollama", "openai"]
    c = LLMFactory.create_provider("ollama", {"model": "m"})
    assert isinstance(c, OllamaClient) and c.model == "m"
    with pytest.raises(ValueError):
        LLMFactory.create_provider("nope")


def test_dispatcher_classifier_and_batches():
    tc = TaskClassifier()
    assert tc.classify_task("extract atomic note JSON from this") == "heavy"
    assert tc.classify_task("yes or no: is it red?") == "light"
    assert tc.classify_task("short", task_type="atomic_note") == "heavy"
    light = OllamaClient(transport=_ollama("light-ans"))
    d = HybridLLMDispatcher(light, OllamaClient(transport=_ollama("heavy-ans")))
    assert d.generate("yes or no: x?") == "light-ans"
    assert d.generate("produce json atomic note") == "heavy-ans"
    d2 = HybridLLMDispatcher(light, OllamaClient(transport=_failing))
    assert d2.generate("produce json atomic note") == "light-ans"
    upper = MultiModelClient([OllamaClient(transport=_ollama(
        lambda p: p["prompt"].upper()))])
    assert upper.batch_generate(["a", "b", "c"], max_workers=2) == ["A", "B", "C"]
    assert d.process_batch(["yes or no: a", "json b"]) == ["light-ans", "heavy-ans"]


def test_local_llm_hybrid_mode_builds_the_dispatcher():
    llm = LocalLLM(cfg=_cfg(**{"llm.provider": "hybrid"}), transport=_ollama("x"))
    assert isinstance(llm.client, HybridLLMDispatcher)
    assert llm.client.heavy.clients[0].base_url == "http://localhost:1234/v1"


def test_optimized_client_caches_and_debug_reports():
    calls = []
    c = OllamaClient(transport=_ollama(lambda p: calls.append(p) or "out"))
    pool = OptimizedMultiModelClient([c])
    assert pool.generate("q") == pool.generate("q") == "out"
    assert len(calls) == 1
    report = debug_endpoints([c, OllamaClient(transport=_failing)], rounds=2)
    assert report[0]["available"] and len(report[0]["latencies"]) == 2
    assert report[1]["errors"] == {"ConnectionError": 2}
    assert clean_response("<think>x</think> a\x01b ") == "ab"


# ------------------------------------------------- the in-process provider
def test_factory_builds_the_decoder_provider_on_the_device():
    cfg = _cfg(**{"llm.provider": "jax", "llm.jax.model": str(CKPT),
                  "llm.jax.max_batch": 2})
    c = LLMFactory.create_from_config(cfg, device="cpu")
    assert isinstance(c, DecoderLLMClient) and c.provider_name == "jax"
    assert (c.model, c.max_batch, c.device.type) == (str(CKPT), 2, "cpu")
    assert LocalLLM(cfg=cfg, device="cpu").client.device.type == "cpu"


def test_decoder_provider_refuses_a_missing_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg(**{"llm.provider": "jax", "llm.jax.model": str(CKPT)})
    with pytest.raises(RuntimeError, match="CUDA"):
        LocalLLM(cfg=cfg).client


# --------------------------------------------------- process() with an LLM
LLM_QUERIES = [q for q, *_ in KB_QUESTIONS] + [
    "Does Aurora Lane have a spouse?", "Who produced Silent River?",
    "Who is the spouse of Aurora Lane?"]


def _llm_pair(**overrides):
    loader = _loader(**{"llm.provider": "jax", "llm.jax.model": str(CKPT),
                        "answer_selector.apply_before_llm": False,
                        "llm.max_output_tokens": 16, **overrides})
    corpus = _notes() + kb_notes()
    cfg = Config(loader.as_dict())
    jqp = JQueryProcessor(corpus, cfg=loader, llm=JLocalLLM(cfg=loader))
    qp = QueryProcessor(corpus, cfg=cfg, llm=LocalLLM(cfg=cfg, device="cpu"),
                        device="cpu")
    return jqp, qp


@pytest.fixture(scope="module")
def llm_answers():
    jqp, qp = _llm_pair()
    return ([jqp.process(q) for q in LLM_QUERIES], [qp.process(q) for q in LLM_QUERIES],
            jqp.llm.client.stats["calls"], qp.llm.client.stats["calls"])


@pytest.mark.parametrize("i", range(len(LLM_QUERIES)), ids=lambda i: LLM_QUERIES[i][:40])
def test_process_with_the_decoder_llm_equals_the_reference(llm_answers, i):
    want, got, _, _ = llm_answers
    assert_same_process(got[i], want[i])


def test_process_with_the_decoder_llm_reaches_stage_c(llm_answers):
    """The KB questions reach the LLM stage; random-looking generations
    are no valid JSON, so EFSA rescues their answers."""
    _, got, j_calls, calls = llm_answers
    assert calls == j_calls > 0
    for (q, answer, *_), r in zip(KB_QUESTIONS[:2], got):
        assert (r["answer_method"], r["answer"]) == ("llm", answer), q


def test_process_batch_with_the_decoder_llm_equals_the_reference():
    jqp, qp = _llm_pair()
    queries = [q for q, *_ in KB_QUESTIONS]
    want, got = jqp.process_batch(queries), qp.process_batch(queries)
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("answer", "predicted_support_idxs", "answer_method")} \
            == {k: w[k] for k in ("answer", "predicted_support_idxs", "answer_method")}
    assert qp.llm.client.stats["calls"] == jqp.llm.client.stats["calls"] > 0


class _JsonClient:
    """A provider whose reply is a valid evidence-first answer: the quoted
    span is the packed context's line naming `answer`."""

    provider_name = "stub"

    def __init__(self, answer):
        self.answer = answer
        self.calls = 0

    def generate(self, prompt, system_prompt=None, **params):
        self.calls += 1
        span = next((ln.split("] ", 1)[-1].strip() for ln in prompt.splitlines()
                     if self.answer in ln), None)
        return json.dumps({"answer": self.answer, "evidence_spans": [span] if span else [],
                           "support_idxs": [1], "insufficient": span is None})


def test_process_through_local_llm_where_the_llms_answer_stands():
    loader = _loader(**{"answer_selector.apply_before_llm": False})
    corpus = _notes() + kb_notes()
    cfg = Config(loader.as_dict())
    jqp = JQueryProcessor(corpus, cfg=loader,
                          llm=JLocalLLM(cfg=loader, client=_JsonClient("Chris Reed")))
    qp = QueryProcessor(corpus, cfg=cfg, device="cpu",
                        llm=LocalLLM(cfg=cfg, client=_JsonClient("Chris Reed")))
    q = "Who is the spouse of Aurora Lane?"
    want, got = jqp.process(q), qp.process(q)
    assert_same_process(got, want)
    assert (got["answer"], got["answer_method"]) == ("Chris Reed", "llm")
    assert qp.llm.client.calls == jqp.llm.client.calls > 0
