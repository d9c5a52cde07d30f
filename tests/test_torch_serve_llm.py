"""The port's LLM server (anorag_tpu_torch/serve_llm.py) against the repo's
scripts/serve_llm.py, and the port's `serve --llm` against root
serve.py's, on the CPU.

Both LLM servers wrap the decoder LM of checkpoints/note_lm_cpu_small
(prompt bucket 1024, max_new 48) on 127.0.0.1 port 0; the port's Ollama
and OpenAI clients must get equal texts from both, one request at a time
and micro-batched. Both KB servers run over the same notes with a config
naming `llm.provider: jax` and that checkpoint
(answer_selector.apply_before_llm off, as README's LLM mode sets it):
/query must give equal answers with `answer_method` "llm" on the KB
questions, through process() and through the engine.
"""
import concurrent.futures as cf
import json
import urllib.request

import pytest

from anorag_tpu.config import ConfigLoader
from anorag_tpu.models.decoder_lm import DecoderLM as JDecoderLM, load_lm as j_load_lm
from anorag_tpu.serving import ServingEngine as JServingEngine
from anorag_tpu_torch import serve as tserve
from anorag_tpu_torch import serve_llm as tserve_llm
from anorag_tpu_torch.llm.clients import OllamaClient, OpenAIClient
from anorag_tpu_torch.models.decoder_lm import DecoderLM, load_lm
from anorag_tpu_torch.serving import ServingEngine
from anorag_tpu_torch.testing import KB_QUESTIONS, kb_notes
from anorag_tpu_torch.utils.file_io import write_json

import serve as jserve
from scripts import serve_llm as jserve_llm

from conftest import make_notes
from test_torch_llm import CKPT
from test_torch_serve import _post, _same_answer, _start

PROMPTS = ["Aurora Lane recorded Blue Horizon.", "Who founded Nexus Labs?", "x"]


@pytest.fixture(scope="module")
def llm_urls():
    """{"ref"|"port": (url, batcher)}: the two servers over one checkpoint."""
    jp, jc = j_load_lm(str(CKPT))
    tp, tc = load_lm(str(CKPT), device="cpu")
    batchers = {"ref": jserve_llm.MicroBatcher(JDecoderLM(jp, jc, prompt_bucket=1024),
                                               max_batch=4, max_new=48, window_s=0.2),
                "port": tserve_llm.MicroBatcher(DecoderLM(tp, tc, prompt_bucket=1024),
                                                max_batch=4, max_new=48, window_s=0.2)}
    servers, out = [], {}
    for name, mod in (("ref", jserve_llm), ("port", tserve_llm)):
        srv, url = _start(mod.make_handler(batchers[name], "note-lm"))
        servers.append(srv)
        out[name] = (url, batchers[name])
    yield out
    for srv in servers:
        srv.shutdown()
        srv.server_close()
    batchers["port"].close()
    assert not batchers["port"]._t.is_alive()


def _client(kind, url):
    if kind == "ollama":
        return OllamaClient(base_url=url, model="note-lm", timeout=120)
    return OpenAIClient(base_url=f"{url}/v1", model="note-lm", timeout=120)


@pytest.mark.parametrize("kind", ["ollama", "openai"])
@pytest.mark.parametrize("prompt", PROMPTS)
def test_clients_get_the_references_texts(llm_urls, kind, prompt):
    got, want = (_client(kind, llm_urls[name][0]).generate(
        prompt, system_prompt="Generate atomic notes.\nrules", max_tokens=8)
        for name in ("port", "ref"))
    assert got == want and got


@pytest.mark.parametrize("kind", ["ollama", "openai"])
def test_health_pings_are_answered_without_the_model(llm_urls, kind):
    url, batcher = llm_urls["port"]
    before = dict(batcher.stats)
    assert _client(kind, url).is_available()
    assert batcher.stats == before


def test_concurrent_requests_form_one_batch_with_the_references_texts(llm_urls):
    url, batcher = llm_urls["port"]
    before = batcher.stats["batches"]
    prompts = PROMPTS + ["Chris Reed married Aurora Lane."]
    with cf.ThreadPoolExecutor(len(prompts)) as ex:
        got = list(ex.map(lambda p: _client("ollama", url).generate(p, max_tokens=8),
                          prompts))
    assert batcher.stats["batches"] - before < len(prompts)
    ref = _client("ollama", llm_urls["ref"][0])
    assert got == [ref.generate(p, max_tokens=8) for p in prompts]


def test_bad_json_unknown_route_and_stats(llm_urls):
    for name in ("port", "ref"):
        url = llm_urls[name][0]
        assert _post(f"{url}/api/generate", None, raw=b"{not json")[0] == 400
        assert _post(f"{url}/nope", {})[0] == 404
        with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["model"] == "note-lm" and stats["errors"] == 0


def test_a_failing_model_answers_500_and_the_batcher_closes():
    class Broken:
        def generate(self, prompts, max_new, temperature):
            raise RuntimeError("device lost")

    batcher = tserve_llm.MicroBatcher(Broken(), max_batch=2, max_new=8, window_s=0.01)
    srv, url = _start(tserve_llm.make_handler(batcher, "broken"))
    try:
        code, body = _post(f"{url}/api/generate", {"prompt": "hi"})
        assert (code, body["error"]) == (500, "device lost")
        assert batcher.stats["errors"] == 1
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.close()
    assert not batcher._t.is_alive()


# ----------------------------------------------------------- serve --llm
def _kb(tmp_path):
    write_json(tmp_path / "atomic_notes.json", make_notes(12) + kb_notes())
    settings = {"llm.provider": "jax", "llm.jax.model": str(CKPT),
                "llm.max_output_tokens": 16, "answer_selector.apply_before_llm": False,
                "tpu.sharded_search": "off", "embedding.backend": "hash",
                "embedding.dim": 64, "vector_store.index_type": "Flat"}
    loader = ConfigLoader(auto_load=False)
    cfg = tserve.load_config(None)
    for k, v in settings.items():
        loader.set(k, v)
        cfg.set(k, v)
    return loader, cfg


@pytest.fixture(scope="module")
def kb_urls(tmp_path_factory):
    """{"ref"|"port": {"plain"|"engine": url}}: both servers' build_processor
    with the LLM over one KB."""
    tmp = tmp_path_factory.mktemp("kb")
    loader, cfg = _kb(tmp)
    mp = pytest.MonkeyPatch()
    mp.setattr(jserve, "config", loader)
    jqp = jserve.build_processor(str(tmp), no_llm=False)
    mp.undo()
    qp = tserve.build_processor(str(tmp), no_llm=False, cfg=cfg, device="cpu")
    assert jqp.llm is not None and qp.llm is not None
    assert qp.llm.client.device.type == "cpu"
    engines = [JServingEngine(jqp, sub_batch=4, depth=2), ServingEngine(qp, sub_batch=4, depth=2)]
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


@pytest.mark.parametrize("kind", ["plain", "engine"])
@pytest.mark.parametrize("question", [q for q, *_ in KB_QUESTIONS[:2]])
def test_serve_llm_query_answers_through_the_llm_as_the_reference(kb_urls, kind, question):
    got, want = (_post(f"{kb_urls[name][kind]}/query", {"query": question, "top_k": 5})
                 for name in ("port", "ref"))
    assert got[0] == want[0] == 200
    _same_answer(got[1], want[1])
    assert got[1]["answer_method"] == "llm"


def test_build_processor_drops_an_unavailable_llm(tmp_path, caplog):
    _, cfg = _kb(tmp_path)
    cfg.set("llm.jax.model", str(tmp_path / "missing"))
    qp = tserve.build_processor(str(tmp_path), no_llm=False, cfg=cfg, device="cpu")
    assert qp.llm is None
    assert "not available" in caplog.text
    assert tserve.build_processor(str(tmp_path), cfg=cfg, device="cpu").llm is None
