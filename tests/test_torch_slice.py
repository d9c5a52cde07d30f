"""The ported slice as a whole against anorag_tpu, on the CPU.

Both QueryProcessors are built on the same notes (tests/conftest.py
make_notes plus a few hundred generated notes). The retrievers' hybrid
rows must hold the same note ids in the same order, scores to 1e-5, and
process_batch, which runs the answer stages on those rows, the same
answers and the same notes (tests/test_torch_answer.py holds the answer
stages on more questions).

Also the package rules: no JAX and nothing of anorag_tpu in the port or in
chip_smoke.py, a search that runs with JAX blocked, and entry points that
refuse to fall back to the CPU on their own.
"""
import ast
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from anorag_tpu.config import ConfigLoader
from anorag_tpu.query.processor import QueryProcessor as JQueryProcessor
from anorag_tpu.query.processor import filter_notes_by_namespace as j_filter
from anorag_tpu_torch.models.embedding_manager import EmbeddingManager
from anorag_tpu_torch.models.encoder import EncoderConfig, params_from_jax
from anorag_tpu_torch.query.processor import (QueryProcessor,
                                              filter_notes_by_namespace)
from anorag_tpu_torch.serving import ServingEngine

from conftest import make_notes

ROOT = Path(__file__).resolve().parents[1]

_WORDS = ("river album film singer founder orbit lantern quartz harbor "
          "meadow violin comet ember glacier pixel saffron tundra falcon "
          "marble cedar nebula atlas cobalt dune fable garnet hollow ivory "
          "jasper kestrel lumen maple nectar opal prairie quill raven").split()

QUERIES = [
    "Who is the singer of Blue Horizon?",
    "Who founded Nexus Labs?",
    "Which director made Silent River?",
    "quartz harbor lantern",
    "comet ember glacier falcon marble",
    "Elena Cortez scientist",
    "violin meadow river album",
    "nebula atlas cobalt dune fable garnet hollow ivory",
]


def _notes(n_extra=300, seed=0):
    rng = np.random.default_rng(seed)
    notes = make_notes(24)
    for i in range(n_extra):
        words = rng.choice(_WORDS, int(rng.integers(4, 14))).tolist()
        notes.append({
            "note_id": f"gen_{i}",
            "doc_id": f"doc_g{i % 17}",
            "title": " ".join(words[:2]).title(),
            "content": " ".join(words) + f" item {i}.",
            "raw_span": " ".join(words[2:]),
            "entities": [words[0].title()],
            "paragraph_idxs": [i % 5],
        })
    return notes


def _loader(**overrides):
    loader = ConfigLoader(auto_load=False)
    for k, v in {"embedding.backend": "hash", "embedding.dim": 128,
                 "vector_store.index_type": "Flat", "vector_store.top_k": 10,
                 "tpu.sharded_search": "off", **overrides}.items():
        loader.set(k, v)
    return loader


def _assert_same_rows(got, want, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [n["note_id"] for n in g] == [n["note_id"] for n in w]
        np.testing.assert_allclose([n["final_score"] for n in g],
                                   [n["final_score"] for n in w], atol=atol, rtol=0)


ANSWER_FIELDS = ("query", "answer", "predicted_answer", "predicted_support_idxs",
                 "predicted_answerable", "answer_method")


def assert_same_answers(got, want, atol=1e-5):
    """process_batch results: the same keys, exactly equal answer fields,
    and notes of equal ids in equal order with scores to atol."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert {k: g[k] for k in ANSWER_FIELDS} == {k: w[k] for k in ANSWER_FIELDS}, \
            g["query"]
    _assert_same_rows([g["notes"] for g in got], [w["notes"] for w in want], atol)


def test_process_batch_matches_reference_hash_backend():
    loader = _loader()
    notes = _notes()
    jqp = JQueryProcessor(notes, cfg=loader, llm=None)
    qp = QueryProcessor(notes, cfg=loader.as_dict(), device="cpu")
    top_k = loader.get("context.max_notes_for_llm")
    want = jqp.retriever.hybrid_search(QUERIES, top_k=top_k)
    got = qp.retriever.hybrid_search(QUERIES, top_k=top_k)
    assert all(len(r) == top_k for r in got)
    _assert_same_rows(got, want, atol=1e-5)
    answers = qp.process_batch(QUERIES)
    assert all(len(r["notes"]) == top_k for r in answers)
    assert_same_answers(answers, jqp.process_batch(QUERIES), atol=1e-5)


def test_process_batch_matches_reference_encoder_backend():
    """torch encoder against the JAX encoder at EncoderConfig.small() with
    the JAX weights carried across. The corpus is stored in bf16 in both
    packages, and the two encoders agree to ~1e-6, so a row component can
    round to the neighbouring bf16 value: scores are held to the encoder's
    1e-4."""
    small = EncoderConfig.small()
    loader = _loader(**{
        "embedding.backend": "jax", "embedding.model_name": "",
        "embedding.dim": small.hidden_size,
        "encoder.vocab_size": small.vocab_size,
        "encoder.hidden_size": small.hidden_size,
        "encoder.num_layers": small.num_layers,
        "encoder.num_heads": small.num_heads,
        "encoder.intermediate_size": small.intermediate_size,
        "encoder.max_position": small.max_position,
        "encoder.dtype": "float32"})
    notes = _notes(n_extra=120, seed=1)
    jqp = JQueryProcessor(notes, cfg=loader, llm=None)
    port_cfg = loader.as_dict()
    port_cfg["embedding"]["backend"] = "torch"
    em = EmbeddingManager(port_cfg, device="cpu")
    np_params = jax.tree.map(np.asarray, jqp.em._params)
    em.load_encoder_state(params_from_jax(
        np_params, EncoderConfig.from_config(loader.get("encoder"))))
    qp = QueryProcessor(notes, cfg=port_cfg, device="cpu",
                        embedding_manager=em)
    want = jqp.retriever.hybrid_search(QUERIES, top_k=10)
    got = qp.retriever.hybrid_search(QUERIES, top_k=10)
    _assert_same_rows(got, want, atol=1e-4)
    assert_same_answers(qp.process_batch(QUERIES, top_k=10),
                        jqp.process_batch(QUERIES, top_k=10), atol=1e-4)


def test_serving_engine_matches_process_batch_and_joins_threads():
    notes = _notes(n_extra=60)
    qp = QueryProcessor(notes, cfg=_loader().as_dict(), device="cpu")
    before = threading.active_count()
    engine = ServingEngine(qp, sub_batch=3, depth=2)
    futures = [engine.submit(QUERIES), engine.submit(QUERIES[:2], top_k=5)]
    got = [f.result(timeout=60) for f in futures]
    engine.close()
    assert not engine._dispatcher.is_alive()
    assert threading.active_count() == before
    # sub-batches of 3, in request order, each one device pass
    want = [r for i in range(0, len(QUERIES), 3)
            for r in qp.process_batch(QUERIES[i:i + 3])]
    assert_same_answers(got[0], want, atol=0)
    assert_same_answers(got[1], qp.process_batch(QUERIES[:2], top_k=5), atol=0)
    with pytest.raises(RuntimeError):
        engine.submit(QUERIES)


_CANDIDATES = [{"note_id": "a", "namespace": "ds1"}, {"note_id": "b", "dataset": "ds2"},
               {"note_id": "c"}, {"note_id": "d", "namespace": 1, "dataset": "ds1"},
               {"note_id": "e", "namespace": "ds2", "dataset": "ds1"}]


@pytest.mark.parametrize("namespace", [None, "", "ds1", "ds2", 1, "other"])
def test_filter_notes_by_namespace_equals_the_reference(namespace):
    assert filter_notes_by_namespace(_CANDIDATES, namespace) == \
        j_filter(_CANDIDATES, namespace)


def test_process_batch_filters_by_dataset_as_the_reference_does():
    """Notes of two namespaces ("namespace" and "dataset" keys) and notes of
    none: the port's process_batch(queries, "ds1") answers each query from
    the reference's filter_notes_by_namespace over the reference
    retriever's hybrid_search rows (top_k retrieved, then filtered, never
    more retrieved), as the reference's process_batch does, and
    ServingEngine carries dataset= through to the same answers."""
    notes = _notes(n_extra=200, seed=2)
    for i, n in enumerate(notes):
        if i % 3 == 0:
            n["namespace"] = "ds1"
        elif i % 3 == 1:
            n["dataset"] = "ds2"
    loader = _loader()
    jqp = JQueryProcessor(notes, cfg=loader, llm=None)
    qp = QueryProcessor(notes, cfg=loader.as_dict(), device="cpu")
    top_k = loader.get("context.max_notes_for_llm")
    want = [j_filter(rows, "ds1") for rows in jqp.retriever.hybrid_search(QUERIES, top_k=top_k)]
    got = qp.process_batch(QUERIES, "ds1")
    _assert_same_rows([qp._post_select_processing(rows, rows, q)
                       for rows, q in zip(want, QUERIES)],
                      [r["notes"] for r in got], atol=1e-5)
    assert_same_answers(got, jqp.process_batch(QUERIES, "ds1"), atol=1e-5)
    assert all(0 < len(r["notes"]) < top_k for r in got)
    assert all(n.get("namespace", "ds1") == "ds1" and "dataset" not in n
               for r in got for n in r["notes"])
    assert_same_answers(qp.process_batch(QUERIES, None, 5),
                        qp.process_batch(QUERIES, top_k=5), atol=0)
    with ServingEngine(qp, sub_batch=3, depth=2) as engine:
        served = engine.process(QUERIES, dataset="ds1", timeout=60)
        unfiltered = engine.submit(QUERIES[:3], 4).result(timeout=60)
    assert_same_answers(served, [r for i in range(0, len(QUERIES), 3)
                                 for r in qp.process_batch(QUERIES[i:i + 3], "ds1")], atol=0)
    assert_same_answers(unfiltered, qp.process_batch(QUERIES[:3], top_k=4), atol=0)


# ------------------------------------------------------------ package rules
def _port_files():
    return sorted((ROOT / "anorag_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_anorag_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "anorag_tpu"), (path, name)


def test_port_runs_with_jax_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["anorag_tpu"] = None
        from anorag_tpu_torch.query.processor import (QueryProcessor,
                                              filter_notes_by_namespace)
        notes = [{"note_id": f"n{i}", "title": f"t{i}",
                  "content": f"alpha beta item{i} gamma{i % 3}"} for i in range(40)]
        cfg = {"embedding": {"backend": "hash", "dim": 32},
               "vector_store": {"index_type": "Flat"}}
        qp = QueryProcessor(notes, cfg=cfg, device="cpu")
        out = qp.process_batch(["alpha item7", "gamma1 beta"], top_k=5)
        assert [len(r["notes"]) for r in out] == [5, 5], out
        assert out[0]["notes"][0]["note_id"] == "n7", out[0]["notes"][0]
        assert all(r["answer_method"] and "answer" in r for r in out), out
        from anorag_tpu_torch.serve import make_handler
        from anorag_tpu_torch.serve_llm import MicroBatcher
        from anorag_tpu_torch.llm import LocalLLM
        from anorag_tpu_torch.models.decoder_lm import DecoderConfig, DecoderLM, init_params
        import torch
        cfg = DecoderConfig.tiny()
        lm = DecoderLM(init_params(cfg, torch.Generator().manual_seed(0), "cpu"), cfg,
                       prompt_bucket=32)
        assert len(lm.generate(["a", "bc"], max_new=4)) == 2
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    from anorag_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryProcessor(make_notes(4), cfg={"embedding": {"backend": "hash"}})
    with pytest.raises(RuntimeError, match="CUDA"):
        EmbeddingManager({"embedding": {"backend": "hash"}})
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("backend", ["jax", "bge"])
def test_embedding_manager_rejects_backends_it_does_not_have(backend):
    with pytest.raises(ValueError, match="backend"):
        EmbeddingManager({"embedding": {"backend": backend}}, device="cpu")
