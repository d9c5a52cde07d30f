"""The port's MuSiQue batch pipeline and its evaluation against the
reference's, on the CPU: the copied modules, the eval metrics on seeded
predictions, Chain-of-Retrieval on the KB notes, process_musique_item on
three synthetic items (hash backend: rows and KB notes byte-equal, the
audit files' rows equal with their f32 scores to 1e-5; a
64-wide encoder with carried weights: embeddings to 1e-5, rows equal),
MusiqueProcessor's resume and its error and timeout rows, and the CLIs
(main_musique, run_evaluation, extract_dev200, convert_to_official_format)
in subprocesses against the root ones."""
from __future__ import annotations

import concurrent.futures
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from anorag_tpu import pipeline_musique as jpm
from anorag_tpu.config import ConfigLoader
from anorag_tpu.eval import evaluator as jevaluator
from anorag_tpu.eval import musique as jmusique
from anorag_tpu.graph.note_graph import NoteGraph as JNoteGraph
from anorag_tpu.llm.cor_controller import chain_of_retrieval as jchain
from anorag_tpu.models.embedding_manager import EmbeddingManager as JEmbeddingManager
from anorag_tpu.utils import batch_processor as jbatch
from anorag_tpu_torch import pipeline_musique as tpm
from anorag_tpu_torch.config import Config
from anorag_tpu_torch.eval import evaluator as tevaluator
from anorag_tpu_torch.eval import musique as tmusique
from anorag_tpu_torch.graph.note_graph import NoteGraph as TNoteGraph
from anorag_tpu_torch.llm.cor_controller import chain_of_retrieval as tchain
from anorag_tpu_torch.models.embedding_manager import EmbeddingManager
from anorag_tpu_torch.models.encoder import EncoderConfig, params_from_jax
from anorag_tpu_torch.testing import KB_QUESTIONS, kb_notes
from anorag_tpu_torch.utils import batch_processor as tbatch
from anorag_tpu_torch.utils.file_io import read_jsonl, write_jsonl

from test_torch_answer import _DEVICE, ROOT, assert_copy_equal

MUSIQUE_COPIED = ("utils/padding.py utils/progress.py utils/dataset_guard.py "
                  "utils/batch_processor.py eval/musique.py eval/evaluator.py "
                  "llm/cor_controller.py pipeline_musique.py").split()
MUSIQUE_DIFFERS = {
    "utils/batch_processor.py": {
        "device_memory_stats": "torch.cuda's allocator bytes and mem_get_info's "
                               "total for each card, where the reference asks "
                               "jax.local_devices(); {} on the CPU"},
    "pipeline_musique.py": {
        "from anorag_tpu_torch.device import DeviceLike": "the device's type",
        "process_musique_item": _DEVICE,
        "MusiqueProcessor.__init__": _DEVICE,
        "MusiqueProcessor.process_dataset": "passes the device on"},
}


@pytest.mark.parametrize("rel", [*MUSIQUE_COPIED, "eval/__init__.py"])
def test_copied_musique_module_equals_the_original(rel):
    assert_copy_equal(rel, MUSIQUE_DIFFERS.get(rel, {}))


def test_device_memory_stats_is_empty_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a GPU is present")
    assert tbatch.device_memory_stats() == {}


def test_batch_processor_halves_and_regrows_as_the_reference():
    def run(mod):
        sizes = []

        def fn(batch):
            sizes.append(len(batch))
            if len(batch) > 3 and len(sizes) % 3 == 1:
                raise RuntimeError("out of memory")
            return [x * 2 for x in batch]

        bp = mod.BatchProcessor(batch_size=8, min_batch_size=1, grow_after=2)
        return bp.process(list(range(57)), fn), sizes, bp.batch_size

    assert run(tbatch) == run(jbatch)


# ------------------------------------------------------------ evaluation
@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """Three synthetic MuSiQue-style items from the repo's generator."""
    path = tmp_path_factory.mktemp("synth") / "synth.jsonl"
    subprocess.run([sys.executable, str(ROOT / "scripts" / "gen_synth_musique.py"),
                    str(path), "--n", "3", "--seed", "0"], check=True,
                   stdout=subprocess.DEVNULL)
    return path


def _golds(seed=0, n=40):
    rng = np.random.default_rng(seed)
    words = ["Denver", "Blue Horizon", "the year 1983", "Chris Reed", "Austin", "1990"]
    golds = []
    for i in range(n):
        paras = [{"idx": k, "title": f"t{k}", "paragraph_text": f"p {k}",
                  "is_supporting": bool(rng.random() < 0.3)} for k in range(6)]
        golds.append({"id": f"q{i}", "question": f"Who founded {words[i % 6]} Labs?",
                      "answer": words[i % 6],
                      "answer_aliases": [words[(i + 1) % 6]] if i % 4 == 0 else [],
                      "answerable": bool(i % 5), "paragraphs": paras})
    return golds


def _predictions(golds, seed=1):
    rng = np.random.default_rng(seed)
    preds = []
    for g in golds:
        pick = rng.integers(4)
        answer = [g["answer"], f"the {g['answer']}!", "unknown thing", ""][pick]
        sup = sorted(rng.choice(6, size=int(rng.integers(0, 4)), replace=False).tolist())
        notes = [{"note_id": f"n{k}", "paragraph_idxs": [int(rng.integers(6))],
                  "content": f"{g['answer']} was founded by someone in 19{k}0.",
                  "entities": [g["answer"]] if k % 2 else ["Other"],
                  "hop_no": int(rng.integers(1, 3)),
                  "bridge_entity": "x" if k == 1 else None} for k in range(3)]
        row = {"id": g["id"], "predicted_answer": answer, "predicted_support_idxs": sup,
               "predicted_answerable": bool(rng.random() < 0.8)}
        if pick % 2:
            row.update(notes=notes, candidate_notes=notes[:2])
        preds.append(row)
    return preds + [{"id": "not-in-gold", "predicted_answer": "x",
                     "predicted_support_idxs": [], "predicted_answerable": True}]


def test_eval_metrics_equal_the_reference():
    golds = _golds()
    preds = _predictions(golds)
    assert tmusique.evaluate_dataset(preds, golds) == jmusique.evaluate_dataset(preds, golds)
    assert tmusique.evaluate_dataset(preds[:1], golds) == jmusique.evaluate_dataset(
        preds[:1], golds)
    for p, g in zip(preds, golds):
        assert tmusique.evaluate_item(p, g) == jmusique.evaluate_item(p, g)
    for name in ("answer_em", "answer_f1"):
        for p, g in zip(preds, golds):
            got = getattr(tmusique, name)(p["predicted_answer"], tmusique.gold_aliases(g))
            assert got == getattr(jmusique, name)(p["predicted_answer"],
                                                  jmusique.gold_aliases(g))
    got = tevaluator.EnhancedEvaluator().evaluate_batch(preds, golds)
    assert got == jevaluator.EnhancedEvaluator().evaluate_batch(preds, golds)
    assert "path_recall_rate" in got
    assert tmusique.convert_to_official_format(preds) == \
        jmusique.convert_to_official_format(preds)
    for n, answerable_only in ((5, True), (200, True), (7, False)):
        assert tmusique.extract_dev_subset(golds, n=n, answerable_only=answerable_only) == \
            jmusique.extract_dev_subset(golds, n=n, answerable_only=answerable_only)


@pytest.mark.parametrize("qi", range(len(KB_QUESTIONS)))
def test_chain_of_retrieval_equals_the_reference_on_the_kb_notes(qi):
    question = KB_QUESTIONS[qi][0]
    out = []
    for graph_cls, chain, cfg in ((JNoteGraph, jchain, ConfigLoader(auto_load=False)),
                                  (TNoteGraph, tchain, Config())):
        ng = graph_cls.from_config(cfg)
        ng.add_notes(kb_notes())
        out.append([chain(question, ng, max_rounds=r, budget=b, confidence_tau=tau)
                    for r, b, tau in ((3, 64, 0.8), (1, 2, 0.99), (4, 3, 1.0))])
    assert json.dumps(out[1], sort_keys=True) == json.dumps(out[0], sort_keys=True)


# ------------------------------------------------------------ the pipeline
_AUDIT = ("atomic_notes_recall.jsonl", "selected_atomic_notes.jsonl")


def _assert_same_audit(twork, jwork):
    """Both per-item audit files: the same notes in the same order with
    every field equal, final_score to 1e-5 (the f32 fusion scores differ
    from XLA's in the last bit, as in process()'s final_recall.jsonl)."""
    for name in _AUDIT:
        got, want = read_jsonl(Path(twork) / name), read_jsonl(Path(jwork) / name)
        assert len(got) == len(want) > 0, name
        for g, w in zip(got, want):
            assert {k: v for k, v in g.items() if k != "final_score"} == \
                {k: v for k, v in w.items() if k != "final_score"}, name
        np.testing.assert_allclose([g["final_score"] for g in got],
                                   [w["final_score"] for w in want], atol=1e-5, rtol=0)


def _hash_sets():
    return {"embedding.backend": "hash", "embedding.dim": 128,
            "vector_store.index_type": "Flat", "tpu.sharded_search": "off"}


def _loader(sets):
    loader = ConfigLoader(auto_load=False)
    for k, v in sets.items():
        loader.set(k, v)
    return loader


def test_process_musique_item_equals_the_reference_hash_backend(synth, tmp_path):
    loader = _loader(_hash_sets())
    cfg = Config(loader.as_dict())
    jem = JEmbeddingManager(cfg=loader, singleton=False)
    em = EmbeddingManager(cfg, device="cpu")
    for item in read_jsonl(synth):
        want = jpm.process_musique_item(item, tmp_path / "j" / item["id"], cfg=loader,
                                        embedding_manager=jem)
        got = tpm.process_musique_item(item, tmp_path / "t" / item["id"], cfg=cfg,
                                       embedding_manager=em, device="cpu")
        assert got == want
        _assert_same_audit(tmp_path / "t" / item["id"], tmp_path / "j" / item["id"])
        assert (tmp_path / "t" / item["id"] / "kb" / "atomic_notes.json").read_bytes() == \
            (tmp_path / "j" / item["id"] / "kb" / "atomic_notes.json").read_bytes()


def test_process_musique_item_equals_the_reference_encoder_backend(synth, tmp_path):
    """A 2-layer, 64-wide encoder with the JAX weights carried across: the
    KB's embeddings agree to 1e-5 and the rows are equal."""
    enc = {"vocab_size": 1024, "hidden_size": 64, "num_layers": 2, "num_heads": 4,
           "intermediate_size": 128, "max_position": 128, "dtype": "float32",
           "pooling": "mean"}
    sets = {**_hash_sets(), "embedding.backend": "jax", "embedding.model_name": "",
            "embedding.dim": 64, "embedding.max_length": 128,
            **{f"encoder.{k}": v for k, v in enc.items()}}
    loader = _loader(sets)
    jem = JEmbeddingManager(cfg=loader, singleton=False)
    jem._ensure_backend()
    cfg = Config(loader.as_dict())           # backend jax: the port's torch encoder
    em = EmbeddingManager(cfg, device="cpu")
    em.load_encoder_state(params_from_jax(jax.tree.map(np.asarray, jem._params),
                                          EncoderConfig.from_config(enc)))
    item = read_jsonl(synth)[0]
    want = jpm.process_musique_item(item, tmp_path / "j", cfg=loader, embedding_manager=jem)
    got = tpm.process_musique_item(item, tmp_path / "t", cfg=cfg, embedding_manager=em,
                                   device="cpu")
    np.testing.assert_allclose(np.load(tmp_path / "t" / "kb" / "embeddings.npy"),
                               np.load(tmp_path / "j" / "kb" / "embeddings.npy"),
                               atol=1e-5, rtol=0)
    assert got == want


def test_musique_item_to_document_equals_the_reference(synth):
    for item in [*read_jsonl(synth), {"question": "q"}]:
        assert tpm.musique_item_to_document(item) == jpm.musique_item_to_document(item)


def test_musique_processor_resume_and_error_rows(synth, tmp_path, monkeypatch):
    """Resume adds no duplicate rows; an item that raises, and one whose
    future times out, leave rows shaped as the reference's."""
    items = read_jsonl(synth)
    loader = _loader(_hash_sets())
    cfg = Config(loader.as_dict())
    mp = tpm.MusiqueProcessor(tmp_path / "work", cfg=cfg,
                              embedding_manager=EmbeddingManager(cfg, device="cpu"),
                              max_workers=2, device="cpu")
    out = tmp_path / "preds.jsonl"
    first = mp.process_dataset(items[:1], out)
    again = mp.process_dataset(items, out)
    rows = read_jsonl(out)
    assert len(first) == 1 and len(again) == len(rows) == len(items)
    assert sorted(r["id"] for r in rows) == sorted(it["id"] for it in items)
    assert not any(r.get("error") for r in rows)
    assert mp.process_dataset(items, out) == rows and len(read_jsonl(out)) == len(items)

    def failing(it, *args, **kwargs):
        raise RuntimeError(f"no KB for {it['id']}")

    def timed_out(timeout=None):
        raise concurrent.futures.TimeoutError()

    def late(futs):
        """as_completed, with the second item's future timing out."""
        for f in list(futs):
            f.result()
            if futs[f]["id"] == items[1]["id"]:
                f.result = timed_out
            yield f

    shaped = []
    for mod, loader_or_cfg in ((jpm, loader), (tpm, cfg)):
        monkeypatch.setattr(mod, "process_musique_item", failing)
        kw = {"device": "cpu"} if mod is tpm else {}
        mp = mod.MusiqueProcessor(tmp_path / mod.__name__, cfg=loader_or_cfg,
                                  max_workers=1, **kw)
        errors = mp.process_dataset(items[:1], tmp_path / f"{mod.__name__}_e.jsonl")
        monkeypatch.setattr(mod, "as_completed", late)
        timeouts = mp.process_dataset(items[:2], tmp_path / f"{mod.__name__}_t.jsonl")
        shaped.append((errors, timeouts,
                       read_jsonl(tmp_path / f"{mod.__name__}_t.jsonl")))
    assert shaped[1] == shaped[0]
    assert shaped[1][1][1]["error"] == "timeout"


# ------------------------------------------------------------ the CLIs
_STEPS = """
import io, json, runpy, sys
from contextlib import redirect_stdout
out = {{}}
for name, argv in {steps!r}:
    buf = io.StringIO()
    sys.argv = [name, *argv]
    with redirect_stdout(buf):
        try:
            {run}
            code = None
        except SystemExit as e:
            code = e.code
    out[" ".join([name, *argv])] = [code, buf.getvalue()]
print(json.dumps(out))
"""


def _start_clis(pkg, cwd, steps):
    """A subprocess running `steps` (CLI name, argv) in order through the
    root scripts or the port's modules; its stdout ends with their exit
    codes and printed output as JSON."""
    run = ("runpy.run_path(f'{ROOT}/{name}.py', run_name='__main__')" if pkg == "root"
           else "runpy.run_module(f'anorag_tpu_torch.{name}', run_name='__main__')")
    code = _STEPS.format(steps=steps, run=run.replace("{ROOT}", str(ROOT)))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "PYTHONHASHSEED": "0",
           "JAX_PLATFORMS": "cpu"}
    return subprocess.Popen([sys.executable, "-c", code], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish_clis(proc):
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def test_clis_equal_the_root_clis(synth, tmp_path):
    """main_musique, then run_evaluation plain, --enhanced and with
    --official-out, extract_dev200 and convert_to_official_format, on a copy
    of config.yaml with system.device cpu and the hash backend."""
    text = (ROOT / "config.yaml").read_text()
    text = text.replace("device: tpu", "device: cpu").replace(
        "backend: jax        # jax | hash", "backend: hash").replace(
        "  mesh:\n", "  sharded_search: 'off'\n  mesh:\n")
    assert "device: cpu" in text and "backend: hash" in text and "sharded_search" in text
    items = read_jsonl(synth)
    items[2]["answerable"] = False
    steps = [("main_musique", ["items.jsonl", "preds.jsonl", "--config", "cfg.yaml",
                               "--no-llm", "--workers", "1"]),
             ("main_musique", ["items.jsonl", "preds.jsonl", "--config", "cfg.yaml",
                               "--no-llm", "--workers", "2"]),
             ("run_evaluation", ["preds.jsonl", "items.jsonl"]),
             ("run_evaluation", ["preds.jsonl", "items.jsonl", "--enhanced"]),
             ("run_evaluation", ["preds.jsonl", "items.jsonl", "--official-out",
                                 "official.jsonl"]),
             ("extract_dev200", ["items.jsonl", "dev.jsonl", "-n", "2"]),
             ("extract_dev200", ["items.jsonl", "dev_all.jsonl",
                                 "--include-unanswerable"]),
             ("convert_to_official_format", ["preds.jsonl", "converted.jsonl"])]
    procs = {}
    for pkg in ("root", "port"):         # the two packages side by side
        cwd = tmp_path / pkg
        cwd.mkdir()
        (cwd / "cfg.yaml").write_text(text)
        write_jsonl(cwd / "items.jsonl", items)
        procs[pkg] = _start_clis(pkg, cwd, steps)
    out = {pkg: _finish_clis(proc) for pkg, proc in procs.items()}
    assert out["port"] == out["root"]
    first = out["root"][" ".join(["main_musique", *steps[0][1]])]
    assert first == [0, "done: 3 items (0 errors) -> preds.jsonl; work dir result/1\n"]
    assert out["root"][" ".join(["main_musique", *steps[1][1]])][1].startswith(
        "done: 3 items (0 errors)")
    for name in ("preds.jsonl", "official.jsonl", "dev.jsonl", "dev_all.jsonl",
                 "converted.jsonl"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "root" / name).read_bytes(), name
    for it in items:
        _assert_same_audit(tmp_path / "port" / "result/1" / it["id"],
                           tmp_path / "root" / "result/1" / it["id"])
