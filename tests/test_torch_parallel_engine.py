"""The port's task engine and its interfaces (anorag_tpu_torch/parallel/
{engine,interface}.py) and `main process --parallel` against anorag_tpu's
and the root main.py's, on the CPU, in this process.

engine.py is a copy of the reference's and interface.py a copy whose
processors also take the device: their ASTs are held equal to the
originals' apart from the parts listed. The same tasks go through both
engines (splitting, replication, distribution, hybrid selection, failing
processors) and give the same rows and stats; the document, query and
MuSiQue interfaces give the same results, run counts and error rows (hash
backend, no LLM); and `main process --parallel` builds, for one file, the
serial knowledge base and, for two, one knowledge base a file in
<work dir>/<file stem>, each artifact equal to the root CLI's.
"""
import argparse
import copy
import json

import numpy as np
import pytest
import yaml

import main as root_main
from anorag_tpu.config import ConfigLoader
from anorag_tpu.config import config as jglobal_config
from anorag_tpu.models.embedding_manager import EmbeddingManager as JEmbeddingManager
from anorag_tpu.parallel import engine as jengine
from anorag_tpu.parallel import interface as jinterface
from anorag_tpu.query.processor import QueryProcessor as JQueryProcessor
from anorag_tpu_torch.config import Config
from anorag_tpu_torch.main import main as port_main
from anorag_tpu_torch.models.embedding_manager import EmbeddingManager
from anorag_tpu_torch.parallel import engine as tengine
from anorag_tpu_torch.parallel import interface as tinterface
from anorag_tpu_torch.query.processor import QueryProcessor

from conftest import make_notes
from test_torch_answer import _DEVICE, assert_copy_equal
from test_torch_offline import _ARTIFACTS

PARALLEL_COPIED = ("parallel/engine.py", "parallel/interface.py")
PARALLEL_DIFFERS = {
    "parallel/interface.py": {
        "from anorag_tpu_torch.device import DeviceLike": "the device's type",
        **{name: _DEVICE for name in (
            "DocumentTaskProcessor.__init__", "DocumentTaskProcessor.process_single_task",
            "MusiqueTaskProcessor.__init__", "MusiqueTaskProcessor.process_single_task",
            "create_parallel_interface")}},
}
PACKAGES = {"ref": (jengine, jinterface), "port": (tengine, tinterface)}


@pytest.mark.parametrize("rel", PARALLEL_COPIED)
def test_copied_parallel_module_equals_the_original(rel):
    assert_copy_equal(rel, PARALLEL_DIFFERS.get(rel, {}))


def test_package_exports_equal_the_reference():
    import anorag_tpu.parallel as jpar
    import anorag_tpu_torch.parallel as tpar

    assert tpar.__all__ == jpar.__all__
    assert all(hasattr(tpar, name) for name in tpar.__all__)


# --------------------------------------------------------------- the engine
class Echo:
    def __init__(self, tag, task_types=("echo",)):
        self.tag, self.task_types = tag, task_types

    def process_single_task(self, task):
        return f"{self.tag}:{task.data}"

    def aggregate_results(self, results):
        return results


class Fail(Echo):
    def process_single_task(self, task):
        raise RuntimeError(f"{self.tag} down")


def _rows(done):
    return [(t.task_id, t.task_type, t.data, t.result, t.error) for t in done]


def _run(eng_mod, procs, strategy, tasks, workers=4):
    eng = eng_mod.ParallelEngine(procs, max_workers=workers, strategy=strategy)
    done = eng.process_tasks([eng_mod.ParallelTask(*t) for t in tasks])
    s = eng.stats
    return _rows(done), (s.tasks_done, s.tasks_failed, s.throughput > 0, s.avg_latency >= 0)


ENGINE_CASES = {
    # name: (processors, strategy, tasks)
    "splitting": (lambda: [Echo("a"), Echo("b")], "split",
                  [(str(i), "echo", i) for i in range(6)]),
    "splitting with a failing processor": (
        lambda: [Echo("a"), Fail("b"), Echo("c")], "split",
        [(str(i), "echo", i) for i in range(7)]),
    "replication, first success wins": (lambda: [Fail("f"), Echo("ok")], "copy",
                                        [("0", "echo", "x"), ("1", "echo", "y")]),
    "replication, all fail": (lambda: [Fail("f"), Fail("g")], "copy", [("0", "echo", "x")]),
    "distribution by task type": (
        lambda: [Echo("e"), Echo("u", ("upper",))], "dispatch",
        [("0", "echo", 1), ("1", "upper", 2), ("2", "other", 3), ("3", "upper", 4)]),
    "hybrid: several types -> distribution": (
        lambda: [Echo("e"), Echo("u", ("upper",))], "hybrid",
        [("0", "echo", 1), ("1", "upper", 2)]),
    "hybrid: 6 tasks -> splitting": (lambda: [Echo("a"), Echo("b")], "hybrid",
                                     [(str(i), "echo", i) for i in range(6)]),
    "hybrid: few tasks -> replication": (lambda: [Fail("f"), Echo("b")], "hybrid",
                                         [(str(i), "echo", i) for i in range(3)]),
}


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_engine_strategies_equal_the_reference(case):
    make, strategy, tasks = ENGINE_CASES[case]
    got, want = (_run(mod, make(), strategy, tasks) for mod in (tengine, jengine))
    assert got == want
    assert want[0]


def test_engine_hybrid_auto_selects_as_the_reference():
    for mod in (tengine, jengine):
        one = mod.ParallelEngine([Echo("a")], strategy=mod.Strategy.HYBRID)
        two = mod.ParallelEngine([Echo("a"), Echo("u", ("upper",))], strategy="hybrid")
        T = mod.ParallelTask
        assert one._select_strategy([T(str(i), "echo", i) for i in range(8)]) == "split"
        assert one._select_strategy([T("0", "echo", 0)]) == "copy"
        assert one._select_strategy([T("0", "echo", 0), T("1", "upper", 1)]) == "copy"
        assert two._select_strategy([T("0", "echo", 0), T("1", "upper", 1)]) == "dispatch"
    assert [s.value for s in tengine.Strategy] == [s.value for s in jengine.Strategy]


# --------------------------------------------------------------- interfaces
def _loader():
    loader = ConfigLoader(auto_load=False)
    for key, value in {"embedding.backend": "hash", "embedding.dim": 64,
                       "vector_store.index_type": "Flat", "clustering.n_clusters": 2,
                       "tpu.sharded_search": "off"}.items():
        loader.set(key, value)
    return loader


def _both(loader):
    """(reference, port): each package's config and embedding manager."""
    return ((loader, JEmbeddingManager(cfg=loader, singleton=False)),
            (Config(loader.as_dict()), EmbeddingManager(loader.as_dict(), device="cpu")))


def _strip(obj, *paths):
    text = json.dumps(obj, default=str, sort_keys=True)
    for i, p in enumerate(paths):
        text = text.replace(str(p), f"WORK{i}")
    return json.loads(text)


DOCS = [{"id": "d1", "title": "Blue Horizon",
         "text": "Aurora Lane released Blue Horizon. The album sold well. "
                 "Aurora Lane married Chris Reed."},
        {"id": "d2", "title": "Nexus Labs",
         "text": "Nexus Labs was founded by David Kim in 2010. It is located in Austin."}]


@pytest.fixture(scope="module")
def doc_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("docs")
    paths = []
    for doc in DOCS:
        path = root / f"{doc['id']}.jsonl"
        path.write_text(json.dumps(doc) + "\n")
        paths.append(path)
    return paths


def test_document_interface_equals_the_reference(doc_files, tmp_path):
    files = [str(p) for p in doc_files] + [str(tmp_path / "missing.jsonl")]
    out = {}
    for name, (cfg, em) in zip(("ref", "port"), _both(_loader())):
        kw = {"device": "cpu"} if name == "port" else {}
        iface = PACKAGES[name][1].create_parallel_interface(
            mode="document", work_dir=tmp_path / name, cfg=cfg, embedding_manager=em,
            workers=2, **kw)
        res = iface.process_documents(files)
        stats = res["stats"]
        assert (stats.tasks_done, stats.tasks_failed) == (2, 1)
        res["results"]["atomic_notes"].sort(key=lambda n: n["note_id"])
        out[name] = _strip({k: res[k] for k in ("results", "errors")}, tmp_path / name)
        for path in doc_files:
            assert (tmp_path / name / path.stem / "atomic_notes.json").exists()
    assert out["port"] == out["ref"]
    assert out["ref"]["results"]["n_runs"] == 2 and len(out["ref"]["errors"]) == 1
    assert out["ref"]["results"]["atomic_notes"]


def test_query_interface_equals_the_reference():
    queries = ["Who is Aurora Lane?", {"query": "Quantum Leap Institute", "qid": "q2"},
               {"question": "no query key"}, "Who founded Nexus Labs?"]
    out = {}
    for name, (cfg, em) in zip(("ref", "port"), _both(_loader())):
        kw = {"device": "cpu"} if name == "port" else {}
        qp = (QueryProcessor if name == "port" else JQueryProcessor)(
            make_notes(8), cfg=cfg, embedding_manager=em, **kw)
        iface = PACKAGES[name][1].create_parallel_interface(
            mode="query", query_processor=qp, workers=2)
        out[name] = [r if "error" in r else
                     {k: r[k] for k in ("query", "answer", "predicted_support_idxs",
                                        "answer_method")}
                     for r in iface.process_queries(queries)]
    assert out["port"] == out["ref"]
    assert out["ref"][2] == {"error": "all processors failed"} and out["ref"][0]["answer"]


def test_musique_interface_equals_the_reference(tmp_path):
    items = [{"id": "x", "question": "Who founded Nexus Labs?",
              "paragraphs": [{"idx": 0, "title": "Nexus Labs",
                              "paragraph_text": "Nexus Labs was founded by David Kim."}]},
             {"id": "y", "question": "Who sang Blue Horizon?",
              "paragraphs": [{"idx": 0, "title": "Blue Horizon",
                              "paragraph_text": "Blue Horizon is sung by Aurora Lane."},
                             {"idx": 1, "title": "Aurora Lane",
                              "paragraph_text": "Aurora Lane was born in Boston."}]},
             {"id": "z\x00", "question": "Who?"}]   # no work dir: an error row
    out = {}
    for name, (cfg, em) in zip(("ref", "port"), _both(_loader())):
        kw = {"device": "cpu"} if name == "port" else {}
        iface = PACKAGES[name][1].create_parallel_interface(
            mode="musique", work_dir=tmp_path / name, cfg=cfg, embedding_manager=em,
            workers=1, **kw)
        out[name] = _strip(iface.process_musique_dataset(items), tmp_path / name)
    assert out["port"] == out["ref"]
    assert [r["id"] for r in out["ref"]] == ["x", "y", "z\x00"]
    assert out["ref"][0]["predicted_answer"] and out["ref"][2]["error"]


# ------------------------------------------------- main process --parallel
def _root_process(cfg_path, files, parallel, capsys):
    """Root main.py's `process` in this process; the global config it loads
    the YAML into is put back afterwards."""
    saved = copy.deepcopy(jglobal_config._config), jglobal_config._path
    try:
        args = argparse.Namespace(config=str(cfg_path), files=files, new=False,
                                  force=False, debug=False, parallel=parallel,
                                  workers=2, strategy="hybrid", no_llm=True)
        assert root_main.process_docs(args) == 0
    finally:
        jglobal_config._config, jglobal_config._path = saved
    return capsys.readouterr().out


@pytest.mark.parametrize("n_files", [1, 2])
def test_main_process_parallel_equals_the_root_cli(doc_files, tmp_path, n_files, capsys):
    files = [str(p) for p in doc_files[:n_files]]
    printed = {}
    for name in ("ref", "port"):
        sets = {"system": {"device": "cpu"}, "embedding": {"backend": "hash", "dim": 128},
                "vector_store": {"index_type": "Flat"},
                "tpu": {"sharded_search": "off", "compilation_cache_dir": ""},
                "storage": {"result_root": str(tmp_path / name)}}
        cfg_path = tmp_path / f"{name}.yaml"
        cfg_path.write_text(yaml.safe_dump(sets))
        if name == "ref":
            out = _root_process(cfg_path, files, True, capsys)
        else:
            assert port_main(["--config", str(cfg_path), "process", *files, "--parallel",
                              "--no-llm", "--workers", "2"]) == 0
            out = capsys.readouterr().out
        printed[name] = out.replace(str(tmp_path / name), "ROOT").split("{'n_chunks'")[0]
    assert printed["port"] == printed["ref"]
    dirs = ([""] if n_files == 1 else [p.stem for p in doc_files])
    if n_files == 1:
        assert printed["ref"] == "processed -> ROOT/1: "
    else:
        assert printed["ref"] == "processed 2 files -> ROOT/1 (2 runs, 0 errors)\n"
    for sub in dirs:
        ref, port = (tmp_path / name / "1" / sub for name in ("ref", "port"))
        for artifact in _ARTIFACTS:
            if artifact == "embeddings.npy":
                np.testing.assert_array_equal(np.load(port / artifact), np.load(ref / artifact))
            else:
                assert (port / artifact).read_bytes() == (ref / artifact).read_bytes(), \
                    (sub, artifact)
