"""The port's index and evaluation CLIs (python -m anorag_tpu_torch.{
rebuild_vector_index, run_heldout, eval_recall_optimizer,
eval_encoder_discrimination, check_musique_results, check_support_stats,
check_deprecated_config, migrate_config, debug_heldout, debug_kinds})
against the repo's root scripts, on the CPU.

The root scripts run with JAX on one CPU device, the port's CLIs with
--device cpu (or a config with system.device cpu), each group of steps in
a subprocess of its own, all side by side, each package in a working
directory of its own. Held equal: the reports key for key, the printed
lines (the JSON ones parsed; no step prints a timing), rebuild_vector_index's
saved rows (to 1e-6) and its `fresh` second call, migrate_config's YAML
after loading, and eval_encoder_discrimination's arms on
checkpoints/encoder_synth_small (orbax-restored for the root, carried
into a torch state dict with models/encoder.params_from_jax for the port;
the random arm on the root's PRNGKey(0) weights carried across). The
flags are the root scripts' with their defaults, but --device.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from anorag_tpu.models import encoder as J
from anorag_tpu_torch import eval_encoder_discrimination as port_disc
from anorag_tpu_torch import migrate_config as port_migrate
from anorag_tpu_torch.config.yaml_subset import safe_dump, safe_load
from anorag_tpu_torch.models import encoder as T
from anorag_tpu_torch.models.tokenizer import HashTokenizer

ROOT = Path(__file__).resolve().parents[1]
SMALL = ROOT / "checkpoints" / "encoder_synth_small"
# the small checkpoint's shape (train_retrieval_encoder's defaults), in the
# root eval's keys and train_retrieval_encoder's
SMALL_SHAPE = {"vocab_size": 8192, "hidden_size": 256, "num_layers": 4, "num_heads": 8,
               "intermediate_size": 1024, "vocab": 8192, "hidden": 256, "layers": 4,
               "heads": 8, "ffn": 1024, "pooling": "mean"}

CLIS = {name: f"scripts/{name}.py" for name in (
    "rebuild_vector_index", "run_heldout", "eval_recall_optimizer",
    "eval_encoder_discrimination", "check_musique_results", "check_support_stats",
    "check_deprecated_config", "migrate_config", "debug_heldout", "debug_kinds")}
# flags whose choices or default differ, and flags only the port has
FLAG_DIFFERS = {("run_heldout", "--device"), ("eval_encoder_discrimination", "--device")}
PORT_ONLY = {("eval_recall_optimizer", "--device"), ("debug_heldout", "--device"),
             ("debug_kinds", "--device")}

LEGACY_YAML = """\
# a legacy config: deprecated keys, an unknown one, lists and odd scalars
dispatcher:
  enabled: true
  final_semantic_count: 6
hybrid_search:
  linear:
    vector_weight: 0.7
retrieval:
  candidate_pool: 60
  stop_words: [the, "a", 'of']
embedding:
  model_name: BAAI/bge-m3
  query_prefix: "query: "
  dim: 256
colours:
  - name: red
    rgb: [255, 0, 0]
  - name: "yes"
    rgb: []
misc: {ratio: 1.0e-3, big: 10000000000, none: ~, empty: '', octal: 0o17}
"""


# the port's groups that read the carried checkpoint
NEEDS_CHECKPOINT = ("trained", "host")


def _steps(pkg):
    """{group: [(CLI, argv)]} in the order each group's subprocess runs
    them. The root scripts change their process-wide config: steps that
    set other keys run in processes of their own."""
    dev = [] if pkg == "root" else ["--device", "cpu"]
    disc = ["--worlds", "12", "--group", "4", "--ckpt", "small", "--report", "disc.json"]
    return {
        "heldout": [("run_heldout", ["--n", "6", "--report", "heldout.json", *dev]),
                    ("debug_heldout", ["0", "1", "--n", "6", "--support", *dev]),
                    ("debug_kinds", ["0", "5", "--n", "1", "--verbose", *dev])],
        "trained": [("run_heldout", ["--n", "2", "--embedder", "trained", "--report",
                                     "trained.json", *dev])],
        "recall": [("eval_recall_optimizer", ["--n", "4", "--report", "recall.json", *dev])],
        # the host tools, then eval_encoder_discrimination (the carried checkpoint)
        "host": [("rebuild_vector_index", ["notes.json", "index", "--config", "cpu.yaml"]),
                 ("rebuild_vector_index", ["notes.json", "index", "--config", "cpu.yaml"]),
                 ("check_musique_results", ["preds.jsonl"]),
                 ("check_support_stats", ["preds.jsonl", "--gold", "gold.jsonl"]),
                 ("check_support_stats", ["preds.jsonl"]),
                 ("check_deprecated_config", ["legacy.yaml"]),
                 ("check_deprecated_config", [str(ROOT / "config.yaml")]),
                 ("migrate_config", ["legacy.yaml", "migrated.yaml"]),
                 ("migrate_config", [str(ROOT / "config.yaml"), "root_migrated.yaml"]),
                 ("eval_encoder_discrimination", [*disc, *dev])],
    }


_RUN = """
import io, json, runpy, sys
from contextlib import redirect_stdout
out = []
for target, argv in {steps!r}:
    buf = io.StringIO()
    sys.argv = [target, *argv]
    with redirect_stdout(buf):
        try:
            if target.endswith(".py"):
                runpy.run_path(target, run_name="__main__")
            else:
                runpy.run_module(target, run_name="__main__")
            code = None
        except SystemExit as e:
            code = e.code
    out.append([code, buf.getvalue()])
print(json.dumps(out))
"""


def _rows(n=240):
    people = ["Aurora Lane", "Marcus Webb", "Elena Cortez", "David Kim", "Iris Moreau"]
    works = ["Blue Horizon", "Silent River", "Glass Garden", "Amber Road"]
    return [{"note_id": f"n{i}", "title": works[i % 4],
             "entities": [people[i % 5], works[i % 4]],
             "content": f"{people[i % 5]} recorded {works[i % 4]} in {1900 + i}."}
            for i in range(n)]


def _predictions():
    answers = ["Aurora Lane", "", "insufficient information", "1983", "Unknown band", "Paris"]
    preds = [{"id": f"q{i}", "predicted_answer": a,
              "predicted_support_idxs": list(range(i % 5))} for i, a in enumerate(answers)]
    gold = [{"id": f"q{i}", "question": q} for i, q in enumerate((
        "Who recorded Blue Horizon?", "Where was the performer of Silent River born?",
        "When did the label that released Glass Garden close?", "Who founded Nexus Labs?",
        "What is the capital of the country where Amber Road was filmed?"))]
    return preds, gold


def _port_checkpoint(path: Path):
    """checkpoints/encoder_synth_small restored with orbax and carried into
    a torch state dict at `path` (a file) of the report's shape; the root's
    copy is the orbax directory itself."""
    import orbax.checkpoint as ocp

    cfg = J.EncoderConfig(**{k: SMALL_SHAPE[k] for k in (
        "vocab_size", "hidden_size", "num_layers", "num_heads", "intermediate_size")},
        max_position=128, pooling="mean")
    params = ocp.StandardCheckpointer().restore(
        SMALL.resolve(), J.init_params(jax.random.PRNGKey(0), cfg))
    tcfg = port_disc.checkpoint_config(str(path))
    torch.save(T.params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg), path)


def _write_inputs(cwd: Path, pkg: str):
    from anorag_tpu_torch.utils.file_io import write_json, write_jsonl

    write_json(cwd / "notes.json", _rows())
    (cwd / "cpu.yaml").write_text("system:\n  device: cpu\nembedding:\n  backend: hash\n"
                                  "  dim: 64\nvector_store:\n  index_type: IVFFlat\n")
    preds, gold = _predictions()
    write_jsonl(cwd / "preds.jsonl", preds)
    write_jsonl(cwd / "gold.jsonl", gold)
    (cwd / "legacy.yaml").write_text(LEGACY_YAML)
    report = json.dumps({"config": SMALL_SHAPE})
    # eval_encoder_discrimination's --ckpt small, and run_heldout's
    # trained embedder at its fixed path, checkpoints/encoder_synth_full
    (cwd / "checkpoints").mkdir()
    for ckpt in (cwd / "small", cwd / "checkpoints" / "encoder_synth_full"):
        Path(f"{ckpt}_report.json").write_text(report)
        if pkg == "root":
            ckpt.symlink_to(SMALL.resolve(), target_is_directory=True)
    if pkg == "port":
        (cwd / "checkpoints" / "encoder_synth_full").symlink_to(cwd / "small")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{pkg: (cwd, {group: [[exit code, stdout] per step]})} for the root
    scripts and the port's CLIs, every group of both side by side (the
    port's checkpoint is carried while the rest run)."""
    # one JAX CPU device and one thread a process: ten processes run side by
    # side beside the other test workers
    env = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu",
           "PYTHONHASHSEED": "0", "OMP_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false"}
    cwds = {pkg: tmp_path_factory.mktemp(pkg) for pkg in ("root", "port")}
    for pkg, cwd in cwds.items():
        _write_inputs(cwd, pkg)

    def start(pkg, groups):
        for group in groups:
            targets = [(str(ROOT / CLIS[name]) if pkg == "root"
                        else f"anorag_tpu_torch.{name}", argv)
                       for name, argv in _steps(pkg)[group]]
            procs.append((pkg, group, subprocess.Popen(
                [sys.executable, "-c", _RUN.format(steps=targets)], cwd=cwds[pkg],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))

    procs = []
    start("root", _steps("root"))
    start("port", [g for g in _steps("port") if g not in NEEDS_CHECKPOINT])
    _port_checkpoint(cwds["port"] / "small")
    start("port", NEEDS_CHECKPOINT)
    out = {pkg: (cwd, {}) for pkg, cwd in cwds.items()}
    for pkg, group, proc in procs:
        try:
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            proc.kill()
        assert proc.returncode == 0, (pkg, group, stderr[-3000:])
        out[pkg][1][group] = json.loads(stdout.strip().splitlines()[-1])
    return out


def _out(runs, pkg, group, i=0, code=0):
    got_code, text = runs[pkg][1][group][i]
    assert (got_code or 0) == code, (pkg, group, i, got_code, text[-2000:])
    return text


def _both(runs, group, i=0, code=0):
    return _out(runs, "port", group, i, code), _out(runs, "root", group, i, code)


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _report(runs, pkg, rel):
    return json.loads((runs[pkg][0] / rel).read_text())


# ------------------------------------------------------------- the flags
def _flags(path: Path) -> dict:
    """{option: (default, choices)} of every add_argument call in the file."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            out[node.args[0].value] = tuple(
                ast.literal_eval(kw[k]) if k in kw else None for k in ("default", "choices"))
    return out


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_takes_the_root_scripts_flags_and_defaults(name):
    ref, port = _flags(ROOT / CLIS[name]), _flags(ROOT / "anorag_tpu_torch" / f"{name}.py")
    for flag, spec in ref.items():
        assert flag in port, (name, flag)
        assert (port[flag] != spec) == ((name, flag) in FLAG_DIFFERS), (name, flag)
    assert {(name, f) for f in set(port) - set(ref)} <= PORT_ONLY
    if (name, "--device") in FLAG_DIFFERS | PORT_ONLY:
        assert port["--device"] == ("cuda", ("cuda", "cpu"))


# --------------------------------------------------------------- the runs
def test_run_heldout_equals_the_root_script(runs):
    port, root = _both(runs, "heldout", 0)
    assert _json_lines(port) == _json_lines(root) and len(_json_lines(root)) == 1
    assert _report(runs, "port", "heldout.json") == _report(runs, "root", "heldout.json")


def test_run_heldout_with_the_trained_embedder_equals_the_root_script(runs):
    """checkpoints/encoder_synth_full at the working directory: the small
    checkpoint, orbax for the root, its torch state dict for the port."""
    port, root = _both(runs, "trained")
    assert _json_lines(port) == _json_lines(root)
    assert _report(runs, "port", "trained.json") == _report(runs, "root", "trained.json")


def test_run_heldout_refuses_an_orbax_checkpoint(tmp_path, monkeypatch):
    from anorag_tpu_torch import run_heldout

    (tmp_path / "checkpoints").mkdir()
    (tmp_path / "checkpoints" / "encoder_synth_full").symlink_to(SMALL.resolve())
    (tmp_path / "checkpoints" / "encoder_synth_full_report.json").write_text(
        json.dumps({"config": SMALL_SHAPE}))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="orbax"):
        run_heldout.main(["--embedder", "trained", "--n", "1", "--device", "cpu"])
    assert not (tmp_path / "docs").exists()


@pytest.mark.parametrize("i", [1, 2])
def test_debug_clis_print_the_root_scripts_lines(runs, i):
    port, root = _both(runs, "heldout", i)
    assert port == root and port.rstrip().endswith(("hit", "EM"))


def test_debug_heldout_refuses_a_test_bank():
    from anorag_tpu_torch import debug_heldout

    with pytest.raises(SystemExit, match="not a dev bank"):
        debug_heldout.main(["--bank", "v2", "--device", "cpu"])


def test_eval_recall_optimizer_equals_the_root_script(runs):
    port, root = _both(runs, "recall")
    assert _json_lines(port) == _json_lines(root)
    assert _report(runs, "port", "recall.json") == _report(runs, "root", "recall.json")


def test_eval_encoder_discrimination_equals_the_root_script_but_the_random_arm(runs):
    port, root = _both(runs, "host", 9)
    assert port.splitlines()[0] == root.splitlines()[0]
    got, want = _report(runs, "port", "disc.json"), _report(runs, "root", "disc.json")
    assert got.keys() == want.keys()
    for key in set(want) - {"recall10_random_init"}:
        assert got[key] == want[key], key
    assert 0.0 <= got["recall10_random_init"] <= 1.0
    assert [list(x) for x in _json_lines(port)] == [list(x) for x in _json_lines(root)]


def test_encoder_discrimination_random_arm_on_the_roots_weights(runs):
    """The root's PRNGKey(0) weights carried across give the root's
    random-arm recall."""
    cfg = port_disc.checkpoint_config(str(runs["port"][0] / "small"))
    jcfg = J.EncoderConfig(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                           num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                           intermediate_size=cfg.intermediate_size, max_position=128,
                           pooling="mean")
    params = jax.tree_util.tree_map(np.asarray, J.init_params(jax.random.PRNGKey(0), jcfg))
    model = T.Encoder(cfg, torch.device("cpu"))
    model.load_state_dict(T.params_from_jax(params, cfg))
    queries, corpus, gold = port_disc.make_confusable_eval(12, 4, 31)
    got = port_disc.arm_recall(model, HashTokenizer(cfg.vocab_size, 128), queries, corpus, gold)
    assert round(got, 4) == _report(runs, "root", "disc.json")["recall10_random_init"]


def test_eval_encoder_discrimination_refuses_an_orbax_checkpoint(tmp_path):
    with pytest.raises(SystemExit, match="orbax"):
        port_disc.main(["--worlds", "4", "--group", "2", "--ckpt", str(SMALL),
                        "--device", "cpu", "--report", str(tmp_path / "r.json")])


def test_rebuild_vector_index_equals_the_root_script(runs):
    port, root = _both(runs, "host", 0)
    assert _json_lines(port) == _json_lines(root)
    assert _json_lines(port)[0]["status"] == "rebuilt"
    port, root = _both(runs, "host", 1)
    assert _json_lines(port) == _json_lines(root)
    assert _json_lines(port)[0]["status"] == "fresh"
    (pd, _), (rd, _) = runs["port"], runs["root"]
    with np.load(pd / "index" / "note_embeddings.npz") as p, \
            np.load(rd / "index" / "note_embeddings.npz") as r:
        np.testing.assert_allclose(p["embeddings"], r["embeddings"], atol=1e-6, rtol=0)
    for name in ("atomic_notes.json", "id_mappings.json"):
        assert _report(runs, "port", f"index/{name}") == _report(runs, "root", f"index/{name}")
    got, want = (_report(runs, pkg, "index/index_versions.json") for pkg in ("port", "root"))
    assert [{k: v for k, v in e.items() if k != "created_at"} for e in got] == \
        [{k: v for k, v in e.items() if k != "created_at"} for e in want]


@pytest.mark.parametrize("i", [2, 3, 4])
def test_check_scripts_print_the_root_scripts_report(runs, i):
    port, root = _both(runs, "host", i)
    assert json.loads(port) == json.loads(root) and port == root


@pytest.mark.parametrize("i,code", [(5, 1), (6, 0)])
def test_check_deprecated_config_equals_the_root_script(runs, i, code):
    """legacy.yaml names deprecated and unknown keys (exit 1), the repo's
    config.yaml none (exit 0)."""
    port, root = _both(runs, "host", i, code)
    got, want = json.loads(port), json.loads(root)
    assert got == want and bool(want["unknown_keys"] and want["deprecated"]) == bool(code)


@pytest.mark.parametrize("i,out", [(7, "migrated.yaml"), (8, "root_migrated.yaml")])
def test_migrate_config_equals_the_root_script(runs, i, out):
    port, root = _both(runs, "host", i)
    assert port == root
    want = yaml.safe_load((runs["root"][0] / out).read_text())
    text = (runs["port"][0] / out).read_text()
    assert yaml.safe_load(text) == want == safe_load(text)
    if i == 7:
        assert "migrated: dispatcher -> context_dispatcher" in port


# ---------------------------------------------------------- the YAML writer
_SCALARS = [None, True, False, 0, -7, 10 ** 12, 0.5, 1e-05, 3e20, -0.0, float("inf"),
            float("-inf"), "", " x", "x ", "yes", "No", "null", "~", "1.0", "0x1f", "1_000",
            "2020-01-01", "1:20", "a: b", "a #b", "#c", "-x", "- x", "[x]", "{x}", "x,y",
            "'q'", '"q"', "&a", "*a", "!t", "|", ">", "%d", "@x", "`x", "?x", "a\nb",
            "tab\there", "ünïcödé", " ", "\x85", "\x00", "BAAI/bge-m3",
            "http://localhost:11434", "a  b", "---", "..."]


def test_safe_dump_round_trips_the_configs_and_odd_scalars():
    trees = [yaml.safe_load((ROOT / "config.yaml").read_text()),
             yaml.safe_load(LEGACY_YAML),
             {f"k{i}": v for i, v in enumerate(_SCALARS)},
             {"list": list(_SCALARS), "nested": [[1, [2, []]], {"a": {}}, [{"b": [3]}]],
              5: "int key", "k": {"l": [{"m": None, "n": [{}]}]}},
             [1, {"a": 2}], {}, [], "plain", None]
    for tree in trees:
        text = safe_dump(tree)
        assert yaml.safe_load(text) == tree, text
        assert safe_load(text) == tree, text


def test_safe_dump_refuses_what_safe_load_never_returns():
    with pytest.raises(TypeError):
        safe_dump({"a": (1, 2)})


def test_migrate_config_writes_through_safe_dump(tmp_path, capsys):
    (tmp_path / "in.yaml").write_text(LEGACY_YAML)
    assert port_migrate.main([str(tmp_path / "in.yaml"), str(tmp_path / "out.yaml")]) == 0
    tree = safe_load((tmp_path / "out.yaml").read_text())
    assert tree["context_dispatcher"] == tree["dispatcher"]
    assert tree["hybrid_search"]["weights"]["dense"] == 0.7
    assert "unknown key (kept as-is, check spelling): colours" in capsys.readouterr().out
