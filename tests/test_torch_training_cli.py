"""The port's training CLIs (python -m anorag_tpu_torch.{train_encoder,
train_retrieval_encoder, train_note_lm, train_answer_models,
run_calibration, train_reranker}) against the repo's root scripts, and the
copied training modules, on the CPU.

The CLIs run at tiny sizes with --device cpu (a config with system.device
cpu where they read one), the root scripts and the port's modules each in
a subprocess of their own, side by side. Their flags are the root
scripts' with the same defaults, but for the differences listed. What
does not depend on the initial weights (the port draws them from a
torch.Generator, the reference from JAX's PRNG) is held equal: the answer
heads' calibration.json, run_calibration's report and calibration.json,
train_note_lm's pair statistics, split and report numbers,
train_retrieval_encoder's corpus, step count and hash baseline, and the
step counts of train_encoder and train_reranker; the losses are finite.
The copied modules are held AST-equal to the originals.
"""
import ast
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from anorag_tpu.models import decoder_lm as J
from anorag_tpu.training.answer_models import train_answer_models as j_train_answer_models
from anorag_tpu.training.calibrate import AutoCalibrator as JAutoCalibrator
from anorag_tpu_torch.models import decoder_lm as T
from anorag_tpu_torch.models.embedding_manager import EmbeddingManager
from anorag_tpu_torch.models.train import EncoderTrainer
from anorag_tpu_torch.training.answer_models import train_answer_models
from anorag_tpu_torch.training.calibrate import DEFAULT_SPACES, AutoCalibrator
from anorag_tpu_torch.utils.file_io import write_json

from test_torch_answer import assert_copy_equal

ROOT = Path(__file__).resolve().parents[1]
TRAINING_COPIED = ("training/answer_models.py", "training/calibrate.py")

# (port CLI, the root script it stands for)
CLIS = {"train_encoder": "train_encoder.py",
        "train_retrieval_encoder": "scripts/train_retrieval_encoder.py",
        "train_note_lm": "scripts/train_note_lm.py",
        "train_answer_models": "scripts/train_answer_models.py",
        "run_calibration": "scripts/run_calibration.py",
        "train_reranker": "scripts/train_reranker.py"}
# flags whose default or choices differ, by CLI, and flags only the port has
FLAG_DIFFERS = {("train_note_lm", "--device"): "cuda by default, cuda or cpu (the "
                                                "reference's cpu or tpu)"}
PORT_ONLY = {("train_retrieval_encoder", "--device"), ("run_calibration", "--device"),
             # mesh entries (the reference's mesh spans every device it sees)
             ("train_retrieval_encoder", "--devices"), ("train_encoder", "--devices")}

_NOTE_LM = ["--items", "2", "--seeds", "101"]
_TINY_LM = ["--out", "lm", *_NOTE_LM, "--steps", "3", "--batch", "2", "--hidden", "32",
            "--layers", "1", "--heads", "2", "--ffn", "64", "--warmup", "1",
            "--held-out", "2", "--eval-max-new", "8", "--device", "cpu"]
_TINY_ENC = ["--train-worlds", "3", "--eval-worlds", "3", "--steps", "2", "--batch", "8",
             "--hidden", "32", "--layers", "1", "--heads", "2", "--ffn", "64",
             "--vocab", "512", "--warmup", "1"]


def _steps(pkg):
    """(CLI, argv) in the order one subprocess runs them."""
    cpu = [] if pkg == "root" else ["--device", "cpu"]
    return [("train_answer_models", ["--out", "cal/calibration.json", "--seed", "0"]),
            ("train_note_lm", [*_NOTE_LM, "--stats-only"]),
            ("train_note_lm", _TINY_LM),
            ("train_retrieval_encoder", ["--out", "enc/encoder", *_TINY_ENC, *cpu]),
            ("train_retrieval_encoder", ["--out", "enc32/encoder", *_TINY_ENC,
                                         "--f32-params", "--remat", *cpu]),
            ("run_calibration", ["calib", "--dev-n", "1", *cpu]),
            ("train_encoder", ["notes.json", "--config", "cpu.yaml", "--small",
                               "--batch-size", "8", "--max-length", "16",
                               "--checkpoint", "ckpt/encoder"]),
            ("train_reranker", ["notes.json", "--config", "cpu.yaml", "--epochs", "1",
                                "--batch-size", "4", "--max-length", "32",
                                "--checkpoint", "ckpt/reranker"])]


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


def _notes(n=24):
    people = ["Aurora Lane", "Marcus Webb", "Elena Cortez", "David Kim"]
    works = ["Blue Horizon", "Silent River", "Glass Garden"]
    return [{"note_id": f"n{i}", "title": works[i % 3],
             "entities": [people[i % 4], works[i % 3]],
             "content": f"{people[i % 4]} recorded {works[i % 3]} in {1980 + i}."}
            for i in range(n)]


# the steps by subprocess: run_calibration and the two encoder runs take
# most of the reference's time, so they run beside the rest
GROUPS = ((0, 1, 2, 6, 7), (3, 4), (5,))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{pkg: (cwd, [[exit code, stdout] per step])} for the root scripts and
    the port's CLIs, all groups of both side by side."""
    procs = []
    cwds = {}
    for pkg in ("root", "port"):
        cwd = cwds[pkg] = tmp_path_factory.mktemp(pkg)
        write_json(cwd / "notes.json", _notes())
        (cwd / "cpu.yaml").write_text("system:\n  device: cpu\n")
        steps = [(str(ROOT / CLIS[name]) if pkg == "root" else f"anorag_tpu_torch.{name}",
                  argv) for name, argv in _steps(pkg)]
        env = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"}
        for group in GROUPS:
            procs.append((pkg, group, subprocess.Popen(
                [sys.executable, "-c", _RUN.format(steps=[steps[i] for i in group])],
                cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    out = {pkg: (cwd, [None] * len(_steps(pkg))) for pkg, cwd in cwds.items()}
    for pkg, group, proc in procs:
        try:
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            proc.kill()
        assert proc.returncode == 0, stderr[-3000:]
        for i, res in zip(group, json.loads(stdout.strip().splitlines()[-1])):
            out[pkg][1][i] = res
    return out


def _step(runs, pkg, i):
    code, text = runs[pkg][1][i]
    assert code in (None, 0), (pkg, _steps(pkg)[i], text[-2000:])
    return text


def _report(runs, pkg, rel):
    return json.loads((runs[pkg][0] / rel).read_text())


# ------------------------------------------------------------ the copies
@pytest.mark.parametrize("rel", TRAINING_COPIED)
def test_copied_training_module_equals_the_original(rel):
    assert_copy_equal(rel, {})


def test_train_answer_models_equals_the_reference():
    for seed in (0, 3):
        assert train_answer_models(seed=seed) == j_train_answer_models(seed=seed)


def test_auto_calibrator_equals_the_reference_under_a_fixed_eval_fn():
    """The same deterministic eval_fn (a hash of the candidate params) gives
    the same searches, calibration, oracle bound and sensitivities."""
    def eval_fn(dev, params):
        text = json.dumps(params, sort_keys=True) + str(len(dev))
        return (sum(map(ord, text)) * 7919 % 1000) / 1000.0

    dev = [{"id": i} for i in range(3)]
    for seed, trials in ((0, 24), (7, 2)):
        got = AutoCalibrator(eval_fn, max_trials_per_component=trials, seed=seed)
        want = JAutoCalibrator(eval_fn, max_trials_per_component=trials, seed=seed)
        assert got.calibrate_all_components(dev) == want.calibrate_all_components(dev)
        assert got.get_oracle_upper_bound(dev) == want.get_oracle_upper_bound(dev)
        params = got.calibration["components"]
        assert got.sensitivity_analysis(dev, params) == want.sensitivity_analysis(dev, params)
    rows = [{"params": {"a": 1}, "metric": 0.2}, {"params": {"b": 2}, "metric": 0.7}]
    assert AutoCalibrator(eval_fn).calibrate_from_oracle_dump(rows) == \
        JAutoCalibrator(eval_fn).calibrate_from_oracle_dump(rows)
    assert set(DEFAULT_SPACES) == {"learned_fusion", "qa_coverage", "span_picker",
                                   "k_estimator", "listwise"}


# ------------------------------------------------------------- the flags
def _flags(path: Path) -> dict:
    """{option: default} of every add_argument call in the file."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            name = node.args[0].value
            kw = {k.arg: k.value for k in node.keywords}
            default = ast.literal_eval(kw["default"]) if "default" in kw else None
            choices = ast.literal_eval(kw["choices"]) if "choices" in kw else None
            out[name] = (default, choices)
    return out


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_takes_the_root_scripts_flags_and_defaults(name):
    ref, port = _flags(ROOT / CLIS[name]), _flags(ROOT / "anorag_tpu_torch" / f"{name}.py")
    for flag, spec in ref.items():
        assert flag in port, (name, flag)
        if (name, flag) in FLAG_DIFFERS:
            assert port[flag] != spec, (name, flag, "no longer differs")
        else:
            assert port[flag] == spec, (name, flag)
    assert {(name, f) for f in set(port) - set(ref)} <= PORT_ONLY
    assert {n for n, _ in set(FLAG_DIFFERS) | PORT_ONLY} <= set(CLIS)


# --------------------------------------------------------------- the runs
def test_train_answer_models_cli_equals_the_root_script(runs):
    assert _step(runs, "port", 0) == _step(runs, "root", 0)
    assert _report(runs, "port", "cal/calibration.json") == \
        _report(runs, "root", "cal/calibration.json")


def test_train_note_lm_stats_line_equals_the_root_script(runs):
    def strip(text):
        return re.sub(r"build [0-9.]+s", "build Ts", text)

    got, want = _step(runs, "port", 1), _step(runs, "root", 1)
    assert got.startswith("pairs: ") and strip(got) == strip(want)


def test_train_note_lm_report_equals_the_root_script_but_the_losses(runs):
    got, want = _report(runs, "port", "lm/report.json"), _report(runs, "root", "lm/report.json")
    assert got.keys() == want.keys()
    for key in ("out", "n_params", "config", "n_train", "n_held_out", "steps", "batch",
                "seq"):
        assert got[key] == want[key], key
    assert [h["step"] for h in got["loss_history"]] == [h["step"] for h in want["loss_history"]]
    assert all(math.isfinite(h["loss"]) for h in got["loss_history"])
    assert got["held_out"].keys() == want["held_out"].keys()
    for key in ("n_eval", "n_eval_answer", "n_eval_copy"):
        assert got["held_out"][key] == want["held_out"][key], key
    port, root = ([re.sub(r"build [0-9.]+s", "build Ts", line)
                   for line in _step(runs, pkg, 2).splitlines()[:2]] for pkg in ("port", "root"))
    assert port == root and port[1].startswith("train ")      # pairs, split
    # the port's checkpoint loads in both packages with the same weights
    jp, jc = J.load_lm(runs["port"][0] / "lm")
    tp, tc = T.load_lm(runs["port"][0] / "lm", device="cpu")
    assert jc.as_dict() == tc.as_dict() == got["config"]
    np.testing.assert_array_equal(np.asarray(jp["tok_emb"]), tp.tok_emb.numpy())


@pytest.mark.parametrize("i,out", [(3, "enc/encoder"), (4, "enc32/encoder")])
def test_train_retrieval_encoder_report_equals_the_root_script_but_the_model(runs, i, out):
    got, want = _report(runs, "port", f"{out}_report.json"), \
        _report(runs, "root", f"{out}_report.json")
    assert got.keys() == want.keys()
    for key in ("config", "train_pairs", "steps", "eval_corpus", "eval_queries",
                "checkpoint_path"):
        assert got[key] == want[key], key
    assert got["recall_at_10"].keys() == want["recall_at_10"].keys()
    assert got["recall_at_10"]["hash_embedder"] == want["recall_at_10"]["hash_embedder"]
    assert math.isfinite(got["loss_first"]) and math.isfinite(got["loss_last"])
    assert got["checkpoint_saved"]
    lines = [_step(runs, pkg, i).splitlines() for pkg in ("port", "root")]
    assert lines[0][0] == lines[1][0] and lines[0][2] == lines[1][2]   # corpus, hash
    # the state dict at the inference dtypes, read as embedding.checkpoint_path
    state = torch.load(runs["port"][0] / out, weights_only=True)
    assert state["tok_emb"].dtype == torch.bfloat16
    assert state["emb_ln_scale"].dtype == torch.float32
    em = EmbeddingManager({"embedding": {"model_name": "", "max_length": 128,
                                         "checkpoint_path": str(runs["port"][0] / out)},
                           "encoder": {"vocab_size": 512, "hidden_size": 32,
                                       "num_layers": 1, "num_heads": 2,
                                       "intermediate_size": 64, "max_position": 128,
                                       "pooling": "mean"}}, device="cpu")
    assert torch.isfinite(em.encode_texts(["Who founded Nexus Labs?"])).all()
    assert em.weights_source.endswith("+checkpoint:" + str(runs["port"][0] / out))


def test_run_calibration_equals_the_root_script(runs):
    assert _step(runs, "port", 5) == _step(runs, "root", 5)
    for rel in ("calib/calibration.json", "calib/calibration_report.json"):
        assert _report(runs, "port", rel) == _report(runs, "root", rel), rel


@pytest.mark.parametrize("i,pattern", [
    (6, r"trained (\d+) steps: loss [0-9.]+ -> [0-9.]+; checkpoint "),
    (7, r"trained (\d+) steps, final loss [0-9.]+, checkpoint ")])
def test_train_encoder_and_reranker_take_the_root_scripts_steps(runs, i, pattern):
    got, want = (re.search(pattern, _step(runs, pkg, i)) for pkg in ("port", "root"))
    assert got and want and got.group(1) == want.group(1)
    assert _step(runs, "port", i).rstrip().endswith(
        "saved to " + _steps("port")[i][1][-1])


def test_train_encoder_checkpoint_restores_into_a_trainer(runs):
    trainer = EncoderTrainer(seed=5, device="cpu")
    assert trainer.restore_checkpoint(runs["port"][0] / "ckpt/encoder")


def test_run_calibration_runs_the_held_out_generator_in_a_subprocess(monkeypatch):
    """--paraphrase-bank: the items of scripts/gen_heldout_musique.py, run
    as a script; nothing of it is imported into the process."""
    from anorag_tpu_torch import run_calibration

    before = set(sys.modules)
    items = run_calibration.heldout_items(2, 7, "v1")
    assert len(items) == 2 and all(it["id"].startswith("heldout_") for it in items)
    assert "gen_heldout_musique" not in set(sys.modules) - before


def test_training_clis_run_on_the_card_unless_asked(monkeypatch, tmp_path):
    from anorag_tpu_torch import train_note_lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_note_lm.main(["--out", str(tmp_path / "lm"), *_NOTE_LM, "--steps", "1"])
