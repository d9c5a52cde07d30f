"""Run the AutoCalibrator loop end to end on a synthetic dev set, on the card.

Counterpart of scripts/run_calibration.py, with its flags, printed lines
and files (calibration.json, calibration_report.json):

    python -m anorag_tpu_torch.run_calibration OUT_DIR [--dev-n 24] [--seed 7] \
        [--paraphrase-bank v1] [--device cuda]

  1. a dev split from scripts/gen_synth_musique.py (loaded by path), or
     with --paraphrase-bank from scripts/gen_heldout_musique.py, which runs
     as a subprocess into a temporary jsonl (the held-out bank stays out of
     the package);
  2. eval_fn runs the LLM-free per-item pipeline (pipeline_musique.py) with
     the candidate params written to a calibration.json the pipeline loads;
  3. AutoCalibrator's component and joint search (training/calibrate.py);
  4. the winner persisted to OUT_DIR/calibration.json;
  5. the dev-set delta: uncalibrated score against calibrated.
make_cfg takes the device, cuda by default (--device), where the
reference's hard-codes system.device cpu.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional, Sequence

from anorag_tpu_torch.config.loader import ConfigLoader
from anorag_tpu_torch.eval.musique import evaluate_dataset
from anorag_tpu_torch.pipeline_musique import process_musique_item
from anorag_tpu_torch.training.calibrate import AutoCalibrator
from anorag_tpu_torch.training.synth import SCRIPTS, synth_generator
from anorag_tpu_torch.utils.file_io import read_jsonl, write_json


def make_cfg(calibration_path: str = "", device: str = "cuda") -> ConfigLoader:
    cfg = ConfigLoader(auto_load=False)
    cfg.set("embedding.backend", "hash")
    cfg.set("embedding.dim", 256)
    cfg.set("vector_store.index_type", "Flat")
    cfg.set("system.device", device)
    if calibration_path:
        cfg.set("calibration.path", calibration_path)
    return cfg


def run_dev(dev_items, work_root: Path, calibration_path: str = "",
            device: str = "cuda") -> dict:
    cfg = make_cfg(calibration_path, device)
    preds = []
    for it in dev_items:
        wd = work_root / str(it["id"])
        if wd.exists():
            shutil.rmtree(wd)
        preds.append(process_musique_item(it, wd, cfg=cfg, llm=None, device=device))
    return evaluate_dataset(preds, dev_items)


def score(metrics: dict) -> float:
    # the reference's joint objective shape: answer first, support second
    return metrics["answer_em"] + 0.5 * metrics["support_f1"]


def heldout_items(n: int, seed: int, bank: str) -> list:
    """gen_heldout_musique's items (8 distractors), made by the script in a
    subprocess."""
    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "dev.jsonl"
        subprocess.run([sys.executable, str(SCRIPTS / "gen_heldout_musique.py"),
                        str(path), "--n", str(n), "--distractors", "8",
                        "--seed", str(seed), "--bank", bank],
                       check=True, stdout=subprocess.DEVNULL)
        return read_jsonl(path)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--dev-n", type=int, default=24)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--paraphrase-bank", default=None,
                    help="calibrate against a paraphrased dev sheet "
                         "(gen_heldout_musique bank, e.g. v1, the dev bank); "
                         "the saturated sheet scores every candidate alike")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    device = args.device

    if args.paraphrase_bank:
        dev = heldout_items(args.dev_n, args.seed, args.paraphrase_bank)
    else:
        dev = synth_generator().make_items(args.dev_n, distractors=8, seed=args.seed)
    # calibrate on answerable items (the unanswerable kind scores a flag,
    # not params); keep them for the final delta report
    dev_ans = [it for it in dev if it.get("answerable", True)]

    n_evals = [0]

    def eval_fn(dev_data, params):
        n_evals[0] += 1
        with tempfile.TemporaryDirectory() as td:
            cal_path = Path(td) / "calibration.json"
            write_json(cal_path, {"components": params})
            m = run_dev(dev_data, Path(td) / "work", str(cal_path), device)
        s = score(m)
        print(f"  eval #{n_evals[0]}: params={json.dumps(params, sort_keys=True)}"
              f" -> em={m['answer_em']:.3f} supF1={m['support_f1']:.3f} s={s:.4f}",
              flush=True)
        return s

    base_metrics = run_dev(dev_ans, out / "base_work", device=device)
    print(f"uncalibrated: em={base_metrics['answer_em']:.3f} "
          f"supF1={base_metrics['support_f1']:.3f} "
          f"score={score(base_metrics):.4f}", flush=True)

    cal = AutoCalibrator(eval_fn, max_trials_per_component=6, seed=args.seed)
    cal.calibrate_all_components(dev_ans)
    cal_path = out / "calibration.json"
    cal.save_calibration(cal_path)

    cal_metrics = run_dev(dev_ans, out / "cal_work", str(cal_path), device)
    print(f"calibrated:   em={cal_metrics['answer_em']:.3f} "
          f"supF1={cal_metrics['support_f1']:.3f} "
          f"score={score(cal_metrics):.4f}", flush=True)
    delta = score(cal_metrics) - score(base_metrics)
    report = {
        "dev_sheet": (f"paraphrase bank {args.paraphrase_bank}"
                      if args.paraphrase_bank else "saturated synth"),
        "dev_n": len(dev_ans),
        "n_pipeline_evals": n_evals[0],
        "uncalibrated": base_metrics,
        "calibrated": cal_metrics,
        "delta_score": round(delta, 4),
        "components": cal.calibration.get("components", {}),
    }
    write_json(out / "calibration_report.json", report)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
