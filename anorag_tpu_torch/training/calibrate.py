"""Counterpart of anorag_tpu/training/calibrate.py,
copied as it is with its imports renamed to anorag_tpu_torch.

AutoCalibrator: grid search over component parameters against an eval
function, persisted as calibration.json.
"""
from __future__ import annotations

import itertools
import random
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from anorag_tpu_torch.utils.file_io import read_json, write_json
from anorag_tpu_torch.utils.logging import get_logger

logger = get_logger("anorag.calibrate")

EvalFn = Callable[[Sequence[Dict[str, Any]], Dict[str, Any]], float]

DEFAULT_SPACES: Dict[str, Dict[str, List[Any]]] = {
    "learned_fusion": {"dense_weight": [0.7, 1.0], "bm25_weight": [0.3, 0.5, 0.6]},
    "qa_coverage": {"min_score": [0.1, 0.2, 0.3]},
    "span_picker": {"type_weight": [0.25, 0.35, 0.45]},
    "k_estimator": {"complexity_per_k": [0.5, 1.0, 1.5]},
    "listwise": {"listt5_weight": [0.25, 0.35, 0.45]},
}


class AutoCalibrator:
    def __init__(self, eval_fn: EvalFn,
                 spaces: Optional[Dict[str, Dict[str, List[Any]]]] = None,
                 max_trials_per_component: int = 24, seed: int = 0):
        self.eval_fn = eval_fn
        self.spaces = spaces or DEFAULT_SPACES
        self.max_trials = max_trials_per_component
        self.rng = random.Random(seed)
        self.calibration: Dict[str, Any] = {}

    # ------------------------------------------------------------ search
    def _grid(self, space: Dict[str, List[Any]]) -> List[Dict[str, Any]]:
        keys = sorted(space)
        combos = list(itertools.product(*(space[k] for k in keys)))
        if len(combos) > self.max_trials:
            combos = self.rng.sample(combos, self.max_trials)
        return [dict(zip(keys, c)) for c in combos]

    def _calibrate_component(self, name: str, dev_data: Sequence[Dict[str, Any]],
                             base_params: Dict[str, Any]) -> Tuple[Dict[str, Any], float]:
        best_params: Dict[str, Any] = {}
        best_score = -float("inf")
        for cand in self._grid(self.spaces.get(name, {})):
            params = {**base_params, name: cand}
            score = self.eval_fn(dev_data, params)
            if score > best_score:
                best_score, best_params = score, cand
        logger.info("calibrated %s -> %s (score %.4f)", name, best_params, best_score)
        return best_params, best_score

    def calibrate_all_components(self, dev_data: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        params: Dict[str, Any] = {}
        scores: Dict[str, float] = {}
        for name in self.spaces:
            params[name], scores[name] = self._calibrate_component(name, dev_data, params)
        params, joint = self._joint_optimization(dev_data, params)
        self.calibration = {"components": params, "scores": scores, "joint_score": joint}
        return self.calibration

    def _joint_optimization(self, dev_data, params,
                            max_rounds: int = 3) -> Tuple[Dict[str, Any], float]:
        """Joint coordinate descent over cross-component weights: sweep
        every component's grid against the CURRENT setting of all others,
        repeat until a full round yields no improvement (ref
        training/calibrate.py:299 joint pass)."""
        best = self.eval_fn(dev_data, params)
        for _ in range(max_rounds):
            improved = False
            for name in self.spaces:
                for cand in self._grid(self.spaces[name])[:6]:
                    trial = {**params, name: cand}
                    s = self.eval_fn(dev_data, trial)
                    if s > best:
                        best, params, improved = s, trial, True
            if not improved:
                break
        return params, best

    # --------------------------------------------------------- persistence
    def save_calibration(self, path: str | Path) -> None:
        write_json(path, self.calibration)

    @staticmethod
    def load_calibration(path: str | Path) -> Dict[str, Any]:
        return read_json(path)

    # ------------------------------------------------------------- extras
    def calibrate_from_oracle_dump(self, dump_rows: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        """Use pre-scored (params, metric) rows instead of live eval."""
        best = max(dump_rows, key=lambda r: r.get("metric", -1e9), default=None)
        if best:
            self.calibration = {"components": best.get("params", {}),
                                "joint_score": best.get("metric")}
        return self.calibration

    def get_oracle_upper_bound(self, dev_data: Sequence[Dict[str, Any]]) -> float:
        """Best achievable score with per-item best params (diagnostic)."""
        total = 0.0
        for item in dev_data:
            best = max(
                (self.eval_fn([item], {name: cand})
                 for name in self.spaces for cand in self._grid(self.spaces[name])[:4]),
                default=0.0,
            )
            total += best
        return total / max(len(dev_data), 1)

    def sensitivity_analysis(self, dev_data, params) -> Dict[str, float]:
        """Score drop when each component's params are reset to defaults."""
        base = self.eval_fn(dev_data, params)
        out = {}
        for name in params:
            reduced = {k: v for k, v in params.items() if k != name}
            out[name] = base - self.eval_fn(dev_data, reduced)
        return out
