"""The repo's synthetic MuSiQue-style generator, scripts/gen_synth_musique.py
(numpy only, outside both packages), loaded by its path for the training
CLIs, as the reference's scripts load it from their own directory; and the
held-out paraphrase sheet, scripts/gen_heldout_musique.py, for the
evaluation CLIs only (run_heldout, debug_heldout,
eval_encoder_discrimination): no module of the solver loads it."""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import ModuleType

SCRIPTS = Path(__file__).resolve().parents[2] / "scripts"


def synth_generator() -> ModuleType:
    """scripts/gen_synth_musique.py as the module gen_synth_musique (its
    _world, _paragraphs and make_items), imported once."""
    mod = sys.modules.get("gen_synth_musique")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "gen_synth_musique", SCRIPTS / "gen_synth_musique.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules["gen_synth_musique"] = mod
        spec.loader.exec_module(mod)
    return mod


def heldout_generator() -> ModuleType:
    """scripts/gen_heldout_musique.py as the module gen_heldout_musique
    (make_heldout, its banks and _apply), imported once after
    gen_synth_musique, which its make_heldout imports by name."""
    synth_generator()
    mod = sys.modules.get("gen_heldout_musique")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "gen_heldout_musique", SCRIPTS / "gen_heldout_musique.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules["gen_heldout_musique"] = mod
        spec.loader.exec_module(mod)
    return mod
