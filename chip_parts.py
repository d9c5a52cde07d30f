"""Parts of chip_smoke.py alone on the card, for measurements that need no
other phase. Run from the root of a checkout (it imports that checkout's
chip_smoke.py, so two checkouts can be compared in one call):

    python3 chip_parts.py PART [PART ...] [--seed 0] [--reps 1]

Parts:
  llm_timings  phase llm's decoder timings (prefill at pb 256 and 1024, a
               decode step and generate's 256 steps, at B 1 and 8) on seeded
               weights at note_lm_tpu_large's shape
  decode_steps the decoder's host-clock ms at note_lm_tpu_large's shape, B 1
               and 8, pb 256: 200 decode steps and 5 generate calls of 256
               steps, each call between synchronisations of the card; the
               median and the least
  multichip    phase multichip (training over meshes of the visible cards),
               with 512 generated notes in place of phase offline's

Each part runs --reps times in turn. Exit 1 when a part fails.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
import traceback


def _llm_timings(cs, dev, seed: int, smi_line: str) -> None:
    import torch

    from anorag_tpu_torch.models import decoder_lm as dlm
    from anorag_tpu_torch.testing import NOTE_LM_TPU_LARGE

    cfg = dlm.DecoderConfig(**NOTE_LM_TPU_LARGE)
    params = dlm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    cs._llm_timings(dev, params, cfg, smi_line)


def _decode_steps(cs, dev, seed: int, smi_line: str) -> None:
    import numpy as np
    import torch

    from anorag_tpu_torch.models import decoder_lm as dlm
    from anorag_tpu_torch.testing import NOTE_LM_TPU_LARGE

    cfg = dlm.DecoderConfig(**NOTE_LM_TPU_LARGE)
    params = dlm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    rng = np.random.default_rng(7)

    def timed(fn) -> float:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        return 1e3 * (time.perf_counter() - t0)

    for b in (1, 8):
        ids = torch.from_numpy(rng.integers(dlm._BYTE0 + 32, dlm._BYTE0 + 127,
                                            (b, 256)).astype(np.int32)).to(dev)
        pad = torch.zeros(b, dtype=torch.int32, device=dev)
        _, cache = dlm._prefill(params, ids, pad, cfg)
        rope = dlm._rope_tables(torch.arange(cfg.max_len, device=dev), cfg.head_dim)
        tok = ids[:, -1]
        step = lambda: dlm._decode_step(params, tok, 256, pad, cache, cfg, rope)  # noqa: E731
        for _ in range(10):
            step()
        steps = [timed(step) for _ in range(200)]
        ran, inner = [], dlm._decode_step
        dlm._decode_step = lambda *a: ran.append(1) or inner(*a)
        try:
            gens = []
            for _ in range(5):
                ran.clear()
                gens.append(timed(lambda: dlm.generate(params, ids, pad, cfg, 256)) / len(ran))
        finally:
            dlm._decode_step = inner
        print(f"decode_steps B {b}: a decode step median {statistics.median(steps):.4f} ms, "
              f"least {min(steps):.4f}; in generate ({len(ran)} steps a call) median "
              f"{statistics.median(gens):.4f} ms a step, least {min(gens):.4f} | {smi_line}",
              flush=True)


def _multichip(cs, dev, seed: int, smi_line: str) -> None:
    notes = [{"title": f"T{i}", "entities": [f"E{i % 7}", f"F{i % 5}"],
              "content": f"note {i} about E{i % 7} and F{i % 5} w{i % 11}"}
             for i in range(512)]
    cs._multichip_phase(dev, notes, seed, smi_line)


PARTS = {"decode_steps": _decode_steps, "llm_timings": _llm_timings, "multichip": _multichip}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parts", nargs="+", choices=sorted(PARTS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args(argv)
    try:
        import torch

        import chip_smoke as cs
        from anorag_tpu_torch.bench import card_line

        if not torch.cuda.is_available():
            print("chip_parts: no CUDA device", file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
        smi_line = card_line() or "nvidia-smi gave no output"
        for rep in range(args.reps):
            for part in args.parts:
                t0 = time.perf_counter()
                PARTS[part](cs, dev, args.seed, smi_line)
                print(f"chip_parts: {part} (rep {rep + 1}) {time.perf_counter() - t0:.2f} s "
                      f"| {smi_line}", flush=True)
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
