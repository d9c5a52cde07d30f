"""Device selection for the port.

Counterpart of anorag_tpu/device.py. The port's entry points run on the
card unless the caller asks for the CPU: with no device given they pick
cuda, and they raise rather than quietly moving to the CPU when no GPU is
present.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """cuda by default; cpu only when asked for. Raises RuntimeError when
    cuda is wanted and torch sees no GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

