"""Product-path mesh provisioning.

Counterpart of anorag_tpu/parallel/runtime.py: every user-facing surface
(VectorIndex, VectorRetriever, QueryProcessor) gets one shared device mesh
when more than one GPU is attached, so corpus-axis sharded search is the
default on multi-GPU hosts.

Config surface (config `tpu:` section, whose name the port keeps):
  tpu.sharded_search: auto|on|off   auto = shard when more than one CUDA
                                    device is visible; on = a mesh even over
                                    one device (the CPU's when the caller
                                    runs on the CPU); off = none
  tpu.mesh.model_parallel_size: int  'model' axis width (encoder tp)
"""
from __future__ import annotations

import threading
from typing import Any, Optional

import torch

from anorag_tpu_torch.device import DeviceLike, resolve_device
from anorag_tpu_torch.utils.logging import get_logger

logger = get_logger("anorag.parallel")

_lock = threading.Lock()
_cache: dict = {}


def cfg_get(cfg: Any, dotted: str, default: Any = None) -> Any:
    """Read a dotted key from either a ConfigLoader (dot-path get) or a
    plain nested dict."""
    if cfg is None:
        return default
    get = getattr(cfg, "get", None)
    if get is None:
        return default
    try:
        v = get(dotted, None)
        if v is not None:
            return v
    except Exception:
        pass
    node = cfg
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return node if node is not None else default


def product_mesh(cfg: Any = None, device: DeviceLike = None):
    """The process-wide mesh for sharded product search on `device`'s kind
    (cuda unless the caller asks for the CPU), or None when single-device
    or disabled. On cuda the mesh spans every visible GPU; on the CPU it is
    the one CPU device, so only mode 'on' gives one there."""
    device = resolve_device(device)
    mode = str(cfg_get(cfg, "tpu.sharded_search", "auto")).lower()
    if mode in ("off", "false", "0", "none"):
        return None
    mp = int(cfg_get(cfg, "tpu.mesh.model_parallel_size", 1) or 1)
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n < 2 and mode != "on":
        return None
    key = (device.type, n, mp)
    with _lock:
        mesh = _cache.get(key)
        if mesh is None:
            from anorag_tpu_torch.parallel.mesh import make_mesh

            devices = ([torch.device("cuda", i) for i in range(n)]
                       if device.type == "cuda" else [device])
            mesh = make_mesh(model_parallel=mp, devices=devices)
            _cache[key] = mesh
            logger.info("product mesh: %s", mesh.shape)
        return mesh


def reset_mesh_cache() -> None:
    with _lock:
        _cache.clear()
