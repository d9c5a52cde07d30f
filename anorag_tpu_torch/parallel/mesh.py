"""Device mesh bootstrap.

Counterpart of anorag_tpu/parallel/mesh.py. One 2-D mesh ('data', 'model')
carries the framework: corpus shards and batches ride 'data', and 'model'
is the tensor-parallel axis of the encoder's weights (param_pspecs).

The reference's mesh is single-controller: one process drives every device
and shard_map runs a body per shard. The port keeps that model without a
process group: a Mesh is a grid of torch.devices, a shard's body runs on
the first device of its 'data' row, and its results are gathered on the
mesh's first device (parallel/sharded_search.py). A device may appear more
than once, so one card (or the CPU) can carry several shards; a mesh over
one device is the 'on' mode of parallel/runtime.py. Training over a mesh
(parameters split over 'model', batches over 'data') is
parallel/tensor_parallel.py.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from anorag_tpu_torch.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """torch.devices shaped (data, model), with the axis names."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty (data, model) grid, got shape "
                             f"{devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def shard_devices(self) -> List[torch.device]:
        """The device of each 'data' shard: the first of its row."""
        return [row[0] for row in self.devices]

    def distinct_devices(self) -> List[torch.device]:
        return list(dict.fromkeys(self.devices.flat))

    @property
    def first_device(self) -> torch.device:
        """Where gathered results land."""
        return self.devices[0, 0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.distinct_devices()]})"


def visible_devices(device: DeviceLike = None, n: Optional[int] = None) -> List[torch.device]:
    """The devices a mesh over `device`'s kind takes (cuda unless asked
    for the CPU, as resolve_device picks): every visible card, or the CPU
    once; with `n`, n entries that cycle through them, so a mesh of n
    entries repeats a device where fewer are visible."""
    dev = resolve_device(device)
    pool = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if dev.type == "cuda" else [dev])
    return pool if n is None else [pool[i % len(pool)] for i in range(n)]


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """(data, model) mesh over `devices` (every visible CUDA device when
    None), the first n_devices of them when given; model_parallel is
    clamped to a divisor of the device count, as in the reference."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    model_parallel = max(1, min(model_parallel, n))
    while n % model_parallel:
        model_parallel -= 1
    data = n // model_parallel
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(data, model_parallel))


class Sharding(NamedTuple):
    """Where an array lives on a mesh: `spec` names the mesh axis each
    array axis is split over (None: not split); () is replicated. The
    counterpart of a NamedSharding with its PartitionSpec."""
    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def data_sharding(mesh: Mesh, *trailing: Optional[str]) -> Sharding:
    """Leading axis over 'data', remaining axes as given."""
    return Sharding(mesh, (DATA_AXIS, *trailing))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_rows(mesh: Mesh, arr, pad_value: float = 0.0, *,
               dtype: Optional[torch.dtype] = None, chunk_rows: int = 1 << 18):
    """Rows of `arr` (numpy or a tensor on any device) split over 'data':
    the row count padded with pad_value to a multiple of the data-axis
    size, shard i (rows [i * rows_per_shard, (i + 1) * rows_per_shard))
    copied into a new tensor in `dtype` (arr's when None) on the first
    device of data row i, chunk_rows rows at a time, so no shard-sized
    temporary of arr's dtype forms there. Returns (list of shards, original
    row count)."""
    arr = torch.as_tensor(arr)
    dtype = dtype or arr.dtype
    d = mesh.shape[DATA_AXIS]
    n = arr.shape[0]
    rows = (n + d - 1) // d
    shards = []
    for i, dev in enumerate(mesh.shard_devices()):
        part = torch.full((rows,) + tuple(arr.shape[1:]), pad_value, dtype=dtype,
                          device=dev)
        for lo in range(i * rows, min((i + 1) * rows, n), chunk_rows):
            hi = min(lo + chunk_rows, (i + 1) * rows, n)
            part[lo - i * rows:hi - i * rows] = arr[lo:hi].to(dev).to(dtype)
        shards.append(part)
    return shards, n
