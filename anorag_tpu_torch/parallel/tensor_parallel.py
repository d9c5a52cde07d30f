"""Data- and tensor-parallel parameter sets over a mesh, one controller.

Counterpart of the reference's placement of a parameter tree on a mesh by
its PartitionSpec tree (jax.device_put(params, NamedSharding(mesh, spec)),
anorag_tpu/models/train.py:67-73) and of the collectives GSPMD inserts
around the sharded forward. As in parallel/mesh.py, one process drives
every device and there is no process group. Data row i of the mesh keeps a
copy of every parameter: an array split over 'model' has its slice j on
mesh.devices[i, j], a replicated one sits on the row's first device. Row
0's tensors are the masters that the optimizer steps; reduce_grads sums
each row's gradient onto them in row order, and broadcast_masters copies
the stepped masters to the other rows.

The collectives are copies between devices with sums in a fixed order:
broadcast sends an activation to a row's devices and sums its gradients in
shard order, reduce_sum adds the shards' partial sums in shard order. So a
step's bits depend on no device's finishing order, and a mesh that repeats
a device computes what the same mesh over distinct devices computes.

As jax.device_put does, placement raises ValueError when an axis is not
divisible by its mesh axis (a parameter's over 'model', a batch over
'data').
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence

import torch

from anorag_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh


def split_axes(pspecs: Any, model_axis: str = MODEL_AXIS) -> Dict[str, Optional[int]]:
    """A param_pspecs tree flattened to state-dict names ({'emb_ln':
    {'scale': ...}} -> 'emb_ln_scale', {'layers': [{'qkv': ...}]} ->
    'layers.0.qkv'), each with the axis split over `model_axis` (None:
    replicated)."""
    out: Dict[str, Optional[int]] = {}

    def walk(node: Any, name: str) -> None:
        if isinstance(node, tuple):
            axes = [i for i, a in enumerate(node) if a == model_axis]
            out[name] = axes[0] if axes else None
        elif isinstance(node, dict):
            for key, sub in node.items():
                walk(sub, f"{name}_{key}" if name and not name.endswith(".") else name + key)
        else:
            for i, sub in enumerate(node):
                walk(sub, f"{name}.{i}.")

    walk(pspecs, "")
    return out


def check_divisible(name: str, shape: Sequence[int], axis: int, parts: int,
                    mesh_axis: str) -> None:
    """ValueError, as jax.device_put raises it, when `axis` of `shape`
    cannot be split into `parts` equal pieces."""
    if shape[axis] % parts:
        raise ValueError(
            f"{name} of shape {tuple(shape)} cannot be placed on the mesh: its axis "
            f"{axis} ({shape[axis]}) should be divisible by the '{mesh_axis}' axis "
            f"({parts})")


def split_rows(mesh: Mesh, name: str, t: torch.Tensor) -> List[torch.Tensor]:
    """A batch split over 'data': data row i's rows on the row's first
    device."""
    devices = mesh.shard_devices()
    check_divisible(name, t.shape, 0, len(devices), DATA_AXIS)
    return [x.to(d) for x, d in zip(torch.chunk(t, len(devices)), devices)]


def gather_rows(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Each data row's rows concatenated in row order on `device`."""
    return torch.cat([p.to(device) for p in parts])


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, devices):
        ctx.device = x.device
        return tuple(x.to(d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in grads:
            g = g.to(ctx.device)
            total = g if total is None else total + g
        return total, None


def broadcast(x: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """x on each of `devices` (the input of each model shard). With more
    than one device the gradients that come back are summed on x's device
    in the order of `devices`; with one, x itself."""
    if len(devices) == 1:
        return [x.to(devices[0])]
    return list(_Broadcast.apply(x, tuple(devices)))


def reduce_sum(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The sum of the shards' partial results on `device`, added in shard
    order (((p0 + p1) + p2) + ...)."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def vocab_parallel_lookup(tables: Sequence[torch.Tensor], ids: torch.Tensor,
                          devices: Sequence[torch.device], device: torch.device,
                          dtype: torch.dtype) -> torch.Tensor:
    """Rows `ids` of an embedding table split over 'model' by rows
    (`tables[j]` on devices[j], vocabulary rows in shard order), cast to
    `dtype`: each shard looks up the ids in its range and gives zeros
    elsewhere, and the shards' results are summed on `device`. Exact: each
    id is found in one shard. One table: table[ids], cast."""
    if len(tables) == 1:
        return tables[0][ids.to(devices[0])].to(dtype)
    parts, lo = [], 0
    for table, dev in zip(tables, devices):
        local = ids.to(dev) - lo
        rows = table.shape[0]
        inside = (local >= 0) & (local < rows)
        found = table[local.clamp(0, rows - 1)].to(dtype)
        parts.append(torch.where(inside[..., None], found, torch.zeros((), dtype=dtype,
                                                                       device=dev)))
        lo += rows
    return reduce_sum(parts, device)


class Row(NamedTuple):
    """One data row of a ShardedParams: its devices (shard j on
    devices[j]), its replicated parameters (on devices[0]) and each
    shard's slices, by state-dict name."""
    devices: List[torch.device]
    rep: Dict[str, torch.Tensor]
    shards: List[Dict[str, torch.Tensor]]

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def tables(self, name: str) -> List[torch.Tensor]:
        """The shards' slices of the split parameter `name`."""
        return [s[name] for s in self.shards]


class ShardedParams:
    """A state dict placed on `mesh` by `axes` (split_axes of the model's
    param_pspecs): every tensor a leaf that takes gradients, in the state
    dict's dtype. Row 0's tensors are the masters (parameters())."""

    def __init__(self, state: Mapping[str, torch.Tensor],
                 axes: Mapping[str, Optional[int]], mesh: Mesh):
        if set(state) != set(axes):
            raise ValueError(f"state and specs differ: "
                             f"{sorted(set(state) ^ set(axes))}")
        n_data, n_model = mesh.devices.shape
        for name, t in state.items():
            if axes[name] is not None:
                check_divisible(name, t.shape, axes[name], n_model, MODEL_AXIS)
        self.mesh = mesh
        self.axes = {name: axes[name] for name in state}
        self.rows: List[Row] = []
        for i in range(n_data):
            devices = list(mesh.devices[i])
            row = Row(devices, {}, [{} for _ in devices])
            for name, t in state.items():
                if self.axes[name] is None:
                    row.rep[name] = _leaf(t, devices[0])
                else:
                    for shard, part, dev in zip(row.shards,
                                                torch.chunk(t, n_model, self.axes[name]),
                                                devices):
                        shard[name] = _leaf(part, dev)
            self.rows.append(row)

    @property
    def device(self) -> torch.device:
        """The mesh's first device, where gathered results land."""
        return self.mesh.first_device

    def _tensors(self, row: Row) -> List[torch.Tensor]:
        """A row's tensors in the state dict's order, a split one's shards
        in shard order."""
        out = []
        for name, axis in self.axes.items():
            out.extend([row.rep[name]] if axis is None else row.tables(name))
        return out

    def parameters(self) -> List[torch.Tensor]:
        """The masters: row 0's tensors, each replicated parameter once."""
        return self._tensors(self.rows[0])

    def zero_grad(self) -> None:
        """Clear every row's gradients."""
        for row in self.rows:
            for t in self._tensors(row):
                t.grad = None

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """Sum every row's gradient onto its master in row order (row 0's,
        then + row 1's, ...); the other rows' gradients are cleared."""
        masters = self.parameters()
        for row in self.rows[1:]:
            for m, t in zip(masters, self._tensors(row)):
                if t.grad is None:
                    continue
                g = t.grad.to(m.device)
                if m.grad is None:
                    m.grad = g.clone()
                else:
                    m.grad.add_(g)
                t.grad = None

    @torch.no_grad()
    def broadcast_masters(self) -> None:
        """Copy the masters into every other row."""
        masters = self.parameters()
        for row in self.rows[1:]:
            for m, t in zip(masters, self._tensors(row)):
                t.copy_(m)

    def state_dict(self, device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
        """The masters gathered into full tensors on `device` (the mesh's
        first device when None), in the state dict's order and dtypes."""
        return self._gather(lambda t: t, device)

    def grad_dict(self, device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
        """The masters' gradients gathered as state_dict gathers them."""
        return self._gather(lambda t: t.grad, device)

    @torch.no_grad()
    def _gather(self, of, device: Optional[torch.device]) -> Dict[str, torch.Tensor]:
        device = device or self.device
        row = self.rows[0]
        out = {}
        for name, axis in self.axes.items():
            if axis is None:
                out[name] = of(row.rep[name]).detach().to(device, copy=True)
            else:
                out[name] = torch.cat([of(t).detach().to(device) for t in row.tables(name)],
                                      dim=axis)
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, torch.Tensor]) -> None:
        """Copy full tensors (a state_dict) into every row's slices.
        RuntimeError for a key missing or unexpected or a shape that
        differs."""
        if set(state) != set(self.axes):
            raise RuntimeError(f"state dict keys differ: {sorted(set(state) ^ set(self.axes))}")
        n_model = self.mesh.devices.shape[1]
        for name, axis in self.axes.items():
            shape = list((self.rows[0].rep.get(name) if axis is None
                          else self.rows[0].shards[0][name]).shape)
            if axis is not None:
                shape[axis] *= n_model
            if list(state[name].shape) != shape:
                raise RuntimeError(f"{name}: shape {tuple(state[name].shape)}, the "
                                   f"parameter's is {tuple(shape)}")
        for row in self.rows:
            for name, axis in self.axes.items():
                if axis is None:
                    row.rep[name].copy_(state[name])
                else:
                    for dst, part in zip(row.tables(name),
                                         torch.chunk(state[name], n_model, axis)):
                        dst.copy_(part)


def _leaf(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A new contiguous copy of t on `device` that takes gradients."""
    return t.detach().to(device, copy=True,
                         memory_format=torch.contiguous_format).requires_grad_(True)
