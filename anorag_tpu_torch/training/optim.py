"""The optimizer pieces that the reference's trainers take from optax.

Counterparts of optax 0.2.6's adamw, linear_schedule,
warmup_cosine_decay_schedule and clip_by_global_norm, with optax's
formulas (read from its source, not its documentation):
  * adamw: torch.optim.AdamW with betas (0.9, 0.999), eps 1e-8 and optax's
    default weight decay of 1e-4 (torch's own default is 0.01). Decoupled
    decay and bias correction are optax's arithmetic in another order. A
    learning rate may be a schedule: update n (from 0) runs at
    schedule(n), as optax's count gives it, so a warmup from 0 moves
    nothing on the first step;
  * the schedules are evaluated in f32, as jnp evaluates them;
    warmup_cosine_decay_schedule's decay_steps includes the warmup;
  * clip_by_global_norm scales the gradients by max_norm / norm only when
    norm >= max_norm (t / norm * max_norm), where torch's clip_grad_norm_
    divides by norm + 1e-6 always.
make_step is the body the models' make_train_step share: the reference's
jax.value_and_grad, optimizer.update and apply_updates as one autograd
step in place.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Iterable, List, Mapping, Optional, Union

import numpy as np
import torch

from anorag_tpu_torch.parallel.tensor_parallel import ShardedParams

Schedule = Callable[[int], float]
ScalarOrSchedule = Union[float, Schedule]

_F32 = np.float32


class AdamW(torch.optim.AdamW):
    """torch.optim.AdamW whose learning rate may be a schedule of the
    update count."""

    def __init__(self, params, learning_rate: ScalarOrSchedule, weight_decay: float):
        self.schedule = learning_rate if callable(learning_rate) else None
        self.count = 0
        lr = self.schedule(0) if self.schedule else float(learning_rate)
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=weight_decay)

    @torch.no_grad()
    def step(self, closure=None):
        if self.schedule is not None:
            for group in self.param_groups:
                group["lr"] = self.schedule(self.count)
        self.count += 1
        return super().step(closure)


def adamw(params: Iterable[torch.Tensor], learning_rate: ScalarOrSchedule,
          weight_decay: float = 1e-4) -> AdamW:
    """optax.adamw(learning_rate, weight_decay=weight_decay) over `params`."""
    return AdamW(params, learning_rate, weight_decay)


def linear_schedule(init_value: float, end_value: float, transition_steps: int,
                    transition_begin: int = 0) -> Schedule:
    """optax.linear_schedule: init_value before transition_begin, a line to
    end_value over transition_steps, end_value after; init_value throughout
    when transition_steps <= 0."""
    if transition_steps <= 0:
        return lambda count: init_value
    transition_begin = max(transition_begin, 0)

    def schedule(count: int) -> float:
        c = min(max(count - transition_begin, 0), transition_steps)
        frac = _F32(1) - _F32(c) / _F32(transition_steps)
        return float((_F32(init_value) - _F32(end_value)) * frac + _F32(end_value))

    return schedule


def _cosine_decay_schedule(init_value: float, decay_steps: int,
                           alpha: float = 0.0, exponent: float = 1.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"the cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        c = _F32(min(count, decay_steps))
        cosine = _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * c / _F32(decay_steps)))
        decayed = (_F32(1) - _F32(alpha)) * cosine ** _F32(exponent) + _F32(alpha)
        return float(_F32(init_value) * decayed)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: a linear warmup from init_value
    to peak_value over warmup_steps, then a cosine decay to end_value that
    ends at decay_steps counted from 0 (the warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = _cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha, exponent)

    def schedule(count: int) -> float:
        return warmup(count) if count < warmup_steps else decay(count - warmup_steps)

    return schedule


def clip_by_global_norm(max_norm: float) -> Callable[[Iterable[torch.Tensor]], None]:
    """optax.clip_by_global_norm(max_norm) as a function that clips the
    .grad of each parameter given, in place, with no host sync. The
    parameters may lie on several devices (a ShardedParams' masters: each
    replicated parameter once, each shard of a split one); the squares
    are summed on the first one's."""

    def clip(params: Iterable[torch.Tensor]) -> None:
        grads: List[torch.Tensor] = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        # over devices: each tensor's sum of squares added on the first's
        dev = grads[0].device
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2).to(dev) for g in grads))
        keep = norm < max_norm
        for g in grads:
            g.copy_(torch.where(keep.to(g.device), g,
                                g / norm.to(g.device, g.dtype) * max_norm))

    return clip


def make_step(loss_fn: Callable[[torch.nn.Module, Mapping[str, Any]], torch.Tensor],
              optimizer: torch.optim.Optimizer,
              clip: Optional[Callable[[Iterable[torch.Tensor]], None]] = None):
    """train_step(params, opt_state, batch) -> (params, opt_state, loss):
    loss_fn(params, batch)'s gradients, `clip` applied to them (as optax
    chains clip_by_global_norm before adamw), one optimizer step in place,
    which keeps each parameter's dtype. The optimizer holds its own state,
    so opt_state passes through. `params` may be a ShardedParams (the
    optimizer over its masters): each data row's gradients are summed onto
    the masters in row order before the clip and the step, and the stepped
    masters are copied to the other rows after it."""
    def train_step(params, opt_state, batch):
        sharded = isinstance(params, ShardedParams)
        if sharded:
            params.zero_grad()
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch)
        loss.backward()
        if sharded:
            params.reduce_grads()
        if clip is not None:
            clip(list(params.parameters()))
        optimizer.step()
        if sharded:
            params.broadcast_masters()
        return params, opt_state, loss.detach()

    return train_step
