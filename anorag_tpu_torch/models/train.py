"""Encoder training loop: contrastive fine-tuning, data and tensor parallel
over a mesh of devices.

Counterpart of anorag_tpu/models/train.py: make_pair_batches (:29),
EncoderTrainer (:58) with train (:85) and its checkpoints, and
pairs_from_notes (:136, copied). InfoNCE over (query, positive-note) pairs
with in-batch negatives (models/encoder.py's info_nce_loss and
make_train_step), adamw as optax applies it (training/optim.py),
deterministic data iteration. The trainer builds its mesh as the reference
does (make_mesh(model_parallel=...)) over `devices` when given them (an
entry may repeat, so one card or the CPU can carry a mesh), else over
`device` alone (cuda unless asked for the CPU). The reference's mesh spans
every chip it sees; here a mesh over several cards is opt-in, since the
one-controller route is slower than one card (PERF.md §6). On a (1, 1)
mesh it trains the Encoder module in place; on a larger one the parameters
are a ShardedEncoder (heads, FFN width and vocabulary over 'model', each
batch over 'data', the loss over the whole batch, one adamw step on the
masters; see parallel/tensor_parallel.py). A checkpoint is the full
encoder state dict written with torch.save, the file
EmbeddingManager.load_checkpoint and embedding.checkpoint_path read, where
the reference writes orbax (the card has none); restore_checkpoint places
it on the trainer's mesh again.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from anorag_tpu_torch.device import DeviceLike, resolve_device
from anorag_tpu_torch.models import encoder as enc
from anorag_tpu_torch.models.tokenizer import HashTokenizer
from anorag_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh
from anorag_tpu_torch.parallel.tensor_parallel import check_divisible
from anorag_tpu_torch.training.optim import ScalarOrSchedule, adamw
from anorag_tpu_torch.utils.logging import get_logger

logger = get_logger("anorag.train")


def make_pair_batches(
    pairs: Sequence[Tuple[str, str]],
    tokenizer,
    batch_size: int,
    max_length: int = 64,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled epochs of (query, positive) token batches, static shapes."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pairs))
    for i in range(0, len(order) - batch_size + 1, batch_size):
        idx = order[i : i + batch_size]
        qs = [pairs[j][0] for j in idx]
        ps = [pairs[j][1] for j in idx]
        q_ids, q_mask = tokenizer.encode_batch(qs, max_length)
        p_ids, p_mask = tokenizer.encode_batch(ps, max_length)
        width = max(q_ids.shape[1], p_ids.shape[1])

        def pad(a, fill):
            return np.pad(a, ((0, 0), (0, width - a.shape[1])), constant_values=fill)

        yield {
            "q_ids": pad(q_ids, 2), "q_mask": pad(q_mask, 0),
            "p_ids": pad(p_ids, 2), "p_mask": pad(p_mask, 0),
        }


class EncoderTrainer:
    """The encoder (drawn from `seed`) and its adamw on a (data, model)
    mesh: over `devices` when given, else over `device` alone (cuda
    unless asked for the CPU); model_parallel clamped to a divisor of the device
    count, as the reference's make_mesh clamps it. ValueError where the
    reference's device_put raises: a head, FFN or vocabulary count not
    divisible by the 'model' axis, or (in train) a batch not divisible by
    the 'data' axis."""

    def __init__(
        self,
        cfg: Optional[enc.EncoderConfig] = None,
        learning_rate: ScalarOrSchedule = 1e-4,
        weight_decay: float = 0.01,
        model_parallel: int = 1,
        seed: int = 0,
        device: DeviceLike = None,
        devices: Optional[Sequence[DeviceLike]] = None,
    ):
        if device is not None and devices is not None:
            raise ValueError("give the trainer a device or devices, not both")
        self.cfg = cfg or enc.EncoderConfig.small()
        if devices is None:
            devices = [device]
        self.mesh = make_mesh(model_parallel=model_parallel,
                              devices=[resolve_device(d) for d in devices])
        self.device = self.mesh.first_device
        gen = torch.Generator(device=self.device).manual_seed(seed)
        model = enc.Encoder(self.cfg, self.device).init_random(gen)
        if self.mesh.size == 1:
            self.params = model.requires_grad_(True)
        else:
            self.params = enc.ShardedEncoder(model.state_dict(), self.cfg, self.mesh)
            del model
        self.optimizer = adamw(self.params.parameters(), learning_rate,
                               weight_decay=weight_decay)
        self._step = enc.make_train_step(self.cfg, self.optimizer)
        self.history: List[float] = []

    @property
    def model(self) -> enc.Encoder:
        """The Encoder being trained on a (1, 1) mesh; on a larger mesh a
        copy of the parameters gathered on the first device."""
        if isinstance(self.params, enc.ShardedEncoder):
            return self.params.to_encoder()
        return self.params

    def _tensors(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The batch on the first device; on a larger mesh each array must
        split evenly over 'data' (ValueError naming it otherwise)."""
        out = {k: torch.from_numpy(v).to(self.device, torch.long if k.endswith("ids")
                                          else torch.int32)
               for k, v in batch.items()}
        if self.mesh.size > 1:
            for k, v in out.items():
                check_divisible(k, v.shape, 0, self.mesh.shape[DATA_AXIS], DATA_AXIS)
        return out

    def train(
        self,
        pairs: Sequence[Tuple[str, str]],
        tokenizer=None,
        epochs: int = 1,
        batch_size: int = 32,
        max_length: int = 64,
        log_every: int = 20,
    ) -> List[float]:
        """Steps over `epochs` shuffles of `pairs`; returns the loss history
        (Python floats, one a step), which it also keeps in self.history."""
        tokenizer = tokenizer or HashTokenizer(self.cfg.vocab_size, self.cfg.max_position)
        step = 0
        t0 = time.perf_counter()
        for epoch in range(epochs):
            for batch in make_pair_batches(pairs, tokenizer, batch_size,
                                           max_length, seed=epoch):
                _, _, loss = self._step(self.params, None, self._tensors(batch))
                step += 1
                self.history.append(float(loss))
                if step % log_every == 0:
                    logger.info("step %d loss %.4f (%.1f steps/s)", step,
                                self.history[-1], step / (time.perf_counter() - t0))
        return self.history

    # --------------------------------------------------------- checkpoints
    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The full encoder state dict (gathered from the mesh) on the first
        device."""
        return self.params.state_dict()

    def save_checkpoint(self, path: str | Path) -> bool:
        """The full encoder state dict, written with torch.save; False
        (with a warning) when it cannot be written."""
        return save_state_dict(self.state_dict(), path)

    def restore_checkpoint(self, path: str | Path) -> bool:
        """Load a state dict that save_checkpoint (or EmbeddingManager's
        checkpoint format) wrote, placed on the trainer's mesh; False (with
        a warning) for a path that cannot be read or does not fit."""
        try:
            state = torch.load(Path(path), map_location=self.device, weights_only=True)
            self.params.load_state_dict(dict(state))
            return True
        except Exception as e:
            logger.warning("checkpoint restore failed: %s", e)
            return False


def save_state_dict(state: Mapping[str, torch.Tensor], path: str | Path) -> bool:
    """torch.save of an encoder state dict to `path` (its directory made);
    False (with a warning) when it cannot be written."""
    try:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        torch.save(state, Path(path))
        return True
    except (OSError, RuntimeError) as e:
        logger.warning("checkpoint save failed: %s", e)
        return False


def pairs_from_notes(notes: Sequence[Dict[str, Any]]) -> List[Tuple[str, str]]:
    """(pseudo-query, note text) training pairs from atomic notes: the title
    + entities form the query side (a cheap in-domain objective)."""
    out = []
    for n in notes:
        ents = " ".join(str(e) for e in (n.get("entities") or [])[:3])
        q = f"{n.get('title', '')} {ents}".strip()
        p = str(n.get("content") or n.get("text") or "")
        if q and p:
            out.append((q, p))
    return out
