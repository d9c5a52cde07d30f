"""Encoder training loop: contrastive fine-tuning on one device.

Counterpart of anorag_tpu/models/train.py: make_pair_batches (:29),
EncoderTrainer (:58) with train (:85) and its checkpoints, and
pairs_from_notes (:136, copied). InfoNCE over (query, positive-note) pairs
with in-batch negatives (models/encoder.py's info_nce_loss and
make_train_step), adamw as optax applies it (training/optim.py),
deterministic data iteration. It runs on the card unless the caller asks
for the CPU. The trainer builds its mesh as the reference does
(make_mesh(model_parallel=...)), over its one device, where the clamp makes
it (1, 1), as the reference's on one chip: model_parallel above 1 trains as
1 does. Data and tensor parallel training over more than one device is not
ported and raises NotImplementedError. A
checkpoint is the encoder's state dict written with torch.save, the file
EmbeddingManager.load_checkpoint and embedding.checkpoint_path read, where
the reference writes orbax (the card has none).
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from anorag_tpu_torch.device import DeviceLike, resolve_device
from anorag_tpu_torch.models import encoder as enc
from anorag_tpu_torch.models.tokenizer import HashTokenizer
from anorag_tpu_torch.parallel.mesh import make_mesh
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
    """The encoder (self.model, drawn from `seed`) and its adamw on one
    device, the card unless `device` says cpu."""

    def __init__(
        self,
        cfg: Optional[enc.EncoderConfig] = None,
        learning_rate: ScalarOrSchedule = 1e-4,
        weight_decay: float = 0.01,
        model_parallel: int = 1,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.cfg = cfg or enc.EncoderConfig.small()
        self.device = resolve_device(device)
        self.mesh = make_mesh(model_parallel=model_parallel, devices=[self.device])
        if len(self.mesh.distinct_devices()) > 1:
            raise NotImplementedError(
                "training over more than one device (data and tensor parallel "
                "over a mesh, ROADMAP.md) is not ported")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.model = enc.Encoder(self.cfg, self.device).init_random(gen)
        self.model.requires_grad_(True)
        self.optimizer = adamw(self.model.parameters(), learning_rate,
                               weight_decay=weight_decay)
        self._step = enc.make_train_step(self.cfg, self.optimizer)
        self.history: List[float] = []

    def _tensors(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device, torch.long if k.endswith("ids")
                                          else torch.int32)
                for k, v in batch.items()}

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
                _, _, loss = self._step(self.model, None, self._tensors(batch))
                step += 1
                self.history.append(float(loss))
                if step % log_every == 0:
                    logger.info("step %d loss %.4f (%.1f steps/s)", step,
                                self.history[-1], step / (time.perf_counter() - t0))
        return self.history

    # --------------------------------------------------------- checkpoints
    def save_checkpoint(self, path: str | Path) -> bool:
        """The encoder's state dict, written with torch.save; False (with a
        warning) when it cannot be written."""
        try:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            torch.save(self.model.state_dict(), Path(path))
            return True
        except (OSError, RuntimeError) as e:
            logger.warning("checkpoint save failed: %s", e)
            return False

    def restore_checkpoint(self, path: str | Path) -> bool:
        """Load a state dict that save_checkpoint (or EmbeddingManager's
        checkpoint format) wrote; False (with a warning) for a path that
        cannot be read or does not fit."""
        try:
            state = torch.load(Path(path), map_location=self.device, weights_only=True)
            self.model.load_state_dict(dict(state))
            return True
        except Exception as e:
            logger.warning("checkpoint restore failed: %s", e)
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
