"""Listwise cross-encoder reranker model.

Counterpart of anorag_tpu/models/cross_encoder.py: CrossEncoderConfig
(:38), init_params (:71), score (:84), listwise_loss (:99),
make_train_step (:111), pack_pair / _bucket_width / pack_batch (:123-154,
host code copied as it is), CrossEncoderReranker (:156) with train (:190)
and its checkpoints, and slates_from_notes (:268, copied).

A single-stream bidirectional transformer over `[CLS] query [SEP]
candidate [SEP]`: the port's encoder layers (models/encoder.py, cls
pooling, no normalization, f32), segment embeddings for the two spans and
a scalar relevance head on the CLS state. Training is listwise softmax
cross-entropy over slates of one positive and in-domain negatives, with
training/optim.py's adamw(lr, weight_decay=0.01), optax.adamw's update.
Checkpoints are a state dict written with torch.save, where the reference
writes orbax (the card has none); params_from_jax carries the reference's
parameters into the port.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from anorag_tpu_torch.device import DeviceLike, resolve_device
from anorag_tpu_torch.models import encoder as enc
from anorag_tpu_torch.models.tokenizer import CLS_ID, PAD_ID, SEP_ID, HashTokenizer
from anorag_tpu_torch.training.optim import adamw, make_step
from anorag_tpu_torch.utils.logging import get_logger

logger = get_logger("anorag.xenc")


@dataclasses.dataclass(frozen=True)
class CrossEncoderConfig:
    vocab_size: int = 8192
    hidden_size: int = 128
    num_layers: int = 2
    num_heads: int = 4
    intermediate_size: int = 256
    max_position: int = 256
    # f32 params: at this scale bf16 weight rounding stalls from-scratch
    # training (the reference measured heldout MRR 0.63 bf16 vs 0.94 f32)
    dtype: torch.dtype = torch.float32

    def encoder_cfg(self) -> enc.EncoderConfig:
        return enc.EncoderConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            num_layers=self.num_layers, num_heads=self.num_heads,
            intermediate_size=self.intermediate_size,
            max_position=self.max_position, pooling="cls",
            dtype=self.dtype, normalize=False,
        )

    @staticmethod
    def from_config(cfg: Dict[str, Any]) -> "CrossEncoderConfig":
        return CrossEncoderConfig(
            vocab_size=cfg.get("vocab_size", 8192),
            hidden_size=cfg.get("hidden_size", 128),
            num_layers=cfg.get("num_layers", 2),
            num_heads=cfg.get("num_heads", 4),
            intermediate_size=cfg.get("intermediate_size", 256),
            max_position=cfg.get("max_position", 256),
        )


class CrossEncoder(nn.Module):
    """The encoder's parameters (Encoder's names) plus seg_emb (2, H),
    head_w (H,) and head_b (); forward gives (B,) f32 logits and keeps the
    autograd graph when the parameters require gradients (train)."""

    def __init__(self, cfg: CrossEncoderConfig, device: torch.device):
        super().__init__()
        ecfg = cfg.encoder_cfg()
        h = cfg.hidden_size
        self.cfg = cfg

        def p(*shape, dtype=cfg.dtype, fill=0.0):
            return nn.Parameter(torch.full(shape, fill, dtype=dtype, device=device),
                                requires_grad=False)

        self.tok_emb = p(cfg.vocab_size, h)
        self.pos_emb = p(cfg.max_position, h)
        self.emb_ln_scale = p(h, dtype=torch.float32, fill=1.0)
        self.emb_ln_bias = p(h, dtype=torch.float32)
        self.layers = nn.ModuleList(
            enc.EncoderLayer(ecfg, device) for _ in range(cfg.num_layers))
        self.seg_emb = p(2, h)
        self.head_w = p(h, dtype=torch.float32)
        self.head_b = p(dtype=torch.float32)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                seg: torch.Tensor) -> torch.Tensor:
        s = ids.shape[1]
        x = self.tok_emb[ids] + self.pos_emb[:s][None, :, :] + self.seg_emb[seg]
        x = enc._layer_norm(x.to(self.cfg.dtype), self.emb_ln_scale, self.emb_ln_bias)
        for lp in self.layers:
            x = lp(x, mask)
        cls = x[:, 0, :].float()
        return cls @ self.head_w + self.head_b


@torch.no_grad()
def init_params(key: torch.Generator, cfg: CrossEncoderConfig,
                device: DeviceLike = None) -> CrossEncoder:
    """A CrossEncoder on `device` drawn from the generator `key` by the
    reference's scheme (the encoder's init, seg_emb and head_w normal(0,
    0.02), head_b 0). Torch draws differ from JAX's for the same seed."""
    model = CrossEncoder(cfg, resolve_device(device))
    enc.draw_weights(model, cfg.num_layers, key)
    for name in ("seg_emb", "head_w"):
        p = getattr(model, name)
        p.copy_(torch.randn(p.shape, generator=key, device=p.device,
                            dtype=torch.float32) * 0.02)
    model.head_b.zero_()
    return model


def score(params: CrossEncoder, ids: torch.Tensor, mask: torch.Tensor,
          seg: torch.Tensor, cfg: Optional[CrossEncoderConfig] = None) -> torch.Tensor:
    """(B, L) packed pair tokens -> (B,) f32 relevance logits. cfg is
    taken for the reference's signature: the model carries its own."""
    return params(ids, mask, seg)


def listwise_loss(params: CrossEncoder, batch: Dict[str, torch.Tensor],
                  cfg: Optional[CrossEncoderConfig] = None) -> torch.Tensor:
    """Slates (B, S, L): position 0 is the positive; softmax CE over the
    slate."""
    b, s, l = batch["ids"].shape
    logits = score(params, batch["ids"].reshape(b * s, l),
                   batch["mask"].reshape(b * s, l),
                   batch["seg"].reshape(b * s, l), cfg).reshape(b, s)
    return torch.mean(-torch.log_softmax(logits, dim=-1)[:, 0])


def make_train_step(cfg: CrossEncoderConfig, optimizer: torch.optim.Optimizer):
    """train_step(params, opt_state, batch) -> (params, opt_state, loss):
    one optimizer step on the listwise loss (training/optim.py's
    make_step)."""
    return make_step(lambda params, batch: listwise_loss(params, batch, cfg), optimizer)


def pack_pair(tokenizer, query_ids: List[int], text: str,
              max_length: int) -> Tuple[List[int], List[int]]:
    """[CLS] q [SEP] t [SEP] token ids + segment ids (0=query, 1=candidate)."""
    t_ids = tokenizer.token_ids(text)
    budget = max_length - 3 - len(query_ids)
    t_ids = t_ids[: max(budget, 8)]
    ids = [CLS_ID] + query_ids + [SEP_ID] + t_ids + [SEP_ID]
    ids = ids[:max_length]
    seg = [0] * min(len(query_ids) + 2, len(ids))
    seg += [1] * (len(ids) - len(seg))
    return ids, seg


def _bucket_width(n: int, max_length: int) -> int:
    return min(max_length, ((n + 127) // 128) * 128)


def pack_batch(tokenizer, query: str, texts: Sequence[str],
               max_length: int) -> Dict[str, np.ndarray]:
    q_ids = tokenizer.token_ids(query)[: max_length // 2]
    rows = [pack_pair(tokenizer, q_ids, t, max_length) for t in texts]
    width = _bucket_width(max(len(r[0]) for r in rows), max_length)
    ids = np.full((len(rows), width), PAD_ID, np.int32)
    mask = np.zeros((len(rows), width), np.int32)
    seg = np.zeros((len(rows), width), np.int32)
    for i, (r_ids, r_seg) in enumerate(rows):
        r_ids, r_seg = r_ids[:width], r_seg[:width]
        ids[i, : len(r_ids)] = r_ids
        mask[i, : len(r_ids)] = 1
        seg[i, : len(r_seg)] = r_seg
    return {"ids": ids, "mask": mask, "seg": seg}


def params_from_jax(np_params: Mapping[str, Any],
                    cfg: CrossEncoderConfig) -> Dict[str, torch.Tensor]:
    """The reference's parameter pytree (init_params :71, as numpy arrays)
    as a CrossEncoder state_dict."""
    sd = enc.params_from_jax(np_params, cfg.encoder_cfg())
    sd["seg_emb"] = torch.tensor(np.asarray(np_params["seg_emb"], np.float32)).to(cfg.dtype)
    for name in ("head_w", "head_b"):
        sd[name] = torch.tensor(np.asarray(np_params[name], np.float32))
    return sd


class CrossEncoderReranker:
    """Inference and training wrapper on one device (the card unless the
    caller passes the CPU)."""

    def __init__(self, cfg: Optional[CrossEncoderConfig] = None,
                 params: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0,
                 max_length: int = 256, tokenizer=None, *, device: DeviceLike = None):
        self.cfg = cfg or CrossEncoderConfig()
        self.device = resolve_device(device)
        self.max_length = min(max_length, self.cfg.max_position)
        self.tokenizer = tokenizer or HashTokenizer(
            self.cfg.vocab_size, self.max_length)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.model = init_params(gen, self.cfg, self.device)
        else:
            self.model = CrossEncoder(self.cfg, self.device)
            self.model.load_state_dict(dict(params))
        self.trained = params is not None

    def _tensors(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device, torch.long)
                for k, v in batch.items()}

    # ----------------------------------------------------------- scoring
    def score_pairs(self, query: str, texts: Sequence[str]) -> np.ndarray:
        """(len(texts),) f32 relevance logits, one batch padded to a
        multiple of 8 rows, as the reference pads it."""
        if not texts:
            return np.zeros((0,), np.float32)
        batch = pack_batch(self.tokenizer, query, texts, self.max_length)
        n = len(texts)
        n_pad = ((n + 7) // 8) * 8
        if n_pad != n:
            batch = {k: np.pad(v, ((0, n_pad - n), (0, 0)),
                               constant_values=PAD_ID if k == "ids" else 0)
                     for k, v in batch.items()}
        t = self._tensors(batch)
        with torch.no_grad():
            out = self.model(t["ids"], t["mask"], t["seg"])
        return out.cpu().numpy()[:n]

    # ---------------------------------------------------------- training
    def train(self, slates: Sequence[Tuple[str, str, Sequence[str]]],
              epochs: int = 3, batch_size: int = 8, slate_size: int = 4,
              learning_rate: float = 3e-4, max_length: int = 128,
              seed: int = 0, log_every: int = 20) -> List[float]:
        """slates: (query, positive_text, negative_texts). Listwise CE; the
        slates are drawn from np.random.default_rng(seed) as the
        reference draws them."""
        self.model.requires_grad_(True)
        optimizer = adamw(self.model.parameters(), learning_rate, weight_decay=0.01)
        step_fn = make_train_step(self.cfg, optimizer)
        rng = np.random.default_rng(seed)
        history: List[float] = []
        t0 = time.perf_counter()
        max_length = min(max_length, self.max_length)
        batch_size = max(1, min(batch_size, len(slates)))
        try:
            for epoch in range(epochs):
                order = rng.permutation(len(slates))
                for i in range(0, len(order) - batch_size + 1, batch_size):
                    rows = []
                    for j in order[i : i + batch_size]:
                        q, pos, negs = slates[j]
                        negs = list(negs)
                        if len(negs) >= slate_size - 1:
                            pick = rng.choice(len(negs), slate_size - 1, replace=False)
                        else:
                            pick = rng.choice(max(len(negs), 1), slate_size - 1,
                                              replace=True) if negs else []
                        texts = [pos] + [negs[p] for p in pick]
                        rows.append(pack_batch(self.tokenizer, q, texts, max_length))
                    width = max(r["ids"].shape[1] for r in rows)

                    def pad(a, fill):
                        return np.pad(a, ((0, 0), (0, width - a.shape[1])),
                                      constant_values=fill)

                    batch = self._tensors({
                        k: np.stack([pad(r[k], PAD_ID if k == "ids" else 0) for r in rows])
                        for k in ("ids", "mask", "seg")})
                    _, _, loss = step_fn(self.model, None, batch)
                    history.append(float(loss))
                    if len(history) % log_every == 0:
                        logger.info("xenc step %d loss %.4f (%.1f steps/s)",
                                    len(history), history[-1],
                                    len(history) / (time.perf_counter() - t0))
        finally:
            self.model.requires_grad_(False)
        self.trained = True
        return history

    # -------------------------------------------------------- checkpoints
    def save_checkpoint(self, path: str | Path) -> bool:
        """The model's state dict, written with torch.save; False (with a
        warning) when it cannot be written."""
        try:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            torch.save(self.model.state_dict(), Path(path))
            return True
        except (OSError, RuntimeError) as e:
            logger.warning("cross-encoder checkpoint save failed: %s", e)
            return False

    def restore_checkpoint(self, path: str | Path) -> bool:
        """Load a state dict that save_checkpoint wrote onto self.device;
        False (with a warning) for a path that cannot be read or does not
        fit."""
        try:
            state = torch.load(Path(path), map_location=self.device, weights_only=True)
            self.model.load_state_dict(dict(state))
            self.trained = True
            return True
        except Exception as e:
            logger.warning("cross-encoder checkpoint restore failed: %s", e)
            return False


def slates_from_notes(notes: Sequence[Dict[str, Any]], n_negatives: int = 6,
                      seed: int = 0) -> List[Tuple[str, str, List[str]]]:
    """In-domain listwise training data from atomic notes: the title +
    entities form a pseudo-query; its own content is the positive; other
    notes' contents are the negatives (same recipe as
    models/train.py::pairs_from_notes, extended with negatives)."""
    rng = np.random.default_rng(seed)
    texts = [str(n.get("content") or n.get("text") or "") for n in notes]
    out: List[Tuple[str, str, List[str]]] = []
    for i, n in enumerate(notes):
        ents = " ".join(str(e) for e in (n.get("entities") or [])[:3])
        q = f"{n.get('title', '')} {ents}".strip()
        if not q or not texts[i]:
            continue
        others = [j for j in range(len(notes)) if j != i and texts[j]]
        if not others:
            continue
        pick = rng.choice(others, min(n_negatives, len(others)), replace=False)
        out.append((q, texts[i], [texts[j] for j in pick]))
    return out
