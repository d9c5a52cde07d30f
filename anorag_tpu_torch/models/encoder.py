"""Transformer text encoder (XLM-R-large geometry by default) and its
contrastive training step.

Counterpart of anorag_tpu/models/encoder.py: EncoderConfig (:29),
param_pspecs (:115), and Encoder.forward for encode (:166), info_nce_loss
(:197) and make_train_step (:210). The parameters keep the JAX package's
layout (qkv (h, 3, n, dh), attn_out (n, dh, h), ...) so that
params_from_jax is a renaming, and the
forward pass mirrors the reference's rounding points: layer norm statistics
in f32 (eps 1e-5), attention logits in f32 masked with the f32 minimum,
post-LN blocks with erf GELU, cls or mean pooling, L2 normalisation with a
1e-9 floor. The encoder is plain tensor code: its matmuls go to
torch.matmul, as the reference left them to XLA, and autograd takes its
gradients where the reference's jax.value_and_grad does. With
cfg.param_dtype f32 and cfg.dtype bf16 the parameters are f32 masters and
the forward casts every one of them (layer norms too) to bf16 at entry, as
the reference's encode casts its tree; cfg.remat recomputes each block in
the backward pass (torch.utils.checkpoint, the reference's jax.checkpoint).
ShardedEncoder is the encoder placed on a (data, model) mesh by
param_pspecs, its forward data x tensor parallel (parallel/
tensor_parallel.py), the reference's sharded training step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from anorag_tpu_torch.parallel.tensor_parallel import (Row, ShardedParams, broadcast,
                                                       gather_rows, reduce_sum, split_axes,
                                                       split_rows, vocab_parallel_lookup)
from anorag_tpu_torch.training.optim import make_step

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 250002
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position: int = 512
    pooling: str = "cls"          # cls | mean
    dtype: torch.dtype = torch.bfloat16
    normalize: bool = True
    remat: bool = False           # checkpoint each block (training big configs)
    # master-parameter dtype; None -> dtype. f32 masters with bf16 compute
    # keep adamw's small updates that bf16 weights would round away
    param_dtype: Optional[torch.dtype] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def masters(self) -> bool:
        """Whether the parameters are masters cast to dtype in the forward."""
        return self.param_dtype is not None and self.param_dtype != self.dtype

    @staticmethod
    def small() -> "EncoderConfig":
        return EncoderConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                             num_heads=4, intermediate_size=256, max_position=128)

    @staticmethod
    def from_config(cfg: Mapping[str, Any]) -> "EncoderConfig":
        return EncoderConfig(
            vocab_size=cfg.get("vocab_size", 250002),
            hidden_size=cfg.get("hidden_size", 1024),
            num_layers=cfg.get("num_layers", 24),
            num_heads=cfg.get("num_heads", 16),
            intermediate_size=cfg.get("intermediate_size", 4096),
            max_position=cfg.get("max_position", 512),
            pooling=cfg.get("pooling", "cls"),
            dtype=_DTYPES[cfg.get("dtype", "bfloat16")],
        )


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def _compute(t: torch.Tensor, cfg: EncoderConfig) -> torch.Tensor:
    """A parameter at the compute dtype: f32 masters cast to cfg.dtype (the
    layer norms too, as the reference casts its whole tree), else as it is."""
    return t.to(cfg.dtype) if cfg.masters else t


_LAYER_PARAMS = ("qkv", "qkv_b", "attn_out", "attn_out_b", "ln1_scale", "ln1_bias",
                 "ffn_in", "ffn_in_b", "ffn_out", "ffn_out_b", "ln2_scale", "ln2_bias")


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig, device: torch.device):
        super().__init__()
        h, n, dh, i_sz = (cfg.hidden_size, cfg.num_heads, cfg.head_dim,
                          cfg.intermediate_size)
        self.cfg = cfg

        def p(*shape, dtype=cfg.param_dtype or cfg.dtype):
            return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.qkv = p(h, 3, n, dh)
        self.qkv_b = p(3, n, dh)
        self.attn_out = p(n, dh, h)
        self.attn_out_b = p(h)
        self.ln1_scale = p(h, dtype=torch.float32)
        self.ln1_bias = p(h, dtype=torch.float32)
        self.ffn_in = p(h, i_sz)
        self.ffn_in_b = p(i_sz)
        self.ffn_out = p(i_sz, h)
        self.ffn_out_b = p(h)
        self.ln2_scale = p(h, dtype=torch.float32)
        self.ln2_bias = p(h, dtype=torch.float32)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        w = {name: _compute(getattr(self, name), self.cfg) for name in _LAYER_PARAMS}
        x = _layer_norm(x + (_attention_part(x, mask, w["qkv"], w["qkv_b"],
                                             w["attn_out"], self.cfg) + w["attn_out_b"]),
                        w["ln1_scale"], w["ln1_bias"])
        ff = _ffn_part(x, w["ffn_in"], w["ffn_in_b"], w["ffn_out"]) + w["ffn_out_b"]
        return _layer_norm(x + ff, w["ln2_scale"], w["ln2_bias"])


def _attention_part(x: torch.Tensor, mask: torch.Tensor, qkv: torch.Tensor,
                    qkv_b: torch.Tensor, attn_out: torch.Tensor,
                    cfg: EncoderConfig) -> torch.Tensor:
    """Self-attention over the heads of qkv (h, 3, n, dh) and attn_out
    (n, dh, h), without the output bias: all heads, or one model shard's
    heads, whose partial results sum to the whole."""
    qkv = torch.einsum("bsh,htnd->tbsnd", x, qkv) + qkv_b[:, None, None]
    q, k, v = qkv[0], qkv[1], qkv[2]                      # (B, S, N, Dh)
    logits = torch.einsum("bsnd,btnd->bnst", q, k).float()
    logits = logits / math.sqrt(cfg.head_dim)
    neg = torch.finfo(torch.float32).min
    logits = logits.masked_fill(~(mask[:, None, None, :] > 0), neg)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    ctx = torch.einsum("bnst,btnd->bsnd", probs, v)
    return torch.einsum("bsnd,ndh->bsh", ctx, attn_out)


def _ffn_part(x: torch.Tensor, ffn_in: torch.Tensor, ffn_in_b: torch.Tensor,
              ffn_out: torch.Tensor) -> torch.Tensor:
    """The FFN without its output bias, over all its columns or one model
    shard's (ffn_in (h, f), ffn_out (f, h))."""
    ff = torch.matmul(x, ffn_in) + ffn_in_b
    ff = torch.nn.functional.gelu(ff, approximate="none")  # erf GELU
    return torch.matmul(ff, ffn_out)


def _pool(x: torch.Tensor, mask: torch.Tensor, cfg: EncoderConfig) -> torch.Tensor:
    """(B, L, H) -> (B, H) f32: cls or mean pooling, L2-normalized when
    cfg.normalize."""
    if cfg.pooling == "mean":
        m = mask[:, :, None].float()
        pooled = (x.float() * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    else:
        pooled = x[:, 0, :].float()
    if cfg.normalize:
        pooled = pooled / torch.linalg.vector_norm(
            pooled, dim=-1, keepdim=True).clamp_min(1e-9)
    return pooled


class Encoder(nn.Module):
    """The encoder's parameters and forward pass; parameters are zero until
    loaded (load_state_dict, e.g. from params_from_jax) or drawn
    (init_random), and take no gradients until a trainer asks for them
    (requires_grad_)."""

    def __init__(self, cfg: EncoderConfig, device: torch.device):
        super().__init__()
        h = cfg.hidden_size
        pdtype = cfg.param_dtype or cfg.dtype
        self.cfg = cfg
        self.tok_emb = nn.Parameter(
            torch.zeros(cfg.vocab_size, h, dtype=pdtype, device=device),
            requires_grad=False)
        self.pos_emb = nn.Parameter(
            torch.zeros(cfg.max_position, h, dtype=pdtype, device=device),
            requires_grad=False)
        self.emb_ln_scale = nn.Parameter(
            torch.ones(h, device=device), requires_grad=False)
        self.emb_ln_bias = nn.Parameter(
            torch.zeros(h, device=device), requires_grad=False)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, device) for _ in range(cfg.num_layers))

    def init_random(self, generator: torch.Generator) -> "Encoder":
        """The reference's init scheme (init_params :73), drawn from
        `generator` (draw_weights)."""
        draw_weights(self, self.cfg.num_layers, generator)
        return self

    def forward(self, token_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(B, L) ids + mask -> (B, H) f32 (L2-normalized) embeddings."""
        cfg = self.cfg
        s = token_ids.shape[1]
        # the rows gathered, then cast: the reference's cast-then-gather values
        x = (_compute(self.tok_emb[token_ids], cfg)
             + _compute(self.pos_emb[:s], cfg)[None, :, :])
        x = _layer_norm(x.to(cfg.dtype), _compute(self.emb_ln_scale, cfg),
                        _compute(self.emb_ln_bias, cfg))
        for lp in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(lp, x, mask, use_reentrant=False)
            else:
                x = lp(x, mask)
        return _pool(x, mask, cfg)


@torch.no_grad()
def draw_weights(module: nn.Module, num_layers: int, generator: torch.Generator) -> None:
    """Draw the encoder parameters of `module` (tok_emb, pos_emb, emb_ln_*,
    layers) by the reference's init scheme (init_params :73): normal(0,
    0.02) weights, residual-branch projections scaled by 1/sqrt(2L), zero
    biases, unit layer-norm scales. Draws come from `generator`, so they
    differ from JAX's PRNG draws for the same seed."""
    scale = 0.02
    res_scale = scale / max(1.0, (2.0 * num_layers) ** 0.5)

    def fill(p: torch.Tensor, s: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator,
                            device=p.device, dtype=torch.float32) * s)

    fill(module.tok_emb, scale)
    fill(module.pos_emb, scale)
    for lp in module.layers:
        fill(lp.qkv, scale)
        fill(lp.attn_out, res_scale)
        fill(lp.ffn_in, scale)
        fill(lp.ffn_out, res_scale)
        for name in ("qkv_b", "attn_out_b", "ffn_in_b", "ffn_out_b",
                     "ln1_bias", "ln2_bias"):
            getattr(lp, name).zero_()
        lp.ln1_scale.fill_(1.0)
        lp.ln2_scale.fill_(1.0)
    module.emb_ln_scale.fill_(1.0)
    module.emb_ln_bias.zero_()


def params_from_jax(np_params: Mapping[str, Any],
                    cfg: EncoderConfig) -> Dict[str, torch.Tensor]:
    """Carry the reference's parameter pytree (init_params :73, as numpy
    arrays) into an Encoder state_dict. Weights take cfg.param_dtype (the
    masters) or else cfg.dtype; layer-norm scales and biases stay f32, as in
    the reference."""

    def t(a, dtype=cfg.param_dtype or cfg.dtype) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32)).to(dtype)

    f32 = torch.float32
    sd: Dict[str, torch.Tensor] = {
        "tok_emb": t(np_params["tok_emb"]),
        "pos_emb": t(np_params["pos_emb"]),
        "emb_ln_scale": t(np_params["emb_ln"]["scale"], f32),
        "emb_ln_bias": t(np_params["emb_ln"]["bias"], f32),
    }
    for i, lp in enumerate(np_params["layers"]):
        pre = f"layers.{i}."
        for name in ("qkv", "qkv_b", "attn_out", "attn_out_b", "ffn_in",
                     "ffn_in_b", "ffn_out", "ffn_out_b"):
            sd[pre + name] = t(lp[name])
        for ln in ("ln1", "ln2"):
            sd[pre + ln + "_scale"] = t(lp[ln]["scale"], f32)
            sd[pre + ln + "_bias"] = t(lp[ln]["bias"], f32)
    return sd


def param_pspecs(cfg: EncoderConfig, model_axis: str = "model") -> Dict[str, Any]:
    """The reference's PartitionSpec tree (param_pspecs :115), each spec a
    tuple of axis names and None (() replicated): heads, the FFN width and
    the vocabulary sharded over the model axis."""
    m = model_axis
    layer = {
        "qkv": (None, None, m, None),
        "qkv_b": (None, m, None),
        "attn_out": (m, None, None),
        "attn_out_b": (),
        "ln1": {"scale": (), "bias": ()},
        "ffn_in": (None, m),
        "ffn_in_b": (m,),
        "ffn_out": (m, None),
        "ffn_out_b": (),
        "ln2": {"scale": (), "bias": ()},
    }
    return {
        "tok_emb": (m, None),
        "pos_emb": (),
        "emb_ln": {"scale": (), "bias": ()},
        "layers": [layer for _ in range(cfg.num_layers)],
    }


# ---------------------------------------------------- over a mesh (dp x tp)
class ShardedEncoder(ShardedParams):
    """The encoder's parameters placed on a (data, model) mesh by
    param_pspecs (the reference's device_put by NamedSharding, models/
    train.py:67-73): heads, the FFN width and the vocabulary split over
    'model', the rest replicated, one copy a data row. Called as the
    Encoder is, (ids, mask) -> (B, H) f32 embeddings on the mesh's first
    device: the batch split over 'data', each row's rows encoded by tensor
    parallelism over its devices
    (the vocabulary-parallel lookup; each shard's heads with its part of
    attn_out, and its FFN columns with its rows of ffn_out, the partial
    sums added in shard order and each bias added once after the sum),
    then gathered in row order. With cfg.remat each shard's attention and
    FFN and each residual layer norm is recomputed in the backward pass, a
    piece on one device at a time. ValueError where the reference's
    device_put raises: a split axis or the batch not divisible."""

    def __init__(self, state: Mapping[str, torch.Tensor], cfg: EncoderConfig, mesh):
        super().__init__(state, split_axes(param_pspecs(cfg)), mesh)
        self.cfg = cfg

    def __call__(self, token_ids, mask) -> torch.Tensor:
        ids_rows = split_rows(self.mesh, "token_ids", token_ids)
        mask_rows = split_rows(self.mesh, "mask", mask)
        return gather_rows([self._encode(row, ids.long(), m) for row, ids, m
                            in zip(self.rows, ids_rows, mask_rows)], self.device)

    def _encode(self, row: Row, token_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg, rep = self.cfg, row.rep
        s = token_ids.shape[1]
        x = (vocab_parallel_lookup(row.tables("tok_emb"), token_ids, row.devices,
                                   row.device, cfg.dtype)
             + _compute(rep["pos_emb"][:s], cfg)[None, :, :])
        x = _layer_norm(x.to(cfg.dtype), _compute(rep["emb_ln_scale"], cfg),
                        _compute(rep["emb_ln_bias"], cfg))
        masks = [mask.to(d) for d in row.devices]
        remat = cfg.remat and torch.is_grad_enabled()

        def run(fn, *args):
            if remat:
                return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
            return fn(*args)

        def attention(xj, mj, qkv, qkv_b, attn_out):
            return _attention_part(xj, mj, _compute(qkv, cfg), _compute(qkv_b, cfg),
                                   _compute(attn_out, cfg), cfg)

        def ffn(xj, ffn_in, ffn_in_b, ffn_out):
            return _ffn_part(xj, _compute(ffn_in, cfg), _compute(ffn_in_b, cfg),
                             _compute(ffn_out, cfg))

        def add_norm(x, y, b, scale, bias):
            return _layer_norm(x + (y + _compute(b, cfg)), _compute(scale, cfg),
                               _compute(bias, cfg))

        for i in range(cfg.num_layers):
            pre = f"layers.{i}."
            y = reduce_sum([run(attention, xj, mj, sh[pre + "qkv"], sh[pre + "qkv_b"],
                                sh[pre + "attn_out"])
                            for xj, mj, sh in zip(broadcast(x, row.devices), masks,
                                                  row.shards)], row.device)
            x = run(add_norm, x, y, rep[pre + "attn_out_b"], rep[pre + "ln1_scale"],
                    rep[pre + "ln1_bias"])
            y = reduce_sum([run(ffn, xj, sh[pre + "ffn_in"], sh[pre + "ffn_in_b"],
                                sh[pre + "ffn_out"])
                            for xj, sh in zip(broadcast(x, row.devices), row.shards)],
                           row.device)
            x = run(add_norm, x, y, rep[pre + "ffn_out_b"], rep[pre + "ln2_scale"],
                    rep[pre + "ln2_bias"])
        return _pool(x, mask, cfg)

    def to_encoder(self) -> Encoder:
        """An Encoder on the mesh's first device holding the gathered
        parameters (taking no gradients)."""
        model = Encoder(self.cfg, self.device)
        model.load_state_dict(self.state_dict())
        return model


# ------------------------------------------------------------- training
def info_nce_loss(params: Encoder, batch: Mapping[str, torch.Tensor],
                  cfg: Optional[EncoderConfig] = None,
                  temperature: float = 0.05) -> torch.Tensor:
    """Contrastive loss: query i matches positive i, in-batch negatives;
    the mean of the row-wise and the column-wise -log_softmax diagonal,
    times 0.5. `params` is the Encoder or a ShardedEncoder (whose q and
    p embeddings of every data row are gathered on the mesh's first device
    first, so the negatives span the whole batch, as the reference's
    global loss); cfg is taken for the reference's signature (the model
    carries its own)."""
    q = params(batch["q_ids"], batch["q_mask"])
    p = params(batch["p_ids"], batch["p_mask"])
    logits = torch.matmul(q, p.T) / temperature                  # (B, B)
    rows = torch.diagonal(torch.log_softmax(logits, dim=-1))
    cols = torch.diagonal(torch.log_softmax(logits, dim=0))
    return torch.mean(-rows - cols) * 0.5


def make_train_step(cfg: EncoderConfig, optimizer: torch.optim.Optimizer):
    """train_step(params, opt_state, batch) -> (params, opt_state, loss):
    the InfoNCE loss's gradients into the parameters (the f32 masters when
    cfg.param_dtype is f32) and one optimizer step (training/optim.py's
    make_step)."""
    return make_step(lambda params, batch: info_nce_loss(params, batch, cfg), optimizer)
