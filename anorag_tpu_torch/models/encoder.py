"""Transformer text encoder (XLM-R-large geometry by default).

Counterpart of anorag_tpu/models/encoder.py: EncoderConfig (:29), and
Encoder.forward for encode (:166). The parameters keep the JAX package's
layout (qkv (h, 3, n, dh), attn_out (n, dh, h), ...) so that
params_from_jax is a renaming, and the
forward pass mirrors the reference's rounding points: layer norm statistics
in f32 (eps 1e-5), attention logits in f32 masked with the f32 minimum,
post-LN blocks with erf GELU, cls or mean pooling, L2 normalisation with a
1e-9 floor. The encoder is plain tensor code: its matmuls go to
torch.matmul, as the reference left them to XLA.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

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

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

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


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig, device: torch.device):
        super().__init__()
        h, n, dh, i_sz = (cfg.hidden_size, cfg.num_heads, cfg.head_dim,
                          cfg.intermediate_size)
        self.cfg = cfg

        def p(*shape, dtype=cfg.dtype):
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

    def _attention(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        qkv = torch.einsum("bsh,htnd->tbsnd", x, self.qkv) + self.qkv_b[:, None, None]
        q, k, v = qkv[0], qkv[1], qkv[2]                      # (B, S, N, Dh)
        logits = torch.einsum("bsnd,btnd->bnst", q, k).float()
        logits = logits / math.sqrt(self.cfg.head_dim)
        neg = torch.finfo(torch.float32).min
        logits = logits.masked_fill(~(mask[:, None, None, :] > 0), neg)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        ctx = torch.einsum("bnst,btnd->bsnd", probs, v)
        return torch.einsum("bsnd,ndh->bsh", ctx, self.attn_out) + self.attn_out_b

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = _layer_norm(x + self._attention(x, mask), self.ln1_scale, self.ln1_bias)
        ff = torch.matmul(x, self.ffn_in) + self.ffn_in_b
        ff = torch.nn.functional.gelu(ff, approximate="none")  # erf GELU
        ff = torch.matmul(ff, self.ffn_out) + self.ffn_out_b
        return _layer_norm(x + ff, self.ln2_scale, self.ln2_bias)


class Encoder(nn.Module):
    """Inference-only encoder; parameters are zero until loaded
    (load_state_dict, e.g. from params_from_jax) or drawn (init_random)."""

    def __init__(self, cfg: EncoderConfig, device: torch.device):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.tok_emb = nn.Parameter(
            torch.zeros(cfg.vocab_size, h, dtype=cfg.dtype, device=device),
            requires_grad=False)
        self.pos_emb = nn.Parameter(
            torch.zeros(cfg.max_position, h, dtype=cfg.dtype, device=device),
            requires_grad=False)
        self.emb_ln_scale = nn.Parameter(
            torch.ones(h, device=device), requires_grad=False)
        self.emb_ln_bias = nn.Parameter(
            torch.zeros(h, device=device), requires_grad=False)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, device) for _ in range(cfg.num_layers))

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "Encoder":
        """The reference's init scheme (init_params :73): normal(0, 0.02)
        weights, residual-branch projections scaled by 1/sqrt(2L), zero
        biases, unit layer-norm scales. Draws come from `generator`, so they
        differ from JAX's PRNG draws for the same seed."""
        scale = 0.02
        res_scale = scale / max(1.0, (2.0 * self.cfg.num_layers) ** 0.5)

        def fill(p: torch.Tensor, s: float) -> None:
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device, dtype=torch.float32) * s)

        fill(self.tok_emb, scale)
        fill(self.pos_emb, scale)
        for lp in self.layers:
            fill(lp.qkv, scale)
            fill(lp.attn_out, res_scale)
            fill(lp.ffn_in, scale)
            fill(lp.ffn_out, res_scale)
            for name in ("qkv_b", "attn_out_b", "ffn_in_b", "ffn_out_b",
                         "ln1_bias", "ln2_bias"):
                getattr(lp, name).zero_()
            lp.ln1_scale.fill_(1.0)
            lp.ln2_scale.fill_(1.0)
        self.emb_ln_scale.fill_(1.0)
        self.emb_ln_bias.zero_()
        return self

    @torch.no_grad()
    def forward(self, token_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(B, L) ids + mask -> (B, H) f32 (L2-normalized) embeddings."""
        cfg = self.cfg
        s = token_ids.shape[1]
        x = self.tok_emb[token_ids] + self.pos_emb[:s][None, :, :]
        x = _layer_norm(x.to(cfg.dtype), self.emb_ln_scale, self.emb_ln_bias)
        for lp in self.layers:
            x = lp(x, mask)
        if cfg.pooling == "mean":
            m = mask[:, :, None].float()
            pooled = (x.float() * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
        else:
            pooled = x[:, 0, :].float()
        if cfg.normalize:
            pooled = pooled / torch.linalg.vector_norm(
                pooled, dim=-1, keepdim=True).clamp_min(1e-9)
        return pooled


def params_from_jax(np_params: Mapping[str, Any],
                    cfg: EncoderConfig) -> Dict[str, torch.Tensor]:
    """Carry the reference's parameter pytree (init_params :73, as numpy
    arrays) into an Encoder state_dict. Weights take cfg.dtype; layer-norm
    scales and biases stay f32, as in the reference."""

    def t(a, dtype=cfg.dtype) -> torch.Tensor:
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
