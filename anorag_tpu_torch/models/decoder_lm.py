"""Byte-level causal decoder LM: the framework's own generative model.

Counterpart of anorag_tpu/models/decoder_lm.py: ByteTokenizer, DecoderConfig,
init_params, forward, the training loss and step (lm_loss :229,
make_train_step :246; autograd where the reference takes
jax.value_and_grad), the generator (_prefill, _decode_step, _mask_unused,
_pick, generate; the reference's generate_fn), DecoderLM and the checkpoint
files (save_lm, load_lm: the same params.npz and config.json, read and
written with numpy). params_from_jax carries the reference's parameter
pytree across, and param_pspecs gives the reference's sharding specs (a
tuple of axis names for each PartitionSpec).

The arithmetic follows the reference's: pre-LN blocks with layer norm in
f32 (eps 1e-5), RoPE at absolute positions over the left-padded row
(arange(Pb) in prefill, Pb + i in decode step i), attention logits in f32
masked additively with the f32 minimum (a left-pad query row, which has no
allowed key, gets a uniform softmax as in the reference; a boolean mask
would give it NaN), tanh GELU, and the output projection tied to tok_emb
in f32. The decode cache is (B, max_len, N, Dh) a layer and every step
attends over all max_len columns, keys allowed where pad_len <= t <= pos.
The parameters keep the reference's layout (qkv (H, 3, N, Dh), attn_out
(N, Dh, H)), so that params_from_jax is a renaming. The decoder is plain
tensor code (the reference's is plain JAX with no Pallas kernel): its
matmuls go to torch.matmul. Greedy decoding (temperature <= 0) is the
operating point and matches the reference token for token; sampling draws
from an explicit torch.Generator, not from JAX's PRNG. ShardedDecoder places
the parameters on a (data, model) mesh by param_pspecs, as the reference's
dry run does (__graft_entry__.py:222-260), and lm_loss, make_train_step,
forward and generate run it data x tensor parallel
(parallel/tensor_parallel.py).
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from types import SimpleNamespace
from typing import (Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch
from torch import nn

from anorag_tpu_torch.device import DeviceLike, resolve_device
from anorag_tpu_torch.models.encoder import _layer_norm
from anorag_tpu_torch.parallel.tensor_parallel import (Row, ShardedParams, broadcast,
                                                       gather_rows, reduce_sum, split_axes,
                                                       split_rows, vocab_parallel_lookup)
from anorag_tpu_torch.training.optim import make_step

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
_BYTE0 = 3                       # byte b encodes as _BYTE0 + b
N_USED = _BYTE0 + 256            # 259
_NEG = torch.finfo(torch.float32).min
# decode steps between the checks that every row is done (one host sync)
_DONE_EVERY = 16


class ByteTokenizer:
    """Invertible byte-level tokenizer (ids 3..258 = bytes 0..255)."""

    vocab_size = N_USED

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        ids = [_BYTE0 + b for b in text.encode("utf-8")]
        if add_bos:
            ids = [BOS_ID] + ids
        if add_eos:
            ids = ids + [EOS_ID]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        bs = bytes(i - _BYTE0 for i in ids if _BYTE0 <= i < N_USED)
        return bs.decode("utf-8", errors="replace")


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 384        # >= N_USED, lane-aligned
    hidden_size: int = 256
    num_layers: int = 4
    num_heads: int = 8
    intermediate_size: int = 1024
    max_len: int = 2048          # cache capacity (prompt + generated)
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def tiny() -> "DecoderConfig":
        return DecoderConfig(hidden_size=64, num_layers=2, num_heads=2,
                             intermediate_size=128, max_len=256)

    @staticmethod
    def from_config(cfg: Mapping[str, Any]) -> "DecoderConfig":
        return DecoderConfig(
            vocab_size=int(cfg.get("vocab_size", 384)),
            hidden_size=int(cfg.get("hidden_size", 256)),
            num_layers=int(cfg.get("num_layers", 4)),
            num_heads=int(cfg.get("num_heads", 8)),
            intermediate_size=int(cfg.get("intermediate_size", 1024)),
            max_len=int(cfg.get("max_len", 2048)),
            dtype=torch.bfloat16 if cfg.get("dtype") == "bfloat16" else torch.float32,
        )

    def as_dict(self) -> Dict[str, Any]:
        return {
            "vocab_size": self.vocab_size, "hidden_size": self.hidden_size,
            "num_layers": self.num_layers, "num_heads": self.num_heads,
            "intermediate_size": self.intermediate_size, "max_len": self.max_len,
            "dtype": "bfloat16" if self.dtype == torch.bfloat16 else "float32",
        }


# ------------------------------------------------------------- parameters
class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig, device: torch.device):
        super().__init__()
        h, n, dh, i_sz = (cfg.hidden_size, cfg.num_heads, cfg.head_dim,
                          cfg.intermediate_size)

        def p(*shape, dtype=cfg.dtype):
            return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.ln1_scale = p(h, dtype=torch.float32)
        self.ln1_bias = p(h, dtype=torch.float32)
        self.qkv = p(h, 3, n, dh)
        self.attn_out = p(n, dh, h)
        self.ln2_scale = p(h, dtype=torch.float32)
        self.ln2_bias = p(h, dtype=torch.float32)
        self.ffn_in = p(h, i_sz)
        self.ffn_out = p(i_sz, h)


class DecoderParams(nn.Module):
    """The decoder's parameters on one device (zero until loaded or drawn);
    the functions below take it as the reference's take its pytree."""

    def __init__(self, cfg: DecoderConfig, device: torch.device):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.tok_emb = nn.Parameter(
            torch.zeros(cfg.vocab_size, h, dtype=cfg.dtype, device=device),
            requires_grad=False)
        self.final_ln_scale = nn.Parameter(torch.zeros(h, device=device),
                                           requires_grad=False)
        self.final_ln_bias = nn.Parameter(torch.zeros(h, device=device),
                                          requires_grad=False)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device)
                                    for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device


@torch.no_grad()
def init_params(cfg: DecoderConfig, generator: torch.Generator,
                device: DeviceLike = None) -> DecoderParams:
    """The reference's init scheme (init_params :104): normal(0, 0.02)
    weights, residual-path outputs scaled by 1/sqrt(2L), unit layer-norm
    scales, zero biases. Draws come from `generator` (on the device the
    parameters are made on), so they differ from JAX's for the same seed."""
    params = DecoderParams(cfg, resolve_device(device))
    scale = 0.02
    out_scale = scale / np.sqrt(2.0 * cfg.num_layers)

    def fill(p: torch.Tensor, s: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32) * s)

    fill(params.tok_emb, scale)
    params.final_ln_scale.fill_(1.0)
    for lp in params.layers:
        fill(lp.qkv, scale)
        fill(lp.attn_out, out_scale)
        fill(lp.ffn_in, scale)
        fill(lp.ffn_out, out_scale)
        lp.ln1_scale.fill_(1.0)
        lp.ln2_scale.fill_(1.0)
    return params


def param_pspecs(cfg: DecoderConfig, model_axis: str = "model") -> Dict[str, Any]:
    """The reference's PartitionSpec tree (param_pspecs :139), each spec a
    tuple of axis names and None (() replicated)."""
    m = model_axis
    layer = {
        "ln1": {"scale": (), "bias": ()},
        "qkv": (None, None, m, None),
        "attn_out": (m, None, None),
        "ln2": {"scale": (), "bias": ()},
        "ffn_in": (None, m),
        "ffn_out": (m, None),
    }
    return {
        "tok_emb": (m, None),
        "final_ln": {"scale": (), "bias": ()},
        "layers": [layer for _ in range(cfg.num_layers)],
    }


def params_from_jax(np_params: Mapping[str, Any], cfg: DecoderConfig,
                    device: DeviceLike = None) -> DecoderParams:
    """The reference's parameter pytree (init_params, load_lm; leaves as
    numpy arrays) as DecoderParams on `device`: weights in cfg.dtype,
    layer-norm scales and biases in f32, as the reference keeps them."""
    params = DecoderParams(cfg, resolve_device(device))
    params.load_state_dict(_state_dict(np_params))
    return params


def _state_dict(np_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32))

    sd = {"tok_emb": t(np_params["tok_emb"]),
          "final_ln_scale": t(np_params["final_ln"]["scale"]),
          "final_ln_bias": t(np_params["final_ln"]["bias"])}
    for i, lp in enumerate(np_params["layers"]):
        for name in ("qkv", "attn_out", "ffn_in", "ffn_out"):
            sd[f"layers.{i}.{name}"] = t(lp[name])
        for ln in ("ln1", "ln2"):
            sd[f"layers.{i}.{ln}_scale"] = t(lp[ln]["scale"])
            sd[f"layers.{i}.{ln}_bias"] = t(lp[ln]["bias"])
    return sd


# ---------------------------------------------------------------- blocks
def _rope_tables(positions: torch.Tensor, head_dim: int,
                 base: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin (S, Dh/2) of the rotary angles at `positions` (S,), in
    f32 from the reference's f32 frequencies."""
    half = head_dim // 2
    freqs = torch.from_numpy(
        1.0 / (base ** (np.arange(half, dtype=np.float32) / half)))
    ang = positions.float()[:, None] * freqs.to(positions.device)[None, :]
    return torch.cos(ang), torch.sin(ang)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding over the last dim. x: (B, S, N, Dh), cos and sin
    (S, Dh/2) from _rope_tables."""
    half = x.shape[-1] // 2
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def _qkv(x: torch.Tensor, lp: DecoderLayer):
    qkv = torch.einsum("bsh,htnd->tbsnd", x, lp.qkv)
    return qkv[0], qkv[1], qkv[2]                       # each (B, S, N, Dh)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            allowed: torch.Tensor, lp: DecoderLayer, cfg: DecoderConfig) -> torch.Tensor:
    """q (B,S,N,Dh) vs keys (B,T,N,Dh); allowed (B,S,T) bool."""
    logits = torch.einsum("bsnd,btnd->bnst", q, k).float()
    logits = logits / math.sqrt(cfg.head_dim)
    logits = logits.masked_fill(~allowed[:, None, :, :], _NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    ctx = torch.einsum("bnst,btnd->bsnd", probs, v)
    return torch.einsum("bsnd,ndh->bsh", ctx, lp.attn_out)


def _ffn(x: torch.Tensor, lp: DecoderLayer) -> torch.Tensor:
    ff = torch.nn.functional.gelu(torch.matmul(x, lp.ffn_in), approximate="tanh")
    return torch.matmul(ff, lp.ffn_out)


# one data row of parameters (DecoderParams as one row of one shard, or a
# ShardedDecoder's row): the blocks over the row's model shards
def _layer_views(row: Row, i: int):
    """Layer i of a row: (ln1 scale, bias), (ln2 scale, bias) and each
    shard's slices as an object with the attributes _qkv, _attend and
    _ffn read."""
    pre = f"layers.{i}."
    shards = [SimpleNamespace(**{k: sh[pre + k] for k in ("qkv", "attn_out", "ffn_in",
                                                          "ffn_out")})
              for sh in row.shards]
    return ((row.rep[pre + "ln1_scale"], row.rep[pre + "ln1_bias"]),
            (row.rep[pre + "ln2_scale"], row.rep[pre + "ln2_bias"]), shards)


class _RowLayers(NamedTuple):
    """A data row of parameters and its layers' views (_layer_views), built
    once a call (generate builds them once for all its steps)."""
    row: Row
    layers: List[tuple]


def _rows(params: "Params", cfg: DecoderConfig) -> List[_RowLayers]:
    """Each data row of `params` (DecoderParams: one row of one shard)
    with its layers' views."""
    rows = params.rows if isinstance(params, ShardedDecoder) else [_as_row(params)]
    return [_RowLayers(r, [_layer_views(r, i) for i in range(cfg.num_layers)]) for r in rows]


def _blocks(rl: _RowLayers, x: torch.Tensor, allowed: torch.Tensor, rope,
            cfg: DecoderConfig, caches=None, step_pos: Optional[int] = None) -> torch.Tensor:
    """The blocks over a row's model shards: x (B, S, H) on the row's
    device -> x after the last block. rope: (cos, sin) of x's positions.
    caches: one list a layer of each shard's (k, v) buffers (B, max_len,
    N / model, Dh), written at [0, S) (prefill) or at step_pos (a decode
    step, which then attends over the whole buffer)."""
    row = rl.row
    # each shard's mask and rope tables on its device, once for all layers
    on_dev = [(allowed.to(d), rope[0].to(d), rope[1].to(d)) for d in row.devices]
    for i, (ln1, ln2, lps) in enumerate(rl.layers):
        parts = []
        for j, (hj, lp) in enumerate(zip(broadcast(_layer_norm(x, *ln1), row.devices), lps)):
            allowed_j, cos, sin = on_dev[j]
            q, k, v = _qkv(hj, lp)
            q, k = _rope(q, cos, sin), _rope(k, cos, sin)
            if caches is not None:
                ck, cv = caches[i][j]
                if step_pos is None:
                    ck[:, :k.shape[1]] = k
                    cv[:, :v.shape[1]] = v
                else:
                    ck[:, step_pos] = k[:, 0]
                    cv[:, step_pos] = v[:, 0]
                    k, v = ck, cv
            parts.append(_attend(q, k, v, allowed_j, lp, cfg))
        x = x + reduce_sum(parts, row.device)
        h = broadcast(_layer_norm(x, *ln2), row.devices)
        x = x + reduce_sum([_ffn(hj, lp) for hj, lp in zip(h, lps)], row.device)
    return x


def _logit_parts(row: Row, x: torch.Tensor) -> List[torch.Tensor]:
    """The tied output projection by vocabulary shard: the final layer
    norm on the row's device, then each shard's f32 logits (..., V /
    model) on its device."""
    x = _layer_norm(x, row.rep["final_ln_scale"], row.rep["final_ln_bias"])
    return [torch.matmul(xj.float(), t.float().T)
            for xj, t in zip(broadcast(x, row.devices), row.tables("tok_emb"))]


def _gather_vocab(row: Row, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    if len(parts) == 1:
        return parts[0].to(row.device)
    return torch.cat([p.to(row.device) for p in parts], dim=-1)


def _embed(row: Row, ids: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    return vocab_parallel_lookup(row.tables("tok_emb"), ids.long(), row.devices,
                                 row.device, cfg.dtype)


def _forward_row(rl: _RowLayers, token_ids: torch.Tensor, cfg: DecoderConfig,
                 attn_mask: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """forward over one data row: its logits by vocabulary shard."""
    row = rl.row
    b, s = token_ids.shape
    x = _embed(row, token_ids, cfg)
    pos = torch.arange(s, device=row.device)
    causal = pos[None, :, None] >= pos[None, None, :]   # (1, S, T)
    if attn_mask is None:
        allowed = causal.expand(b, s, s)
    else:
        allowed = causal & (attn_mask.to(row.device)[:, None, :] > 0)
    return _logit_parts(row, _blocks(rl, x, allowed, _rope_tables(pos, cfg.head_dim), cfg))


def _kv_buffers(b: int, lp, cfg: DecoderConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """A shard's zeroed (k, v) cache of one layer: (B, max_len, its heads,
    Dh) on its device."""
    k = torch.zeros((b, cfg.max_len, lp.qkv.shape[2], cfg.head_dim), dtype=cfg.dtype,
                    device=lp.qkv.device)
    return k, torch.zeros_like(k)


def _as_row(params: DecoderParams) -> Row:
    """DecoderParams as one data row of one shard: each parameter is the
    row's and its shard's, so the row functions run the one-device
    arithmetic (a broadcast to one device is the tensor itself, a sum of one
    part the part)."""
    named = dict(params.named_parameters())
    return Row([params.device], named, [named])


def _prefill_row(rl: _RowLayers, ids: torch.Tensor, pad_lens: torch.Tensor,
                 cfg: DecoderConfig):
    """_prefill over one data row: (last-position logits (B, V) on the
    row's device, its cache: per layer, each shard's (k, v))."""
    row = rl.row
    b, pb = ids.shape
    pos = torch.arange(pb, device=row.device)
    valid = pos[None, :] >= pad_lens[:, None]           # (B, Pb)
    allowed = (pos[None, :, None] >= pos[None, None, :]) & valid[:, None, :]
    caches = [[_kv_buffers(b, lp, cfg) for lp in lps] for _, _, lps in rl.layers]
    x = _blocks(rl, _embed(row, ids, cfg), allowed, _rope_tables(pos, cfg.head_dim), cfg,
                caches)
    return _gather_vocab(row, _logit_parts(row, x[:, -1, :])), caches


def _rope_at(rope: Optional[Tuple[torch.Tensor, torch.Tensor]], step_pos: int,
             cfg: DecoderConfig, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin at step_pos, from `rope` (_rope_tables of arange(max_len))
    or computed."""
    cos, sin = rope or _rope_tables(torch.arange(cfg.max_len, device=device), cfg.head_dim)
    return cos[step_pos:step_pos + 1], sin[step_pos:step_pos + 1]


def _decode_row(rl: _RowLayers, tok: torch.Tensor, step_pos: int, pad_lens: torch.Tensor,
                caches, cfg: DecoderConfig, rope_one) -> torch.Tensor:
    """_decode_step over one data row: logits (B, V) on the row's device."""
    row = rl.row
    tpos = torch.arange(cfg.max_len, device=row.device)
    key_ok = (tpos[None, :] >= pad_lens[:, None]) & (tpos[None, :] <= step_pos)
    x = _blocks(rl, _embed(row, tok, cfg)[:, None, :], key_ok[:, None, :], rope_one, cfg,
                caches, step_pos)
    return _gather_vocab(row, _logit_parts(row, x[:, 0, :]))


@torch.no_grad()
def forward(params: "Params", token_ids: torch.Tensor, cfg: DecoderConfig,
            attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence causal forward: (B, S) ids -> (B, S, V) f32 logits
    (on a ShardedDecoder's first device, gathered).

    attn_mask (B, S) marks valid tokens (left- OR right-padding excluded
    from keys); causality is applied on top.
    """
    if isinstance(params, ShardedDecoder):
        masks = (split_rows(params.mesh, "attn_mask", attn_mask) if attn_mask is not None
                 else [None] * len(params.rows))
        return gather_rows([_gather_vocab(rl.row, _forward_row(rl, ids, cfg, m))
                            for rl, ids, m in zip(_rows(params, cfg),
                                                  split_rows(params.mesh, "token_ids",
                                                             token_ids), masks)],
                           params.device)
    return _forward(params, token_ids, cfg, attn_mask)


def _forward(params: DecoderParams, token_ids: torch.Tensor, cfg: DecoderConfig,
             attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """forward, with autograd's graph when the parameters take gradients."""
    return _forward_row(_rows(params, cfg)[0], token_ids, cfg, attn_mask)[0]


# ----------------------------------------------------------------- loss
def lm_loss(params: "Params", batch: Mapping[str, torch.Tensor],
            cfg: DecoderConfig) -> torch.Tensor:
    """Next-token CE masked to completion tokens; on a ShardedDecoder the
    batch split over 'data', the cross-entropy vocabulary-parallel, and the
    masked sum over every row divided by the mask count of the whole batch.

    batch: ids (B, S) int, loss_mask (B, S) f32 -- mask[i, t] weights the
    prediction OF token t (from position t-1).
    """
    if isinstance(params, ShardedDecoder):
        return _tp_lm_loss(params, batch, cfg)
    ids, mask = batch["ids"], batch["loss_mask"]
    logits = _forward(params, ids[:, :-1], cfg,
                      attn_mask=(ids[:, :-1] != PAD_ID).to(torch.int32))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, ids[:, 1:, None].long())[:, :, 0]
    w = mask[:, 1:]
    return torch.sum(nll * w) / torch.clamp_min(torch.sum(w), 1.0)


def make_train_step(cfg: DecoderConfig, optimizer: torch.optim.Optimizer,
                    clip: Optional[Callable[[Sequence[torch.Tensor]], None]] = None):
    """train_step(params, opt_state, batch) -> (params, opt_state, loss):
    lm_loss's gradients, `clip` applied to them (training/optim.py's
    clip_by_global_norm: the reference chains optax.clip_by_global_norm
    before its adamw), then one optimizer step (training/optim.py's
    make_step)."""
    return make_step(lambda params, batch: lm_loss(params, batch, cfg), optimizer, clip)


# ------------------------------------------------------------ generation
Cache = List[Tuple[torch.Tensor, torch.Tensor]]


@torch.no_grad()
def _prefill(params: "Params", ids: torch.Tensor, pad_lens: torch.Tensor,
             cfg: DecoderConfig, rows: Optional[List[_RowLayers]] = None
             ) -> Tuple[torch.Tensor, Cache]:
    """LEFT-padded prompt (B, Pb) -> (last-position logits, KV cache).

    Cache buffers are (B, max_len, N, Dh) with prompt K/V in columns
    [0, Pb); decode writes Pb, Pb+1, ... `rows`: _rows(params, cfg), made
    here when None. A ShardedDecoder's: _tp_prefill.
    """
    rows = rows or _rows(params, cfg)
    if isinstance(params, ShardedDecoder):
        return _tp_prefill(params, ids, pad_lens, cfg, rows)
    logits, caches = _prefill_row(rows[0], ids, pad_lens, cfg)
    return logits, [layer[0] for layer in caches]


@torch.no_grad()
def _decode_step(params: "Params", tok: torch.Tensor, step_pos: int,
                 pad_lens: torch.Tensor, cache: Cache, cfg: DecoderConfig,
                 rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 rows: Optional[List[_RowLayers]] = None) -> torch.Tensor:
    """One token (B,) at absolute position step_pos -> logits (B, V); the
    step's K/V are written into `cache` in place. `rope`: _rope_tables of
    arange(max_len), and `rows`: _rows(params, cfg), which generate makes
    once for all its steps. A ShardedDecoder's: _tp_decode_step."""
    rows = rows or _rows(params, cfg)
    if isinstance(params, ShardedDecoder):
        return _tp_decode_step(params, tok, step_pos, pad_lens, cache, cfg, rope, rows)
    return _decode_row(rows[0], tok, step_pos, pad_lens, [[kv] for kv in cache],
                       cfg, _rope_at(rope, step_pos, cfg, tok.device))


def _mask_unused(logits: torch.Tensor) -> torch.Tensor:
    """Padding vocab rows (>= N_USED) and PAD/BOS can never be sampled."""
    v = torch.arange(logits.shape[-1], device=logits.device)
    bad = (v >= N_USED) | (v == PAD_ID) | (v == BOS_ID)
    return logits.masked_fill(bad[None, :], _NEG)


def _pick(logits: torch.Tensor, generator: Optional[torch.Generator],
          temperature: float) -> torch.Tensor:
    logits = _mask_unused(logits)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


@torch.no_grad()
def generate(params: "Params", ids: torch.Tensor, pad_lens: torch.Tensor,
             cfg: DecoderConfig, max_new: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(ids (B, Pb) left-padded, pad_lens (B,)) -> (B, max_new) int32 tokens,
    PAD after a row's EOS (EOS itself is not emitted), as the reference's
    compiled generator gives them. The loop ends early once every row is
    done; the steps it skips would emit PAD only. On a ShardedDecoder the
    batch is split over 'data', each row's heads and KV cache over its
    model shards, and each step's logits are gathered on the first device
    before the pick, so greedy tokens are the unsharded ones."""
    rows = _rows(params, cfg)
    logits, cache = _prefill(params, ids, pad_lens, cfg, rows)
    pb = ids.shape[1]
    rope = _rope_tables(torch.arange(cfg.max_len, device=ids.device), cfg.head_dim)
    tok = _pick(logits, generator, temperature)
    done = tok == EOS_ID
    out = torch.full((ids.shape[0], max_new), PAD_ID, dtype=torch.int32,
                     device=ids.device)
    for i in range(max_new):
        if i % _DONE_EVERY == 0 and i and bool(done.all()):
            break
        emit = torch.where(done, PAD_ID, tok)
        out[:, i] = emit
        logits = _decode_step(params, emit, pb + i, pad_lens, cache, cfg, rope, rows)
        tok = _pick(logits, generator, temperature)
        done = done | (tok == EOS_ID)
    return out


# ------------------------------------------------- over a mesh (dp x tp)
class ShardedDecoder(ShardedParams):
    """The decoder's parameters placed on a (data, model) mesh by
    param_pspecs (heads, FFN width and the tied vocabulary over 'model',
    the layer norms replicated, one copy a data row), as the reference's
    dry run places them by NamedSharding (__graft_entry__.py:229-233).
    lm_loss, make_train_step, forward and generate take it where they take
    DecoderParams: each data row's rows by tensor parallelism over its
    devices (the vocabulary-parallel lookup, each shard's heads with its
    part of attn_out and its KV cache, its FFN columns with its rows of
    ffn_out, partial sums added in shard order; the tied logits split by
    vocabulary). ValueError where the reference's device_put raises."""

    def __init__(self, state: Mapping[str, torch.Tensor], cfg: DecoderConfig, mesh):
        super().__init__(state, split_axes(param_pspecs(cfg)), mesh)
        self.cfg = cfg

    def to_params(self) -> DecoderParams:
        """DecoderParams on the mesh's first device holding the gathered
        parameters (taking no gradients)."""
        params = DecoderParams(self.cfg, self.device)
        params.load_state_dict(self.state_dict())
        return params


Params = Union[DecoderParams, ShardedDecoder]


def _vocab_parallel_nll(row: Row, parts: Sequence[torch.Tensor],
                        tgt: torch.Tensor) -> torch.Tensor:
    """-log_softmax(logits)[tgt] from the logits' vocabulary shards: the
    max and the sum of exps reduced over the shards in shard order on the
    row's device (the max taken as a constant, which leaves the value and
    the softmax gradient as they are), the target's logit from the shard
    that holds it."""
    dev = row.device
    top = parts[0].detach().amax(-1).to(dev)
    for p in parts[1:]:
        top = torch.maximum(top, p.detach().amax(-1).to(dev))
    sums, picked, lo = [], [], 0
    for p, d in zip(parts, row.devices):
        sums.append(torch.exp(p - top.to(d)[..., None]).sum(-1))
        local, n = tgt.to(d) - lo, p.shape[-1]
        got = torch.gather(p, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        picked.append(torch.where((local >= 0) & (local < n), got,
                                  torch.zeros((), dtype=got.dtype, device=d)))
        lo += n
    return top + torch.log(reduce_sum(sums, dev)) - reduce_sum(picked, dev)


def _tp_lm_loss(params: ShardedDecoder, batch: Mapping[str, Any],
                cfg: DecoderConfig) -> torch.Tensor:
    total = count = None
    for rl, ids, mask in zip(_rows(params, cfg), split_rows(params.mesh, "ids", batch["ids"]),
                             split_rows(params.mesh, "loss_mask", batch["loss_mask"])):
        parts = _forward_row(rl, ids[:, :-1], cfg,
                             attn_mask=(ids[:, :-1] != PAD_ID).to(torch.int32))
        nll = _vocab_parallel_nll(rl.row, parts, ids[:, 1:].long())
        w = mask[:, 1:]
        s_i, c_i = torch.sum(nll * w).to(params.device), torch.sum(w).to(params.device)
        total = s_i if total is None else total + s_i
        count = c_i if count is None else count + c_i
    return total / torch.clamp_min(count, 1.0)


@torch.no_grad()
def _tp_prefill(params: ShardedDecoder, ids: torch.Tensor, pad_lens: torch.Tensor,
                cfg: DecoderConfig, rows: List[_RowLayers]):
    """_prefill over the mesh: (last-position logits (B, V) on the first
    device, the cache: per data row, per layer, each shard's (k, v))."""
    out = [_prefill_row(rl, ids_i, pad_i, cfg) for rl, ids_i, pad_i
           in zip(rows, split_rows(params.mesh, "ids", ids),
                  split_rows(params.mesh, "pad_lens", pad_lens))]
    return gather_rows([logits for logits, _ in out], params.device), [c for _, c in out]


@torch.no_grad()
def _tp_decode_step(params: ShardedDecoder, tok: torch.Tensor, step_pos: int,
                    pad_lens: torch.Tensor, cache, cfg: DecoderConfig,
                    rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
                    rows: List[_RowLayers]) -> torch.Tensor:
    """_decode_step over the mesh: logits (B, V) on the first device; each
    shard's K/V written into its cache in place."""
    one = _rope_at(rope, step_pos, cfg, params.device)
    return gather_rows([_decode_row(rl, tok_i, step_pos, pad_i, caches, cfg, one)
                        for rl, tok_i, pad_i, caches
                        in zip(rows, split_rows(params.mesh, "tok", tok),
                               split_rows(params.mesh, "pad_lens", pad_lens), cache)],
                       params.device)


class DecoderLM:
    """Host-side wrapper: tokenize, bucket, run the generator."""

    def __init__(self, params: DecoderParams, cfg: DecoderConfig,
                 prompt_bucket: int = 128, max_prompt: Optional[int] = None):
        self.params = params
        self.cfg = cfg
        self.tok = ByteTokenizer()
        self.prompt_bucket = prompt_bucket
        self.max_prompt = max_prompt or (cfg.max_len // 2)

    def _bucket(self, n: int) -> int:
        b = self.prompt_bucket
        return min(self.max_prompt, max(b, ((n + b - 1) // b) * b))

    def encode_batch(self, prompts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """The prompts as generate gives them to the model: (ids (nb, Pb),
        pad_lens (nb,)), BOS first, the last max_prompt ids kept, left
        padded to the bucket, the batch padded to a power of two with
        copies of row 0."""
        enc = [self.tok.encode(p, add_bos=True)[-self.max_prompt:]
               for p in prompts]
        nb = 1
        while nb < len(enc):
            nb *= 2
        enc = enc + [enc[0]] * (nb - len(enc))
        pb = self._bucket(max(len(e) for e in enc))
        ids = np.full((len(enc), pb), PAD_ID, np.int32)
        pad_lens = np.zeros((len(enc),), np.int32)
        for i, e in enumerate(enc):
            e = e[-pb:]
            ids[i, pb - len(e):] = e                     # LEFT pad
            pad_lens[i] = pb - len(e)
        return ids, pad_lens

    def generate(self, prompts: Sequence[str], max_new: int = 512,
                 temperature: float = 0.0, seed: int = 0) -> List[str]:
        if not prompts:
            return []
        ids, pad_lens = self.encode_batch(prompts)
        max_new = min(max_new, self.cfg.max_len - ids.shape[1])
        dev = self.params.device
        generator = None
        if temperature > 0.0:
            generator = torch.Generator(device=dev).manual_seed(seed)
        toks = generate(self.params, torch.from_numpy(ids).to(dev),
                        torch.from_numpy(pad_lens).to(dev), self.cfg, max_new,
                        temperature, generator).cpu().numpy()
        out = []
        for row in toks[:len(prompts)]:
            stop = np.nonzero(row == PAD_ID)[0]
            end = int(stop[0]) if stop.size else len(row)
            out.append(self.tok.decode(row[:end].tolist()))
        return out


# -------------------------------------------------------- checkpoint io
def save_lm(path, params: DecoderParams, cfg: DecoderConfig) -> None:
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)

    def a(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    flat = {"tok_emb": a(params.tok_emb),
            "final_ln.scale": a(params.final_ln_scale),
            "final_ln.bias": a(params.final_ln_bias)}
    for i, lp in enumerate(params.layers):
        for k in ("qkv", "attn_out", "ffn_in", "ffn_out"):
            flat[f"l{i}.{k}"] = a(getattr(lp, k))
        for ln in ("ln1", "ln2"):
            flat[f"l{i}.{ln}.scale"] = a(getattr(lp, f"{ln}_scale"))
            flat[f"l{i}.{ln}.bias"] = a(getattr(lp, f"{ln}_bias"))
    np.savez_compressed(p / "params.npz", **flat)
    (p / "config.json").write_text(json.dumps(cfg.as_dict()))


def load_lm(path, device: DeviceLike = None) -> Tuple[DecoderParams, DecoderConfig]:
    p = Path(path)
    cfg = DecoderConfig.from_config(json.loads((p / "config.json").read_text()))
    with np.load(p / "params.npz") as z:
        tree = {"tok_emb": z["tok_emb"],
                "final_ln": {"scale": z["final_ln.scale"], "bias": z["final_ln.bias"]},
                "layers": [{"qkv": z[f"l{i}.qkv"], "attn_out": z[f"l{i}.attn_out"],
                            "ffn_in": z[f"l{i}.ffn_in"], "ffn_out": z[f"l{i}.ffn_out"],
                            "ln1": {"scale": z[f"l{i}.ln1.scale"],
                                    "bias": z[f"l{i}.ln1.bias"]},
                            "ln2": {"scale": z[f"l{i}.ln2.scale"],
                                    "bias": z[f"l{i}.ln2.bias"]}}
                           for i in range(cfg.num_layers)]}
    return params_from_jax(tree, cfg, device), cfg
