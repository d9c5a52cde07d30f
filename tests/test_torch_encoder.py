"""Parity of the port's encoder (anorag_tpu_torch/models/encoder.py) with
anorag_tpu/models/encoder.py::encode, in f32 on the CPU: the JAX
parameters are carried across with params_from_jax, the same numpy token
ids go through both, and the embeddings agree to atol 1e-4."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anorag_tpu.models import encoder as jenc
from anorag_tpu_torch.models.encoder import Encoder, EncoderConfig, params_from_jax

CKPT = Path(__file__).resolve().parents[1] / "checkpoints" / "encoder_synth_small"


def _torch_cfg(jcfg) -> EncoderConfig:
    return EncoderConfig(vocab_size=jcfg.vocab_size, hidden_size=jcfg.hidden_size,
                         num_layers=jcfg.num_layers, num_heads=jcfg.num_heads,
                         intermediate_size=jcfg.intermediate_size,
                         max_position=jcfg.max_position, pooling=jcfg.pooling,
                         dtype=torch.float32)


def _tokens(vocab, b=5, s=24, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (b, s)).astype(np.int32)
    lens = rng.integers(2, s + 1, b)
    lens[0] = s
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    return np.where(mask > 0, ids, 2).astype(np.int32), mask


def _compare(jparams, jcfg, seed=0):
    ids, mask = _tokens(jcfg.vocab_size, seed=seed)
    want = np.asarray(jenc.encode(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    tcfg = _torch_cfg(jcfg)
    enc = Encoder(tcfg, torch.device("cpu"))
    np_params = jax.tree.map(np.asarray, jparams)
    enc.load_state_dict(params_from_jax(np_params, tcfg))
    got = enc(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_encoder_matches_jax_small(pooling):
    jcfg = dataclasses.replace(jenc.EncoderConfig.small(), pooling=pooling,
                               dtype=jnp.float32)
    _compare(jenc.init_params(jax.random.PRNGKey(0), jcfg), jcfg)


def test_encoder_matches_jax_on_shipped_checkpoint():
    """The trained small checkpoint, restored with orbax in the test only."""
    import orbax.checkpoint as ocp

    jcfg = jenc.EncoderConfig(vocab_size=8192, hidden_size=256, num_layers=4,
                              num_heads=8, intermediate_size=1024,
                              max_position=128, pooling="mean",
                              dtype=jnp.float32)
    target = jenc.init_params(jax.random.PRNGKey(0), jcfg)
    params = ocp.StandardCheckpointer().restore(CKPT.resolve(), target)
    assert not np.allclose(np.asarray(params["tok_emb"]),
                           np.asarray(target["tok_emb"]))
    _compare(params, jcfg, seed=1)


def test_params_from_jax_layout():
    jcfg = dataclasses.replace(jenc.EncoderConfig.small(), dtype=jnp.bfloat16)
    np_params = jax.tree.map(np.asarray, jenc.init_params(jax.random.PRNGKey(1), jcfg))
    tcfg = dataclasses.replace(_torch_cfg(jcfg), dtype=torch.bfloat16)
    sd = params_from_jax(np_params, tcfg)
    enc = Encoder(tcfg, torch.device("cpu"))
    enc.load_state_dict(sd)          # strict: every key and shape matches
    assert sd["layers.0.qkv"].shape == (128, 3, 4, 32)
    assert sd["layers.1.attn_out"].shape == (4, 32, 128)
    assert sd["tok_emb"].dtype == torch.bfloat16
    assert sd["layers.0.ln1_scale"].dtype == torch.float32
    np.testing.assert_array_equal(
        sd["layers.1.ffn_in"].float().numpy(),
        np.asarray(np_params["layers"][1]["ffn_in"], np.float32))
