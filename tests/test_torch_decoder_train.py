"""The port's decoder LM training (anorag_tpu_torch/models/decoder_lm.py's
lm_loss and make_train_step, with training/optim.py's adamw,
warmup_cosine_decay_schedule and clip_by_global_norm) against
anorag_tpu's under optax, on the CPU in f32: the same numpy batches, the
reference's initial parameters carried across with params_from_jax.

Tolerances: the loss to rtol 1e-5, the gradients to atol 1e-5, the
parameters after each step to atol 1e-5; greedy tokens after training are
compared as tests/test_torch_decoder_lm.py compares them (up to a
reference top-2 margin under 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anorag_tpu.models import decoder_lm as J
from anorag_tpu_torch.models import decoder_lm as T
from anorag_tpu_torch.training import optim

from test_torch_decoder_lm import MARGIN

CFG = T.DecoderConfig.tiny()
JCFG = J.DecoderConfig(**{**CFG.as_dict(), "dtype": jnp.float32})
PROMPTS = ["Who founded Nexus Labs?", "Aurora Lane recorded Blue Horizon."]


def lm_batch(seed, b=4, s=48):
    """Right-padded (prompt, completion) rows: ids (B, S) int32 and the
    loss mask on the completion's bytes, as train_note_lm encodes them."""
    rng = np.random.default_rng(seed)
    ids = np.full((b, s), T.PAD_ID, np.int32)
    w = np.zeros((b, s), np.float32)
    for i in range(b):
        n_p, n_c = int(rng.integers(4, 20)), int(rng.integers(2, 20))
        seq = ([T.BOS_ID] + list(rng.integers(T._BYTE0 + 32, T._BYTE0 + 127, n_p - 1))
               + list(rng.integers(T._BYTE0 + 32, T._BYTE0 + 127, n_c - 1)) + [T.EOS_ID])
        ids[i, :len(seq)] = seq
        w[i, n_p:len(seq)] = 1.0
    return {"ids": ids, "loss_mask": w}


def carried(jparams):
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), CFG, "cpu")
    return params.requires_grad_(True)


def as_tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def assert_params_close(params, jparams, what, atol=1e-5):
    want = T.params_from_jax(jax.tree.map(np.asarray, jparams), CFG, "cpu").state_dict()
    for name, p in params.state_dict().items():
        torch.testing.assert_close(p, want[name], rtol=0, atol=atol, msg=f"{what} {name}")


@pytest.mark.parametrize("seed", [0, 1])
def test_lm_loss_and_gradients_equal_the_reference(seed):
    jparams = J.init_params(jax.random.PRNGKey(seed), JCFG)
    batch = lm_batch(seed)
    loss, jgrads = jax.value_and_grad(lambda p: J.lm_loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, JCFG))(jparams)
    params = carried(jparams)
    got = T.lm_loss(params, as_tensors(batch), CFG)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    want = T.params_from_jax(jax.tree.map(np.asarray, jgrads), CFG, "cpu").state_dict()
    for name, p in params.named_parameters():
        torch.testing.assert_close(p.grad, want[name], rtol=0, atol=1e-5, msg=name)


def test_lm_loss_weighs_only_the_masked_predictions():
    params = T.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    batch = as_tensors(lm_batch(3))
    empty = {**batch, "loss_mask": torch.zeros_like(batch["loss_mask"])}
    assert T.lm_loss(params, empty, CFG).item() == 0.0      # sum 0 over max(0, 1)
    assert not any(p.requires_grad for p in params.parameters())


def test_five_steps_under_clip_and_a_warmup_cosine_schedule_equal_optax():
    """chain(clip_by_global_norm(1.0), adamw(warmup_cosine_decay_schedule(
    0, 3e-3, 2, 5, 1.5e-4))) against make_train_step(..., clip=...), at
    train_note_lm's default peak rate: the first step runs at lr 0 (the
    parameters do not move), the clip bites at least once."""
    jparams = J.init_params(jax.random.PRNGKey(2), JCFG)
    jsched = optax.warmup_cosine_decay_schedule(0.0, 3e-3, 2, 5, 1.5e-4)
    jopt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(jsched))
    jstate = jopt.init(jparams)
    jstep = jax.jit(J.make_train_step(JCFG, jopt))
    params = carried(jparams)
    before = {k: v.clone() for k, v in params.state_dict().items()}
    sched = optim.warmup_cosine_decay_schedule(0.0, 3e-3, 2, 5, 1.5e-4)
    step = T.make_train_step(CFG, optim.adamw(params.parameters(), sched),
                             clip=optim.clip_by_global_norm(1.0))
    norms = []
    for i in range(5):
        batch = lm_batch(10 + i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jgrads = jax.grad(lambda p: J.lm_loss(p, jb, JCFG))(jparams)
        norms.append(float(optax.global_norm(jgrads)))
        jparams, jstate, jloss = jstep(jparams, jstate, jb)
        _, _, loss = step(params, None, as_tensors(batch))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        assert_params_close(params, jparams, f"step {i}")
        if i == 0:
            for name, p in params.state_dict().items():
                assert torch.equal(p, before[name]), name
    assert max(norms) >= 1.0, norms          # the clip bit
    assert all(p.dtype == torch.float32 for p in params.parameters())


def test_greedy_tokens_after_training_equal_the_reference():
    """Ten adamw(1e-2) steps in both packages, then the greedy bytes of the
    trained models, each row up to a reference top-2 margin under MARGIN."""
    jparams = J.init_params(jax.random.PRNGKey(4), JCFG)
    jopt = optax.adamw(1e-2)
    jstate = jopt.init(jparams)
    jstep = jax.jit(J.make_train_step(JCFG, jopt))
    params = carried(jparams)
    step = T.make_train_step(CFG, optim.adamw(params.parameters(), 1e-2))
    losses = []
    for i in range(10):
        batch = lm_batch(20 + i % 2)
        jparams, jstate, jloss = jstep(jparams, jstate,
                                       {k: jnp.asarray(v) for k, v in batch.items()})
        _, _, loss = step(params, None, as_tensors(batch))
        losses.append((loss.item(), float(jloss)))
    np.testing.assert_allclose(*zip(*losses), rtol=1e-4)
    assert losses[-1][0] < losses[0][0]
    params.requires_grad_(False)
    steps = 24
    lm = T.DecoderLM(params, CFG, prompt_bucket=256)
    ids, pad_lens = lm.encode_batch(PROMPTS)
    got = T.generate(params, torch.from_numpy(ids), torch.from_numpy(pad_lens), CFG,
                     steps).numpy()
    want, margins = _greedy(jparams, ids, pad_lens, steps)
    for row in range(len(PROMPTS)):
        low = np.nonzero(margins[row] < MARGIN)[0]
        upto = int(low[0]) if low.size else steps
        assert upto >= 16, f"row {row}: a near tie at step {upto}"
        np.testing.assert_array_equal(got[row, :upto], want[row, :upto])


def _greedy(jparams, ids, pad_lens, steps):
    """The reference's greedy bytes (PAD from a row's EOS on) and the top-2
    margins of its picks, step by step."""
    jl, cache = J._prefill(jparams, jnp.asarray(ids), jnp.asarray(pad_lens), JCFG)
    dec = jax.jit(J._decode_step, static_argnums=(5,))
    emitted, margins = [], []
    done = np.zeros(len(ids), bool)
    for i in range(steps):
        masked = np.asarray(J._mask_unused(jl))
        top2 = np.sort(masked, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = masked.argmax(-1).astype(np.int32)
        done |= tok == T.EOS_ID
        emit = np.where(done, T.PAD_ID, tok).astype(np.int32)
        emitted.append(emit)
        jl, cache = dec(jparams, jnp.asarray(emit), jnp.asarray(ids.shape[1] + i),
                        jnp.asarray(pad_lens), cache, JCFG)
    return np.stack(emitted, 1), np.stack(margins, 1)


def test_save_lm_after_training_loads_in_both_packages(tmp_path):
    params = T.init_params(CFG, torch.Generator().manual_seed(1), "cpu").requires_grad_(True)
    step = T.make_train_step(CFG, optim.adamw(params.parameters(), 1e-2),
                             clip=optim.clip_by_global_norm(1.0))
    step(params, None, as_tensors(lm_batch(5)))
    T.save_lm(tmp_path / "lm", params, CFG)
    jp, jc = J.load_lm(tmp_path / "lm")
    tp, tc = T.load_lm(tmp_path / "lm", device="cpu")
    assert tc == CFG and jc.as_dict() == CFG.as_dict()
    for name, p in tp.state_dict().items():
        assert torch.equal(p, params.state_dict()[name]), name
    assert_params_close(tp, jp, "reference's load_lm", atol=0)
