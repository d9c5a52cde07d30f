"""The port's encoder training (anorag_tpu_torch/models/encoder.py's
info_nce_loss and make_train_step, models/train.py, training/optim.py's
adamw and schedules) against anorag_tpu's on the CPU: the same numpy
batches, the JAX parameters carried across with params_from_jax.

Tolerances: in f32 the loss to rtol 1e-5 and the gradients to atol 1e-5;
in bf16, and with f32 masters and bf16 compute, the loss to rtol 2e-2 and
the gradients, taken as one vector, to a relative norm of 2e-2 (the two
packages round bf16 matmuls and sums at other points; the key bias's
gradient, zero in exact arithmetic, is rounding alone); parameters after
adamw steps to atol 1e-5; the trainer's loss histories to rtol 1e-4.
"""
import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from anorag_tpu.models import encoder as jenc
from anorag_tpu.models import train as jtrain
from anorag_tpu.models.tokenizer import HashTokenizer as JHashTokenizer
from anorag_tpu_torch.models import encoder as tenc
from anorag_tpu_torch.models import train as ttrain
from anorag_tpu_torch.models.embedding_manager import EmbeddingManager
from anorag_tpu_torch.models.tokenizer import HashTokenizer
from anorag_tpu_torch.training import optim

CPU = torch.device("cpu")
MODES = {   # name: (reference's dtype fields, the port's)
    "f32": (dict(dtype=jnp.float32), dict(dtype=torch.float32)),
    "bf16": (dict(dtype=jnp.bfloat16), dict(dtype=torch.bfloat16)),
    "masters": (dict(dtype=jnp.bfloat16, param_dtype=jnp.float32),
                dict(dtype=torch.bfloat16, param_dtype=torch.float32)),
}


def port_cfg(jcfg, **kw) -> tenc.EncoderConfig:
    fields = dict(vocab_size=jcfg.vocab_size, hidden_size=jcfg.hidden_size,
                  num_layers=jcfg.num_layers, num_heads=jcfg.num_heads,
                  intermediate_size=jcfg.intermediate_size,
                  max_position=jcfg.max_position, pooling=jcfg.pooling,
                  remat=jcfg.remat)
    return tenc.EncoderConfig(**{**fields, **kw})


def carried(jparams, cfg) -> tenc.Encoder:
    """An Encoder on the CPU holding the reference's parameters, taking
    gradients."""
    model = tenc.Encoder(cfg, CPU)
    model.load_state_dict(tenc.params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return model.requires_grad_(True)


def pair_batch(vocab, seed, b=6, s=20):
    rng = np.random.default_rng(seed)
    out = {}
    for side in "qp":
        ids = rng.integers(3, vocab, (b, s)).astype(np.int32)
        lens = rng.integers(2, s + 1, b)
        mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
        out[f"{side}_ids"] = np.where(mask > 0, ids, 2).astype(np.int32)
        out[f"{side}_mask"] = mask
    return out


def tensors(batch):
    return {k: torch.from_numpy(v).long() if k.endswith("ids") else torch.from_numpy(v)
            for k, v in batch.items()}


def grads_as_state(jgrads, cfg):
    """The reference's gradient tree as the port's state dict, in f32."""
    f32 = dataclasses.replace(cfg, dtype=torch.float32, param_dtype=None)
    return tenc.params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), jgrads),
                                f32)


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("pooling", ["cls", "mean"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_info_nce_loss_and_gradients_equal_the_reference(mode, pooling):
    jkw, tkw = MODES[mode]
    jcfg = dataclasses.replace(jenc.EncoderConfig.small(), pooling=pooling, **jkw)
    jparams = jenc.init_params(jax.random.PRNGKey(1), jcfg)
    batch = pair_batch(jcfg.vocab_size, seed=2)
    loss, jgrads = jax.value_and_grad(lambda p: jenc.info_nce_loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg))(jparams)
    cfg = port_cfg(jcfg, **tkw)
    model = carried(jparams, cfg)
    got = tenc.info_nce_loss(model, tensors(batch), cfg)
    got.backward()
    want = grads_as_state(jgrads, cfg)
    assert {n for n, _ in model.named_parameters()} == set(want)
    if mode == "f32":
        np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
        for name, p in model.named_parameters():
            torch.testing.assert_close(p.grad, want[name], rtol=0, atol=1e-5, msg=name)
        return
    np.testing.assert_allclose(got.item(), float(loss), rtol=2e-2)
    for name, p in model.named_parameters():
        assert p.grad.dtype == p.dtype, name       # into the masters in their dtype
    diff = torch.cat([(p.grad.float() - want[n]).flatten()
                      for n, p in model.named_parameters()])
    ref = torch.cat([want[n].flatten() for n, _ in model.named_parameters()])
    assert float(diff.norm() / ref.norm()) < 2e-2


def test_masters_take_f32_and_cast_every_parameter_at_entry():
    """f32 masters: the parameters are f32 (layer norms too) and the
    forward equals the bf16 model holding the same weights rounded, as the
    reference's encode casts its whole tree."""
    cfg = dataclasses.replace(tenc.EncoderConfig.small(), dtype=torch.bfloat16,
                              param_dtype=torch.float32)
    masters = tenc.Encoder(cfg, CPU).init_random(torch.Generator().manual_seed(0))
    assert cfg.masters and all(p.dtype == torch.float32 for p in masters.parameters())
    with torch.no_grad():
        masters.emb_ln_scale.add_(0.001)      # not representable in bf16
    bf16_cfg = dataclasses.replace(cfg, param_dtype=None)
    rounded = tenc.Encoder(bf16_cfg, CPU)
    rounded.load_state_dict({k: v.to(torch.bfloat16) for k, v in masters.state_dict().items()})
    rounded.emb_ln_scale.data = masters.emb_ln_scale.to(torch.bfloat16).float()
    b = tensors(pair_batch(cfg.vocab_size, seed=3))
    with torch.no_grad():
        assert torch.equal(masters(b["q_ids"], b["q_mask"]), rounded(b["q_ids"], b["q_mask"]))


@pytest.mark.parametrize("mode", ["f32", "masters"])
def test_remat_gives_the_loss_and_gradients_of_no_remat(mode):
    cfg = dataclasses.replace(tenc.EncoderConfig.small(), pooling="mean", **MODES[mode][1])
    b = tensors(pair_batch(cfg.vocab_size, seed=4))
    grads = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = tenc.Encoder(c, CPU).init_random(torch.Generator().manual_seed(5))
        model.requires_grad_(True)
        loss = tenc.info_nce_loss(model, b, c)
        loss.backward()
        grads.append((loss.item(), {n: p.grad for n, p in model.named_parameters()}))
    (l0, g0), (l1, g1) = grads
    assert l0 == l1
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


# ------------------------------------------------------------ optimizer
def _rates(rate):
    if rate == "float":
        return 3e-3, 3e-3
    return optax.linear_schedule(0.0, 3e-3, 2), optim.linear_schedule(0.0, 3e-3, 2)


@pytest.mark.parametrize("rate", ["float", "linear_schedule"])
def test_three_train_steps_equal_optax_adamw(rate):
    """make_train_step against the reference's under optax.adamw: the loss
    to rtol 1e-5 and the parameters to atol 1e-5, but for the elements
    whose gradient in the reference was below 1e-6 but not zero in both at
    some step (the key bias's gradient is zero in exact arithmetic; the
    rows of tokens no batch holds get exact zeros). Adam divides a gradient
    by its own size plus 1e-8, so there the two packages' rounding noise
    (about 1e-10) moves an element by up to lr a step; those elements are
    fewer than 1% and within 2 lr a step of the reference's."""
    jcfg = dataclasses.replace(jenc.EncoderConfig.small(), dtype=jnp.float32)
    jparams = jenc.init_params(jax.random.PRNGKey(6), jcfg)
    jlr, lr = _rates(rate)
    jopt = optax.adamw(jlr, weight_decay=0.01)
    jstep = jax.jit(jenc.make_train_step(jcfg, jopt))
    jstate = jopt.init(jparams)
    cfg = port_cfg(jcfg, dtype=torch.float32)
    model = carried(jparams, cfg)
    step = tenc.make_train_step(cfg, optim.adamw(model.parameters(), lr, weight_decay=0.01))
    noise = {n: torch.zeros(p.shape, dtype=torch.bool) for n, p in model.named_parameters()}
    for i in range(3):
        batch = {k: jnp.asarray(v) for k, v in pair_batch(jcfg.vocab_size, seed=10 + i).items()}
        jgrads = jax.grad(lambda p: jenc.info_nce_loss(p, batch, jcfg))(jparams)
        jparams, jstate, jloss = jstep(jparams, jstate, batch)
        _, _, loss = step(model, None, tensors({k: np.array(v) for k, v in batch.items()}))
        for name, g in grads_as_state(jgrads, cfg).items():
            mine = dict(model.named_parameters())[name].grad
            noise[name] |= (g.abs() < 1e-6) & ((g != 0) | (mine != 0))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        want = tenc.params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
        for name, p in model.named_parameters():
            diff = (p.detach() - want[name]).abs()
            kept = diff[~noise[name]]
            assert kept.numel() == 0 or float(kept.max()) <= 1e-5, (i, name)
            assert float(diff.max()) <= 2 * 3e-3 * (i + 1), (i, name)
    n_noise = sum(int(m.sum()) for m in noise.values())
    assert n_noise < 0.01 * sum(m.numel() for m in noise.values())


@pytest.mark.parametrize("rate", ["float", "linear_schedule"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_adamw_updates_equal_optax_on_the_same_gradients(rate, dtype):
    """Three updates from the same gradients, weight decay 0.01: the
    parameters to atol 1e-6 in f32 (one bf16 rounding in bf16, where both
    keep the moments in the parameter's dtype)."""
    rng = np.random.default_rng(8)
    shapes = ((4, 3), (7,), (2, 2, 2))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jparams = [jnp.asarray(a, jdt) for a in init]
    params = [torch.nn.Parameter(torch.from_numpy(a).to(dtype)) for a in init]
    jlr, lr = _rates(rate)
    jopt = optax.adamw(jlr, weight_decay=0.01)
    jstate = jopt.init(jparams)
    opt = optim.adamw(params, lr, weight_decay=0.01)
    for i in range(3):
        grads = [(rng.standard_normal(s) * 10.0 ** (i - 1)).astype(np.float32) for s in shapes]
        updates, jstate = jopt.update([jnp.asarray(g, jdt) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g).to(dtype)
        opt.step()
        for p, w in zip(params, jparams):
            assert p.dtype == dtype
            np.testing.assert_allclose(p.detach().float().numpy(),
                                       np.asarray(w, np.float32),
                                       rtol=0, atol=1e-6 if dtype == torch.float32 else 2e-2)


def test_adamw_defaults_are_optaxs():
    p = torch.nn.Parameter(torch.ones(3))
    opt = optim.adamw([p], 1e-3)
    group = opt.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == ((0.9, 0.999), 1e-8, 1e-4)


def test_a_warmup_from_zero_moves_nothing_on_the_first_step():
    p = torch.nn.Parameter(torch.arange(4.0))
    opt = optim.adamw([p], optim.linear_schedule(0.0, 1e-2, 3), weight_decay=0.5)
    p.grad = torch.ones(4)
    opt.step()
    assert torch.equal(p.detach(), torch.arange(4.0))
    p.grad = torch.ones(4)
    opt.step()
    assert not torch.equal(p.detach(), torch.arange(4.0))
    assert opt.count == 2 and opt.param_groups[0]["lr"] == optim.linear_schedule(0.0, 1e-2, 3)(1)


@pytest.mark.parametrize("args", [(0.0, 3e-3, 5, 0), (1.0, 0.1, 4, 2), (0.5, 0.5, 0, 0),
                                  (2.0, 0.0, 7, -3)])
def test_linear_schedule_equals_optax(args):
    want, got = optax.linear_schedule(*args), optim.linear_schedule(*args)
    for count in range(12):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("args", [(0.0, 3e-3, 5, 30, 1.5e-4), (1e-4, 1e-2, 1, 6, 0.0),
                                  (0.0, 1.0, 3, 10, 0.2, 2.0), (0.0, 0.0, 2, 5, 0.0)])
def test_warmup_cosine_decay_schedule_equals_optax(args):
    want = optax.warmup_cosine_decay_schedule(*args)
    got = optim.warmup_cosine_decay_schedule(*args)
    for count in range(40):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("scale", [0.1, 1.0, 30.0])
def test_clip_by_global_norm_equals_optax(scale):
    rng = np.random.default_rng(7)
    grads = [(rng.standard_normal(s) * scale).astype(np.float32) for s in ((3, 4), (5,), (2, 2))]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    optim.clip_by_global_norm(1.0)(params)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_clip_leaves_a_norm_below_the_limit_alone():
    p = torch.nn.Parameter(torch.zeros(2))
    p.grad = torch.tensor([0.3, 0.4])
    optim.clip_by_global_norm(1.0)([p])
    assert torch.equal(p.grad, torch.tensor([0.3, 0.4]))


# -------------------------------------------------------------- trainer
def _pairs(n=40, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(300)]
    return [(" ".join(rng.choice(words, 4)), " ".join(rng.choice(words, 12)))
            for _ in range(n)]


@pytest.mark.parametrize("max_length", [16, 64, 200])
def test_make_pair_batches_equal_the_reference(max_length):
    pairs = _pairs(23, seed=1)
    for seed in (0, 3):
        want = list(jtrain.make_pair_batches(pairs, JHashTokenizer(1024, 128), 5,
                                             max_length, seed=seed))
        got = list(ttrain.make_pair_batches(pairs, HashTokenizer(1024, 128), 5,
                                            max_length, seed=seed))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_pairs_from_notes_equal_the_reference():
    notes = [{"title": "T0", "entities": ["a", "b", "c", "d"], "content": "x y"},
             {"title": "", "entities": [], "content": "only content"},
             {"title": "T2", "text": "from text", "entities": [3, None]},
             {"title": "T3", "content": ""},
             {"entities": ["E"], "content": "z"}]
    assert ttrain.pairs_from_notes(notes) == jtrain.pairs_from_notes(notes)


def test_encoder_trainer_histories_equal_the_reference():
    """Two epochs over 40 pairs at batch 8 (10 steps), from the
    reference's initial parameters, f32 and adamw(1e-3, 0.01)."""
    jcfg = dataclasses.replace(jenc.EncoderConfig.small(), dtype=jnp.float32)
    pairs = _pairs(40)
    jt = jtrain.EncoderTrainer(cfg=jcfg, learning_rate=1e-3, seed=3)
    jparams = jt.params
    want = jt.train(pairs, epochs=2, batch_size=8, max_length=32)
    cfg = port_cfg(jcfg, dtype=torch.float32)
    tt = ttrain.EncoderTrainer(cfg=cfg, learning_rate=1e-3, seed=3, device="cpu")
    tt.model.load_state_dict(tenc.params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    got = tt.train(pairs, epochs=2, batch_size=8, max_length=32)
    assert len(got) == len(want) == 10 and got is tt.history
    assert all(isinstance(x, float) for x in got)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_encoder_trainer_defaults_and_log_line(caplog):
    tt = ttrain.EncoderTrainer(device="cpu")
    assert tt.cfg == tenc.EncoderConfig.small()
    group = tt.optimizer.param_groups[0]
    assert (group["lr"], group["weight_decay"]) == (1e-4, 0.01)
    assert all(p.requires_grad for p in tt.model.parameters())
    with caplog.at_level("INFO", logger="anorag.train"):
        hist = tt.train(_pairs(16), batch_size=4, max_length=16, log_every=2)
    assert len(hist) == 4 and np.isfinite(hist).all()
    lines = [r.getMessage() for r in caplog.records if r.name == "anorag.train"]
    assert len(lines) == 2 and lines[0].startswith("step 2 loss ")
    assert lines[0].endswith("steps/s)")


def test_device_cpu_alone_clamps_model_parallel_to_one():
    """Given one device, model_parallel 2 raises nothing: the trainer's mesh
    over that device clamps to (1, 1), as the reference's on one chip, and
    the first steps equal model_parallel 1's."""
    one = ttrain.EncoderTrainer(device="cpu")
    two = ttrain.EncoderTrainer(model_parallel=2, device="cpu")
    assert two.mesh.shape == one.mesh.shape == {"data": 1, "model": 1}
    assert two.mesh.distinct_devices() == [CPU]
    pairs = _pairs(16)
    assert two.train(pairs, batch_size=8, max_length=16) == one.train(
        pairs, batch_size=8, max_length=16)


def test_trainer_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.EncoderTrainer()


def test_checkpoint_round_trip_through_embedding_checkpoint_path(tmp_path):
    """save_checkpoint's file, named as embedding.checkpoint_path, gives the
    trainer's embeddings; restore_checkpoint reads it back; an unreadable
    path returns False in both directions."""
    cfg = dataclasses.replace(tenc.EncoderConfig.small(), pooling="mean")
    tt = ttrain.EncoderTrainer(cfg=cfg, learning_rate=1e-3, device="cpu")
    tt.train(_pairs(16), batch_size=8, max_length=32)
    path = tmp_path / "enc" / "encoder.pt"
    assert tt.save_checkpoint(path)
    em = EmbeddingManager({"embedding": {"backend": "torch", "model_name": "",
                                         "max_length": 128,
                                         "checkpoint_path": str(path)},
                           "encoder": {"vocab_size": cfg.vocab_size,
                                       "hidden_size": cfg.hidden_size,
                                       "num_layers": cfg.num_layers,
                                       "num_heads": cfg.num_heads,
                                       "intermediate_size": cfg.intermediate_size,
                                       "max_position": cfg.max_position,
                                       "pooling": "mean"}}, device="cpu")
    texts = ["alpha beta", "w1 w2 w3 w4", "gamma"]
    got = em.encode_texts(texts)
    assert em.weights_source == f"seeded+checkpoint:{path}"
    ids, mask = HashTokenizer(cfg.vocab_size, 128).encode_batch(texts, 128)
    with torch.no_grad():
        want = tt.model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    other = ttrain.EncoderTrainer(cfg=cfg, seed=9, device="cpu")
    assert other.restore_checkpoint(path)
    for (n, a), b in zip(tt.model.state_dict().items(), other.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert not other.restore_checkpoint(tmp_path / "missing.pt")
    assert not tt.save_checkpoint(tmp_path / "enc" / "encoder.pt" / "under_a_file")
