"""Data- and tensor-parallel training over a mesh of several devices
(anorag_tpu_torch/parallel/tensor_parallel.py, models/encoder.py's
ShardedEncoder, models/decoder_lm.py's ShardedDecoder, models/train.py's
EncoderTrainer(devices=...), dryrun_multichip.py) against anorag_tpu's
GSPMD runs on its 8 virtual CPU devices (tests/conftest.py). The port's
meshes repeat the CPU, so each shard's body runs as it would on a device
of its own; the reference's initial parameters are carried across with
params_from_jax, the batches are the same numpy draws.

Tolerances, f32: the trainer's parameters after a step to atol 1e-5 (but
where Adam divides rounding noise by a gradient below 1e-6: 2 lr), its
10-step loss histories to rtol 1e-4 and final parameters to a relative
norm of 2e-2 of the update (see the test); the
decoder's loss and parameters after a step to 1e-5, the clipped gradients
to rtol 1e-5; greedy tokens equal. Each reference output is computed once
for the module.
"""
import contextlib
import dataclasses
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import __graft_entry__
from anorag_tpu.models import decoder_lm as jdlm
from anorag_tpu.models import encoder as jenc
from anorag_tpu.models import train as jtrain
from anorag_tpu.parallel import mesh as jmesh
from anorag_tpu_torch import dryrun_multichip as tdry
from anorag_tpu_torch.models import decoder_lm as tdlm
from anorag_tpu_torch.models import encoder as tenc
from anorag_tpu_torch.models import train as ttrain
from anorag_tpu_torch.models.embedding_manager import EmbeddingManager
from anorag_tpu_torch.models.tokenizer import HashTokenizer
from anorag_tpu_torch.parallel import tensor_parallel as tp
from anorag_tpu_torch.parallel.mesh import make_mesh
from anorag_tpu_torch.testing import _adam_noise_check
from anorag_tpu_torch.training import optim

from test_torch_train import _pairs, port_cfg

CPU = torch.device("cpu")
JCFG = dataclasses.replace(jenc.EncoderConfig.small(), dtype=jnp.float32)
CFG = port_cfg(JCFG, dtype=torch.float32)
MESHES = {(4, 2): 2, (8, 1): 1, (2, 4): 4}     # (data, model): model_parallel
PAIRS = _pairs(40)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's meshes run many small ops a step; on a loaded host (the
    suite's workers side by side) torch's thread pool spends more time
    waiting than computing, so this module runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def as_state(jparams, cfg=CFG):
    return tenc.params_from_jax(jax.tree.map(np.asarray, jparams), cfg)


@functools.lru_cache(maxsize=None)
def reference_run(model_parallel: int):
    """The reference's EncoderTrainer(model_parallel) over its 8 devices:
    (mesh shape, initial params, the first batch, the params after one step
    on it, the 10-step history, the final params)."""
    jt = jtrain.EncoderTrainer(cfg=JCFG, learning_rate=1e-3, model_parallel=model_parallel,
                               seed=3)
    start = jax.device_get(jt.params)
    first = next(jtrain.make_pair_batches(PAIRS, jtrain.HashTokenizer(1024, 128), 8, 32))
    one = jax.device_get(jt._step(jt.params, jt.opt_state, jt._shard_batch(first))[0])
    hist = jt.train(PAIRS, epochs=2, batch_size=8, max_length=32)
    return dict(jt.mesh.shape), start, first, one, list(hist), jax.device_get(jt.params)


def port_trainer(model_parallel: int, n: int = 8, **kw) -> ttrain.EncoderTrainer:
    return ttrain.EncoderTrainer(cfg=kw.pop("cfg", CFG), learning_rate=1e-3,
                                 model_parallel=model_parallel, seed=kw.pop("seed", 3),
                                 devices=["cpu"] * n, **kw)


# ---------------------------------------------------------------- the trainer
@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: f"{s[0]}x{s[1]}")
def test_trainer_on_a_mesh_equals_the_reference(shape):
    """One step: the parameters to atol 1e-5 (testing._adam_noise_check:
    where the gradient is below 1e-6, Adam's first step is about lr times
    its sign, which rounding flips, so those within 2 lr). Ten steps: the
    loss history to rtol 1e-4, and the final parameters within 2e-2 of the
    ten steps' update as a relative norm (that noise spreads over the
    steps: the reference's own runs at model_parallel 1, 2 and 4 end up to
    8.3e-3 apart on this measure, 1.9e-3 at most in an element)."""
    mp = MESHES[shape]
    want_mesh, start, first, one, want, final = reference_run(mp)
    tt = port_trainer(mp)
    assert tt.mesh.shape == want_mesh == {"data": shape[0], "model": shape[1]}
    assert tt.mesh.distinct_devices() == [CPU]
    assert isinstance(tt.params, tenc.ShardedEncoder)
    start = as_state(start)
    tt.params.load_state_dict(start)
    tt._step(tt.params, None, tt._tensors(first))
    grads = tt.params.grad_dict()
    one = as_state(one)
    for name, t in tt.state_dict().items():
        _adam_noise_check(name, t, one[name], grads[name], 1e-3, 1e-5)
    tt = port_trainer(mp)
    tt.params.load_state_dict(start)
    got = tt.train(PAIRS, epochs=2, batch_size=8, max_length=32)
    assert len(got) == len(want) == 10
    np.testing.assert_allclose(got, want, rtol=1e-4)
    final, got = as_state(final), tt.state_dict()
    diff = torch.cat([(got[n] - final[n]).flatten() for n in final])
    update = torch.cat([(final[n] - start[n]).flatten() for n in final])
    assert float(diff.norm() / update.norm()) <= 2e-2


def test_trainer_without_devices_trains_on_one_device(monkeypatch):
    """No device and no devices: the mesh is the one card, not every
    visible card as the reference's make_mesh() would take (a mesh over
    several cards is opt-in: slower than one card on this route);
    visible_devices, which --devices and the dry run use, takes the cards
    in turn (cards stood in for by a count; no tensor is made on them)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    from anorag_tpu_torch.parallel import mesh as tmesh

    class Placed(Exception):
        pass

    def make_mesh(model_parallel, devices):
        raise Placed(devices)

    monkeypatch.setattr(ttrain, "make_mesh", make_mesh)
    with pytest.raises(Placed) as placed:
        ttrain.EncoderTrainer(model_parallel=2)
    assert placed.value.args[0] == [torch.device("cuda")]
    assert tmesh.visible_devices() == [torch.device("cuda", i) for i in range(4)]
    assert tmesh.visible_devices("cpu", 3) == [CPU] * 3
    assert tmesh.visible_devices(None, 6)[4:] == [torch.device("cuda", 0),
                                                  torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="not both"):
        ttrain.EncoderTrainer(device="cpu", devices=["cpu"])


def test_a_cuda_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.EncoderTrainer(devices=["cpu", "cuda"])


def test_global_info_nce_is_not_the_mean_of_per_shard_losses():
    """The in-batch negatives span the whole batch (the reference's loss on
    the full batch), not each data row's part of it."""
    start = reference_run(2)[1]
    rng = np.random.default_rng(5)
    batch = {}
    for side in "qp":
        batch[f"{side}_ids"] = rng.integers(3, JCFG.vocab_size, (8, 16)).astype(np.int32)
        batch[f"{side}_mask"] = np.ones((8, 16), np.int32)
    loss = jax.jit(lambda p, b: jenc.info_nce_loss(p, b, JCFG))
    params = jax.tree.map(jnp.asarray, start)
    want = float(loss(params, {k: jnp.asarray(v) for k, v in batch.items()}))
    per_shard = np.mean([float(loss(params, {k: jnp.asarray(v[i:i + 2])
                                             for k, v in batch.items()}))
                         for i in range(0, 8, 2)])
    sharded = tenc.ShardedEncoder(as_state(start), CFG, make_mesh(model_parallel=2,
                                                                   devices=["cpu"] * 8))
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    with torch.no_grad():
        got = float(tenc.info_nce_loss(sharded, tb, CFG))
    assert abs(got - want) < 1e-5 * abs(want)
    assert abs(per_shard - want) > 0.1


@pytest.mark.parametrize("vocab,model_parallel", [(10, 4), (12, 4), (10, 2), (1024, 8)])
def test_uneven_parameter_splits_raise_where_the_reference_raises(vocab, model_parallel):
    """Vocabulary (and heads, FFN width) over 'model': ValueError exactly
    where jax.device_put raises. XLM-R's 250,002 at model_parallel 4 is
    such a case (250,002 = 2 x 125,001)."""
    jcfg = dataclasses.replace(JCFG, vocab_size=vocab)
    try:
        jtrain.EncoderTrainer(cfg=jcfg, model_parallel=model_parallel)
        raised = False
    except ValueError:
        raised = True
    cfg = port_cfg(jcfg, dtype=torch.float32)
    if raised:
        with pytest.raises(ValueError, match="should be divisible"):
            port_trainer(model_parallel, cfg=cfg)
    else:
        assert port_trainer(model_parallel, cfg=cfg).mesh.shape["model"] == model_parallel
    assert raised == (vocab % model_parallel != 0 or JCFG.num_heads % model_parallel != 0)
    with pytest.raises(ValueError, match=r"tok_emb of shape \(250002, 8\)"):
        tp.ShardedParams({"tok_emb": torch.zeros(250002, 8)}, {"tok_emb": 0},
                         make_mesh(model_parallel=4, devices=["cpu"] * 4))


@pytest.mark.parametrize("batch,model_parallel", [(7, 4), (8, 4), (6, 1), (8, 1)])
def test_uneven_batch_splits_raise_where_the_reference_raises(batch, model_parallel):
    """A batch over 'data' (2 rows at model_parallel 4, 8 at 1)."""
    pairs = _pairs(batch)
    jt = jtrain.EncoderTrainer(cfg=JCFG, model_parallel=model_parallel)
    first = next(jtrain.make_pair_batches(pairs, jtrain.HashTokenizer(1024, 128), batch, 16))
    try:
        jt._shard_batch(first)
        raised = False
    except ValueError:
        raised = True
    assert raised == (batch % (8 // model_parallel) != 0)
    tt = port_trainer(model_parallel)
    if raised:
        with pytest.raises(ValueError, match=r"q_ids of shape \(%d, " % batch):
            tt.train(pairs, batch_size=batch, max_length=16)
    else:
        assert len(tt.train(pairs, batch_size=batch, max_length=16)) == 1


def test_checkpoint_of_a_sharded_trainer(tmp_path):
    """A (4, 2) trainer's checkpoint: read by EmbeddingManager.load_checkpoint
    with the trainer's embeddings, and by a (1, 1) and a (2, 4) trainer."""
    cfg = dataclasses.replace(CFG, pooling="mean")
    tt = port_trainer(2, cfg=cfg)
    tt.train(PAIRS[:16], batch_size=8, max_length=32)
    path = tmp_path / "enc" / "encoder.pt"
    assert tt.save_checkpoint(path)
    em = EmbeddingManager({"embedding": {"backend": "torch", "model_name": "",
                                         "max_length": 128},
                           "encoder": {"vocab_size": cfg.vocab_size,
                                       "hidden_size": cfg.hidden_size,
                                       "num_layers": cfg.num_layers,
                                       "num_heads": cfg.num_heads,
                                       "intermediate_size": cfg.intermediate_size,
                                       "max_position": cfg.max_position,
                                       "pooling": "mean", "dtype": "float32"}},
                          device="cpu")
    assert em.load_checkpoint(str(path))
    texts = ["alpha beta", "w1 w2 w3 w4", "gamma", "delta w7"]
    ids, mask = HashTokenizer(cfg.vocab_size, 128).encode_batch(texts, 128)
    with torch.no_grad():
        want = tt.params(torch.from_numpy(ids).long(), torch.from_numpy(mask))
        gathered = tt.model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    torch.testing.assert_close(em.encode_texts(texts), gathered, rtol=0, atol=0)
    torch.testing.assert_close(gathered, want, rtol=0, atol=1e-6)
    state = tt.state_dict()
    for other in (ttrain.EncoderTrainer(cfg=cfg, seed=9, device="cpu"),
                  port_trainer(4, cfg=cfg, seed=9)):
        assert other.restore_checkpoint(path)
        for name, t in other.state_dict().items():
            assert torch.equal(t, state[name]), name
    assert not port_trainer(4, cfg=dataclasses.replace(cfg, vocab_size=2048)
                            ).restore_checkpoint(path)


def test_two_runs_of_a_sharded_trainer_are_bit_equal():
    runs = []
    for _ in range(2):
        tt = port_trainer(2, cfg=dataclasses.replace(CFG, remat=True))
        hist = tt.train(PAIRS[:24], batch_size=8, max_length=32)
        runs.append((hist, tt.state_dict()))
    (h0, s0), (h1, s1) = runs
    assert h0 == h1
    for name in s0:
        assert torch.equal(s0[name], s1[name]), name


def test_the_masters_take_each_rows_gradient_once():
    """reduce_grads sums data row i's gradient onto the masters in row
    order, and clears the other rows'; broadcast_masters copies the
    masters out."""
    mesh = make_mesh(model_parallel=2, devices=["cpu"] * 6)
    sp = tp.ShardedParams({"w": torch.zeros(4, 2), "b": torch.zeros(3)},
                          {"w": 0, "b": None}, mesh)
    for i, row in enumerate(sp.rows):
        row.rep["b"].grad = torch.full((3,), 10.0 ** i)
        for j, t in enumerate(row.tables("w")):
            t.grad = torch.full((2, 2), 10.0 ** i + j)
    sp.reduce_grads()
    masters = sp.parameters()
    assert [tuple(m.shape) for m in masters] == [(2, 2), (2, 2), (3,)]
    assert masters[0].grad[0, 0] == 111 and masters[1].grad[0, 0] == 114
    assert masters[2].grad[0] == 111
    assert all(t.grad is None for row in sp.rows[1:] for t in sp._tensors(row))
    with torch.no_grad():
        masters[0].add_(1.0)
    sp.broadcast_masters()
    assert all(torch.equal(row.tables("w")[0], masters[0]) for row in sp.rows)
    assert torch.equal(sp.state_dict()["w"][:2], torch.ones(2, 2))


def test_split_axes_names_the_state_dicts():
    enc_axes = tp.split_axes(tenc.param_pspecs(CFG))
    assert list(enc_axes) == list(tenc.Encoder(CFG, CPU).state_dict())
    assert {k: v for k, v in enc_axes.items() if v is not None} == {
        "tok_emb": 0, **{f"layers.{i}.{n}": a for i in range(CFG.num_layers)
                         for n, a in (("qkv", 2), ("qkv_b", 1), ("attn_out", 0),
                                      ("ffn_in", 1), ("ffn_in_b", 0), ("ffn_out", 0))}}
    dcfg = tdlm.DecoderConfig.tiny()
    dec_axes = tp.split_axes(tdlm.param_pspecs(dcfg))
    assert set(dec_axes) == set(tdlm.DecoderParams(dcfg, CPU).state_dict())


# ---------------------------------------------------------------- the decoder
DCFG = tdlm.DecoderConfig(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                          max_len=128)
JDCFG = jdlm.DecoderConfig(**{**DCFG.as_dict(), "dtype": jnp.float32})


@functools.lru_cache(maxsize=None)
def decoder_reference():
    """The reference's dp x tp decoder step at (4, 2) with __graft_entry__'s
    shapes: (initial params, batch, loss, params after the step,
    gradients, greedy tokens of the stepped params on a sharded batch)."""
    mesh = jmesh.make_mesh(model_parallel=2)
    params = jdlm.init_params(jax.random.PRNGKey(1), JDCFG)
    start = jax.device_get(params)
    params = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params,
                          jdlm.param_pspecs(JDCFG), is_leaf=lambda x: isinstance(x, P))
    opt = optax.adamw(1e-4)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 259, (8, 48)).astype(np.int32)
    ids[:, 40:] = jdlm.PAD_ID
    w = np.ones((8, 48), np.float32)
    w[:, :20] = 0.0
    rows = NamedSharding(mesh, P(jmesh.DATA_AXIS, None))
    batch = {"ids": jax.device_put(jnp.asarray(ids), rows),
             "loss_mask": jax.device_put(jnp.asarray(w), rows)}
    grads = jax.grad(lambda p: jdlm.lm_loss(p, batch, JDCFG))(params)
    stepped, _, loss = jax.jit(jdlm.make_train_step(JDCFG, opt))(params, opt.init(params),
                                                                  batch)
    toks = jdlm.generate_fn(JDCFG, max_new=12)(
        stepped, batch["ids"][:, :32],
        jax.device_put(jnp.zeros((8,), jnp.int32), NamedSharding(mesh, P(jmesh.DATA_AXIS))),
        jax.random.PRNGKey(0))
    return (start, {"ids": ids, "loss_mask": w}, float(loss), jax.device_get(stepped),
            jax.device_get(grads), np.asarray(toks))


def decoder_state(jparams):
    return tdlm.params_from_jax(jax.tree.map(np.asarray, jparams), DCFG, "cpu").state_dict()


def sharded_decoder(jparams):
    return tdlm.ShardedDecoder(decoder_state(jparams), DCFG,
                               make_mesh(model_parallel=2, devices=["cpu"] * 8))


def test_decoder_dp_tp_step_equals_the_reference():
    start, batch, want_loss, stepped, _, _ = decoder_reference()
    params = sharded_decoder(start)
    step = tdlm.make_train_step(DCFG, optim.adamw(params.parameters(), 1e-4))
    _, _, loss = step(params, None, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - want_loss) <= 1e-5
    want = decoder_state(stepped)
    for name, t in params.state_dict().items():
        torch.testing.assert_close(t, want[name], rtol=0, atol=1e-5, msg=name)


def test_decoder_global_norm_clip_equals_optax():
    """The gradients summed onto the masters, clipped by the norm over
    every shard with each replicated parameter once, equal optax's clip of
    the reference's gradient tree (at a max norm below the norm and above
    it)."""
    start, batch, _, _, jgrads, _ = decoder_reference()
    norm = float(optax.global_norm(jgrads))
    for max_norm in (0.5 * norm, 2.0 * norm):
        tx = optax.clip_by_global_norm(max_norm)
        clipped, _ = tx.update(jgrads, tx.init(jgrads))
        want = decoder_state(clipped)
        params = sharded_decoder(start)
        loss = tdlm.lm_loss(params, {k: torch.from_numpy(v) for k, v in batch.items()}, DCFG)
        loss.backward()
        params.reduce_grads()
        optim.clip_by_global_norm(max_norm)(params.parameters())
        for name, t in params.grad_dict().items():
            torch.testing.assert_close(t, want[name], rtol=1e-5, atol=1e-7, msg=name)


def test_decoder_greedy_generation_on_sharded_params_equals_the_reference():
    _, batch, _, stepped, _, want = decoder_reference()
    params = sharded_decoder(stepped)
    ids = torch.from_numpy(batch["ids"][:, :32])
    got = tdlm.generate(params, ids, torch.zeros(8, dtype=torch.int32), DCFG, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    lm = tdlm.DecoderLM(params, DCFG, prompt_bucket=32)
    unsharded = tdlm.DecoderLM(params.to_params(), DCFG, prompt_bucket=32)
    prompts = ["Who founded Nexus Labs?", "Aurora Lane recorded", "x", "Blue Horizon"]
    assert lm.generate(prompts, max_new=10) == unsharded.generate(prompts, max_new=10)


# ---------------------------------------------------------------- the dry run
def test_dry_run_summary_equals_the_references():
    """The port's five parts over 8 CPU entries at the reference's shapes,
    its weights carried from the reference's keys 0 and 1, against the
    reference's dryrun_multichip(8) on its 8 devices."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        __graft_entry__.dryrun_multichip(8)
    want = [ln for ln in out.getvalue().splitlines() if ln.startswith("dryrun_multichip OK")]
    enc_cfg = jenc.EncoderConfig(**tdry.ENCODER)
    enc_state = tenc.params_from_jax(
        jax.tree.map(np.asarray, jenc.init_params(jax.random.PRNGKey(0), enc_cfg)),
        tenc.EncoderConfig(**tdry.ENCODER))
    dcfg = jdlm.DecoderConfig(hidden_size=64, num_layers=2, num_heads=4,
                              intermediate_size=128, max_len=128)
    dec_state = tdlm.params_from_jax(
        jax.tree.map(np.asarray, jdlm.init_params(jax.random.PRNGKey(1), dcfg)),
        tdlm.DecoderConfig(hidden_size=64, num_layers=2, num_heads=4,
                           intermediate_size=128, max_len=128), "cpu").state_dict()
    fields = tdry.run(tdry.dryrun_mesh(8, "cpu"), enc_state, dec_state)
    got = tdry.summary(fields)
    assert len(want) == 1
    w, g = dict(_fields(want[0])), dict(_fields(got))
    assert g.keys() == w.keys()
    for key in w:
        if key == "loss":       # bf16, as the reference's (tests/test_torch_train.py)
            assert abs(float(g[key]) - float(w[key])) <= 2e-2 * float(w[key]), key
        elif key == "decoder_lm_loss":      # f32, printed to 4 places
            assert abs(float(g[key]) - float(w[key])) <= 2e-4, key
        else:
            assert g[key] == w[key], key


def _fields(line: str):
    """(name, value) of a summary line's name=value fields."""
    body = line.split(": ", 1)[1]
    names = [tok.split("=", 1)[0] for tok in body.split(" ") if "=" in tok
             and tok.split("=", 1)[0].isidentifier() and not tok.startswith("'")]
    for name, nxt in zip(names, names[1:] + [None]):
        start = body.index(name + "=") + len(name) + 1
        end = body.index(" " + nxt + "=") if nxt else len(body)
        yield name, body[start:end]


def test_dry_run_module_runs_on_repeated_cpu_entries(capsys):
    assert tdry.main(["--devices", "4", "--device", "cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("dryrun_multichip OK")]
    assert len(line) == 1 and "mesh={'data': 2, 'model': 2}" in line[0]
    assert tdry.main(["--devices", "3", "--device", "cpu"]) == 1


# ---------------------------------------------------------------- the CLIs
def test_training_clis_over_a_mesh_of_cpu_entries(tmp_path):
    """train_retrieval_encoder --devices 4 (data parallel, a (4, 1) mesh)
    and train_encoder --model-parallel 2 --devices 4 (a (2, 2) mesh): their
    checkpoints read by EmbeddingManager.load_checkpoint."""
    from anorag_tpu_torch import train_encoder, train_retrieval_encoder
    from anorag_tpu_torch.config import Config
    from anorag_tpu_torch.utils.file_io import write_json

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert train_retrieval_encoder.main([
            "--out", str(tmp_path / "enc.pt"), "--train-worlds", "10", "--eval-worlds", "4",
            "--steps", "2", "--batch", "16", "--hidden", "64", "--layers", "2", "--heads",
            "4", "--ffn", "128", "--vocab", "512", "--device", "cpu", "--devices", "4",
            "--f32-params", "--remat", "--warmup", "2"]) == 0
    report = json.loads(out.getvalue().splitlines()[-1])
    assert report["steps"] == 4 and report["checkpoint_saved"]
    enc_cfg = {"vocab_size": 512, "hidden_size": 64, "num_layers": 2, "num_heads": 4,
               "intermediate_size": 128, "max_position": 128, "pooling": "mean"}
    em = EmbeddingManager({"embedding": {"backend": "torch", "model_name": "",
                                         "max_length": 128}, "encoder": enc_cfg},
                          device="cpu")
    assert em.load_checkpoint(str(tmp_path / "enc.pt"))

    notes = [{"title": f"T{i}", "entities": [f"E{i % 7}", f"F{i % 5}"],
              "content": f"note {i} about E{i % 7} and F{i % 5} w{i % 11}"} for i in range(48)]
    write_json(tmp_path / "notes.json", notes)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert train_encoder.main([str(tmp_path / "notes.json"), "--small", "--batch-size",
                                   "16", "--model-parallel", "2", "--devices", "4",
                                   "--checkpoint", str(tmp_path / "e2.pt")],
                                  Config({"system": {"device": "cpu"}})) == 0
    assert "trained 3 steps" in out.getvalue() and "saved to" in out.getvalue()
    small = tenc.EncoderConfig.small()
    em = EmbeddingManager({"embedding": {"backend": "torch", "model_name": "",
                                         "max_length": 128},
                           "encoder": {f.name: getattr(small, f.name) for f in
                                       dataclasses.fields(small)
                                       if f.name in ("vocab_size", "hidden_size",
                                                     "num_layers", "num_heads",
                                                     "intermediate_size", "max_position")}},
                          device="cpu")
    assert em.load_checkpoint(str(tmp_path / "e2.pt"))
