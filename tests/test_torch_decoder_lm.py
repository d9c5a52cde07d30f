"""The port's decoder LM (anorag_tpu_torch/models/decoder_lm.py) and its
in-process provider against anorag_tpu's, on the CPU.

Both packages load the same checkpoints (checkpoints/note_lm_cpu_small:
3 layers, hidden 128; checkpoints/note_lm_tpu_large: 6 layers, hidden 384,
the width the card runs). forward, prefill and every decode step agree in
their logits to atol 1e-4 (f32 in both; matmul order differs). Greedy
tokens are held equal up to the first step where the reference's top-2
logit margin is under 1e-3, where an f32 rounding difference may flip the
argmax: the comparison stops there, and the tests check that at least 32
steps were compared. Also the batch pad (3 prompts run as 4), the prompt
buckets at 255/256/257 bytes, a prompt past max_prompt, left-pad rows
(finite, as the reference's uniform softmax gives them), the early stop,
the checkpoint files in both directions, params_from_jax, sampling with
an explicit generator, and the provider's texts against JaxLLMClient's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anorag_tpu.llm.jax_client import JaxLLMClient, render_prompt as j_render_prompt
from anorag_tpu.models import decoder_lm as J
from anorag_tpu_torch.llm.decoder_client import DecoderLLMClient, render_prompt
from anorag_tpu_torch.models import decoder_lm as T

from test_torch_llm import CKPT, ROOT

CHECKPOINTS = {"cpu_small": CKPT, "tpu_large": ROOT / "checkpoints" / "note_lm_tpu_large"}
ATOL = 1e-4
MARGIN = 1e-3
PROMPTS = [render_prompt("Who founded Nexus Labs?", "Answer the question."),
           render_prompt("Aurora Lane recorded Blue Horizon. Chris Reed married "
                         "Aurora Lane.", "Generate atomic notes."),
           "x",
           render_prompt('{"answer": "David Kim", "evidence_spans": [', None)]


@pytest.fixture(scope="module", params=sorted(CHECKPOINTS))
def pair(request):
    path = CHECKPOINTS[request.param]
    jp, jc = J.load_lm(path)
    tp, tc = T.load_lm(path, device="cpu")
    assert tc.as_dict() == jc.as_dict()
    return jp, tp, tc


def _close(got: torch.Tensor, want, what: str):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL,
                               err_msg=what)


def _encode(prompts, bucket=256, cfg=None):
    lm = T.DecoderLM(None, cfg or T.DecoderConfig(), prompt_bucket=bucket)
    return lm.encode_batch(prompts)


def test_byte_tokenizer_equals_the_reference():
    for s in ["hello", 'j1 {"a": [1, 2]} ~', "héllo wörld", "日本語", ""]:
        ids = T.ByteTokenizer().encode(s, add_bos=True, add_eos=True)
        assert ids == J.ByteTokenizer().encode(s, add_bos=True, add_eos=True)
        assert T.ByteTokenizer().decode(ids) == s


def test_forward_equals_the_reference(pair):
    jp, tp, cfg = pair
    ids, pad_lens = _encode(PROMPTS, cfg=cfg)
    mask = (ids != T.PAD_ID).astype(np.int32)
    want = J.forward(jp, jnp.asarray(ids), J.DecoderConfig(**{
        **cfg.as_dict(), "dtype": jnp.float32}), attn_mask=jnp.asarray(mask))
    got = T.forward(tp, torch.from_numpy(ids), cfg, attn_mask=torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    _close(got, want, "forward")


def _jcfg(cfg):
    return J.DecoderConfig(**{**cfg.as_dict(), "dtype": jnp.float32})


def _stepwise(jp, tp, cfg, prompts, steps):
    """Prefill and `steps` decode steps in both packages, each fed the
    token the reference's generator emits (its greedy pick; PAD from a
    row's EOS on, which is not emitted): the logits of every step compared. Returns the reference's
    emitted tokens (B, steps) and the top-2 margins of their picks."""
    jc = _jcfg(cfg)
    ids, pad_lens = _encode(prompts, cfg=cfg)
    jl, jcache = J._prefill(jp, jnp.asarray(ids), jnp.asarray(pad_lens), jc)
    tl, tcache = T._prefill(tp, torch.from_numpy(ids), torch.from_numpy(pad_lens), cfg)
    _close(tl, jl, "prefill logits")
    for (tk, tv), c in zip(tcache, jcache):
        _close(tk, c["k"], "prefill cache k")
        _close(tv, c["v"], "prefill cache v")
    dec = jax.jit(J._decode_step, static_argnums=(5,))
    pb = ids.shape[1]
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
        jl, jcache = dec(jp, jnp.asarray(emit), jnp.asarray(pb + i),
                         jnp.asarray(pad_lens), jcache, jc)
        tl = T._decode_step(tp, torch.from_numpy(emit), pb + i,
                            torch.from_numpy(pad_lens), tcache, cfg)
        assert torch.isfinite(tl).all()
        _close(tl, jl, f"decode step {i} logits")
    return np.stack(emitted, 1), np.stack(margins, 1)


def test_prefill_and_decode_steps_equal_the_reference(pair):
    jp, tp, cfg = pair
    _stepwise(jp, tp, cfg, PROMPTS, 8)


def test_greedy_tokens_and_texts_equal_the_reference(pair):
    """Each row's tokens are compared up to its first step whose top-2
    margin in the reference is under MARGIN (there an f32 rounding
    difference may pick the other byte), and that is at least 32 steps;
    the texts of rows with no such step are equal whole."""
    jp, tp, cfg = pair
    steps = 40
    want, margins = _stepwise(jp, tp, cfg, PROMPTS, steps)
    ids, pad_lens = _encode(PROMPTS, cfg=cfg)
    got = T.generate(tp, torch.from_numpy(ids), torch.from_numpy(pad_lens), cfg,
                     steps).numpy()
    texts = T.DecoderLM(tp, cfg, prompt_bucket=256).generate(PROMPTS, max_new=steps)
    want_texts = J.DecoderLM(jp, _jcfg(cfg), prompt_bucket=256).generate(
        PROMPTS, max_new=steps)
    for row in range(len(PROMPTS)):
        low = np.nonzero(margins[row] < MARGIN)[0]
        upto = int(low[0]) if low.size else steps
        assert upto >= 32, f"row {row}: a near tie at step {upto}"
        np.testing.assert_array_equal(got[row, :upto], want[row, :upto])
        if upto == steps:
            assert texts[row] == want_texts[row]


@pytest.mark.parametrize("n_bytes", [255, 256, 257, 1500])
def test_prompt_buckets_and_max_prompt_equal_the_reference(pair, n_bytes):
    """255 bytes + BOS fill the 256 bucket, 256 and 257 take 512; 1500
    bytes pass max_prompt (1024) and keep their last 1024 ids."""
    jp, tp, cfg = pair
    prompt = ("Elena Cortez sang Ghostly Meridian. " * 60)[:n_bytes - 1] + "?"
    ids, pad_lens = _encode([prompt], cfg=cfg)
    assert ids.shape[1] == {255: 256, 256: 512, 257: 512, 1500: 1024}[n_bytes]
    want = J.DecoderLM(jp, _jcfg(cfg), prompt_bucket=256).generate([prompt], max_new=12)
    assert T.DecoderLM(tp, cfg, prompt_bucket=256).generate([prompt], max_new=12) == want


def test_a_batch_of_three_runs_as_four_and_equals_the_reference(pair, monkeypatch):
    jp, tp, cfg = pair
    seen = []
    inner = T.generate
    monkeypatch.setattr(T, "generate", lambda p, ids, *a, **k: seen.append(ids.shape)
                        or inner(p, ids, *a, **k))
    prompts = PROMPTS[:3]
    got = T.DecoderLM(tp, cfg, prompt_bucket=256).generate(prompts, max_new=16)
    assert len(got) == 3 and seen[0][0] == 4
    assert got == J.DecoderLM(jp, _jcfg(cfg), prompt_bucket=256).generate(prompts,
                                                                          max_new=16)
    assert T.DecoderLM(tp, cfg, prompt_bucket=256).generate(PROMPTS[:1], max_new=16) \
        == got[:1]


def test_left_pad_rows_stay_finite(pair):
    """Pad positions have no allowed key: the additive f32-minimum mask
    gives them the reference's uniform softmax, never NaN."""
    jp, tp, cfg = pair
    ids, pad_lens = _encode(["a", "a longer prompt " * 10], cfg=cfg)
    assert pad_lens[0] > 200
    logits, cache = T._prefill(tp, torch.from_numpy(ids), torch.from_numpy(pad_lens), cfg)
    assert torch.isfinite(logits).all()
    assert all(torch.isfinite(k).all() and torch.isfinite(v).all() for k, v in cache)
    full = T.forward(tp, torch.from_numpy(ids), cfg,
                     attn_mask=torch.from_numpy(ids != T.PAD_ID))
    assert torch.isfinite(full).all()
    want = J.forward(jp, jnp.asarray(ids), _jcfg(cfg),
                     attn_mask=jnp.asarray(ids != T.PAD_ID).astype(jnp.int32))
    _close(full, want, "forward over left-pad rows")


def test_generation_stops_once_every_row_is_done(monkeypatch):
    """A model that emits EOS first: the texts are empty in both packages,
    and the port stops after its first check instead of running max_new
    steps."""
    jp, jc = J.load_lm(CKPT)
    np_params = jax.tree.map(np.array, jp)
    # the final layer norm emits a multiple of EOS's embedding, now the
    # longest row of the tied output projection: EOS wins every step
    np_params["tok_emb"][T.EOS_ID] *= 10.0
    np_params["final_ln"]["scale"][:] = 0.0
    np_params["final_ln"]["bias"][:] = np_params["tok_emb"][T.EOS_ID]
    cfg = T.DecoderConfig.from_config(jc.as_dict())
    tp = T.params_from_jax(np_params, cfg, "cpu")
    steps = []
    inner = T._decode_step
    monkeypatch.setattr(T, "_decode_step", lambda *a: steps.append(1) or inner(*a))
    got = T.DecoderLM(tp, cfg, prompt_bucket=256).generate(PROMPTS, max_new=200)
    want = J.DecoderLM(jax.tree.map(jnp.asarray, np_params), jc,
                       prompt_bucket=256).generate(PROMPTS, max_new=200)
    assert got == want == [""] * len(PROMPTS)
    assert len(steps) == T._DONE_EVERY


def test_checkpoint_files_cross_both_ways(tmp_path):
    cfg = T.DecoderConfig.tiny()
    tp = T.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    T.save_lm(tmp_path / "port", tp, cfg)
    jp, jc = J.load_lm(tmp_path / "port")
    assert jc.as_dict() == cfg.as_dict()
    ids = np.array([[1, 10, 20, 30, 40, 50]], np.int32)
    _close(T.forward(tp, torch.from_numpy(ids), cfg), J.forward(jp, jnp.asarray(ids), jc),
           "the port's checkpoint in the reference")
    jp2 = J.init_params(jax.random.PRNGKey(1), jc)
    J.save_lm(tmp_path / "ref", jp2, jc)
    tp2, cfg2 = T.load_lm(tmp_path / "ref", device="cpu")
    _close(T.forward(tp2, torch.from_numpy(ids), cfg2), J.forward(jp2, jnp.asarray(ids), jc),
           "the reference's checkpoint in the port")
    tp3 = T.params_from_jax(jax.tree.map(np.asarray, jp2), cfg2, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tp2.state_dict().values(),
                                                 tp3.state_dict().values()))


def test_init_params_follow_the_reference_scheme():
    cfg = T.DecoderConfig(hidden_size=128, num_layers=4, num_heads=4,
                          intermediate_size=256, max_len=128)
    a = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    ref = J.init_params(jax.random.PRNGKey(0), _jcfg(cfg))
    for name, t in a.state_dict().items():
        node = ref
        for part in name.replace("_scale", ".scale").replace("_bias", ".bias").split("."):
            node = node[int(part)] if part.isdigit() else node[part]
        assert tuple(t.shape) == tuple(np.shape(node)), name
        np.testing.assert_allclose(float(t.std()), float(np.std(node)), rtol=0.1, atol=1e-6,
                                   err_msg=name)


def test_sampling_uses_the_explicit_generator():
    path = CKPT
    tp, cfg = T.load_lm(path, device="cpu")
    lm = T.DecoderLM(tp, cfg, prompt_bucket=256)
    a = lm.generate(PROMPTS[:2], max_new=24, temperature=0.8, seed=5)
    assert a == lm.generate(PROMPTS[:2], max_new=24, temperature=0.8, seed=5)
    assert a != lm.generate(PROMPTS[:2], max_new=24, temperature=0.8, seed=6)


# ------------------------------------------------------------ the provider
def test_render_prompt_equals_the_reference():
    for args in [("body", "SYSTEM LINE\nrest is dropped"), ("q", None), ("", "x" * 200)]:
        assert render_prompt(*args) == j_render_prompt(*args)


def test_provider_texts_equal_the_reference():
    kw = dict(model=str(CKPT), prompt_bucket=256, max_batch=2)
    ref, port = JaxLLMClient(**kw), DecoderLLMClient(**kw, device="cpu")
    prompts = ["Who founded Nexus Labs?", "Aurora Lane", "x", "Chris Reed married",
               "Silent River"]
    assert port.generate(prompts[0], system_prompt="Answer.", max_tokens=12) \
        == ref.generate(prompts[0], system_prompt="Answer.", max_tokens=12)
    assert port.batch_generate(prompts, system_prompt="notes", max_tokens=10) \
        == ref.batch_generate(prompts, system_prompt="notes", max_tokens=10)
    assert port.stats["calls"] == ref.stats["calls"] == 6
    assert port._max_new({"max_tokens": 10}) == ref._max_new({"max_tokens": 10}) == 64


def test_provider_is_unavailable_without_a_checkpoint(tmp_path):
    assert not DecoderLLMClient(model=str(tmp_path / "missing"), device="cpu").is_available()
    assert DecoderLLMClient(model=str(CKPT), device="cpu").is_available()


@pytest.mark.parametrize("b", [1, 3])
def test_decoder_parity_helper_on_the_cpu(b, monkeypatch):
    """testing.decoder_parity, which chip_smoke.py and the card's test run
    between the card and the CPU, at a small shape with both sides on the
    CPU; and it catches a host copy whose weights differ."""
    from anorag_tpu_torch.testing import decoder_parity

    cfg = T.DecoderConfig.tiny()
    params = T.init_params(cfg, torch.Generator().manual_seed(b), "cpu")
    out = decoder_parity(params, b, steps=20, pb=64, seed=b)
    assert out["max_abs_err"] == 0.0 and out["steps_compared"] <= 20
    original = T.DecoderParams.load_state_dict
    monkeypatch.setattr(T.DecoderParams, "load_state_dict", lambda self, sd: original(
        self, {k: v * 0.99 if k == "tok_emb" else v for k, v in sd.items()}))
    with pytest.raises(AssertionError, match="logits off"):
        decoder_parity(params, b, steps=4, pb=64, seed=b)
