"""The port's encoder-decoder family (whisper-base), held against
``repro.models.encdec`` and ``repro.launch`` on the CPU.

whisper-base's smoke config (2 encoder and 2 decoder layers, d 128, 4
heads of 32, float32) goes through both packages with the weights of one
JAX init carried across and the same numpy inputs.  On the CPU the
port's attention runs the ``flash_attention`` kernel's plain version.
The encoder runs at 60 frames and at 1500, where the JAX package takes
its query-chunked branch (``sdpa_qchunked``, chunks of 512).

Tolerances: float32 on both sides, sums in another order.  Values rtol
1e-4 (atol 1e-5 on values near zero); gradients rtol 1e-4 with an atol
of 1e-5 of each leaf's largest gradient; decode logits within 1e-5 and
greedy tokens equal; bf16 prefill logits one bf16 rounding apart (rtol
8e-3).  Train rounds: metrics rtol 1e-4, weights as in
tests/test_torch_steps.py (Adam's near-sign first steps): each within
2 * lr * steps, and all but 0.1% within 1e-6, where a leaf under 1000
values may hold one over it (a GeLU bias whose gradient is near 0 takes
a step of another sign: one of b_in's 512 values moves by 8.9e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import smoke_config as j_smoke
from repro.core import cyclesl as jc
from repro.core import protocol as jp
from repro.core.feature_store import resample_plan as j_plan
from repro.launch import serve as j_serve
from repro.launch.steps import make_whisper_task as j_make_whisper_task
from repro.models import ffn as j_ffn
from repro.models import layers as jl
from repro.models.encdec import EncDec as JE
from repro.optim import adam as j_adam
from repro_torch.configs import InputShape, get_config, smoke_config
from repro_torch.core.cyclesl import CycleConfig
from repro_torch.launch import inputs as t_inputs
from repro_torch.launch import serve as t_serve
from repro_torch.launch.steps import (build_decode_step, build_prefill_step,
                                      build_train_step, make_whisper_task)
from repro_torch.models import ffn as t_ffn
from repro_torch.models import layers as tl
from repro_torch.models.encdec import EncDec
from repro_torch.utils.tree import tree_leaves, tree_unflatten_like
from repro_torch.utils.weights import entity_from_reference, to_torch
from torch_threads import one_thread  # noqa: F401

ARCH = "whisper-base"
RNG = np.random.default_rng(22)
B, S = 2, 24
LR = 3e-4
C, ROUNDS = 2, 2
SHAPE = InputShape("train_smoke", 16, 4, "train")        # b = 2 a client


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-4, atol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def carried():
    """(JAX cfg, port cfg, numpy params of one JAX init, as tensors)."""
    jcfg = j_smoke(ARCH)
    jparams = jax.device_get(JE.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, smoke_config(ARCH), jparams, to_torch(jparams)


def _frames(T, d, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, T, d)).astype(np.float32)


def _tokens(cfg, n=S, seed=1):
    stream = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, n + 1), dtype=np.int32)
    return stream[:, :-1], stream[:, 1:]


# ----------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    """Normalized and scaled in float32, cast once: bit-equal in bf16."""
    x = (RNG.normal(size=(B, S, 128)) * 3 + 1).astype(np.float32)
    scale = RNG.normal(size=(128,)).astype(np.float32)
    bias = RNG.normal(size=(128,)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jl.layernorm({"scale": jnp.asarray(scale, jdt),
                         "bias": jnp.asarray(bias, jdt)},
                        jnp.asarray(x, jdt))
    got = tl.layernorm({"scale": _t(scale).to(tdt), "bias": _t(bias).to(tdt)},
                       _t(x).to(tdt))
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        _close(got.numpy(), want)
    p = tl.layernorm_init(128)
    assert p["scale"].sum() == 128 and p["bias"].abs().sum() == 0


def test_linear_and_embedding_init_match_reference_layout():
    gen = torch.Generator().manual_seed(0)
    jlin = jl.linear_init(jax.random.PRNGKey(0), 16, 8, bias=True)
    tlin = tl.linear_init(gen, 16, 8, bias=True)
    assert {k: tuple(v.shape) for k, v in tlin.items()} == {
        k: tuple(v.shape) for k, v in jlin.items()}
    x = RNG.normal(size=(3, 16)).astype(np.float32)
    jlin = jax.device_get(jlin)
    _close(tl.linear(to_torch(jlin), _t(x)).numpy(),
           np.asarray(jl.linear(jlin, jnp.asarray(x))))
    assert tuple(tl.embedding_init(gen, 64, 8)["table"].shape) == (64, 8)
    assert float(tl.embedding_init(gen, 4096, 8)["table"].std()) == \
        pytest.approx(0.02, rel=0.05)


def test_gelu_mlp_takes_the_tanh_form():
    """jax.nn.gelu is the tanh approximation; the erf form differs from
    it by more than this test's rtol 1e-4, so an erf port would fail."""
    jp_ = jax.device_get(j_ffn.gelu_mlp_init(jax.random.PRNGKey(3), 128, 256,
                                             jnp.float32))
    jp_ = dict(jp_, b_in=RNG.normal(size=(256,)).astype(np.float32))
    x = RNG.normal(size=(B, S, 128)).astype(np.float32)
    want = np.asarray(j_ffn.gelu_mlp(jp_, jnp.asarray(x)))
    tp = to_torch(jp_)
    _close(t_ffn.gelu_mlp(tp, _t(x)).numpy(), want, atol=1e-6)
    h = _t(x) @ tp["w_in"] + tp["b_in"]
    erf = F.gelu(h) @ tp["w_out"] + tp["b_out"]
    with pytest.raises(AssertionError):
        _close(erf.numpy(), want, atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    shapes = {k: tuple(v.shape) for k, v in
              t_ffn.gelu_mlp_init(gen, 128, 256, torch.float32).items()}
    assert shapes == {k: tuple(v.shape) for k, v in jp_.items()}


# ------------------------------------------------------------------ model
def test_init_tree_matches_reference(carried):
    jcfg, tcfg, jparams, _ = carried
    tparams = EncDec.init(torch.Generator().manual_seed(0), tcfg)
    jl_ = jax.tree_util.tree_leaves_with_path(jparams)
    tl_ = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: np.zeros(t.shape, np.float32), tparams))
    assert [(p, a.shape) for p, a in jl_] == [(p, a.shape) for p, a in tl_]
    assert tparams["encoder"]["pos"].shape == (1500, tcfg.d_model)
    assert tparams["decoder"]["pos"].shape == (448, tcfg.d_model)
    assert tparams["decoder"]["embed"]["table"].shape[0] == tcfg.vocab_padded


def test_bf16_tree_carries_exactly():
    """A bf16 EncDec tree of the reference crosses leaf for leaf."""
    jcfg = j_smoke(ARCH).with_(dtype="bfloat16")
    jparams = jax.device_get(JE.init(jax.random.PRNGKey(4), jcfg))
    tparams = to_torch(jparams)
    for a, b in zip(jax.tree.leaves(jparams), tree_leaves(tparams)):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))


@pytest.mark.parametrize("T", [60, 1500])
def test_encode_matches_reference(carried, T):
    jcfg, tcfg, jparams, tparams = carried
    frames = _frames(T, tcfg.enc_d_model)
    want = JE.encode(jparams["encoder"], jcfg, jnp.asarray(frames))
    with torch.no_grad():
        got = EncDec.encode(tparams["encoder"], tcfg, _t(frames))
    assert tuple(got.shape) == (B, T, tcfg.d_model)
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("T", [60, 1500])
def test_decode_train_and_forward_match_reference(carried, T):
    jcfg, tcfg, jparams, tparams = carried
    frames = _frames(T, tcfg.enc_d_model, seed=T)
    tokens, _ = _tokens(tcfg)
    enc = np.asarray(JE.encode(jparams["encoder"], jcfg, jnp.asarray(frames)))
    want = JE.decode_train(jparams["decoder"], jcfg, jnp.asarray(tokens),
                           jnp.asarray(enc))
    with torch.no_grad():
        got = EncDec.decode_train(tparams["decoder"], tcfg, _t(tokens),
                                  _t(enc))
        fwd = EncDec.forward(tparams, tcfg, _t(frames), _t(tokens))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (B, S, tcfg.vocab)
    _close(got.numpy(), np.asarray(want))
    _close(fwd.numpy(), np.asarray(want))


@pytest.mark.parametrize("T", [60, 1500])
def test_loss_and_every_gradient_match_reference(carried, T):
    """``loss_fn`` and its gradient in every parameter against
    ``jax.grad`` of the reference (the plain attention backward at
    Sq != Sk for the cross-attention, and at 1500 frames against the
    reference's query-chunked encoder)."""
    jcfg, tcfg, jparams, tparams = carried
    frames = _frames(T, tcfg.enc_d_model, seed=T + 1)
    tokens, labels = _tokens(tcfg, seed=T)
    jloss, jgrad = jax.value_and_grad(
        lambda p: JE.loss_fn(p, jcfg, jnp.asarray(frames), jnp.asarray(tokens),
                             jnp.asarray(labels))[0])(jparams)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(tparams)]
    loss, metrics = EncDec.loss_fn(tree_unflatten_like(tparams, leaves), tcfg,
                                   _t(frames), _t(tokens), _t(labels))
    grads = torch.autograd.grad(loss, leaves)
    assert metrics == {}
    _close(float(loss.detach()), float(jloss), atol=0)
    paths = jax.tree_util.tree_leaves_with_path(jax.device_get(jgrad))
    assert len(paths) == len(grads)
    for (path, want), got in zip(paths, grads):
        want = np.asarray(want)
        _close(got.numpy(), want, atol=1e-5 * float(np.abs(want).max()),
               msg=jax.tree_util.keystr(path))


def test_decode_steps_match_reference(carried):
    """8 greedy steps from token 0 over 60 encoded frames: tokens equal,
    logits within 1e-5; then teacher forcing: each step's logits equal
    ``forward``'s at its position."""
    jcfg, tcfg, jparams, tparams = carried
    frames = _frames(60, tcfg.enc_d_model, seed=5)
    jstate = JE.init_decode_state(jparams, jcfg, jnp.asarray(frames), 8)
    jtok = jnp.zeros((B, 1), jnp.int32)
    with torch.no_grad():
        tstate = EncDec.init_decode_state(tparams, tcfg, _t(frames), 8)
        ttok = torch.zeros((B, 1), dtype=torch.int32)
        seq = []
        for _ in range(8):
            jlog, jstate = JE.decode_step(jparams, jcfg, jtok, jstate)
            tlog, tstate = EncDec.decode_step(tparams, tcfg, ttok, tstate)
            _close(tlog.numpy(), np.asarray(jlog), rtol=0, atol=1e-5)
            seq.append(ttok)
            jtok = jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32)
            ttok = torch.argmax(tlog[:, -1:], dim=-1).to(torch.int32)
            np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        assert int(tstate["pos"]) == 8 and int(tstate["kv"].idx) == 8
        toks = torch.cat(seq, dim=1)
        fwd = EncDec.forward(tparams, tcfg, _t(frames), toks)
        state = EncDec.init_decode_state(tparams, tcfg, _t(frames), 8)
        for t in range(8):
            lg, state = EncDec.decode_step(tparams, tcfg, toks[:, t:t + 1],
                                           state)
            _close(lg[:, 0].numpy(), fwd[:, t].numpy(), rtol=0, atol=1e-5)


# ------------------------------------------------------------------ steps
def test_whisper_task_matches_reference(carried):
    jcfg, tcfg, jparams, tparams = carried
    jtask, ttask = j_make_whisper_task(jcfg), make_whisper_task(tcfg)
    frames = _frames(60, tcfg.enc_d_model, seed=7)
    tokens, labels = _tokens(tcfg, seed=7)
    feats = ttask.client_forward(tparams["encoder"], {"frames": _t(frames)})
    jfeats = jtask.client_forward(jparams["encoder"],
                                  {"frames": jnp.asarray(frames)})
    _close(feats.detach().numpy(), np.asarray(jfeats))
    y = {"tokens": tokens, "labels": labels}
    want = jtask.server_loss(jparams["decoder"], jfeats,
                             jax.tree.map(jnp.asarray, y))
    got = ttask.server_loss(tparams["decoder"], feats,
                            {k: _t(v) for k, v in y.items()})
    _close(float(got), float(want), atol=0)
    gen = torch.Generator().manual_seed(0)
    assert set(ttask.init_client(gen)) == {"pos", "blocks", "final_norm"}
    assert set(ttask.init_server(gen)) == {"embed", "pos", "blocks",
                                           "final_norm"}
    with pytest.raises(NotImplementedError):
        ttask.server_apply(tparams["decoder"], feats)


@pytest.mark.parametrize("shape", ["train", "prefill"])
def test_audio_input_specs_match_reference(shape):
    from repro.configs import INPUT_SHAPES as J_SHAPES
    from repro.launch import inputs as j_inputs
    from repro_torch.configs import INPUT_SHAPES
    jcfg, tcfg = j_smoke(ARCH), smoke_config(ARCH)
    name = "train_4k" if shape == "train" else "prefill_32k"
    if shape == "train":
        want = j_inputs.train_batch_specs(jcfg, J_SHAPES[name], 8)
        got = t_inputs.train_batch_specs(tcfg, INPUT_SHAPES[name], 8)
    else:
        want = j_inputs.prefill_specs(jcfg, J_SHAPES[name])
        got = t_inputs.prefill_specs(tcfg, INPUT_SHAPES[name])
    wl = jax.tree.leaves(want)
    gl = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, t_inputs.Spec))
    assert [tuple(w.shape) for w in wl] == [tuple(g.shape) for g in gl]
    assert [str(w.dtype) for w in wl] == [str(g.dtype)[6:] for g in gl]
    if shape == "train":
        xs, ys = t_inputs.make_train_batch(tcfg, INPUT_SHAPES[name], 8, 3)
        assert xs["frames"].shape == (8, 32, 1500, tcfg.enc_d_model)
        assert ys["tokens"].shape == ys["labels"].shape == (8, 32, 448)
        np.testing.assert_array_equal(ys["tokens"][..., 1:],
                                      ys["labels"][..., :-1])


@pytest.fixture(scope="module")
def rounds(carried):
    """Two CycleSL rounds of the whisper split from one carried init on
    the reference's plans: (JAX metrics, JAX state, port metrics, port
    state)."""
    jcfg, tcfg, _, _ = carried
    jtask, jopt = j_make_whisper_task(jcfg), j_adam(LR)
    jserver = jp.init_entity(jtask.init_server(jax.random.PRNGKey(0)), jopt)
    jclients = jp.broadcast_entity(
        jp.init_entity(jtask.init_client(jax.random.PRNGKey(1)), jopt), C)
    jkeys = [jax.random.PRNGKey(10 + r) for r in range(ROUNDS)]
    step = jax.jit(lambda s, c, xs, ys, key: jc.cyclesl_round(
        jtask, s, c, jopt, jopt, xs, ys, key, jc.CycleConfig()))

    def plan_fn(key, valid, epochs, sb):
        assert valid is None
        return torch.from_numpy(np.array(
            j_plan(jkeys[key], SHAPE.global_batch, epochs, sb))), None

    bundle = build_train_step(tcfg, SHAPE, CycleConfig(), cohort=C,
                              device="cpu", plan_fn=plan_fn)
    ts = entity_from_reference(jax.device_get(jserver))
    tcl = entity_from_reference(jax.device_get(jclients))
    jm_all, tm_all = [], []
    for r in range(ROUNDS):
        xs, ys = t_inputs.make_train_batch(tcfg, SHAPE, C, r)
        jserver, jclients, jm = step(jserver, jclients,
                                     jax.tree.map(jnp.asarray, xs),
                                     jax.tree.map(jnp.asarray, ys), jkeys[r])
        ts, tcl, tm = bundle.fn(ts, tcl, t_inputs.to_device(xs, tcfg, "cpu"),
                                t_inputs.to_device(ys, tcfg, "cpu"), r)
        jm_all.append({k: float(v) for k, v in jm.items()})
        tm_all.append({k: float(v) for k, v in tm.items()})
    return jm_all, jax.device_get((jserver, jclients)), tm_all, (ts, tcl)


def _assert_adam_close(j_tree, t_tree, steps):
    jl_, tl_ = jax.tree.leaves(j_tree), tree_leaves(t_tree)
    assert len(jl_) == len(tl_)
    for a, b in zip(jl_, tl_):
        d = np.abs(np.asarray(a, np.float32) - b.float().numpy())
        if not d.size:
            continue
        assert d.max() <= 2 * LR * steps + 1e-6, d.max()
        # a leaf under 1000 values may hold one over 1e-6
        assert (d > 1e-6).sum() <= max(1, 1e-3 * d.size), (d > 1e-6).sum()


def test_train_round_metrics_match_reference(rounds):
    jm_all, _, tm_all, _ = rounds
    for jm, tm in zip(jm_all, tm_all):
        assert set(jm) == set(tm)
        for k in jm:
            assert np.isfinite(tm[k])
            _close(tm[k], jm[k], atol=0, msg=k)


@pytest.mark.parametrize("side", ["server", "clients"])
def test_train_round_params_match_reference(rounds, side):
    """Server: 2 steps a round (pool of 4 rows, server batch 2); each
    client slot: 1 step a round."""
    _, (jserver, jclients), _, (ts, tcl) = rounds
    j_e, t_e, steps = ((jserver, ts, 2 * ROUNDS) if side == "server"
                       else (jclients, tcl, ROUNDS))
    np.testing.assert_array_equal(t_e.step.numpy(), np.asarray(j_e.step))
    _assert_adam_close(j_e.params, t_e.params, steps)
    _assert_adam_close(j_e.opt_state, t_e.opt_state, steps)


def test_prefill_step_matches_reference(carried):
    """Last-position logits over 1500 frames, bf16 on both sides."""
    jcfg, tcfg, jparams, tparams = carried
    bundle = build_prefill_step(tcfg, InputShape("p", 16, B, "prefill"),
                                device="cpu")
    (batch,) = bundle.make_batch(5)
    assert tuple(batch["frames"].shape) == (B, 1500, tcfg.enc_d_model)
    jlog = JE.forward(jparams, jcfg, jnp.asarray(batch["frames"].numpy()),
                      jnp.asarray(batch["tokens"].numpy()))
    want = np.asarray(jlog[:, -1].astype(jnp.bfloat16), np.float32)
    got = bundle.fn(tparams, batch)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, tcfg.vocab)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=8e-3,
                               atol=1e-3)


def test_decode_step_bundle_matches_reference(carried):
    """``build_decode_step``: the state encodes 1500 frames of the seed;
    three steps against the reference's ``decode_step`` from the same
    encoder states."""
    jcfg, tcfg, jparams, tparams = carried
    bundle = build_decode_step(tcfg, InputShape("d", 16, B, "decode"),
                               device="cpu")
    _, state = bundle.init_state(0)
    assert tuple(state["enc_out"].shape) == (B, 1500, tcfg.d_model)
    assert state["kv"].capacity == 16
    frames = np.random.default_rng(0).standard_normal(
        (B, 1500, tcfg.enc_d_model)).astype(np.float32)
    jstate = JE.init_decode_state(jparams, jcfg, jnp.asarray(frames), 16)
    state = EncDec.init_decode_state(tparams, tcfg, _t(frames), 16)
    (tok,) = bundle.make_batch(3)
    for _ in range(3):
        jlog, jstate = JE.decode_step(jparams, jcfg, jnp.asarray(tok.numpy()),
                                      jstate)
        tlog, state = bundle.fn(tparams, tok, state)
        _close(tlog.numpy(), np.asarray(jlog), rtol=0, atol=1e-5)
        tok = torch.argmax(tlog, dim=-1).to(torch.int32)


def test_serve_whisper_matches_reference():
    """``serve_whisper`` with the reference's weights and frames (its
    PRNG keys 0 and 1): the same greedy tokens."""
    jcfg, tcfg = j_smoke(ARCH), smoke_config(ARCH)
    want = j_serve.serve_whisper(jcfg, batch=2, steps=6)
    params = to_torch(jax.device_get(JE.init(jax.random.PRNGKey(0), jcfg)))
    frames = jax.random.normal(jax.random.PRNGKey(1),
                               (2, 60, jcfg.enc_d_model), jnp.float32) * 0.1
    got = t_serve.serve_whisper(tcfg, batch=2, steps=6, device="cpu",
                                params=params, frames=_t(frames))
    assert got["batch"] == 2 and got["decode_s_per_token"] > 0.0
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    own = t_serve.serve_whisper(tcfg, batch=3, steps=4, device="cpu")
    assert tuple(own["tokens"].shape) == (3, 4)
    assert t_serve.serve_whisper(tcfg, batch=1, steps=0,
                                 device="cpu")["tokens"].shape == (1, 0)
    with pytest.raises(ValueError):
        t_serve.serve_whisper(tcfg, batch=0, steps=1, device="cpu")


def test_whisper_entry_points_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_train_step(cfg, SHAPE, cohort=C)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_prefill_step(cfg, InputShape("p", 16, B, "prefill"))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_decode_step(cfg, InputShape("d", 16, B, "decode"))
    with pytest.raises(RuntimeError, match="CUDA"):
        t_serve.serve_whisper(cfg, batch=1, steps=1)


def test_full_config_heads_have_a_tensor_core_design():
    from repro_torch.kernels.flash_attention import design
    cfg = get_config(ARCH)
    assert design(cfg.torch_dtype, cfg.hd) == "wgmma"
    assert design(torch.float32, smoke_config(ARCH).hd) == "simt"
