"""The port's transformer zoo, held against ``repro.models`` on the CPU.

olmoe-1b-7b's smoke config (MoE, qk-norm) and gemma2-2b's (sliding
window, logit and final softcap, GQA, sandwich norms, tied embeddings)
go through both packages with the same numpy inputs and the weights of
one JAX init carried across.  On the CPU the port's attention and router
run their kernels' plain versions.

Tolerances: float32 on both sides, sums in another order; values atol
1e-5 (rtol 1e-5 for losses), gradients atol 1e-5 (and rtol 1e-5 for the
expert weights' gradients, which reach ~20).  A router whose top-k
flipped between the two would show as a jump, far above these.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as j_attn_mod
from repro.configs import smoke_config as j_smoke
from repro.configs.registry import get_config as j_get
from repro.configs.registry import list_archs as j_list
from repro.models import layers as jl
from repro.models.moe import moe_apply as j_moe_apply
from repro.models.transformer import Transformer as JT
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.kernels import ref as t_ref
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as tl
from repro_torch.models.moe import moe_apply
from repro_torch.models.transformer import Transformer, positions_for
from repro_torch.utils.tree import tree_leaves, tree_map
from repro_torch.utils.weights import to_torch

ARCHS = ["olmoe-1b-7b", "gemma2-2b"]
PORTED = ["moonshot-v1-16b-a3b", "grok-1-314b", "pixtral-12b", "gemma2-2b",
          "glm4-9b", "olmoe-1b-7b", "phi3-mini-3.8b"]
B, S = 2, 40
RNG = np.random.default_rng(21)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def carried():
    """arch -> (JAX cfg, port cfg, numpy params of one JAX init, the
    same as tensors)."""
    out = {}
    for arch in ARCHS:
        jcfg = j_smoke(arch)
        jp = jax.device_get(JT.init(jax.random.PRNGKey(0), jcfg))
        out[arch] = (jcfg, smoke_config(arch), jp, to_torch(jp))
    return out


def _block(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_configs_match_reference(arch, size):
    want = j_get(arch) if size == "full" else j_smoke(arch)
    got = get_config(arch) if size == "full" else smoke_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_params() == want.n_params()
    assert got.n_active_params() == want.n_active_params()
    assert (got.hd, got.vocab_padded) == (want.hd, want.vocab_padded)
    assert got.torch_dtype == {"float32": torch.float32,
                               "bfloat16": torch.bfloat16}[want.dtype]


def test_registry_names_and_later_families():
    assert list_archs() == j_list()
    for arch in ("mamba2-2.7b", "zamba2-1.2b", "whisper-base"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            get_config(arch)
        with pytest.raises(NotImplementedError, match="not ported yet"):
            smoke_config(arch)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


# ----------------------------------------------------------------- layers
def test_layers_match_reference():
    x = RNG.normal(size=(B, S, 4, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    scale = RNG.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        tl.rmsnorm({"scale": _t(scale)}, _t(x)).numpy(),
        np.asarray(jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        atol=1e-5)
    np.testing.assert_allclose(
        tl.apply_rope(_t(x), _t(pos), 10_000.0).numpy(),
        np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
        atol=1e-5)
    np.testing.assert_allclose(tl.softcap(_t(x) * 40, 30.0).numpy(),
                               np.asarray(jl.softcap(jnp.asarray(x) * 40, 30.0)),
                               atol=1e-5)
    table = RNG.normal(size=(50, 64)).astype(np.float32)
    ids = RNG.integers(0, 50, size=(B, S)).astype(np.int32)
    np.testing.assert_array_equal(
        tl.embedding({"table": _t(table)}, _t(ids)).numpy(),
        np.asarray(jl.embedding({"table": jnp.asarray(table)},
                                jnp.asarray(ids))))
    h = RNG.normal(size=(B, S, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tl.unembed({"table": _t(table)}, _t(h)).numpy(),
        np.asarray(jl.unembed({"table": jnp.asarray(table)}, jnp.asarray(h))),
        atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_and_carry_match_reference(arch, dtype):
    """The port's init has the reference's tree, shapes and dtypes (its
    values come from another generator), and a JAX tree carries across
    leaf for leaf, bfloat16 included."""
    jcfg, tcfg = j_smoke(arch).with_(dtype=dtype), smoke_config(arch).with_(
        dtype=dtype)
    jp = jax.device_get(JT.init(jax.random.PRNGKey(1), jcfg))
    tp = Transformer.init(torch.Generator().manual_seed(1), tcfg)
    assert jax.tree.structure(jp) == jax.tree.structure(
        tree_map(lambda t: 0, tp))
    carried_tree = to_torch(jp)
    for a, b, c in zip(jax.tree.leaves(jp), tree_leaves(tp),
                       tree_leaves(carried_tree)):
        assert tuple(b.shape) == a.shape == tuple(c.shape)
        assert b.dtype == c.dtype == tcfg.torch_dtype or (
            b.dtype == c.dtype == torch.float32)          # the f32 router
        np.testing.assert_array_equal(c.float().numpy(),
                                      np.asarray(a, np.float32))


# -------------------------------------------------------------- attention
@pytest.mark.parametrize("arch,local", [("olmoe-1b-7b", False),
                                        ("gemma2-2b", True),
                                        ("gemma2-2b", False)],
                         ids=["olmoe", "gemma2-local", "gemma2-global"])
@pytest.mark.parametrize("chunked", [False, True], ids=["sdpa", "qchunked"])
def test_attend_full_matches_reference(carried, arch, local, chunked,
                                       monkeypatch):
    """Output and gradients in x and wq; ``qchunked`` lowers both
    packages' QCHUNK_THRESHOLD at run time so the query-chunked branch
    runs (in three chunks on the port's side)."""
    if chunked:
        monkeypatch.setattr(j_attn_mod, "QCHUNK_THRESHOLD", 16)
        monkeypatch.setattr(t_ref, "QCHUNK_THRESHOLD", 16)
        monkeypatch.setattr(t_ref, "QCHUNK", 16)
    jcfg, tcfg, jp, tp = carried[arch]
    window = j_attn_mod.layer_window(jcfg, local, False)
    assert window == t_attn.layer_window(tcfg, local, False)
    assert (window is not None) == (arch == "gemma2-2b" and local)
    japar, tapar = _block(jp["blocks"], 0)["attn"], tree_map(
        lambda a: a[0], tp["blocks"])["attn"]
    x = RNG.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    ct = RNG.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))

    def j_loss(xx, wq):
        out, _ = j_attn_mod.attend_full(dict(japar, wq=wq), jcfg, xx, pos,
                                        window)
        return jnp.sum(out * ct), out

    (_, j_out), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(x), jnp.asarray(japar["wq"]))
    xt = _t(x).requires_grad_(True)
    wq = tapar["wq"].clone().requires_grad_(True)
    out, _ = t_attn.attend_full(dict(tapar, wq=wq), tcfg, xt,
                                positions_for(B, S, "cpu"), window)
    got = torch.autograd.grad((out * _t(ct)).sum(), (xt, wq))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=1e-5)
    for g, w in zip(got, j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_attend_full_refuses_positions_that_are_not_the_index():
    """The kernel masks by index: other positions are refused."""
    tcfg = smoke_config("olmoe-1b-7b")
    p = Transformer.init(torch.Generator().manual_seed(0), tcfg)
    bp = tree_map(lambda a: a[0], p["blocks"])["attn"]
    x = torch.zeros(1, 8, tcfg.d_model)
    with pytest.raises(RuntimeError):
        t_attn.attend_full(bp, tcfg, x, torch.arange(8)[None] + 3, None)


# -------------------------------------------------------------------- moe
@pytest.mark.parametrize("capacity_factor,group_size",
                         [(1.25, 4096), (0.5, 4096), (0.5, 24)],
                         ids=["default", "drops", "drops-groups"])
def test_moe_apply_matches_reference(carried, capacity_factor, group_size):
    """Sort-based dispatch with tokens dropped at capacity (0.5) and, at
    group 24 over 80 tokens, a zero-padded last group; output, aux, z
    and load, and gradients in x and the expert and router weights."""
    jcfg, tcfg, jp, tp = carried["olmoe-1b-7b"]
    mc = jcfg.moe.__class__(**dict(dataclasses.asdict(jcfg.moe),
                                   capacity_factor=capacity_factor,
                                   group_size=group_size))
    tmc = tcfg.moe.__class__(**dataclasses.asdict(mc))
    jm, tm = _block(jp["blocks"], 1)["moe"], tree_map(
        lambda a: a[1], tp["blocks"])["moe"]
    x = RNG.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    ct = RNG.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    names = ("router", "w_gate", "w_down")

    def j_loss(xx, *ws):
        y, m = j_moe_apply(dict(jm, **dict(zip(names, ws))), mc, xx)
        return jnp.sum(y * ct) + m["aux_loss"] + m["z_loss"], (y, m)

    (_, (jy, jmet)), j_grads = jax.value_and_grad(
        j_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(x), *(jnp.asarray(jm[n]) for n in names))
    xt = _t(x).requires_grad_(True)
    ws = [tm[n].clone().requires_grad_(True) for n in names]
    y, met = moe_apply(dict(tm, **dict(zip(names, ws))), tmc, xt)
    got = torch.autograd.grad((y * _t(ct)).sum() + met["aux_loss"]
                              + met["z_loss"], [xt] + ws)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5)
    for k in ("aux_loss", "z_loss", "load"):
        np.testing.assert_allclose(met[k].detach().numpy(),
                                   np.asarray(jmet[k]), rtol=1e-5, atol=1e-7)
    for g, w in zip(got, j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(carried, arch):
    jcfg, tcfg, jp, tp = carried[arch]
    tokens = RNG.integers(0, jcfg.vocab, size=(B, S)).astype(np.int32)
    jlog, jmet = JT.forward(jp, jcfg, jnp.asarray(tokens))
    with torch.no_grad():
        tlog, tmet = Transformer.forward(tp, tcfg, _t(tokens))
    assert tlog.dtype == torch.float32 and tuple(tlog.shape) == jlog.shape
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5)
    for k in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5,
                                   atol=1e-7)
    labels = RNG.integers(0, jcfg.vocab, size=(B, S)).astype(np.int32)
    jl_, _ = JT.loss_fn(jp, jcfg, jnp.asarray(tokens), jnp.asarray(labels))
    with torch.no_grad():
        tl_, _ = Transformer.loss_fn(tp, tcfg, _t(tokens), _t(labels))
    np.testing.assert_allclose(float(tl_), float(jl_), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_lm_loss_matches_reference(carried, arch):
    """Padded sequence (40 positions in chunks of 16) and padded vocab
    (500 of 512 columns); nll, accuracy and the gradient in hidden."""
    jcfg, tcfg, jp, tp = carried[arch]
    jcfg, tcfg = jcfg.with_(vocab=500), tcfg.with_(vocab=500)
    assert tcfg.vocab_padded == 512
    h = RNG.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    labels = RNG.integers(0, 500, size=(B, S)).astype(np.int32)
    (jn, ja), jg = jax.value_and_grad(
        lambda hh: JT.chunked_lm_loss(jp, jcfg, hh, jnp.asarray(labels),
                                      chunk=16), has_aux=True)(jnp.asarray(h))
    ht = _t(h).requires_grad_(True)
    tn, ta = Transformer.chunked_lm_loss(tp, tcfg, ht, _t(labels), chunk=16)
    (tg,) = torch.autograd.grad(tn, ht)
    np.testing.assert_allclose(float(tn.detach()), float(jn), rtol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
