"""The port's SSM family, held against the JAX package on the CPU.

The SSD scan: on CPU tensors the port's ``ssd_scan`` runs its plain
version, the chunked dual form, which is held to the reference's Pallas
kernel in the interpreter (as tests/test_kernels.py runs it, B and C per
head) and to the two oracles (the sequential ``ssd_scan_ref`` and the
model's ``ssd_chunked``) with grouped B and C; its final state to both
oracles' h; and the autograd Function's five input gradients to
``jax.grad`` of ``ssd_chunked``.  Then the Mamba-2 block, the hybrid
stack (zamba2 with the shared attention on the server), the forward and
the loss of the mamba2-2.7b and zamba2-1.2b smoke configs, with the
weights of one JAX init carried across.

Tolerances (float32 on both sides, the same algorithm with sums in
another order): the scan to rtol 1e-4 with atol 1e-4 times max|y| (the
sequential oracle rounds differently from the chunked form, and the
values reach ~50); gradients likewise; the model values atol 1e-5 and
the losses rtol 1e-5 as in tests/test_torch_transformer.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan
from repro.models import mamba2 as j_mamba
from repro.models.transformer import Transformer as JT
from repro.models.transformer import mamba_block as j_mamba_block
from repro_torch.configs import smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import mamba2 as t_mamba
from repro_torch.models.transformer import Transformer, mamba_block
from repro_torch.models.transformer import positions_for
from repro_torch.utils.tree import (tree_leaves, tree_map, tree_slice,
                                    tree_unflatten_like)
from repro_torch.utils.weights import to_torch
from torch_threads import one_thread  # noqa: F401

ARCHS = ["mamba2-2.7b", "zamba2-1.2b"]
B, S = 2, 64                    # two SSD chunks of the smoke configs' 32
RNG = np.random.default_rng(31)

SSD_CASES = [
    # B, L, H, P, N, chunk (tests/test_kernels.py)
    (1, 128, 2, 32, 16, 32),
    (2, 256, 3, 64, 32, 64),
    (1, 64, 1, 16, 8, 64),      # single chunk
    (2, 128, 4, 32, 16, 128),   # chunk == L
]


def _t(a):
    return torch.from_numpy(np.array(a))


def _ssd_inputs(B_, L, H, P, N, G):
    """x, B, C ~ N(0, 1); dt = softplus(N(0, 1)); A = -exp(N(0, 1))."""
    x = RNG.normal(size=(B_, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(RNG.normal(size=(B_, L, H)))).astype(np.float32)
    A = -np.exp(RNG.normal(size=(H,))).astype(np.float32)
    Bm = RNG.normal(size=(B_, L, G, N)).astype(np.float32)
    Cm = RNG.normal(size=(B_, L, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


# --------------------------------------------------------------- ssd_scan
@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c) for c in SSD_CASES])
def test_ssd_scan_matches_reference_kernel(case):
    """B and C per head (G = H), the TPU kernel's own contract."""
    B_, L, H, P, N, chunk = case
    x, dt, A, Bm, Cm = _ssd_inputs(B_, L, H, P, N, H)
    y, h = ssd_scan(*map(_t, (x, dt, A, Bm, Cm)), chunk=chunk)
    assert y.dtype == torch.float32 and tuple(y.shape) == x.shape
    assert h.dtype == torch.float32 and tuple(h.shape) == (B_, H, N, P)
    want = j_ssd_scan(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=chunk,
                      interpret=True)
    _close(y.numpy(), want)


@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c) for c in SSD_CASES])
@pytest.mark.parametrize("groups", ["1", "H"])
def test_ssd_scan_matches_oracles(case, groups):
    """y and the final state against the reference's sequential oracle
    (B and C repeated to heads in numpy) and its ``ssd_chunked`` (B and
    C grouped), and the port's own sequential oracle against the
    reference's."""
    B_, L, H, P, N, chunk = case
    G = 1 if groups == "1" else H
    x, dt, A, Bm, Cm = _ssd_inputs(B_, L, H, P, N, G)
    y, h = ssd_scan(*map(_t, (x, dt, A, Bm, Cm)), chunk=chunk)
    rep = lambda a: jnp.asarray(np.repeat(a, H // G, axis=2))
    ys, hs = jref.ssd_scan_ref(jnp.asarray(x), jnp.asarray(dt),
                               jnp.asarray(A), rep(Bm), rep(Cm))
    yc, hc = j_mamba.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                 chunk)
    for want_y, want_h in ((ys, hs), (yc, hc)):
        _close(y.numpy(), want_y)
        _close(h.numpy(), want_h)
    ty, th = ref.ssd_scan_ref(*map(_t, (x, dt, A, Bm, Cm)))
    _close(ty.numpy(), ys)
    _close(th.numpy(), hs)


GRAD_CASES = [
    # B, L, H, P, N, G, chunk
    (2, 96, 4, 16, 8, 2, 32),       # three chunks, two groups
    (1, 64, 3, 8, 4, 1, 64),        # one chunk
    (2, 128, 2, 16, 8, 2, 32),      # four chunks, G = H
]


@pytest.mark.parametrize("case", GRAD_CASES, ids=[str(c) for c in GRAD_CASES])
@pytest.mark.parametrize("strided", [False, True], ids=["contig", "slices"])
def test_ssd_scan_grads_match_jax_grad_of_ssd_chunked(case, strided):
    """The Function's gradients in x, dt, A, B and C (its backward
    recomputes the plain form under autograd, all chunks at once from
    the states entering them) against
    jax.grad of the reference's ``ssd_chunked``; ``slices`` passes x, B
    and C as column slices of one [B, L, ...] tensor, as the model
    does."""
    B_, L, H, P, N, G, chunk = case
    x, dt, A, Bm, Cm = _ssd_inputs(B_, L, H, P, N, G)
    ct = RNG.normal(size=x.shape).astype(np.float32)

    def j_loss(*args):
        y, _ = j_mamba.ssd_chunked(*args, chunk)
        return jnp.sum(y * ct)

    want = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)))
    leaves = [_t(a).requires_grad_(True) for a in (x, dt, A, Bm, Cm)]
    if strided:
        flat = torch.cat([leaves[0].reshape(B_, L, -1),
                          leaves[3].reshape(B_, L, -1),
                          leaves[4].reshape(B_, L, -1)], dim=-1)
        xs, bs, cs = torch.split(flat, [H * P, G * N, G * N], dim=-1)
        args = (xs.reshape(x.shape), leaves[1], leaves[2],
                bs.reshape(Bm.shape), cs.reshape(Cm.shape))
        assert not args[0].is_contiguous()
    else:
        args = leaves
    y, h = ops.ssd_scan(*args, chunk=chunk)
    assert y.requires_grad and not h.requires_grad
    got = torch.autograd.grad((y * _t(ct)).sum(), leaves)
    for g, w, leaf in zip(got, want, leaves):
        assert g.shape == leaf.shape
        _close(g.numpy(), w)


def test_ssd_scan_wrapper_contract():
    x, dt, A = torch.zeros(1, 64, 4, 8), torch.zeros(1, 64, 4), torch.zeros(4)
    Bm = torch.zeros(1, 64, 2, 8)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(x, dt, A, Bm, Bm, chunk=48)
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A, torch.zeros(1, 64, 3, 8), torch.zeros(1, 64, 3, 8),
                 chunk=32)              # H % G != 0
    with pytest.raises(ValueError):
        ssd_scan(x, dt[:, :32], A, Bm, Bm, chunk=32)
    meta = lambda t: torch.empty(t.shape, device="meta")
    y, h = ssd_scan(*map(meta, (x, dt, A, Bm, Bm)), chunk=32)
    assert y.is_meta and y.shape == x.shape and h.shape == (1, 4, 8, 8)
    with pytest.raises(ValueError):
        ssd_scan(meta(x), dt, A, Bm, Bm, chunk=32)


# ---------------------------------------------------------- the model
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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_and_carry_match_reference(arch, dtype):
    """The port's init has the reference's tree, shapes and dtypes
    (a_log, dt_bias and D float32 in a bf16 model; zamba2's shared
    attention block), and a JAX tree carries across leaf for leaf."""
    jcfg, tcfg = j_smoke(arch).with_(dtype=dtype), smoke_config(arch).with_(
        dtype=dtype)
    jp = jax.device_get(JT.init(jax.random.PRNGKey(1), jcfg))
    tp = Transformer.init(torch.Generator().manual_seed(1), tcfg)
    assert jax.tree.structure(jp) == jax.tree.structure(
        tree_map(lambda t: 0, tp))
    assert ("shared_attn" in tp) == (arch == "zamba2-1.2b")
    f32 = {"a_log", "dt_bias", "D"}
    for (path, a), b, c in zip(jax.tree_util.tree_leaves_with_path(jp),
                               tree_leaves(tp), tree_leaves(to_torch(jp))):
        name = path[-1].key
        want = torch.float32 if name in f32 else tcfg.torch_dtype
        assert tuple(b.shape) == a.shape == tuple(c.shape)
        assert b.dtype == c.dtype == want, (name, b.dtype, c.dtype)
        np.testing.assert_array_equal(c.float().numpy(),
                                      np.asarray(a, np.float32))
    np.testing.assert_allclose(
        tp["blocks"]["mamba"]["a_log"][0].numpy(),
        np.asarray(jp["blocks"]["mamba"]["a_log"][0]), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_forward_and_block_match_reference(carried, arch):
    """One block's forward and final state, and the block (norm +
    residual), with the gradients of the block in x and w_in."""
    jcfg, tcfg, jp, tp = carried[arch]
    jb = jax.tree.map(lambda a: a[0], jp["blocks"])
    tb = tree_map(lambda a: a[0], tp["blocks"])
    x = RNG.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    ct = RNG.normal(size=x.shape).astype(np.float32)
    jy, jh = j_mamba.mamba_forward(jb["mamba"], jcfg, jnp.asarray(x))
    with torch.no_grad():
        ty, th = t_mamba.mamba_forward(tb["mamba"], tcfg, _t(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    _close(th.numpy(), jh)

    def j_loss(xx, w_in):
        p = dict(jb, mamba=dict(jb["mamba"], w_in=w_in))
        out, _ = j_mamba_block(p, jcfg, xx)
        return jnp.sum(out * ct), out

    (_, j_out), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(x), jnp.asarray(jb["mamba"]["w_in"]))
    xt = _t(x).requires_grad_(True)
    w_in = tb["mamba"]["w_in"].clone().requires_grad_(True)
    out, m = mamba_block(dict(tb, mamba=dict(tb["mamba"], w_in=w_in)), tcfg,
                         xt)
    assert float(m["aux_loss"]) == 0.0
    got = torch.autograd.grad((out * _t(ct)).sum(), (xt, w_in))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=1e-5)
    for g, w in zip(got, j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("half", ["server", "whole"])
def test_hybrid_stack_matches_reference(carried, half):
    """zamba2's stack: the server half (blocks [cut, L) with the shared
    attention after block 1) and the whole stack, from one input."""
    jcfg, tcfg, jp, tp = carried["zamba2-1.2b"]
    cut, L = jcfg.cut_layers, jcfg.n_layers
    first = cut if half == "server" else 0
    assert first <= jcfg.ssm.shared_attn_positions[0] < L
    jpar = {"blocks": jax.tree.map(lambda a: a[first:], jp["blocks"]),
            "shared_attn": jp["shared_attn"]}
    tpar = {"blocks": tree_slice(tp["blocks"], first, None),
            "shared_attn": tp["shared_attn"]}
    x = RNG.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    jx, _ = JT.stack_forward(jpar, jcfg, jnp.asarray(x), pos,
                             first_block=first, n_blocks=L - first)
    with torch.no_grad():
        tx, _ = Transformer.stack_forward(tpar, tcfg, _t(x),
                                          positions_for(B, S, "cpu"),
                                          first_block=first,
                                          n_blocks=L - first)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)


def test_client_stack_across_a_shared_position_is_refused(carried):
    """A stack without the shared block must end before its position."""
    _, tcfg, _, tp = carried["zamba2-1.2b"]
    x = torch.zeros(1, 32, tcfg.d_model)
    p = {"blocks": tp["blocks"]}
    with pytest.raises(ValueError, match="shared-attention"):
        Transformer.stack_forward(p, tcfg, x, positions_for(1, 32, "cpu"),
                                  first_block=0, n_blocks=tcfg.n_layers)
    y, _ = Transformer.stack_forward(p, tcfg, x, positions_for(1, 32, "cpu"),
                                     first_block=0, n_blocks=1)
    assert tuple(y.shape) == tuple(x.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(carried, arch):
    """Logits of the full forward, and ``loss_fn`` with its gradient in
    every parameter (the backward runs through the scan's Function)."""
    jcfg, tcfg, jp, tp = carried[arch]
    tokens = RNG.integers(0, jcfg.vocab, size=(B, S)).astype(np.int32)
    labels = RNG.integers(0, jcfg.vocab, size=(B, S)).astype(np.int32)
    jlog, _ = JT.forward(jp, jcfg, jnp.asarray(tokens))
    with torch.no_grad():
        tlog, _ = Transformer.forward(tp, tcfg, _t(tokens))
    assert tlog.dtype == torch.float32 and tuple(tlog.shape) == jlog.shape
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5)

    (jl_, _), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, jnp.asarray(tokens),
                             jnp.asarray(labels)), has_aux=True)(jp)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    tl_, _ = Transformer.loss_fn(tree_unflatten_like(tp, leaves), tcfg,
                                 _t(tokens), _t(labels))
    tg = torch.autograd.grad(tl_, leaves, allow_unused=True)
    np.testing.assert_allclose(float(tl_.detach()), float(jl_), rtol=1e-5)
    for g, w in zip(tg, jax.tree.leaves(jg)):
        g = torch.zeros(w.shape) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4)
