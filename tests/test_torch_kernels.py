"""The port's kernels, held against the JAX package's Pallas kernels.

The JAX kernels run as tests/test_kernels.py runs them, in the Pallas
interpreter on the CPU; the port runs on the CPU, where every wrapper
takes its kernel's plain version.  Inputs come from one seeded numpy
generator and go to both packages.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.feature_resample import feature_resample as j_feature_resample
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.fused_adam import fused_adam as j_fused_adam
from repro.kernels.gather_loss import gather_loss_microbatch as j_gather_loss
from repro.kernels.topk_gating import topk_gating as j_topk
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.feature_resample import feature_resample
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_adam import fused_adam
from repro_torch.kernels.gather_loss import gather_loss_microbatch
from repro_torch.kernels.topk_gating import topk_gating
from torch_threads import one_thread  # noqa: F401

RNG = np.random.default_rng(7)

J_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
            "int32": jnp.int32}
T_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int32": torch.int32}


def _pair(a: np.ndarray, dtype: str):
    """One numpy array as a JAX array and a torch tensor of ``dtype``
    (bfloat16 rounds the same float32 values in both)."""
    a = np.asarray(a).astype(np.int32 if dtype == "int32" else np.float32)
    return (jnp.asarray(a, J_DTYPES[dtype]),
            torch.from_numpy(a).to(T_DTYPES[dtype]))


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.float() if x.dtype == torch.bfloat16 else x
        return x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


# ------------------------------------------------------ feature_resample
# bit-equal: a gather copies bytes, so any difference is a fault
@pytest.mark.parametrize("T,D,M", [(64, 32, 64), (300, 128, 128),
                                   (128, 8, 37)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_feature_resample_bit_equal(T, D, M, dtype):
    src_j, src_t = _pair(RNG.normal(size=(T, D)) * 10, dtype)
    idx = RNG.integers(0, T, size=M).astype(np.int32)
    want = j_feature_resample(src_j, jnp.asarray(idx))
    out = feature_resample(src_t, torch.from_numpy(idx))
    assert out.dtype == src_t.dtype and tuple(out.shape) == (M, D)
    np.testing.assert_array_equal(_np(out), _np(want))


@pytest.mark.parametrize("trailing", [(), (8,), (3, 5), (2, 3, 4)],
                         ids=["1d", "2d", "3d", "4d"])
@pytest.mark.parametrize("T,M", [(37, 16), (128, 37)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_resample_rows_bit_equal(trailing, T, M, dtype):
    src_j, src_t = _pair(RNG.normal(size=(T,) + trailing) * 10, dtype)
    idx = RNG.integers(0, T, size=M).astype(np.int32)
    want = jops.resample_rows(src_j, jnp.asarray(idx))
    out = ops.resample_rows(src_t, torch.from_numpy(idx))
    assert out.dtype == src_t.dtype and tuple(out.shape) == (M,) + trailing
    np.testing.assert_array_equal(_np(out), _np(want))


def test_resample_rows_takes_int64_labels():
    """Labels ride the same gather as 8-byte rows."""
    y = torch.from_numpy(RNG.integers(0, 10, size=40))
    idx = torch.from_numpy(RNG.integers(0, 40, size=16).astype(np.int32))
    out = ops.resample_rows(y, idx)
    assert out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), y.numpy()[idx.numpy()])


# --------------------------------------------------- fused gather + loss
GL_CASES = [(37, 16, 5, 12), (300, 24, 3, 50), (64, 8, 10, 64),
            (128, 33, 7, 19),
            # the row-tiled kernel's edges: D not a multiple of its
            # 128-wide chunk, one row, K past one 64-class tile (129, 300)
            (64, 100, 7, 33), (40, 130, 62, 1), (50, 70, 300, 20),
            (33, 65, 129, 17)]


# atol 1e-5: both sides take the K dot products in float32, in another
# summation order (tests/test_kernels.py holds the kernel to 1e-6 of its
# own jnp oracle; across frameworks a few ulps more)
@pytest.mark.parametrize("case", GL_CASES, ids=[str(c) for c in GL_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
def test_gather_loss_microbatch_matches_reference(case, dtype, bias):
    T, D, K, M = case
    src_j, src_t = _pair(RNG.normal(size=(T, D)), dtype)
    w_j, w_t = _pair(RNG.normal(size=(D, K)) * 0.3, dtype)
    labels = RNG.integers(0, K, size=T)
    idx = RNG.integers(0, T, size=M).astype(np.int32)
    b = RNG.normal(size=(K,)).astype(np.float32) if bias else None
    want = j_gather_loss(src_j, jnp.asarray(labels, jnp.int32),
                         jnp.asarray(idx), w_j,
                         None if b is None else jnp.asarray(b),
                         interpret=True)
    out = gather_loss_microbatch(src_t, torch.from_numpy(labels),
                                 torch.from_numpy(idx), w_t,
                                 None if b is None else torch.from_numpy(b))
    assert out.dtype == torch.float32 and tuple(out.shape) == (M,)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("trailing", [(6,), (4, 3), (2, 3, 2)],
                         ids=["2d", "3d", "4d"])
def test_gather_loss_flattens_trailing_shapes(trailing):
    """Rows flatten in the head's ``x.reshape(B, -1)`` order; int32 and
    int64 labels give the same losses.  atol 1e-5 as above."""
    T, K, M = 40, 7, 20
    D = math.prod(trailing)
    src = RNG.normal(size=(T,) + trailing).astype(np.float32)
    labels = RNG.integers(0, K, size=T)
    idx = RNG.integers(0, T, size=M).astype(np.int32)
    w = (RNG.normal(size=(D, K)) * 0.3).astype(np.float32)
    want = jops.gather_loss_microbatch(jnp.asarray(src),
                                       jnp.asarray(labels, jnp.int32),
                                       jnp.asarray(idx), jnp.asarray(w))
    for lab in (torch.from_numpy(labels),
                torch.from_numpy(labels.astype(np.int32))):
        out = ops.gather_loss_microbatch(torch.from_numpy(src), lab,
                                         torch.from_numpy(idx),
                                         torch.from_numpy(w))
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)


def test_fused_gather_loss_mean_value_and_grad_match_reference():
    """The autograd.Function: forward and the analytic w-gradient match
    the JAX custom VJP (value atol 1e-6, gradient atol 1e-5: float32
    sums in another order)."""
    T, D, K, M = 48, 12, 5, 16
    src = RNG.normal(size=(T, D)).astype(np.float32)
    labels = RNG.integers(0, K, size=T)
    idx = RNG.integers(0, T, size=M).astype(np.int32)
    w = (RNG.normal(size=(D, K)) * 0.3).astype(np.float32)
    val_j, grad_j = jax.value_and_grad(
        lambda w: jops.fused_gather_loss_mean(
            jnp.asarray(src), jnp.asarray(labels, jnp.int32),
            jnp.asarray(idx), w))(jnp.asarray(w))
    w_t = torch.from_numpy(w).requires_grad_(True)
    val = ops.fused_gather_loss_mean(torch.from_numpy(src),
                                     torch.from_numpy(labels),
                                     torch.from_numpy(idx), w_t)
    (grad,) = torch.autograd.grad(val, w_t)
    np.testing.assert_allclose(float(val.detach()), float(val_j), atol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j), atol=1e-5)


# ------------------------------------------------------------ fused adam
# tolerances of tests/test_kernels.py: 1e-6 in float32; bf16 params
# round their update to 8 bits of mantissa, 2e-2
@pytest.mark.parametrize("shape,step,wd", [((64,), 0, 0.0),
                                           ((33, 7), 5, 0.0),
                                           ((128, 16), 100, 0.01),
                                           ((70001,), 3, 0.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_adam_matches_reference(shape, step, wd, dtype):
    p_j, p_t = _pair(RNG.normal(size=shape), dtype)
    g_j, g_t = _pair(RNG.normal(size=shape), dtype)
    m = (RNG.normal(size=shape) * 0.1).astype(np.float32)
    v = (np.abs(RNG.normal(size=shape)) * 0.1).astype(np.float32)
    pw, mw, vw = j_fused_adam(p_j, g_j, jnp.asarray(m), jnp.asarray(v), step,
                              lr=1e-3, weight_decay=wd, block=4096,
                              interpret=True)
    p2, m2, v2 = fused_adam(p_t, g_t, torch.from_numpy(m),
                            torch.from_numpy(v),
                            torch.tensor(step, dtype=torch.int32),
                            lr=1e-3, weight_decay=wd)
    tol = 2e-2 if dtype == "bfloat16" else 1e-6
    assert p2.dtype == p_t.dtype
    np.testing.assert_allclose(_np(p2), _np(pw), atol=tol)
    np.testing.assert_allclose(m2.numpy(), np.asarray(mw), atol=1e-6)
    np.testing.assert_allclose(v2.numpy(), np.asarray(vw), atol=1e-6)


def test_fused_adam_stacked_leaf_uses_each_rows_step():
    """A [C, ...] client stack with a [C] step: row c is corrected at
    t = step[c] + 1, as the JAX package's vmap over entities does."""
    C, shape = 5, (3, 4, 6)
    p = RNG.normal(size=(C,) + shape).astype(np.float32)
    g = RNG.normal(size=(C,) + shape).astype(np.float32)
    m = (RNG.normal(size=(C,) + shape) * 0.1).astype(np.float32)
    v = (np.abs(RNG.normal(size=(C,) + shape)) * 0.1).astype(np.float32)
    steps = np.array([0, 1, 7, 30, 2], np.int32)
    p2, m2, v2 = fused_adam(*(torch.from_numpy(a) for a in (p, g, m, v)),
                            torch.from_numpy(steps), lr=3e-3)
    for c in range(C):
        pw, mw, vw = jref.fused_adam_ref(p[c], g[c], m[c], v[c],
                                         int(steps[c]), lr=3e-3)
        np.testing.assert_allclose(p2[c].numpy(), np.asarray(pw), atol=1e-6)
        np.testing.assert_allclose(m2[c].numpy(), np.asarray(mw), atol=1e-6)
        np.testing.assert_allclose(v2[c].numpy(), np.asarray(vw), atol=1e-6)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_fused_and_tree_paths_agree(weight_decay):
    """``adam().apply`` (through ops.fused_adam) and the tree-map update
    implement one rule, on a tree with a stacked cohort step."""
    from repro_torch.optim import adam
    from repro_torch.optim.optimizer import apply_updates
    params = {"a": torch.from_numpy(RNG.normal(size=(4, 3)).astype(np.float32)),
              "b": [torch.from_numpy(RNG.normal(size=(4, 5, 2))
                                     .astype(np.float32))]}
    grads = {"a": torch.from_numpy(RNG.normal(size=(4, 3)).astype(np.float32)),
             "b": [torch.from_numpy(RNG.normal(size=(4, 5, 2))
                                    .astype(np.float32))]}
    step = torch.tensor([0, 3, 3, 9], dtype=torch.int32)
    fused = adam(2e-3, weight_decay=weight_decay)
    plain = adam(2e-3, weight_decay=weight_decay, fused=False)
    assert fused.apply is not None and plain.apply is None
    state = fused.init(params)
    p_f, s_f = fused.apply(grads, state, params, step)
    upd, s_p = plain.update(grads, state, params, step)
    p_p = apply_updates(params, upd)
    for a, b in zip((p_f["a"], p_f["b"][0], s_f["m"]["a"], s_f["v"]["b"][0]),
                    (p_p["a"], p_p["b"][0], s_p["m"]["a"], s_p["v"]["b"][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7)


def test_adam_update_matches_reference_optimizer():
    """The port's tree-map Adam is repro.optim.adam's rule (atol 1e-7)."""
    from repro.optim import adam as j_adam
    from repro_torch.optim import adam
    p = RNG.normal(size=(31,)).astype(np.float32)
    g = RNG.normal(size=(31,)).astype(np.float32)
    j_opt, t_opt = j_adam(3e-3), adam(3e-3, fused=False)
    j_upd, j_state = j_opt.update({"w": jnp.asarray(g)},
                                  j_opt.init({"w": jnp.asarray(p)}),
                                  {"w": jnp.asarray(p)}, 7)
    t_upd, t_state = t_opt.update({"w": torch.from_numpy(g)},
                                  t_opt.init({"w": torch.from_numpy(p)}),
                                  {"w": torch.from_numpy(p)},
                                  torch.tensor(7, dtype=torch.int32))
    np.testing.assert_allclose(t_upd["w"].numpy(), np.asarray(j_upd["w"]),
                               atol=1e-7)
    np.testing.assert_allclose(t_state["v"]["w"].numpy(),
                               np.asarray(j_state["v"]["w"]), atol=1e-7)


def test_adam_schedule_with_fused_raises():
    from repro_torch.optim import adam
    with pytest.raises(ValueError):
        adam(lambda step: 1e-3, fused=True)
    assert adam(lambda step: 1e-3).apply is None


def test_clip_by_global_norm_matches_reference():
    from repro.optim import clip_by_global_norm as j_clip
    from repro_torch.optim import clip_by_global_norm
    g = [RNG.normal(size=(5, 3)).astype(np.float32),
         RNG.normal(size=(7,)).astype(np.float32)]
    cj, nj = j_clip([jnp.asarray(a) for a in g], 0.5)
    ct, nt = clip_by_global_norm([torch.from_numpy(a) for a in g], 0.5)
    np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
    for a, b in zip(ct, cj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)


# ------------------------------------------------- wrapper contracts
def test_wrappers_take_plain_version_only_on_cpu():
    """The plain version serves the CPU and ``meta`` (shapes alone, which
    a dry run asks for) and no other device: a CUDA tensor launches the
    kernel or raises.  On meta each wrapper gives its outputs' shapes and
    dtypes; a device mismatch is refused."""
    from repro_torch.kernels._count import PLAIN_DEVICES
    assert PLAIN_DEVICES == ("cpu", "meta")
    meta = torch.empty((8, 4), device="meta")
    idx = torch.zeros((2,), dtype=torch.int32, device="meta")
    out = feature_resample(meta, idx)
    assert out.is_meta and out.shape == (2, 4)
    with pytest.raises(ValueError):
        feature_resample(torch.zeros(8, 4), idx)
    lab = torch.zeros((8,), dtype=torch.int64, device="meta")
    w = torch.empty((4, 3), device="meta")
    out = gather_loss_microbatch(meta, lab, idx, w)
    assert out.is_meta and out.shape == (2,) and out.dtype == torch.float32
    with pytest.raises(ValueError):
        gather_loss_microbatch(torch.zeros(8, 4), lab, idx, w)
    s = torch.zeros((), dtype=torch.int32, device="meta")
    outs = fused_adam(meta, meta, meta, meta, s, lr=1e-3)
    assert all(o.is_meta and o.shape == (8, 4) for o in outs)
    with pytest.raises(ValueError):
        fused_adam(meta, meta, meta, meta, torch.zeros((), dtype=torch.int32),
                   lr=1e-3)


def test_wrappers_check_dtypes_and_shapes():
    src = torch.zeros(8, 4)
    with pytest.raises(TypeError):
        feature_resample(src, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        feature_resample(src.reshape(2, 4, 4), torch.zeros(2, dtype=torch.int32))
    z = torch.zeros(6)
    with pytest.raises(TypeError):
        fused_adam(z.double(), z.double(), z, z, torch.tensor(0, dtype=torch.int32),
                   lr=1e-3)
    with pytest.raises(ValueError):
        fused_adam(z, z, z, z, torch.zeros(2, dtype=torch.int32), lr=1e-3)
    with pytest.raises(ValueError):
        gather_loss_microbatch(src, torch.zeros(8, dtype=torch.int64),
                               torch.zeros(2, dtype=torch.int32),
                               torch.zeros(5, 3))


def test_build_refuses_without_nvcc(monkeypatch, tmp_path):
    """The build is from source with nvcc; with none found it raises."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_every_kernel_has_a_source_and_a_plain_version():
    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {name}_launch(' in src
        assert "Replaces: src/repro/kernels/" in src
    assert {"feature_resample_ref", "gather_loss_microbatch_ref",
            "fused_adam_ref", "flash_attention_ref",
            "topk_gating_ref"} <= set(dir(ref))


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference_optimizer(momentum):
    from repro.optim import sgd as j_sgd
    from repro_torch.optim import sgd
    p = RNG.normal(size=(9,)).astype(np.float32)
    g = RNG.normal(size=(9,)).astype(np.float32)
    j_opt, t_opt = j_sgd(0.1, momentum), sgd(0.1, momentum)
    js = j_opt.init({"w": jnp.asarray(p)})
    ts = t_opt.init({"w": torch.from_numpy(p)})
    for _ in range(2):
        ju, js = j_opt.update({"w": jnp.asarray(g)}, js)
        tu, ts = t_opt.update({"w": torch.from_numpy(g)}, ts)
    np.testing.assert_allclose(tu["w"].numpy(), np.asarray(ju["w"]),
                               atol=1e-7)


# ------------------------------------------------------- flash attention
# The port's wrapper on CPU tensors runs the plain version (sdpa, as the
# JAX package's attend_full).  Tolerances of tests/test_kernels.py:
# 2e-5 in float32 (both sides float32 math, sums in another order), 2e-2
# in bfloat16 (the output rounds to 8 bits of mantissa).
FA_CASES = [
    # B, Sq, Sk, H, Hkv, D, causal, window, softcap (tests/test_kernels.py)
    (1, 128, 128, 4, 4, 64, True, None, None),
    (2, 128, 128, 4, 2, 64, True, None, None),       # GQA
    (1, 256, 256, 8, 1, 32, True, None, None),       # MQA
    (2, 128, 128, 4, 4, 64, True, 32, None),         # sliding window
    (1, 128, 128, 4, 2, 64, True, None, 50.0),       # softcap (gemma2)
    (1, 64, 64, 2, 2, 128, False, None, None),       # bidirectional
    (1, 192, 192, 4, 4, 64, True, 64, 30.0),         # window+cap
    # Sq != Sk: causal by index, top-left aligned
    (1, 64, 128, 4, 2, 64, True, None, None),
    (2, 128, 64, 2, 1, 64, False, None, 30.0),
]


def _qkv(case, dtype):
    B, Sq, Sk, H, Hkv, D = case[:6]
    return (_pair(RNG.normal(size=(B, Sq, H, D)), dtype),
            _pair(RNG.normal(size=(B, Sk, Hkv, D)), dtype),
            _pair(RNG.normal(size=(B, Sk, Hkv, D)), dtype))


@pytest.mark.parametrize("case", FA_CASES, ids=[str(c) for c in FA_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference_kernel_and_oracle(case, dtype):
    causal, window, cap = case[6:]
    (qj, qt), (kj, kt), (vj, vt) = _qkv(case, dtype)
    kw = dict(causal=causal, window=window, softcap=cap)
    out = flash_attention(qt, kt, vt, **kw)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for want in (j_flash(qj, kj, vj, block_q=64, block_k=64, interpret=True,
                         **kw),
                 jref.flash_attention_ref(qj, kj, vj, **kw)):
        np.testing.assert_allclose(_np(out), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", [FA_CASES[1], FA_CASES[6], FA_CASES[8]],
                         ids=["gqa", "window-cap", "bidir-sq>sk"])
@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "qchunks"])
def test_flash_attention_grads_match_jax_grad_of_sdpa(case, chunked,
                                                      monkeypatch):
    """The autograd.Function's input gradients (a plain recompute, one
    query chunk at a time above the threshold) against jax.grad of the
    reference's einsum ``sdpa``; atol 1e-5 (float32 sums in another
    order)."""
    from repro.models.attention import _mask_bias, sdpa as j_sdpa
    if chunked:
        monkeypatch.setattr(ref, "QCHUNK_THRESHOLD", 32)
        monkeypatch.setattr(ref, "QCHUNK", 48)
    causal, window, cap = case[6:]
    (qj, qt), (kj, kt), (vj, vt) = _qkv(case, "float32")
    ct = RNG.normal(size=qt.shape).astype(np.float32)
    Sq, Sk = qt.shape[1], kt.shape[1]
    bias = _mask_bias(jnp.arange(Sq)[None], jnp.arange(Sk)[None], window,
                      causal)

    def j_loss(q, k, v):
        return jnp.sum(j_sdpa(q, k, v, bias, cap) * ct)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(qj, kj, vj)
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    out = ops.flash_attention(*leaves, causal=causal, window=window,
                              softcap=cap)
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_flash_attention_wrapper_contract():
    q = torch.zeros(1, 8, 4, 64)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 8, 3, 64), torch.zeros(1, 8, 3, 64))
    with pytest.raises(TypeError):
        flash_attention(q, q.double(), q.double())
    with pytest.raises(ValueError):
        flash_attention(q, q, q, window=0)
    meta = torch.empty(1, 8, 4, 64, device="meta")
    out = flash_attention(meta, meta, meta)      # the plain version's shapes
    assert out.is_meta and out.shape == meta.shape
    with pytest.raises(ValueError):
        flash_attention(meta, q, q)


# ----------------------------------------------------------- topk gating
# ids exactly equal (a tie goes to the lower index on both sides), weights
# atol 1e-6 as tests/test_kernels.py holds the Pallas kernel to its oracle
@pytest.mark.parametrize("T,E,k,bt", [(256, 8, 2, 64), (512, 64, 8, 128),
                                      (128, 4, 4, 128), (1024, 16, 1, 256)])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "tied"])
def test_topk_gating_matches_reference_kernel_and_oracle(T, E, k, bt, ties):
    x = (RNG.integers(-2, 3, size=(T, E)) if ties
         else RNG.normal(size=(T, E))).astype(np.float32)
    w, ids = topk_gating(torch.from_numpy(x), k)
    assert w.dtype == torch.float32 and ids.dtype == torch.int32
    for wj, ij in (j_topk(jnp.asarray(x), k, block_t=min(bt, T),
                          interpret=True),
                   jref.topk_gating_ref(jnp.asarray(x), k)):
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ij))
        np.testing.assert_allclose(w.numpy(), np.asarray(wj), atol=1e-6)


# the lane-per-8-experts kernel's edges: E below, at and past a lane's 8
# (4, 8, 60, 64, 256), k of 1 to E (past 8 the rounds are written as
# they come), integer (tied) logits, rows all equal, bf16 logits, and T
# not a multiple of the rows a warp takes
TK_EDGES = [(37, 4, 1, "randn", "float32"), (37, 4, 4, "tied", "float32"),
            (41, 8, 2, "equal", "float32"), (41, 8, 8, "tied", "bfloat16"),
            (33, 60, 6, "randn", "float32"), (33, 60, 60, "tied", "float32"),
            (35, 64, 8, "randn", "bfloat16"), (35, 64, 8, "equal", "float32"),
            (35, 64, 64, "tied", "float32"), (19, 256, 8, "randn", "float32"),
            (9, 256, 256, "tied", "bfloat16")]


@pytest.mark.parametrize("T,E,k,kind,dtype", TK_EDGES,
                         ids=["-".join(map(str, c)) for c in TK_EDGES])
def test_topk_gating_design_edges_match_reference_kernel_and_oracle(
        T, E, k, kind, dtype):
    """ids exactly equal, weights atol 1e-6, as above; the Pallas kernel
    takes the whole T as one block."""
    if kind == "tied":
        x = RNG.integers(-2, 3, size=(T, E))
    elif kind == "equal":
        x = np.full((T, E), 0.75)
    else:
        x = RNG.normal(size=(T, E))
    xj, xt = _pair(x, dtype)
    w, ids = topk_gating(xt, k)
    for wj, ij in (j_topk(xj, k, block_t=T, interpret=True),
                   jref.topk_gating_ref(xj, k)):
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ij))
        np.testing.assert_allclose(w.numpy(), np.asarray(wj), atol=1e-6)


@pytest.mark.parametrize("T,E,k", [(37, 8, 2), (64, 16, 4)])
def test_topk_gating_weight_grad_matches_jax_grad_of_top_k(T, E, k):
    """The Function's logits gradient against jax.grad through
    ``lax.top_k`` and the renormalization (the reference's moe.py);
    atol 1e-7."""
    x = RNG.normal(size=(T, E)).astype(np.float32)
    ct = RNG.normal(size=(T, k)).astype(np.float32)

    def j_loss(logits):
        w, _ = jref.topk_gating_ref(logits, k)
        return jnp.sum(w * ct)

    want = jax.grad(j_loss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    w, ids = ops.topk_gating(xt, k)
    assert not ids.requires_grad
    (got,) = torch.autograd.grad((w * torch.from_numpy(ct)).sum(), xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)


def test_topk_gating_wrapper_contract():
    with pytest.raises(ValueError):
        topk_gating(torch.zeros(4, 8), 9)
    with pytest.raises(ValueError):
        topk_gating(torch.zeros(4, 8, 2), 2)
    w, ids = topk_gating(torch.empty(4, 8, device="meta"), 2)
    assert w.is_meta and w.shape == ids.shape == (4, 2)
