"""The port's CelebA CNN, ResNet9, gaze MLP and Shakespeare LSTM, their
synthetic data and the mse loss, against the JAX package.

Weights are drawn by the reference and carried across with
``utils/weights.py``; at every cut the smashed data, the server's output
and every parameter's gradient of the end-to-end loss are compared.
Tolerances: activations atol 1e-5 relative to their largest value
(float32 convolutions, BatchNorm reductions and matmuls summed in
another order); each gradient within rtol 1e-4 plus 1e-5 of that
leaf's own largest gradient.  The conv biases in front of a BatchNorm
(``cnn.bias_before_batchnorm``) take 1e-5 of the model's largest
gradient instead: the norm removes any per-channel constant, so their
exact gradient is 0 and both packages return rounding noise (~1e-7 of
the model's scale).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.split import make_stage_task as j_make_task
from repro.core.split import mse_loss as j_mse_loss
from repro.core.split import mse_metrics as j_mse_metrics
from repro.data.synthetic import SyntheticCharLMTask as JCharLM
from repro.data.synthetic import SyntheticRegressionTask as JRegression
from repro.models import cnn as jcnn
from repro.models import lstm as jlstm
from repro_torch.core.split import make_stage_task, mse_loss, mse_metrics
from repro_torch.data.synthetic import (SyntheticCharLMTask,
                                        SyntheticRegressionTask)
from repro_torch.models import cnn, lstm
from repro_torch.utils.tree import tree_leaves, tree_unflatten_like
from repro_torch.utils.weights import to_numpy, to_torch
from torch_parity import plain_path
from torch_threads import one_thread  # noqa: F401


def _inputs(name, rng):
    """(x, y) of each model's input at the test's small size."""
    if name == "resnet9":
        return (rng.normal(size=(6, 32, 32, 3)).astype(np.float32),
                rng.integers(0, 10, 6))
    if name == "celeba_cnn":
        return (rng.normal(size=(4, 84, 84, 3)).astype(np.float32),
                rng.integers(0, 2, 4))
    if name == "shakespeare_lstm":
        return rng.integers(0, 80, (6, 20)), rng.integers(0, 80, 6)
    return (rng.normal(size=(6, 64)).astype(np.float32),
            rng.normal(size=(6, 2)).astype(np.float32))


# name -> (reference model, port model, loss kind); resnet9 and
# celeba_cnn at width 4, the LSTM and the mlp at their tasks' sizes
MODELS = {
    "resnet9": (lambda: jcnn.resnet9(10, 4), lambda: cnn.resnet9(10, 4),
                "xent"),
    "celeba_cnn": (lambda: jcnn.celeba_cnn(2, 4, 84),
                   lambda: cnn.celeba_cnn(2, 4, 84), "xent"),
    "shakespeare_lstm": (jlstm.shakespeare_lstm, lstm.shakespeare_lstm,
                         "xent"),
    "mlp": (lambda: jcnn.mlp(64, [128, 64], 2),
            lambda: cnn.mlp(64, [128, 64], 2), "mse"),
}
# every cut a model has: stages - 1 of them
STAGES = {"resnet9": 7, "celeba_cnn": 5, "shakespeare_lstm": 3, "mlp": 3}
CUTS = [(name, cut) for name, n in STAGES.items() for cut in range(1, n)]


def _setup(name, seed=0):
    jf, tf, kind = MODELS[name]
    jm, tm = jf(), tf()
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    x, y = _inputs(name, np.random.default_rng(seed))
    return jm, tm, kind, params, to_torch(params), x, y


@pytest.mark.parametrize("name,cut", CUTS, ids=[f"{n}-cut{c}" for n, c in CUTS])
def test_forward_and_gradients_match_reference_at_each_cut(name, cut):
    jm, tm, kind, params, tp, x, y = _setup(name)
    jt, tt = j_make_task(jm, cut, kind), make_stage_task(tm, cut, kind)
    assert tt.name == jt.name
    assert (tt.server_head is None) == (jt.server_head is None)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jy, ty = jnp.asarray(y), torch.from_numpy(y)
    jf = jt.client_forward(params[:cut], jx)
    tf = tt.client_forward(tp[:cut], tx)
    assert tuple(tf.shape) == jf.shape
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf),
                               atol=1e-5 * max(1.0, float(np.abs(jf).max())))
    jo = jt.server_apply(params[cut:], jf)
    to = tt.server_apply(tp[cut:], tf)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo),
                               atol=1e-5 * max(1.0, float(np.abs(jo).max())))

    jg = jax.tree_util.tree_leaves_with_path(jax.grad(
        lambda p: jt.e2e_loss(p[:cut], p[cut:], jx, jy))(params))
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    p2 = tree_unflatten_like(tp, leaves)
    loss = tt.e2e_loss(p2[:cut], p2[cut:], tx, ty)
    np.testing.assert_allclose(float(loss.detach()), float(jt.e2e_loss(
        params[:cut], params[cut:], jx, jy)), rtol=1e-5)
    tg = torch.autograd.grad(loss, leaves)
    scale = max(float(np.abs(np.asarray(g)).max()) for _, g in jg)
    assert len(tg) == len(jg)
    for (path, a), b in zip(jg, tg):
        a = np.asarray(a)
        zero = cnn.bias_before_batchnorm(plain_path(path))
        atol = 1e-5 * (scale if zero else float(np.abs(a).max()))
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=atol,
                                   err_msg=str(plain_path(path)))


@pytest.mark.parametrize("name", list(MODELS))
def test_a_cut_past_the_last_stage_is_refused(name):
    jm, tm, kind, *_ = _setup(name)
    assert jm.n_stages == tm.n_stages == STAGES[name]
    with pytest.raises(AssertionError):
        j_make_task(jm, jm.n_stages, kind)
    with pytest.raises(ValueError, match="out of range"):
        make_stage_task(tm, tm.n_stages, kind)


@pytest.mark.parametrize("name", list(MODELS))
def test_weights_carry_and_init_structure(name):
    """``utils/weights.py`` carries each model's tree leaf for leaf (the
    LSTM's ``cells`` list, BatchNorm's ``scale``/``bias``) and back; the
    port's own init has the reference's leaves, shapes and dtypes, and
    ``head_is_linear`` is the reference's."""
    jm, tm, _, params, tp, _, _ = _setup(name, seed=1)
    jl = jax.tree.leaves(params)
    for a, b in zip(jl, tree_leaves(to_numpy(tp))):
        np.testing.assert_array_equal(a, b)
    own = tree_leaves(tm.init(torch.Generator().manual_seed(0)))
    assert [tuple(t.shape) for t in own] == [a.shape for a in jl]
    assert all(t.dtype == torch.float32 for t in own)
    assert tm.head_is_linear == jm.head_is_linear
    assert (tm.n_stages, tm.n_classes) == (jm.n_stages, jm.n_classes)


@pytest.mark.parametrize("name", ["resnet9", "celeba_cnn"])
def test_batchnorm_of_a_zero_slot_is_its_bias(name):
    """A padded slot's all-zero images: batch variance 0, so every
    BatchNorm gives its bias and the output stays finite; evaluation
    uses the batch statistics too, as in the reference."""
    jm, tm, kind, params, tp, x, _ = _setup(name)
    z = np.zeros_like(x)
    want = jm.apply(params, jnp.asarray(z))
    got = tm.apply(tp, torch.from_numpy(z))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    bn = {"scale": torch.full((3,), 2.0), "bias": torch.tensor([1., -1., .5])}
    out = cnn.batchnorm(bn, torch.zeros(2, 4, 4, 3))
    assert torch.equal(out, bn["bias"].expand(2, 4, 4, 3))


def test_resnet9_global_max_splits_a_tie_like_jax():
    """The head's global max over (H, W) sends a tie's gradient to every
    tied position in equal parts, as ``jnp.max`` does."""
    m, jm = cnn.resnet9(3, 1), jcnn.resnet9(3, 1)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    x = -np.random.default_rng(0).random((2, 4, 4, 8)).astype(np.float32)
    x[0, 1, 2, 3] = x[0, 3, 0, 3] = 1.5           # a two-way tie
    x[1, :, :, 5] = 0.25                          # all sixteen tied
    jg = jax.grad(lambda f: jnp.sum(jm.stages[-1][1](params[-1], f)))(
        jnp.asarray(x))
    f = torch.from_numpy(x).requires_grad_(True)
    (tg,) = torch.autograd.grad(
        m.stages[-1][1](to_torch(params[-1]), f).sum(), f)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-8)
    two, all16 = tg[0, :, :, 3], tg[1, :, :, 5]
    assert int((two != 0).sum()) == 2 and two[1, 2] == two[3, 0] != 0
    assert bool((all16 == all16[0, 0]).all()) and all16[0, 0] != 0


@pytest.mark.parametrize("kw", [dict(n_clients=5, seed=0),
                                dict(n_clients=3, seed=2, vocab=12,
                                     samples_per_client=9,
                                     heterogeneity=0.2)],
                         ids=["default", "small"])
def test_synthetic_charlm_task_is_exact(kw):
    want, got = JCharLM(**kw).build(), SyntheticCharLMTask(**kw).build()
    for a, b in zip(want[:3], got[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(want[3], got[3]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(n_clients=6, seed=0),
                                dict(n_clients=4, seed=3, d_in=10, d_out=3,
                                     samples_per_client=7)],
                         ids=["default", "small"])
def test_synthetic_regression_task_is_exact(kw):
    want, got = JRegression(**kw).build(), SyntheticRegressionTask(**kw).build()
    for a, b in zip(want[:3], got[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(want[3], got[3]):
        np.testing.assert_array_equal(a, b)


def test_mse_loss_and_metrics_match_reference():
    rng = np.random.default_rng(5)
    pred = rng.normal(size=(16, 2)).astype(np.float32)
    y = rng.normal(size=(16, 2)).astype(np.float32)
    pred[3] = y[3] * 2.0                 # exactly aligned: 0 degrees
    pred[4] = 0.0                        # a zero prediction
    tp, ty = torch.from_numpy(pred), torch.from_numpy(y)
    np.testing.assert_allclose(float(mse_loss(tp, ty)),
                               float(j_mse_loss(jnp.asarray(pred),
                                                jnp.asarray(y))), rtol=1e-6)
    jm = j_mse_metrics(jnp.asarray(pred), jnp.asarray(y))
    tm = mse_metrics(tp, ty)
    assert set(tm) == set(jm) == {"angular_deg"}
    np.testing.assert_allclose(float(tm["angular_deg"]),
                               float(jm["angular_deg"]), rtol=1e-5)


@pytest.mark.parametrize("name", list(MODELS))
def test_leaf_paths_match_jax_and_pick_the_conv_biases_before_a_norm(name):
    """``tree_leaves_with_path`` gives JAX's key paths as plain keys, in
    ``tree_leaves`` order, over a NamedTuple of the params too; the
    BatchNorm predicate picks exactly the conv biases of resnet9 and
    celeba_cnn (every conv there feeds a norm), none of the LSTM or mlp."""
    from repro.core.protocol import EntityState as JEntityState
    from repro_torch.core.protocol import EntityState
    from repro_torch.utils.tree import tree_leaves_with_path
    _, _, _, params, tp, _, _ = _setup(name)
    jstate = {"e": JEntityState(params, [params[0]], np.int32(0))}
    tstate = {"e": EntityState(tp, [tp[0]], torch.zeros((), dtype=torch.int32))}
    jp = jax.tree_util.tree_leaves_with_path(jstate)
    got = tree_leaves_with_path(tstate)
    assert [plain_path(p) for p, _ in jp] == [p for p, _ in got]
    assert all(t is u for (_, t), u in zip(got, tree_leaves(tstate)))
    picked = [p for p, _ in tree_leaves_with_path(tp)
              if cnn.bias_before_batchnorm(p)]
    convs = [p for p, _ in tree_leaves_with_path(tp)
             if p[-1] == "w" and p[-2] in ("conv", "c1", "c2")]
    if name in ("resnet9", "celeba_cnn"):
        assert picked and [p[:-1] for p in picked] == [p[:-1] for p in convs]
    else:
        assert picked == []


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("size", [(7, 7), (8, 6), (5, 9)],
                         ids=["odd", "even", "mixed"])
def test_strided_same_conv_matches_reference(stride, size):
    """SAME convolution at every stride, odd and even sizes and kernels:
    XLA's padding rule (ceil(H / s) outputs, the smaller half of the pad
    before) against ``repro.models.cnn.conv2d``, rtol 1e-5."""
    rng = np.random.default_rng(stride)
    x = rng.normal(size=(2, *size, 3)).astype(np.float32)
    for k in (3, 2, 4):
        p = {"w": rng.normal(size=(k, k, 3, 4)).astype(np.float32),
             "b": rng.normal(size=4).astype(np.float32)}
        want = np.asarray(jcnn.conv2d({n: jnp.asarray(v) for n, v in p.items()},
                                      jnp.asarray(x), stride=stride))
        got = cnn.conv2d(to_torch(p), torch.from_numpy(x), stride=stride)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
