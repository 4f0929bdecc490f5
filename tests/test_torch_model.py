"""The port's femnist_cnn, split and losses against the JAX package.

The port keeps the reference's layout at every stage boundary (NHWC
activations, HWIO conv weights, [d_in, d_out] dense weights), so the
reference's weights carry across leaf for leaf.  Tolerance: atol 1e-5
on activations of order 1 (float32 convolutions and matmuls summed in
another order by another library).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.split import make_stage_task as j_make_task
from repro.core.split import xent_loss as j_xent
from repro.core.split import xent_metrics as j_xent_metrics
from repro.models.cnn import femnist_cnn as j_femnist
from repro_torch.core.split import make_stage_task, xent_loss, xent_metrics
from repro_torch.models.cnn import femnist_cnn
from repro_torch.utils.tree import tree_leaves
from repro_torch.utils.weights import to_numpy, to_torch
from torch_threads import one_thread  # noqa: F401

WIDTH = 4


def _models():
    return j_femnist(n_classes=10, width=WIDTH), femnist_cnn(n_classes=10,
                                                             width=WIDTH)


def _x(n=6, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 28, 28, 1)
                                              ).astype(np.float32)


@pytest.mark.parametrize("cut", [1, 2, 3])
def test_split_forward_matches_reference_at_each_cut(cut):
    """Smashed data at the cut (NHWC, same shape) and the server's
    logits, with the reference's weights carried across."""
    jm, tm = _models()
    params = jm.init(jax.random.PRNGKey(0))
    jt, tt = j_make_task(jm, cut), make_stage_task(tm, cut)
    tp = to_torch(jax.device_get(params))
    x = _x()
    jf = jt.client_forward(params[:cut], jnp.asarray(x))
    tf = tt.client_forward(tp[:cut], torch.from_numpy(x))
    assert tuple(tf.shape) == jf.shape
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5)
    jo = jt.server_apply(params[cut:], jf)
    to = tt.server_apply(tp[cut:], tf)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    assert (tt.server_head is None) == (jt.server_head is None)


def test_stage_outputs_and_flatten_order_match_reference():
    """Stage by stage: the two conv stages keep NHWC, and the dense stage
    flattens NHWC (a channel-first flatten would scramble the carried
    dense weights' rows)."""
    jm, tm = _models()
    params = jm.init(jax.random.PRNGKey(1))
    tp = to_torch(jax.device_get(params))
    jx, tx = jnp.asarray(_x(seed=1)), torch.from_numpy(_x(seed=1))
    shapes = [(6, 14, 14, WIDTH), (6, 7, 7, 2 * WIDTH), (6, 2048), (6, 10)]
    for i, shape in enumerate(shapes):
        jx = jm.apply_range(params, jx, i, i + 1)
        tx = tm.apply_range(tp, tx, i, i + 1)
        assert tuple(tx.shape) == jx.shape == shape
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    # a feature map whose value encodes its (h, w, c) position
    pos = np.arange(7 * 7 * 2 * WIDTH, dtype=np.float32).reshape(
        1, 7, 7, 2 * WIDTH) / 100.0
    want = jm.stages[2][1](params[2], jnp.asarray(pos))
    got = tm.stages[2][1](tp[2], torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_port_init_has_reference_structure_and_bounds():
    """The port draws its own init (truncated normal in +-2, times
    1/sqrt(fan_in), zero conv biases): same tree, shapes and dtypes."""
    jm, tm = _models()
    jl = jax.tree.leaves(jm.init(jax.random.PRNGKey(0)))
    tl = tree_leaves(tm.init(torch.Generator().manual_seed(0)))
    assert [tuple(a.shape) for a in tl] == [a.shape for a in jl]
    assert all(a.dtype == torch.float32 for a in tl)
    fan_ins = [25, 25 * WIDTH, 7 * 7 * 2 * WIDTH, 2048]
    weights = [a for a in tl if a.dim() > 1]
    for w, fan_in in zip(weights, fan_ins):
        assert float(w.abs().max()) <= 2.0 / fan_in ** 0.5 + 1e-7
        assert float(w.std()) > 0.5 / fan_in ** 0.5
    again = tree_leaves(tm.init(torch.Generator().manual_seed(0)))
    assert all(torch.equal(a, b) for a, b in zip(tl, again))


def test_xent_loss_and_metrics_match_reference():
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(12, 10)) * 3).astype(np.float32)
    y = rng.integers(0, 10, size=12)
    np.testing.assert_allclose(
        float(xent_loss(torch.from_numpy(logits), torch.from_numpy(y))),
        float(j_xent(jnp.asarray(logits), jnp.asarray(y, jnp.int32))),
        rtol=1e-6)
    assert float(xent_metrics(torch.from_numpy(logits),
                              torch.from_numpy(y))["accuracy"]) == float(
        j_xent_metrics(jnp.asarray(logits), jnp.asarray(y))["accuracy"])


def test_weights_round_trip_including_bfloat16():
    jm, _ = _models()
    params = jax.device_get(jm.init(jax.random.PRNGKey(3)))
    back = to_numpy(to_torch(params))
    for a, b in zip(jax.tree.leaves(params), tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    bf = jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16)
    t = to_torch(jax.device_get(bf))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(t), np.asarray(bf, np.float32))
