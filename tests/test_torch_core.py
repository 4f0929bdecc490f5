"""The port's CycleSL core, held against ``repro.core`` on the CPU.

Both packages get the same numpy inputs, the same initial weights
(carried from the JAX package) and, for the server loop, the JAX
package's own resample plan, injected through ``plan_fn``.

Tolerances.  Losses and gradient norms: rtol 1e-5 (float32 sums in
another order).  Params after Adam steps: Adam's first steps move a
weight by about lr * g / (|g| + eps), nearly its sign, so a weight whose
gradient is tiny may move by a visibly different fraction of lr when its
gradient differs in the last bits.  ``_assert_adam_close`` therefore
holds all but 0.1% of the weights to 1e-6 and every weight to the
2 * lr * steps that such a step can move it at most.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cyclesl as jc
from repro.core import protocol as jp
from repro.core.feature_store import FeatureStore as JStore
from repro.core.feature_store import masked_resample_plan as j_masked_plan
from repro.core.feature_store import resample_plan as j_plan
from repro.core.split import make_stage_task as j_make_task
from repro.models.cnn import femnist_cnn as j_femnist
from repro.optim import adam as j_adam
from repro_torch.core import cyclesl as tc
from repro_torch.core import protocol as tp
from repro_torch.core.feature_store import (FeatureStore, gather_batch,
                                            masked_resample_plan,
                                            resample_plan)
from repro_torch.core.split import make_stage_task
from repro_torch.models.cnn import femnist_cnn
from repro_torch.optim import adam
from repro_torch.utils.tree import tree_leaves
from repro_torch.utils.weights import to_torch
from torch_threads import one_thread  # noqa: F401

LR = 1e-3
WIDTH, C, B = 4, 4, 8
MASKS = {"none": None, "partial": np.array([1, 1, 0, 1], np.float32)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _entity(j_entity):
    return tp.EntityState(*(to_torch(jax.device_get(x)) for x in j_entity))


def _assert_adam_close(j_tree, t_tree, steps):
    jl, tl = jax.tree.leaves(j_tree), tree_leaves(t_tree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        d = np.abs(np.asarray(a, np.float32) - b.float().numpy())
        assert d.max() <= 2 * LR * steps + 1e-6, d.max()
        assert (d > 1e-6).mean() <= 1e-3, (d > 1e-6).mean()


def _tasks(cut):
    return (j_make_task(j_femnist(n_classes=10, width=WIDTH), cut),
            make_stage_task(femnist_cnn(n_classes=10, width=WIDTH), cut))


def _feat_shape(cut):
    return {1: (14, 14, WIDTH), 2: (7, 7, 2 * WIDTH), 3: (2048,)}[cut]


def _ref_plan_fn(jkey, total=C * B):
    """plan_fn feeding the port the JAX package's plan for ``jkey`` over
    a pool of ``total`` rows (dense when the pool has no mask)."""
    def plan_fn(key, valid, epochs, sb):
        if valid is None:
            return _t(j_plan(jkey, total, epochs, sb)), None
        p, ok = j_masked_plan(jkey, jnp.asarray(valid.numpy()), epochs, sb)
        return _t(p), _t(ok)
    return plan_fn


# ---------------------------------------------------------------- protocol
def test_entity_means_keep_int32_steps_and_match_reference():
    rng = np.random.default_rng(0)
    stacked = (rng.normal(size=(5, 3, 2)).astype(np.float32),
               np.array([4, 4, 4, 4, 4], np.int32))
    mask = np.array([1, 0, 1, 1, 0], np.float32)
    j = jp.EntityState({"w": jnp.asarray(stacked[0])}, (),
                       jnp.asarray(stacked[1]))
    t = tp.EntityState({"w": _t(stacked[0])}, (), _t(stacked[1]))
    for jf, tf in ((lambda e: jp.entity_mean(e), tp.entity_mean),
                   (lambda e: jp.masked_entity_mean(e, jnp.asarray(mask)),
                    lambda e: tp.masked_entity_mean(e, _t(mask)))):
        je, te = jf(j), tf(t)
        assert te.step.dtype == torch.int32 and int(te.step) == 4
        np.testing.assert_allclose(te.params["w"].numpy(),
                                   np.asarray(je.params["w"]), rtol=1e-6)


def test_select_take_put_broadcast_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 3)).astype(np.float32)
    j = jp.EntityState(jnp.asarray(x), (), jnp.arange(6, dtype=jnp.int32))
    t = tp.EntityState(_t(x), (), torch.arange(6, dtype=torch.int32))
    ids = np.array([4, 1, 6, 6], np.int32)          # 6 = sentinel id N
    jt, tt = jp.take_entities(j, jnp.asarray(ids)), tp.take_entities(t, _t(ids))
    np.testing.assert_array_equal(tt.params.numpy(), np.asarray(jt.params))
    vals = rng.normal(size=(4, 3)).astype(np.float32)
    jv = jp.EntityState(jnp.asarray(vals), (), jnp.full((4,), 9, jnp.int32))
    tv = tp.EntityState(_t(vals), (), torch.full((4,), 9, dtype=torch.int32))
    jput = jp.put_entities(j, jnp.asarray(ids), jv)
    tput = tp.put_entities(t, _t(ids), tv)
    np.testing.assert_array_equal(tput.params.numpy(), np.asarray(jput.params))
    np.testing.assert_array_equal(tput.step.numpy(), np.asarray(jput.step))
    m = np.array([1, 0, 0, 1], np.float32)
    jsel = jp.select_entities(jnp.asarray(m), jv, jt)
    tsel = tp.select_entities(_t(m), tv, tt)
    np.testing.assert_array_equal(tsel.params.numpy(), np.asarray(jsel.params))
    one = tp.EntityState(_t(x[0]), (), torch.tensor(3, dtype=torch.int32))
    b = tp.broadcast_entity(one, 3)
    assert b.params.is_contiguous() and tuple(b.step.shape) == (3,)
    np.testing.assert_array_equal(b.params.numpy(), np.stack([x[0]] * 3))


# ------------------------------------------------------- server inner loop
@pytest.mark.parametrize("cut,fused", [(2, False), (3, False), (3, True)],
                         ids=["cut2", "cut3", "cut3-fused"])
@pytest.mark.parametrize("mask_name", list(MASKS))
def test_server_inner_loop_matches_reference(cut, fused, mask_name):
    """Classic and fused paths, with the reference's plan injected; the
    partial mask leaves one no-op step per epoch (24 live rows of 32,
    server batch 8), which must not step the server."""
    jt, tt = _tasks(cut)
    rng = np.random.default_rng(cut)
    feats = np.maximum(rng.normal(size=(C, B) + _feat_shape(cut)), 0
                       ).astype(np.float32)
    ys = rng.integers(0, 10, size=(C, B))
    mask = MASKS[mask_name]
    jopt = j_adam(LR)
    js = jp.init_entity(jt.init_server(jax.random.PRNGKey(0)), jopt)
    jkey = jax.random.PRNGKey(5)
    ccfg = dict(server_epochs=2, fused_gather_loss=fused)
    jstore = JStore.pool(jnp.asarray(feats), jnp.asarray(ys, jnp.int32),
                         None if mask is None else jnp.asarray(mask))
    js2, jloss = jc.server_inner_loop(jt, js, jopt, jstore, jkey,
                                      jc.CycleConfig(**ccfg), batch=B)
    tstore = FeatureStore.pool(_t(feats), _t(ys),
                               None if mask is None else _t(mask))
    if fused:
        assert tt.server_head is not None
    ts2, tloss = tc.server_inner_loop(tt, _entity(js), adam(LR), tstore, 0,
                                      tc.CycleConfig(**ccfg), batch=B,
                                      plan_fn=_ref_plan_fn(jkey))
    steps = 8 if mask is None else 6
    assert int(ts2.step) == int(js2.step) == steps
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _assert_adam_close(js2.params, ts2.params, steps)
    _assert_adam_close(js2.opt_state, ts2.opt_state, steps)


def test_fused_and_classic_server_loops_agree():
    """The fused gather + loss trains the head as gather-then-loss does
    (the port's own plan; atol 1e-5 on params, rtol 1e-5 on the loss)."""
    _, tt = _tasks(3)
    rng = np.random.default_rng(3)
    feats = _t(np.maximum(rng.normal(size=(C, B, 2048)), 0).astype(np.float32))
    store = FeatureStore.pool(feats, _t(rng.integers(0, 10, size=(C, B))),
                              _t(MASKS["partial"]))
    server = tp.init_entity(tt.init_server(torch.Generator().manual_seed(0)),
                            adam(LR))
    out = [tc.server_inner_loop(tt, server, adam(LR), store, 11,
                                tc.CycleConfig(server_epochs=2,
                                               fused_gather_loss=f), batch=B)
           for f in (False, True)]
    np.testing.assert_allclose(float(out[0][1]), float(out[1][1]), rtol=1e-5)
    for a, b in zip(tree_leaves(out[0][0]), tree_leaves(out[1][0])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=1e-5)


# ----------------------------------------------------- feature gradients
@pytest.mark.parametrize("avg", [False, True], ids=["per-client", "sglr"])
@pytest.mark.parametrize("mask_name", list(MASKS))
def test_feature_gradients_match_reference(avg, mask_name):
    """Per-client gradients of each client's OWN batch-mean loss (rtol
    1e-5, atol 1e-8 for gradients that are near zero)."""
    jt, tt = _tasks(2)
    rng = np.random.default_rng(4)
    feats = np.maximum(rng.normal(size=(C, B) + _feat_shape(2)), 0
                       ).astype(np.float32)
    ys = rng.integers(0, 10, size=(C, B))
    mask = MASKS[mask_name]
    sp = jt.init_server(jax.random.PRNGKey(1))
    want = jc.feature_gradients(jt, sp, jnp.asarray(feats),
                                jnp.asarray(ys, jnp.int32),
                                jc.CycleConfig(avg_client_grads=avg),
                                mask=None if mask is None else jnp.asarray(mask))
    got = tc.feature_gradients(tt, to_torch(jax.device_get(sp)), _t(feats),
                               _t(ys), tc.CycleConfig(avg_client_grads=avg),
                               mask=None if mask is None else _t(mask))
    assert tuple(got.shape) == feats.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-8)


def test_feature_gradients_are_each_clients_own_scale():
    """Slot c's gradient equals that of slot c's loss alone: a pooled
    mean over all C*b rows would be C times smaller."""
    _, tt = _tasks(2)
    rng = np.random.default_rng(5)
    feats = _t(rng.normal(size=(C, B) + _feat_shape(2)).astype(np.float32))
    ys = _t(rng.integers(0, 10, size=(C, B)))
    sp = tt.init_server(torch.Generator().manual_seed(0))
    got = tc.feature_gradients(tt, sp, feats, ys, tc.CycleConfig())
    for c in range(C):
        f = feats[c].clone().requires_grad_(True)
        (alone,) = torch.autograd.grad(tt.server_loss(sp, f, ys[c]), f)
        np.testing.assert_allclose(got[c].numpy(), alone.numpy(), rtol=1e-6,
                                   atol=1e-9)


# ---------------------------------------------------------- client update
@pytest.mark.parametrize("clip", [None, 0.05], ids=["noclip", "clip"])
@pytest.mark.parametrize("mask_name", list(MASKS))
def test_client_updates_match_reference(clip, mask_name):
    """Per-slot VJP + one stacked Adam step; the norm is taken after
    clipping; padded slots pass through with norm 0."""
    jt, tt = _tasks(2)
    rng = np.random.default_rng(6)
    xs = rng.normal(size=(C, B, 28, 28, 1)).astype(np.float32)
    fg = (rng.normal(size=(C, B) + _feat_shape(2)) * 1e-2).astype(np.float32)
    mask = MASKS[mask_name]
    jopt = j_adam(LR)
    je = jp.broadcast_entity(
        jp.init_entity(jt.init_client(jax.random.PRNGKey(2)), jopt), C)
    je = je._replace(step=jnp.asarray([0, 3, 3, 1], jnp.int32))
    jnew, jn = jc.client_updates(jt, je, jopt, jnp.asarray(xs),
                                 jnp.asarray(fg), grad_clip=clip,
                                 mask=None if mask is None else jnp.asarray(mask))
    tnew, tn = tc.client_updates(tt, _entity(je), adam(LR), _t(xs), _t(fg),
                                 grad_clip=clip,
                                 mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5)
    np.testing.assert_array_equal(tnew.step.numpy(), np.asarray(jnew.step))
    _assert_adam_close(jnew.params, tnew.params, 1)
    _assert_adam_close(jnew.opt_state, tnew.opt_state, 1)


def test_cyclesl_round_matches_reference():
    """Algorithm 1 end to end on an unpadded cohort (extract, server
    loop with the injected plan, feature gradients, client steps)."""
    jt, tt = _tasks(2)
    rng = np.random.default_rng(8)
    xs = rng.normal(size=(C, B, 28, 28, 1)).astype(np.float32)
    ys = rng.integers(0, 10, size=(C, B))
    jopt = j_adam(LR)
    jserver = jp.init_entity(jt.init_server(jax.random.PRNGKey(3)), jopt)
    jclients = jp.broadcast_entity(
        jp.init_entity(jt.init_client(jax.random.PRNGKey(4)), jopt), C)
    jkey = jax.random.PRNGKey(9)
    js, jcl, jm = jc.cyclesl_round(jt, jserver, jclients, jopt, jopt,
                                   jnp.asarray(xs), jnp.asarray(ys, jnp.int32),
                                   jkey, jc.CycleConfig())
    ts, tcl, tm = tc.cyclesl_round(tt, _entity(jserver), _entity(jclients),
                                   adam(LR), adam(LR), _t(xs), _t(ys), 0,
                                   tc.CycleConfig(),
                                   plan_fn=_ref_plan_fn(jkey))
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    _assert_adam_close(js.params, ts.params, 4)
    _assert_adam_close(jcl.params, tcl.params, 1)


# ------------------------------------------------------ the port's own plan
def _live_order(plan, valid):
    flat = plan.reshape(plan.shape[0], -1)
    return [[int(r) for r in row if valid[int(r)] > 0] for row in flat]


@pytest.mark.parametrize("pad", [8, 24])
def test_own_plan_live_order_is_capacity_invariant(pad):
    """The live rows come in the same order whatever padding follows."""
    live, batch, epochs = 40, 8, 3
    base = torch.ones(live)
    padded = torch.cat([base, torch.zeros(pad)])
    p0, ok0 = masked_resample_plan(77, base, epochs, batch)
    p1, ok1 = masked_resample_plan(77, padded, epochs, batch)
    assert p1.dtype == torch.int32 and tuple(p1.shape) == (
        epochs, (live + pad) // batch, batch)
    assert _live_order(p0, base) == _live_order(p1, padded)
    np.testing.assert_array_equal(ok1[:, : ok0.shape[1]].numpy(), ok0.numpy())


def test_own_plan_valid_steps_hold_only_live_rows():
    """Interleaved dead slots (churn-style masks): a valid step never
    holds a dead row, and the valid steps number n_live // batch."""
    batch, epochs = 8, 4
    valid = _t(np.repeat(np.array([1, 0, 1, 1, 0, 1, 0, 1], np.float32), 6))
    n_live = int(valid.sum())
    plan, ok = masked_resample_plan(123, valid, epochs, batch)
    for e in range(epochs):
        assert int(ok[e].sum()) == n_live // batch
        for s in range(plan.shape[1]):
            if ok[e, s]:
                assert bool((valid[plan[e, s].long()] > 0).all())
        # each epoch is a permutation of all rows
        full = torch.sort(plan[e].reshape(-1)).values
        assert len(set(full.tolist())) == full.numel()


def test_own_plan_is_keyed_and_deterministic():
    valid = torch.ones(64)
    a, _ = masked_resample_plan(5, valid, 2, 8)
    b, _ = masked_resample_plan(5, valid, 2, 8)
    c, _ = masked_resample_plan(6, valid, 2, 8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])          # a fresh shuffle per epoch
    dense = resample_plan(5, 64, 2, 8)
    assert torch.equal(dense, a)


def test_gather_batch_gathers_features_and_labels():
    rng = np.random.default_rng(9)
    f = _t(rng.normal(size=(16, 3, 2)).astype(np.float32))
    y = _t(rng.integers(0, 5, size=16))
    idx = _t(np.array([3, 3, 0, 15], np.int32))
    gf, gy = gather_batch(FeatureStore(f, y), idx)
    np.testing.assert_array_equal(gf.numpy(), f.numpy()[[3, 3, 0, 15]])
    np.testing.assert_array_equal(gy.numpy(), y.numpy()[[3, 3, 0, 15]])


def test_client_update_one_matches_reference():
    """One client's VJP step (the single-entity form the chained
    variants share): the norm after clipping, rtol 1e-5."""
    jt, tt = _tasks(2)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(B, 28, 28, 1)).astype(np.float32)
    g = (rng.normal(size=(B,) + _feat_shape(2)) * 1e-2).astype(np.float32)
    jopt = j_adam(LR)
    je = jp.init_entity(jt.init_client(jax.random.PRNGKey(6)), jopt)
    jnew, jn = jc.client_update_one(jt, je, jnp.asarray(x), jnp.asarray(g),
                                    jopt, grad_clip=0.05)
    tnew, tn = tc.client_update_one(tt, _entity(je), _t(x), _t(g), adam(LR),
                                    grad_clip=0.05)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)
    assert int(tnew.step) == 1
    _assert_adam_close(jnew.params, tnew.params, 1)


@pytest.mark.parametrize("mask_name", list(MASKS))
def test_phase_metrics_match_reference(mask_name):
    """masked_mean and feat_grad_metrics (masked mean and population std
    of the per-slot feature-gradient norms), rtol 1e-6."""
    from repro.api.phases import feat_grad_metrics as j_fgm
    from repro.api.phases import masked_mean as j_mm
    from repro_torch.api.phases import feat_grad_metrics, masked_mean
    rng = np.random.default_rng(11)
    fg = rng.normal(size=(C, B, 3, 2)).astype(np.float32)
    x = rng.normal(size=(C,)).astype(np.float32)
    mask = MASKS[mask_name]
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    np.testing.assert_allclose(float(masked_mean(_t(x), tm)),
                               float(j_mm(jnp.asarray(x), jm)), rtol=1e-6)
    want, got = j_fgm(jnp.asarray(fg), jm), feat_grad_metrics(_t(fg), tm)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
