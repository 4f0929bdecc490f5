"""Each phase the algorithm zoo adds, alone, against ``repro.api.phases``
on the CPU; the variable-attendance sampler and Engine capacity; the
per-client evaluation.

Both packages get the same numpy inputs and the same initial weights
(carried from the JAX package).  Tolerances as in
``test_torch_core.py``: losses and norms rtol 1e-5; params after Adam
steps within 1e-6 but for 0.1% of a leaf (one value in a smaller leaf),
each within 2 * lr * steps; int32 steps equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import phases as jph
from repro.api.engine import Engine as JEngine
from repro.api.engine import evaluate as j_evaluate
from repro.api.config import ExperimentConfig as JConfig
from repro.api.tasks import build_task as j_build_task
from repro.core import protocol as jp
from repro.core.cyclesl import CycleConfig as JCycle
from repro.data import federated as jfed
from repro.optim import adam as j_adam
from repro_torch.api import Engine, ExperimentConfig, evaluate
from repro_torch.api import phases as tph
from repro_torch.api.tasks import build_task
from repro_torch.core import protocol as tp
from repro_torch.core.cyclesl import CycleConfig, feature_gradients
from repro_torch.data import federated as tfed
from repro_torch.optim import adam
from repro_torch.utils.tree import tree_leaves, tree_map
from repro_torch.utils.weights import to_numpy, train_state_from_reference
from torch_threads import one_thread  # noqa: F401

LR = 1e-3
WIDTH, C, B, N = 4, 4, 8, 6
MASKS = {"none": None, "padded-middle": np.array([1, 0, 1, 1], np.float32)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_adam_close(j_tree, t_tree, steps):
    jl, tl = jax.tree.leaves(j_tree), tree_leaves(t_tree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        if a.dtype == np.int32:
            np.testing.assert_array_equal(b.numpy(), a)
            continue
        d = np.abs(a.astype(np.float64) - b.double().numpy())
        assert d.max() <= 2 * LR * steps + 1e-6, d.max()
        assert (d > 1e-6).sum() <= max(1, 1e-3 * d.size), (d > 1e-6).sum()


@pytest.fixture(scope="module")
def setup():
    """Both tasks, a TrainState with a shared client model and one with
    a per-client store whose rows differ, and one round's inputs."""
    jtask, _, _ = j_build_task("image", N, 0.5, 0, WIDTH, 2)
    ttask, _, _ = build_task("image", N, 0.5, 0, WIDTH, 2)
    jopt = j_adam(LR)
    ks, kc = jax.random.split(jax.random.PRNGKey(5))
    server = jp.init_entity(jtask.init_server(ks), jopt)
    client = jp.init_entity(jtask.init_client(kc), jopt)
    rng = np.random.default_rng(7)
    store = jp.broadcast_entity(client, N)
    store = store._replace(params=jax.tree.map(
        lambda p: p + jnp.asarray(rng.normal(size=p.shape) * 0.05,
                                  p.dtype), store.params))
    states = {"global": jph.TrainState(server, None, client),
              "per_client": jph.TrainState(server, store, None)}
    xs = rng.normal(size=(C, B, 28, 28, 1)).astype(np.float32)
    ys = rng.integers(0, 10, size=(C, B)).astype(np.int32)
    return jtask, ttask, jax.device_get(states), xs, ys


def _run(setup, phases_j, phases_t, state="global", mask=None,
         cohort=(0, 2, 3, 5), grad_clip=None, fgrads=None):
    """Run the phase lists on one round's inputs; returns both
    RoundVars."""
    jtask, ttask, states, xs, ys = setup
    jctx = jph.PhaseContext(jtask, j_adam(LR), j_adam(LR),
                            JCycle(grad_clip=grad_clip))
    tctx = tph.PhaseContext(ttask, adam(LR), adam(LR),
                            CycleConfig(grad_clip=grad_clip))
    m = None if mask is None else np.asarray(mask, np.float32)
    jv = jph.RoundVars(state=jax.tree.map(jnp.asarray, states[state]),
                       cohort=jnp.asarray(cohort),
                       xs=jnp.asarray(xs), ys=jnp.asarray(ys),
                       key=jax.random.PRNGKey(0),
                       mask=None if m is None else jnp.asarray(m))
    tv = tph.RoundVars(state=train_state_from_reference(states[state]),
                       cohort=_t(np.asarray(cohort)), xs=_t(xs), ys=_t(ys),
                       key=0, mask=None if m is None else _t(m))
    if fgrads is not None:
        jv.fgrads, tv.fgrads = jnp.asarray(fgrads), _t(fgrads)
    for p in phases_j:
        p(jctx, jv)
    for p in phases_t:
        p(tctx, tv)
    return jv, tv


def _assert_metrics(jv, tv):
    assert set(tv.metrics) == set(jv.metrics)
    for k in jv.metrics:
        np.testing.assert_allclose(float(tv.metrics[k]),
                                   float(jv.metrics[k]), rtol=1e-5,
                                   atol=1e-6 * abs(float(jv.metrics.get(
                                       "feat_grad_norm_mean", 0.0))),
                                   err_msg=k)


# ------------------------------------------------------------ ServerUpdate
@pytest.mark.parametrize("mask_name", list(MASKS))
@pytest.mark.parametrize("mode", ["replica_avg", "mean_grad"])
def test_server_update_matches_reference(setup, mode, mask_name):
    """PSL/SFL-V1's replica step + (masked) replica mean, and SGLR's
    (masked) mean gradient step: one Adam step of the server, whose
    int32 step stays 1 through the mean."""
    mask = MASKS[mask_name]
    jv, tv = _run(setup, [jph.ExtractFeatures(), jph.ServerUpdate(mode)],
                  [tph.ExtractFeatures(), tph.ServerUpdate(mode)],
                  state="per_client", mask=mask)
    _assert_metrics(jv, tv)
    _assert_adam_close(jax.device_get(jv.state.server), tv.state.server, 1)
    assert tv.state.server.step.dtype == torch.int32
    assert int(tv.state.server.step) == 1


def test_unknown_modes_raise(setup):
    for bad in (tph.ServerUpdate("bogus"), tph.Commit("bogus")):
        with pytest.raises(ValueError, match="bogus"):
            _run(setup, [], [tph.ExtractFeatures(), bad])


# -------------------------------------------------------- FeatureGradients
def test_classic_feature_gradients_read_the_pre_update_server(setup):
    """use_updated=False reads the θ_S^t snapshot: after a server step it
    equals the gradients at the initial server exactly, differs from
    use_updated=True, and matches the reference."""
    jv, tv = _run(setup, [jph.ExtractFeatures(), jph.ServerUpdate(
        "replica_avg"), jph.FeatureGradients(use_updated=False)],
        [tph.ExtractFeatures(), tph.ServerUpdate("replica_avg")])
    server0 = train_state_from_reference(setup[2]["global"]).server.params
    ttask, cfg = setup[1], CycleConfig()
    want = feature_gradients(ttask, server0, tv.feats, tv.ys, cfg)
    tph.FeatureGradients(use_updated=False)(
        tph.PhaseContext(ttask, adam(LR), adam(LR), cfg), tv)
    old = tv.fgrads
    assert torch.equal(old, want)
    for a, b in zip(tree_leaves(tv.server_prev), tree_leaves(server0)):
        assert torch.equal(a, b)            # the step wrote fresh tensors
    np.testing.assert_allclose(old.numpy(), np.asarray(jv.fgrads),
                               rtol=1e-5, atol=1e-8)
    tph.FeatureGradients(use_updated=True)(
        tph.PhaseContext(ttask, adam(LR), adam(LR), cfg), tv)
    assert not torch.allclose(tv.fgrads, old, rtol=1e-3, atol=0)


# ------------------------------------------------------------ ClientUpdate
@pytest.mark.parametrize("clip", [None, 0.05], ids=["noclip", "clip"])
@pytest.mark.parametrize("mask_name", list(MASKS))
def test_chained_client_update_matches_reference(setup, mask_name, clip):
    """cyclessl's chain: one client entity carried along the slots; the
    padded slot in the middle passes the carry through and reads a grad
    norm of 0, so the chain steps once per live slot."""
    mask = MASKS[mask_name]
    rng = np.random.default_rng(3)
    fg = (rng.normal(size=(C, B, 7, 7, 2 * WIDTH)) * 1e-2).astype(np.float32)
    phase = dict(record_gnorm=True, chained=True)
    jv, tv = _run(setup, [jph.ClientUpdate(**phase)],
                  [tph.ClientUpdate(**phase)], mask=mask, grad_clip=clip,
                  fgrads=fg)
    live = C if mask is None else int(mask.sum())
    assert int(tv.cohort_clients.step) == live
    _assert_adam_close(jax.device_get(jv.cohort_clients), tv.cohort_clients,
                       live)
    _assert_metrics(jv, tv)


# ------------------------------------------------------------------ Commit
def test_commit_per_client_drops_the_sentinel(setup):
    """The per-client scatter writes the live slots' rows and drops the
    padded slots' sentinel id N; every other row stays bit-equal."""
    jv, tv = _run(setup, [jph.ExtractFeatures()], [tph.ExtractFeatures()],
                  state="per_client", cohort=(4, 1, N, N))
    start = train_state_from_reference(setup[2]["per_client"]).clients
    rng = np.random.default_rng(4)
    vals = tree_map(lambda x: (x + 7 if x.dtype == torch.int32 else _t(
        rng.normal(size=tuple(x.shape)).astype(np.float32))),
        tv.cohort_clients)
    tv.cohort_clients = vals
    jv.cohort_clients = jp.EntityState(*(jax.tree.map(jnp.asarray, part)
                                         for part in to_numpy(vals)))
    tph.Commit("per_client")(None, tv)
    jph.Commit("per_client")(None, jv)
    for a, b, s0, v in zip(jax.tree.leaves(jv.state.clients),
                           tree_leaves(tv.state.clients), tree_leaves(start),
                           tree_leaves(vals)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert torch.equal(b[[0, 2, 3, 5]], s0[[0, 2, 3, 5]])
        assert torch.equal(b[[4, 1]], v[:2])


def test_stack_entities_matches_reference():
    rng = np.random.default_rng(2)
    ents = [(rng.normal(size=(3, 2)).astype(np.float32), np.int32(i))
            for i in range(4)]
    want = jp.stack_entities([jp.EntityState({"w": jnp.asarray(w)}, (),
                                             jnp.asarray(s))
                              for w, s in ents])
    got = tp.stack_entities([tp.EntityState({"w": _t(w)}, (), _t(s))
                             for w, s in ents])
    np.testing.assert_array_equal(got.params["w"].numpy(),
                                  np.asarray(want.params["w"]))
    assert got.step.dtype == torch.int32
    np.testing.assert_array_equal(got.step.numpy(), np.asarray(want.step))


# ------------------------------------------------------ variable attendance
def test_variable_cohort_draws_match_reference():
    """Binomial cohort sizes clipped to [min_cohort, max_cohort]: the
    same generator calls in the same order, over many seeds."""
    for seed in range(200):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        n = 5 + seed % 40
        att = (0.05, 0.3, 0.5)[seed % 3]
        kw = dict(min_cohort=1 + seed % 3, variable=True,
                  max_cohort=None if seed % 4 == 0 else max(2, n // 3))
        for _ in range(3):
            np.testing.assert_array_equal(
                tfed.sample_cohort(n, att, rt, **kw),
                jfed.sample_cohort(n, att, rj, **kw))
        assert rj.integers(1 << 30) == rt.integers(1 << 30)


@pytest.mark.parametrize("n,att", [(20, 0.3), (100, 0.05), (10, 0.3),
                                   (7, 0.5)])
def test_variable_capacity_matches_reference(n, att):
    """The tolerant ceil (0.3 * 20 is 6.000000000000001 in binary)."""
    kw = dict(n_clients=n, attendance=att, width=4, variable_attendance=True)
    want = JEngine(JConfig(**kw), log=lambda *a: None).cohort_capacity
    assert Engine(ExperimentConfig(**kw), device="cpu").cohort_capacity \
        == want


@pytest.mark.parametrize("algo", ["cyclesfl", "psl"])
def test_variable_server_batch_guard_matches_reference(algo):
    """Cycle programs refuse a server batch above min_cohort x batch
    under variable attendance; the others take it."""
    kw = dict(algo=algo, n_clients=10, attendance=0.3, batch=8, width=4,
              variable_attendance=True)
    ExperimentConfig(variable_attendance=True).validate()
    jcfg, tcfg = (JConfig(**kw).with_cycle(server_batch=20),
                  ExperimentConfig(**kw).with_cycle(server_batch=20))
    if algo == "psl":
        JEngine(jcfg, log=lambda *a: None)
        Engine(tcfg, device="cpu")
        return
    for make in (lambda: JEngine(jcfg, log=lambda *a: None),
                 lambda: Engine(tcfg, device="cpu")):
        with pytest.raises(ValueError, match="server_batch"):
            make()


# --------------------------------------------------- per-client evaluation
@pytest.mark.parametrize("max_clients", [40, 3])
def test_per_client_evaluate_matches_reference(setup, max_clients):
    """Each of the first clients with test data scored with its own model
    on its first t samples, unweighted mean over clients; a client
    without test data is skipped."""
    _, jfd, _ = j_build_task("image", N, 0.5, 0, WIDTH, 2)
    ttask, tfd, _ = build_task("image", N, 0.5, 0, WIDTH, 2)
    for fd in (jfd, tfd):
        fd.clients[1].x_test = fd.clients[1].x_test[:0]
        fd.clients[1].y_test = fd.clients[1].y_test[:0]
    state = setup[2]["per_client"]
    jloss, jm = j_evaluate(setup[0], state, jfd, max_clients=max_clients)
    tloss, tm = evaluate(ttask, train_state_from_reference(state), tfd,
                         max_clients=max_clients)
    held = [c for c in tfd.clients if len(c.x_test)][:max_clients]
    scored = min(len(c.x_test) for c in held) * len(held)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert set(tm) == set(jm)
    assert abs(tm["accuracy"] - jm["accuracy"]) <= 1.0 / scored + 1e-6


def test_per_client_evaluate_without_test_data_is_nan(setup):
    ttask, tfd, _ = build_task("image", N, 0.5, 0, WIDTH, 2)
    for c in tfd.clients:
        c.x_test, c.y_test = c.x_test[:0], c.y_test[:0]
    state = train_state_from_reference(setup[2]["per_client"])
    with pytest.warns(RuntimeWarning, match="no sampled client"):
        loss, mets = evaluate(ttask, state, tfd)
    assert np.isnan(loss) and mets == {}
