"""Shared harness of the algorithm-zoo parity files: one program through
``repro.api.Engine`` and ``repro_torch.api.Engine`` on one config.

The port starts from the reference's initial TrainState (carried
across), trains on the reference's resample plans (injected through
``plan_fn``), and draws the same cohorts and batches from numpy's
``default_rng(seed + 1)``.  Tolerances, as in ``test_torch_engine.py``:
per-round metrics rtol 1e-4 with the same keys (``feat_grad_norm_std``
also within 1e-5 of ``feat_grad_norm_mean``: where every slot gets one
averaged gradient, as in SGLR, the std of equal norms is float32
rounding of their mean, ~1e-10, not a spread); state leaves within
1e-5 but for at most 0.1% of a leaf's values (one value in a leaf of
fewer than 1000), each within the 2 * lr * steps that Adam's near-sign
steps can move a weight; int32 step counters equal; the final test loss
rtol 1e-4 and the accuracy within one flipped test sample (another
metric, gaze's ``angular_deg``, rtol 1e-4); the run's gradient-stability
summary rtol 1e-4, its ``grad_norm_within_batch_std`` also within 1e-5
of the mean norm (and ``grad_norm_std_over_rounds`` within
``rounds_std_atol`` of it, 0 unless a caller gives it).

Why one value a small leaf: a FedAvg of two slots whose Adam steps on a
bias have opposite signs leaves that bias at float32 rounding noise
(~1e-10), whose sign then differs between the packages; at the images'
exactly-zero pixels the pre-activation is that bias, so the next round's
ReLU gates every such pixel the other way, and the bias and its moments
move by up to ~lr in one package only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.api import Engine as JEngine
from repro.api import ExperimentConfig as JConfig
from repro.core.feature_store import masked_resample_plan as j_masked_plan
from repro.core.feature_store import resample_plan as j_plan
from repro_torch.api import Engine, ExperimentConfig
from repro_torch.utils.tree import tree_leaves
from repro_torch.utils.weights import train_state_from_reference

SMALL = dict(n_clients=10, attendance=0.3, batch=8, width=4, rounds=2,
             eval_every=2)
# padded: Binomial cohort sizes under the attendance mask, so some
# rounds carry a padded slot; unpadded: fixed cohorts, no mask
MODES = {"padded": dict(variable_attendance=True),
         "unpadded": dict(pad_cohorts=False)}
LR = 1e-3


class Recorder:
    """Each round's scalar metrics (not the health guard's vectors) and
    the last committed state."""

    def __init__(self):
        self.rows, self.state = [], None

    def on_round(self, engine, rnd, state, metrics):
        self.rows.append({k: float(v) for k, v in metrics.items()
                          if np.asarray(v).size == 1})
        self.state = state


def reference_plan_fn(total):
    """The JAX package's plan for the round whose key the port passes."""
    def plan_fn(key, valid, epochs, sb):
        jkey = jax.random.PRNGKey(key)
        if valid is None:
            return torch.from_numpy(np.array(j_plan(jkey, total, epochs,
                                                    sb))), None
        p, ok = j_masked_plan(jkey, jnp.asarray(valid.numpy()), epochs, sb)
        return torch.from_numpy(np.array(p)), torch.from_numpy(np.array(ok))
    return plan_fn


def drawn_cohorts(engine, rounds):
    """Replay the Engine's sampler: each round's cohort ids and mask."""
    rng = np.random.default_rng(engine.cfg.seed + 1)
    out = []
    for _ in range(rounds):
        cohort, _, _, mask = engine.sample_round(rng)
        out.append((cohort.numpy(), None if mask is None else mask.numpy()))
    return out


def plain_path(path) -> tuple:
    """A JAX key path as the plain keys of
    ``repro_torch.utils.tree.tree_leaves_with_path``."""
    return tuple(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k)))
                 for k in path)


def assert_rows_close(jrows, rows):
    """Per-round metrics with the same keys to rtol 1e-4
    (``feat_grad_norm_std`` also within 1e-5 of the mean norm)."""
    assert len(rows) == len(jrows)
    for r, (j, t) in enumerate(zip(jrows, rows)):
        assert set(t) == set(j), (sorted(t), sorted(j))
        for k in j:
            atol = (1e-5 * abs(j["feat_grad_norm_mean"])
                    if k == "feat_grad_norm_std" else 0.0)
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=atol,
                                       err_msg=f"round {r} {k}")


def assert_state_close(j_state, t_state, exempt=None):
    """``exempt(path)``, over a leaf's plain key path, marks leaves held
    to the 2 * lr * steps bound alone (see
    ``repro_torch.models.cnn.bias_before_batchnorm``)."""
    jp, tl = jax.tree_util.tree_leaves_with_path(j_state), tree_leaves(t_state)
    assert len(jp) == len(tl)
    steps = max(int(np.max(np.asarray(a))) for _, a in jp
                if np.asarray(a).dtype == np.int32)
    for (path, a), b in zip(jp, tl):
        a = np.asarray(a)
        if a.dtype == np.int32:
            np.testing.assert_array_equal(b.numpy(), a)
            continue
        d = np.abs(a.astype(np.float64) - b.double().numpy())
        assert d.max() <= 2 * LR * steps + 1e-6, (d.max(), steps)
        if exempt is None or not exempt(plain_path(path)):
            assert (d > 1e-5).sum() <= max(1, 1e-3 * d.size), (d > 1e-5).sum()


def check_program(algo, mode, seed, exempt=None, rounds_std_atol=0.0,
                  **overrides):
    """Run ``algo`` through both Engines and hold the port to the
    reference; returns the port's Engine and the two final states.
    ``overrides`` replace config fields of ``SMALL`` (the task, say);
    ``exempt`` goes to ``assert_state_close``; ``rounds_std_atol`` is
    the atol of ``grad_norm_std_over_rounds``, a fraction of
    ``grad_norm_mean``."""
    jcfg = JConfig(algo=algo, seed=seed, **{**SMALL, **MODES[mode],
                                            **overrides})
    jrec, trec = Recorder(), Recorder()
    jeng = JEngine(jcfg, callbacks=[jrec], log=lambda *a: None)
    state0 = jax.device_get(jeng.init_state())
    jres = jeng.run(state=state0)
    teng = Engine(ExperimentConfig.from_dict(jcfg.to_dict()), device="cpu",
                  callbacks=[trec], log=lambda *a: None,
                  plan_fn=reference_plan_fn(jeng.padded_capacity
                                            * jcfg.batch))
    assert teng.padded_capacity == jeng.padded_capacity
    t0 = train_state_from_reference(state0)
    tres = teng.run(state=t0)
    assert len(jrec.rows) == jcfg.rounds
    assert_rows_close(jrec.rows, trec.rows)
    assert_state_close(jax.device_get(jrec.state), trec.state, exempt)
    jh, th = jres["history"][-1], tres["history"][-1]
    np.testing.assert_allclose(th["test_loss"], jh["test_loss"], rtol=1e-4)
    assert teng.metric_key == jeng.metric_key
    if teng.metric_key == "accuracy":
        if trec.state.clients is None:
            scored = len(teng.fed.test_arrays()[1])
        else:
            held = [c for c in teng.fed.clients if len(c.x_test)][:40]
            scored = min(len(c.x_test) for c in held) * len(held)
        assert abs(th["accuracy"] - jh["accuracy"]) <= 1.0 / scored + 1e-6
    else:
        np.testing.assert_allclose(th[teng.metric_key], jh[teng.metric_key],
                                   rtol=1e-4)
    gs = jres["grad_stability"]
    std_atol = {"grad_norm_within_batch_std": 1e-5,
                "grad_norm_std_over_rounds": rounds_std_atol}
    for k, v in gs.items():
        atol = std_atol.get(k, 0.0) * abs(gs["grad_norm_mean"])
        np.testing.assert_allclose(tres["grad_stability"][k], v, rtol=1e-4,
                                   atol=atol, err_msg=k)
    draws = drawn_cohorts(teng, jcfg.rounds)
    if mode == "padded":
        # the masked branches ran: some round carried a padded slot
        assert any((m == 0).any() for _, m in draws), draws
    if trec.state.clients is not None:
        # a client that was in no cohort keeps its initial rows exactly
        seen = {int(c) for ids, _ in draws for c in ids}
        idle = [i for i in range(teng.fed.n_clients) if i not in seen]
        assert idle
        for a, b in zip(tree_leaves(t0.clients), tree_leaves(trec.state.clients)):
            assert torch.equal(a[idle], b[idle])
    return teng, jrec.state, trec.state
