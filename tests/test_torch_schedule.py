"""The port's learning-rate schedules, a scheduled optimizer step on a
[C]-stacked entity, and the Engine's timing windows, against the JAX
package.

Schedules: float32 on both sides, rtol 1e-6 (``cos`` and ``pow`` of two
libraries).  A stacked step: the reference's update ``jax.vmap``-ed over
the C rows (its schedule then sees one scalar step a row) against the
port's one call with a [C] step, rtol 1e-5 on updates and moments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api.engine as j_engine_mod
from repro.api import Engine as JEngine
from repro.api import ExperimentConfig as JConfig
from repro.optim import schedule as j_schedule
from repro.optim.optimizer import adam as j_adam
from repro.optim.optimizer import sgd as j_sgd
from repro_torch.api import Engine, ExperimentConfig
from repro_torch.optim import adam, schedule, sgd
from repro_torch.utils.tree import tree_leaves
from repro_torch.utils.weights import to_torch
from torch_threads import one_thread  # noqa: F401

SCHEDULES = {
    "constant": lambda m: m.constant(3e-4),
    "cosine": lambda m: m.cosine(1e-3, 5, 20, final_frac=0.1),
    "cosine-no-warmup": lambda m: m.cosine(2e-3, 0, 7),
    "exponential": lambda m: m.exponential_decay(1e-2, 0.5, 4),
}
# step 0, inside the warmup, the warmup's end, the total, past the total
STEPS = [0, 3, 5, 20, 27]


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_reference(name):
    jf, tf = SCHEDULES[name](j_schedule), SCHEDULES[name](schedule)
    for s in STEPS:
        got = tf(s)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(jf(s)), rtol=1e-6)
    steps = torch.tensor(STEPS, dtype=torch.int32)
    got = tf(steps)
    assert got.dtype == torch.float32 and got.shape == steps.shape
    assert got.device == steps.device
    want = jax.vmap(jf)(jnp.asarray(STEPS, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("warmup,total", [(-1, 10), (10, 10), (10, 4)])
def test_cosine_rejects_what_the_reference_rejects(warmup, total):
    with pytest.raises(ValueError) as want:
        j_schedule.cosine(1e-3, warmup, total)
    with pytest.raises(ValueError) as got:
        schedule.cosine(1e-3, warmup, total)
    assert str(got.value) == str(want.value)


def _stacked(seed=0):
    """A [C = 3]-stacked entity: params, grads and Adam moments with a
    [3, 4, 5] and a [3, 3] leaf, each row at its own step."""
    rng = np.random.default_rng(seed)
    leaf = lambda *s: rng.normal(size=s).astype(np.float32)
    params = {"a": leaf(3, 4, 5), "b": leaf(3, 3)}
    grads = {"a": leaf(3, 4, 5), "b": leaf(3, 3)}
    state = {"m": {"a": 0.1 * leaf(3, 4, 5), "b": 0.1 * leaf(3, 3)},
             "v": {"a": np.abs(0.1 * leaf(3, 4, 5)),
                   "b": np.abs(0.1 * leaf(3, 3))}}
    return params, grads, state, np.array([0, 6, 25], np.int32)


OPTIMIZERS = {
    "adam": lambda m, s: (j_adam if m == "jax" else adam)(
        s, weight_decay=0.01, fused=False),
    "sgd": lambda m, s: (j_sgd if m == "jax" else sgd)(s),
    "sgd-momentum": lambda m, s: (j_sgd if m == "jax" else sgd)(
        s, momentum=0.9),
}


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
@pytest.mark.parametrize("sched", ["cosine", "exponential"])
def test_scheduled_step_on_a_stacked_entity_matches_vmap(opt, sched):
    """Each row takes the lr of its own step: the reference vmaps the
    update over rows.  A schedule broadcast over the last dim instead
    raises on the [3, 4, 5] leaf and mixes the steps across the [3, 3]
    leaf's columns."""
    params, grads, state, steps = _stacked()
    jopt = OPTIMIZERS[opt]("jax", SCHEDULES[sched](j_schedule))
    topt = OPTIMIZERS[opt]("torch", SCHEDULES[sched](schedule))
    if opt != "adam":
        state = state["m"] if opt == "sgd-momentum" else ()
    jupd, jst = jax.vmap(jopt.update)(grads, state, params, steps)
    tupd, tst = topt.update(to_torch(grads), to_torch(state),
                            to_torch(params), torch.from_numpy(steps))
    for a, b in zip(jax.tree.leaves((jupd, jst)), tree_leaves((tupd, tst))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-9)


def test_a_schedule_takes_the_plain_adam_step():
    lr = schedule.cosine(1e-3, 2, 10)
    assert adam(lr).apply is None and adam(1e-3).apply is not None
    with pytest.raises(ValueError, match="constant lr"):
        adam(lr, fused=True)


def _timing_counts(sync_every, rounds, monkeypatch):
    """Host syncs of one run of each Engine under collect_timing, and
    the port's result."""
    kw = dict(task="gaze", n_clients=10, attendance=0.3, batch=8,
              rounds=rounds, eval_every=rounds, collect_timing=True,
              sync_every=sync_every)
    counts = {"jax": 0, "torch": 0}
    block = jax.block_until_ready

    def j_sync(x):
        counts["jax"] += 1
        return block(x)
    monkeypatch.setattr(j_engine_mod.jax, "block_until_ready", j_sync)
    jres = JEngine(JConfig(**kw), log=lambda *a: None).run()
    monkeypatch.undo()
    eng = Engine(ExperimentConfig(**kw), device="cpu", log=lambda *a: None)
    sync = eng.sync

    def t_sync(metrics):
        counts["torch"] += 1
        return sync(metrics)
    eng.sync = t_sync
    return counts, eng.run(), jres


@pytest.mark.parametrize("sync_every", [1, 3])
def test_timing_windows_follow_the_reference(sync_every, monkeypatch):
    """sync_every 1: one sync a round, the first round untimed.  3: the
    first round synced alone, then a sync closing each window of 3
    rounds and one at the last round."""
    rounds = 7
    counts, res, jres = _timing_counts(sync_every, rounds, monkeypatch)
    want = rounds if sync_every == 1 else 1 + sum(
        1 for r in range(1, rounds)
        if r == rounds - 1 or (r + 1) % sync_every == 0)
    assert counts == {"jax": want, "torch": want}
    assert res["round_time_s"] > 0 and jres["round_time_s"] > 0
    assert "round_time_s" in res and set(res) <= set(jres)


def test_no_timing_without_collect_timing_and_sync_every_zero_raises():
    cfg = ExperimentConfig(task="gaze", n_clients=10, attendance=0.3,
                           batch=8, rounds=2, eval_every=2)
    assert "round_time_s" not in Engine(cfg, device="cpu",
                                        log=lambda *a: None).run()
    with pytest.raises(ValueError, match="sync_every=0"):
        ExperimentConfig(sync_every=0).validate()
    with pytest.raises(ValueError, match="sync_every"):
        JConfig(sync_every=0).validate()
