"""Shared harness of the checkpoint, scenario and resilience parity files:
one config through ``repro.api.Engine`` and ``repro_torch.api.Engine``.

The task is the reference's own resilience/scenario fixture: an 8-wide
mlp split at cut 1 over 24 clients of 12 Gaussian samples each (8
features, 4 classes), cohorts of 6 at batch 4.  As in
``torch_parity.py``, the port starts from the reference's initial
TrainState (carried across) and trains on the reference's resample
plans (injected through ``plan_fn``); cohorts, batches, scenario events
and fault draws agree because both packages draw them from the same
numpy streams.

Tolerances: per-round metrics with the same scalar keys to rtol 1e-4;
the history's test and train losses to rtol 1e-4 and its accuracy within
one test sample; states by ``torch_parity.assert_state_close``; every
count (telemetry, resilience summaries, quarantined clients, resumed
round) exactly.
"""
import jax
import numpy as np
import torch

from repro.api import Engine as JEngine
from repro.api import ExperimentConfig as JConfig
from repro.core.split import make_stage_task as j_make_stage_task
from repro.data.federated import FederatedDataset as JFed
from repro.models.cnn import mlp as j_mlp
from repro_torch.api import Engine, ExperimentConfig
from repro_torch.core.split import make_stage_task
from repro_torch.data.federated import FederatedDataset
from repro_torch.models.cnn import mlp
from repro_torch.utils.weights import train_state_from_reference
from torch_parity import (Recorder, assert_rows_close, assert_state_close,
                          reference_plan_fn)

N = 24
BASE = dict(algo="cyclesfl", rounds=4, n_clients=N, attendance=0.25,
            min_cohort=2, batch=4, width=8, cut=1, seed=0, eval_every=4)
QUIET = dict(log=lambda *a, **k: None)


def _arrays(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n * 12, 8)).astype(np.float32)
    w = rng.normal(size=(8, 4))
    y = np.argmax(x @ w, axis=-1)
    return x, y, list(np.arange(len(x)).reshape(n, -1))


def port_setup(n=N):
    """(task, fed) of the port: the mlp over the Gaussian federation."""
    return (make_stage_task(mlp(8, [8], 4), cut=1, kind="xent"),
            FederatedDataset.from_arrays(*_arrays(n)))


def reference_setup(n=N):
    return (j_make_stage_task(j_mlp(8, [8], 4), cut=1, kind="xent"),
            JFed.from_arrays(*_arrays(n)))


def config(**kw) -> ExperimentConfig:
    return ExperimentConfig(**{**BASE, **kw})


def strip(history):
    """A history without its wall-clock column."""
    return [{k: v for k, v in row.items() if k != "elapsed_s"}
            for row in history]


def run_port(cfg, setup=None, **kw):
    """``Engine.run`` of the port on the CPU: (engine, result, recorder).
    ``setup`` is a (task, fed) pair, None for the config's own task;
    ``kw`` goes to ``run`` (``state``) or to the Engine."""
    state = kw.pop("state", None)
    rec = Recorder()
    extra = {} if setup is None else dict(task=setup[0], fed=setup[1],
                                          metric_key="accuracy")
    eng = Engine(cfg, device="cpu", callbacks=[rec], **extra, **QUIET, **kw)
    res = eng.run(state=state)
    return eng, res, rec


def run_pair(cfg, mlp_task=True, **port_kw):
    """The reference's run of ``cfg`` and the port's from its carried
    init on its plans: ((jeng, jres, jrec), (eng, res, rec))."""
    jcfg = JConfig.from_dict(cfg.to_dict())
    jrec = Recorder()
    extra = {}
    if mlp_task:
        task, fed = reference_setup(cfg.n_clients)
        extra = dict(task=task, fed=fed, metric_key="accuracy")
    jeng = JEngine(jcfg, callbacks=[jrec], **extra, **QUIET)
    state0 = jax.device_get(jeng.init_state())
    jres = jeng.run(state=state0)
    port = run_port(cfg, port_setup(cfg.n_clients) if mlp_task else None,
                    state=train_state_from_reference(state0),
                    plan_fn=reference_plan_fn(jeng.padded_capacity
                                              * cfg.batch), **port_kw)
    return (jeng, jres, jrec), port


def assert_history_close(jhist, hist, n_test):
    assert [h["round"] for h in hist] == [h["round"] for h in jhist]
    for j, t in zip(jhist, hist):
        for k in ("test_loss", "train_loss"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)
        assert abs(t["accuracy"] - j["accuracy"]) <= 1.0 / n_test + 1e-6


def assert_pair_close(pair):
    """Hold the port's run of ``run_pair`` to the reference's."""
    (jeng, jres, jrec), (eng, res, rec) = pair
    assert_rows_close(jrec.rows, rec.rows)
    assert_history_close(jres["history"], res["history"],
                         len(eng.fed.test_arrays()[1]))
    assert_state_close(jax.device_get(jrec.state), rec.state)
    for key in ("resilience", "telemetry", "resumed_from_round"):
        assert (key in res) == (key in jres), key
        if key in res:
            assert res[key] == jres[key], key


def states_equal(a, b) -> bool:
    from repro_torch.utils.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))
