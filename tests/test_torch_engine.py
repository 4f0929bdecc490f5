"""The port's Engine against ``repro.api.Engine``, plus its config and
device contracts.

Parity: one config dict drives both packages; the port starts from the
reference's initial TrainState (carried across) and trains on the
reference's resample plans (injected through ``plan_fn``); cohorts and
batches agree because both draw them from numpy's ``default_rng(seed +
1)``.  Per-round metrics must agree to rtol 1e-4: float32 sums run in
another order, and Adam's near-sign first steps turn last-bit gradient
differences on tiny gradients into weight differences of up to 2 * lr
on a few weights, which later rounds carry.  The eval accuracy may
differ by one test sample whose two top logits are that close.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Engine as JEngine
from repro.api import ExperimentConfig as JConfig
from repro.core.cyclesl import CycleConfig as JCycle
from repro.core.feature_store import masked_resample_plan as j_masked_plan
from repro.core.feature_store import resample_plan as j_plan
from repro_torch.api import Engine, ExperimentConfig
from repro_torch.utils.weights import train_state_from_reference
from torch_threads import one_thread  # noqa: F401

SMALL = dict(n_clients=10, attendance=0.3, batch=8, width=4)
METRICS = ("server_loss", "feat_grad_norm_mean", "feat_grad_norm_std",
           "client_grad_norm_mean")


class _Recorder:
    def __init__(self):
        self.rows = []

    def on_round(self, engine, rnd, state, metrics):
        self.rows.append({k: float(metrics[k]) for k in METRICS})


def _reference_plan_fn(total):
    """The JAX package's plan for the round whose key the port passes."""
    def plan_fn(key, valid, epochs, sb):
        jkey = jax.random.PRNGKey(key)
        if valid is None:
            return torch.from_numpy(np.array(j_plan(jkey, total, epochs,
                                                    sb))), None
        p, ok = j_masked_plan(jkey, jnp.asarray(valid.numpy()), epochs, sb)
        return torch.from_numpy(np.array(p)), torch.from_numpy(np.array(ok))
    return plan_fn


CASES = {
    "default-cut2": dict(rounds=3),
    "fused-cut3": dict(rounds=2, cut=3,
                       cycle=JCycle(server_epochs=2, fused_gather_loss=True)),
    "unpadded-clipped": dict(rounds=2, pad_cohorts=False,
                             cycle=JCycle(grad_clip=0.05, server_batch=6)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_run_matches_reference(case):
    kw = {**SMALL, **CASES[case]}
    jcfg = JConfig(eval_every=kw["rounds"], seed=3, **kw)
    jrec, trec = _Recorder(), _Recorder()
    jeng = JEngine(jcfg, callbacks=[jrec], log=lambda *a: None)
    state0 = jeng.init_state()
    jres = jeng.run(state=state0)
    teng = Engine(ExperimentConfig.from_dict(jcfg.to_dict()), device="cpu",
                  callbacks=[trec], log=lambda *a: None,
                  plan_fn=_reference_plan_fn(jeng.padded_capacity
                                             * jcfg.batch))
    assert teng.padded_capacity == jeng.padded_capacity
    assert teng.round_key(2) == int(jax.random.key_data(jeng.round_key(2))[1])
    tres = teng.run(state=train_state_from_reference(jax.device_get(state0)))
    assert len(trec.rows) == len(jrec.rows) == kw["rounds"]
    for r, (j, t) in enumerate(zip(jrec.rows, trec.rows)):
        for k in METRICS:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4,
                                       err_msg=f"round {r} {k}")
    jh, th = jres["history"][-1], tres["history"][-1]
    n_test = len(teng.fed.test_arrays()[1])
    np.testing.assert_allclose(th["test_loss"], jh["test_loss"], rtol=1e-4)
    assert abs(th["accuracy"] - jh["accuracy"]) <= 1.0 / n_test + 1e-6
    for k, v in jres["grad_stability"].items():
        np.testing.assert_allclose(tres["grad_stability"][k], v, rtol=1e-4)


def test_engine_trains_with_its_own_plan():
    """Without an injected plan the port trains on its own plan: finite
    losses, one eval, and the shape of the reference's result."""
    cfg = ExperimentConfig(rounds=2, eval_every=2, **SMALL)
    res = Engine(cfg, device="cpu", log=lambda *a: None).run()
    assert set(res) == {"algo", "task", "history", "grad_stability",
                        "telemetry"}
    h = res["history"][-1]
    assert h["round"] == 2 and np.isfinite(h["train_loss"])
    assert 0.0 <= h["accuracy"] <= 1.0


@pytest.mark.parametrize("jcfg", [
    JConfig(),
    JConfig(rounds=7, cut=3, width=32, seed=4, pad_cohorts=False,
            cycle=JCycle(server_epochs=3, grad_clip=0.1,
                         fused_gather_loss=True)),
], ids=["default", "custom"])
def test_config_round_trips_from_reference_dict(jcfg):
    cfg = ExperimentConfig.from_dict(jcfg.to_dict()).validate()
    assert cfg.to_dict() == jcfg.to_dict()


# the knobs on a mesh: the pipeline, staleness, checkpoint, scenario and
# resilience knobs combine with one since ROADMAP item 9b's part on
# them, and a (1, 1) case builds the Engine and runs one round; a
# 'model' axis > 1 (the "mesh" cases), a serve config ("serve") and a
# (2, 1) mesh validate, and one process without a group of the mesh's
# size asks for torchrun instead.  A kernel override still raises
OUT_OF_SLICE = {
    "pipeline": dict(pipeline_depth=1, mesh_shape=(2, 1)),
    "mesh": dict(mesh_shape=(1, 2)),
    "mesh-axes": dict(mesh_shape=(1, 1, 2),
                      mesh_axes=("pod", "data", "model")),
    "staleness": dict(staleness_weighting="inverse", pipeline_depth=1,
                      mesh_shape=(1, 1)),
    "resume": dict(resume=True, ckpt_dir="ckpt", mesh_shape=(2, 1)),
    "ckpt": dict(ckpt_dir="ckpt", mesh_shape=(2, 1)),
    "serve": dict(serve={"slots": 4}, mesh_shape=(2, 1)),
    "scenario": dict(scenario={"kind": "diurnal-churn"}, mesh_shape=(1, 1)),
    "resilience": dict(resilience={"guard": True}, mesh_shape=(1, 1)),
    "kernel-override": dict(cycle={"resample_use_kernel": True}),
}


@pytest.mark.parametrize("kw", list(OUT_OF_SLICE.values()),
                         ids=list(OUT_OF_SLICE))
def test_out_of_slice_knobs_raise(kw):
    d = JConfig().to_dict()
    for k, v in kw.items():
        d[k] = {**d[k], **v} if isinstance(v, dict) else v
    cfg = ExperimentConfig.from_dict(d)
    if cfg.mesh_shape is None:
        with pytest.raises(NotImplementedError):
            Engine(cfg, device="cpu")
        return
    assert cfg.validate() is cfg
    if cfg.mesh_shape != (1, 1):
        with pytest.raises(RuntimeError, match="torchrun"):
            Engine(cfg, device="cpu")
        return
    eng = Engine(ExperimentConfig.from_dict({
        **cfg.to_dict(), **SMALL, "rounds": 1, "eval_every": 1}),
        device="cpu", log=lambda *a: None)
    try:
        assert eng.mesh.shape == {"data": 1, "model": 1}
        res = eng.run()
    finally:
        eng.close()
    assert res["history"][-1]["round"] == 1


PORTED = {"resume": dict(resume=True, ckpt_dir="ckpt"),
          "ckpt": dict(ckpt_dir="ckpt"),
          "scenario": dict(scenario={"kind": "diurnal-churn"}),
          "resilience": dict(resilience={"guard": True}),
          "pipeline": dict(pipeline_depth=2, pipeline_staleness="async"),
          "staleness": dict(pipeline_depth=1, staleness_weighting="exp",
                            staleness_lambda=0.3)}


@pytest.mark.parametrize("kw", list(PORTED.values()), ids=list(PORTED))
def test_ported_knobs_are_accepted(kw):
    """The reference's dict form of each knob this port has loads and
    validates; the Engine builds with it.  With a mesh it validates too."""
    d = JConfig().to_dict()
    for k, v in kw.items():
        d[k] = {**d[k], **v} if isinstance(d[k], dict) else v
    cfg = ExperimentConfig.from_dict(d).validate()
    assert cfg.to_dict() == JConfig.from_dict(d).to_dict()
    Engine(cfg, device="cpu", log=lambda *a: None)
    on_mesh = ExperimentConfig.from_dict({**d, "mesh_shape": (2, 1)})
    assert on_mesh.validate() is on_mesh


def test_engine_and_cli_refuse_the_cpu_unless_asked():
    """With no card, Engine(cfg) and the CLI's default device raise; they
    never drop to the CPU on their own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(ExperimentConfig(**SMALL))
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--rounds", "1", "--clients", "10"])


def test_cli_runs_on_the_cpu_when_asked(tmp_path):
    out = tmp_path / "res.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--rounds", "2", "--clients", "10", "--attendance", "0.3",
         "--batch", "8", "--width", "4", "--eval-every", "2",
         "--out", str(out)], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert out.exists() and '"round": 2' in proc.stdout
