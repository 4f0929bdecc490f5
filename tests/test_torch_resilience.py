"""The port's resilience layer (``repro_torch.resilience`` and the
Engine's recovery path) against ``repro.resilience`` and
``repro.api.Engine``.

Harness and tolerances: ``torch_runtime_parity.py`` (the reference's own
8-wide mlp fixture; summaries, quarantined clients and telemetry
exactly, states by ``torch_parity.assert_state_close``).  Port-only
claims are exact: the guard on a fault-free run changes no bit of any
program's run; a transient fault recovered by retry or rollback gives
the fault-free guarded run bit for bit; a resumed run keeps the ledger
and equals the unbroken run bit for bit.
"""
import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.resilience import FaultConfig as JFaultConfig
from repro.resilience import FaultStream as JFaultStream
from repro.resilience import ResilienceConfig as JResilienceConfig
from repro.resilience import health_vector as j_health_vector
from repro_torch.api import ExperimentConfig, algorithm_names
from repro_torch.api import engine as engine_mod
from repro_torch.checkpoint import latest_step
from repro_torch.resilience import (ACTIONS, FaultConfig, FaultInjectedError,
                                    FaultStream, RecoveryController,
                                    ResilienceConfig, ResilienceExhaustedError,
                                    build_fault_stream, tree_all_finite)
from repro_torch.utils.tree import tree_leaves
from torch_runtime_parity import (N, assert_pair_close, config, port_setup,
                                  run_pair, run_port, states_equal, strip)

ROOT = Path(__file__).resolve().parents[1]
GUARD = ResilienceConfig(guard=True)
QUARANTINE = ResilienceConfig(guard=True, on_nonfinite="quarantine",
                              faults=FaultConfig(nan_rate=0.6, persist=10))


# ------------------------------------------------ guard on == guard off
@pytest.mark.parametrize("algo", algorithm_names())
def test_guard_clean_bit_for_bit(algo):
    """Arming the guard on a fault-free run changes no bit of the run,
    for every program; the null config builds no controller."""
    setup = port_setup()
    e0, r0, rec0 = run_port(config(algo=algo), setup)
    e1, r1, rec1 = run_port(config(algo=algo, resilience=GUARD), setup)
    assert strip(r0["history"]) == strip(r1["history"]), algo
    assert rec0.rows == rec1.rows
    assert states_equal(rec0.state, rec1.state)
    assert "resilience" not in r0 and e0.recovery is None
    assert e0.faults is None
    assert r1["resilience"]["faulted_rounds"] == 0


# ----------------------------------------- recovery against the reference
POLICIES = {
    "quarantine": dict(rounds=6, eval_every=3, resilience=ResilienceConfig(
        guard=True, on_nonfinite="quarantine",
        faults=FaultConfig(nan_rate=0.4, persist=10))),
    "retry": dict(resilience=ResilienceConfig(
        guard=True, on_nonfinite="retry",
        faults=FaultConfig(nan_rate=0.5, persist=0))),
    "rollback": dict(resilience=ResilienceConfig(
        guard=True, on_nonfinite="rollback",
        faults=FaultConfig(nan_rate=0.5, persist=0))),
    "dispatch-error": dict(resilience=ResilienceConfig(
        faults=FaultConfig(error_rate=0.4))),
}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_recovery_matches_reference(policy):
    """Each policy on a faulted run: the summary (faulted rounds,
    retries, rollbacks, quarantined clients, per-round actions) equals
    the reference's exactly, the run's metrics and state within the
    harness's tolerances."""
    pair = run_pair(config(**POLICIES[policy]))
    assert_pair_close(pair)
    tel = pair[1][1]["resilience"]
    assert tel["faulted_rounds"] > 0
    if policy == "quarantine":
        assert tel["quarantined_clients"]
        assert set(a for r in tel["per_round"] for a in r["actions"]) \
            <= set(ACTIONS)
    elif policy == "rollback":
        assert tel["rollbacks"] > 0


@pytest.mark.parametrize("action", ["retry", "rollback"])
def test_transient_fault_recovers_bit_for_bit(action):
    """A transient NaN recovered by retry or rollback re-runs the round
    from its pre-round state with the same key: the run is the
    fault-free guarded run's, bit for bit."""
    setup = port_setup()
    _, clean, rec_c = run_port(config(resilience=GUARD), setup)
    _, res, rec = run_port(config(resilience=ResilienceConfig(
        guard=True, on_nonfinite=action,
        faults=FaultConfig(nan_rate=0.5, persist=0))), setup)
    assert res["resilience"]["faulted_rounds"] > 0
    assert strip(res["history"]) == strip(clean["history"])
    assert states_equal(rec.state, rec_c.state)


def test_rollback_restores_the_host_copy(monkeypatch):
    """The snapshot ring holds the accepted states by reference; a
    rollback must hand back exactly what was accepted, compared with a
    host copy taken at accept time, so no later round wrote a snapshot
    in place."""
    copies, restored = {}, []

    class Checked(RecoveryController):
        def note_accept(self, rnd, state, ema):
            copies[rnd] = [t.detach().clone() for t in tree_leaves(state)]
            super().note_accept(rnd, state, ema)

        def rollback(self):
            tgt = super().rollback()
            if tgt is not None:
                restored.append(tgt)
            return tgt

    monkeypatch.setattr(engine_mod, "RecoveryController", Checked)
    _, res, _ = run_port(config(rounds=6, resilience=ResilienceConfig(
        guard=True, on_nonfinite="rollback", ring_size=3,
        faults=FaultConfig(nan_rate=0.5, persist=1))), port_setup())
    assert res["resilience"]["rollbacks"] > 0 and restored
    for rnd, state, _ in restored:
        got = tree_leaves(state)
        assert all(torch.equal(a, b) for a, b in zip(copies[rnd], got))


@pytest.mark.parametrize("case", ["cut2", "cut3-fused"])
def test_quarantined_slot_leaves_a_finite_state(case):
    """A slot poisoned on every attempt of femnist_cnn: its NaN features
    stay in the pooled store and reach the resample plan, the client
    VJPs and (at cut 3, fused) the gather_loss path, but every masked
    reduction selects them out, so the committed state is finite and
    equals the reference's."""
    cut = 3 if case == "cut3-fused" else 2
    cfg = ExperimentConfig(
        rounds=3, eval_every=3, n_clients=10, attendance=0.3, batch=8,
        width=4, cut=cut, seed=1,
        resilience=ResilienceConfig(guard=True, on_nonfinite="quarantine",
                                    faults=FaultConfig(nan_rate=0.6,
                                                       persist=10)))
    if cut == 3:
        cfg = cfg.with_cycle(fused_gather_loss=True, server_epochs=2)
    pair = run_pair(cfg, mlp_task=False)
    assert_pair_close(pair)
    _, res, rec = pair[1]
    assert res["resilience"]["quarantine_events"] > 0
    assert all(torch.isfinite(t).all() for t in tree_leaves(rec.state)
               if t.is_floating_point())


def test_exhausted_budget_raises():
    """max_retries=0 exhausts at once: the fault surfaces."""
    cfg = config(resilience=ResilienceConfig(
        max_retries=0, faults=FaultConfig(error_rate=0.999)))
    with pytest.raises(ResilienceExhaustedError):
        run_port(cfg, port_setup())


def test_spike_detector_flags_via_policy():
    """The EMA loss spike fires the on_spike action once warm, as in the
    reference (spike factor ~1, alpha 1: any loss rise is a spike)."""
    cfg = config(rounds=6, eval_every=6, resilience=ResilienceConfig(
        guard=True, on_spike="ignore", spike_factor=1.0001,
        spike_warmup=2, ema_alpha=1.0))
    pair = run_pair(cfg)
    assert_pair_close(pair)
    tel = pair[1][1]["resilience"]
    assert tel["faults"]["spike"] == tel["faulted_rounds"]


# ------------------------------------------------------------- guards
def test_health_vector_matches_reference():
    """The packed health vector and slot blame, one poisoned live slot
    and one poisoned dead slot, against the reference's."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(4, 3, 5)).astype(np.float32)
    fgrads = rng.normal(size=(4, 3, 5)).astype(np.float32)
    feats[1, 2, 0] = np.nan                # a live slot: blamed
    feats[3, 0, 1] = np.inf                # a dead slot: not blamed
    fgrads[3] = np.nan
    mask = np.array([1, 1, 1, 0], np.float32)
    state = {"w": rng.normal(size=(5, 2)).astype(np.float32),
             "step": np.int32(3)}
    from repro_torch.resilience import health_vector
    for st in (state, {**state, "w": np.full((5, 2), np.nan, np.float32)}):
        for loss, ema in ((1.5, 0.0), (9.0, 2.0), (np.nan, 2.0)):
            jh, jb = j_health_vector(
                {k: jnp.asarray(v) for k, v in st.items()}, jnp.float32(loss),
                jnp.asarray(feats), jnp.asarray(fgrads), jnp.asarray(mask),
                jnp.float32(ema), 0.1, 4.0)
            th, tb = health_vector(
                {k: torch.as_tensor(v) for k, v in st.items()},
                torch.tensor(loss, dtype=torch.float32),
                torch.from_numpy(feats), torch.from_numpy(fgrads),
                torch.from_numpy(mask), torch.tensor(ema), 0.1, 4.0)
            np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
            np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert not bool(tree_all_finite([torch.ones(3),
                                     torch.tensor([1.0, float("inf")])]))
    assert bool(tree_all_finite([torch.ones(2), torch.arange(3)]))


# --------------------------------------------------- fault determinism
def test_fault_stream_replays_the_reference():
    """Two port streams agree, in any query order, and both agree with
    the reference's: poisoned slots, dispatch errors, torn steps."""
    kw = dict(nan_rate=0.5, nan_slots=2, error_rate=0.3, ckpt_rate=0.4,
              persist=1)
    a, b = FaultStream(FaultConfig(**kw), 7), FaultStream(FaultConfig(**kw), 7)
    j = JFaultStream(JFaultConfig(**kw), 7)

    def fires(stream, rnd, att):
        try:
            stream.check_dispatch(rnd, att)
        except Exception as e:
            return (e.rnd, e.attempt)
        return None

    for rnd in list(range(20)) + list(range(20))[::-1]:
        for att in (0, 1, 2):
            want = j.nan_slots_for(rnd, att, 6)
            np.testing.assert_array_equal(a.nan_slots_for(rnd, att, 6), want)
            np.testing.assert_array_equal(b.nan_slots_for(rnd, att, 6), want)
            assert fires(a, rnd, att) == fires(b, rnd, att) == fires(j, rnd,
                                                                    att)
        assert a.ckpt_corrupt(rnd) == j.ckpt_corrupt(rnd)
    with pytest.raises(FaultInjectedError):
        FaultStream(FaultConfig(error_rate=0.999), 0).check_dispatch(0, 0)
    assert build_fault_stream(FaultConfig(), 0) is None


# ------------------------------------------------------ config plumbing
def test_resilience_config_round_trips_with_the_reference():
    rc = ResilienceConfig(guard=True, on_nonfinite="rollback", max_retries=5,
                          ring_size=3, faults=FaultConfig(nan_rate=0.1))
    assert rc.to_dict() == JResilienceConfig.from_dict(rc.to_dict()).to_dict()
    assert ResilienceConfig.from_dict(rc.to_dict()) == rc
    cfg = ExperimentConfig(resilience=rc)
    assert ExperimentConfig.from_dict(cfg.to_dict()) == cfg
    d = cfg.to_dict()
    d.pop("resilience")
    assert ExperimentConfig.from_dict(d).resilience == ResilienceConfig()
    ap = ExperimentConfig.add_arguments(argparse.ArgumentParser())
    args = ap.parse_args(["--guard", "--on-nonfinite", "rollback",
                          "--max-retries", "5", "--snapshot-ring", "4",
                          "--faults", "nan=0.2,persist=1"])
    rc = ExperimentConfig.from_flags(args).resilience
    assert rc.guard and rc.on_nonfinite == "rollback"
    assert rc.max_retries == 5 and rc.ring_size == 4
    assert rc.faults == FaultConfig(nan_rate=0.2, persist=1)
    with pytest.raises(ValueError):
        ExperimentConfig(pad_cohorts=False, resilience=ResilienceConfig(
            guard=True, on_nonfinite="quarantine")).validate()
    with pytest.raises(ValueError):
        ResilienceConfig(ring_size=0).validate()
    with pytest.raises(KeyError):
        FaultConfig.from_spec("bogus=1")


# ------------------------------------------------------ ledger + resume
def test_quarantine_ledger_survives_resume(tmp_path):
    """A guarded run with persistent poison, stopped at round 3 and
    resumed by a fresh Engine: the restored ledger and the
    history-aware replay of the weighted cohort draws give the unbroken
    run bit for bit, bans included."""
    setup = port_setup()
    base = dict(rounds=6, eval_every=3, resilience=QUARANTINE)
    _, golden, rec_g = run_port(config(ckpt_dir=str(tmp_path / "g"), **base),
                                setup)
    assert golden["resilience"]["quarantined_clients"]
    ck = str(tmp_path / "p")
    run_port(config(ckpt_dir=ck, **{**base, "rounds": 3}), setup)
    eng, res, rec = run_port(config(ckpt_dir=ck, resume=True, **base), setup)
    assert res["resumed_from_round"] == 3
    want = {r["round"]: r for r in strip(golden["history"])}
    for row in strip(res["history"]):
        assert row == want[row["round"]]
    assert states_equal(rec.state, rec_g.state)
    for k in ("quarantined_clients", "quarantine_events"):
        assert res["resilience"][k] == golden["resilience"][k]
    fresh = RecoveryController(QUARANTINE, N, log=lambda *a: None)
    fresh.restore_state(eng.recovery.export_state())
    assert fresh.quarantine_history == eng.recovery.quarantine_history
    assert fresh.export_state() == eng.recovery.export_state()


def _harness(ck, *extra):
    return ["--device", "cpu", "--ckpt-dir", ck, "--rounds", "6",
            "--clients", str(N), "--batch", "4", "--guard", "--faults",
            "nan=0.6,persist=10", *extra]


def test_sigkill_resume_keeps_bans(tmp_path):
    """The harness SIGKILLed after its step_2, then resumed: the history
    tail and the bans equal an unbroken harness run's, bit for bit.  The
    unbroken run runs here and the two others in processes of their own,
    all on one CPU thread; the test has one 115 s budget."""
    from repro_torch.resilience import harness
    deadline = time.time() + 115
    left = lambda: max(deadline - time.time(), 1.0)
    golden_out = str(tmp_path / "golden.json")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        harness.main(_harness(str(tmp_path / "g"), "--out", golden_out))
    finally:
        torch.set_num_threads(threads)
    golden = json.load(open(golden_out))
    assert golden["resilience"]["quarantined_clients"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    run = dict(env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
               stderr=subprocess.DEVNULL)
    cmd = [sys.executable, "-m", "repro_torch.resilience.harness"]
    ck = str(tmp_path / "ck")
    proc = subprocess.Popen(cmd + _harness(ck, "--sleep-per-round", "0.5"),
                            **run)
    try:
        while time.time() < deadline:
            if (latest_step(ck) or 0) >= 2:
                break
            if proc.poll() is not None:
                pytest.fail("harness exited before checkpointing")
            time.sleep(0.05)
        else:
            pytest.fail("harness never wrote step_2")
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.wait()
    killed_at = latest_step(ck)
    assert killed_at is not None and killed_at < 6
    out = str(tmp_path / "resumed.json")
    subprocess.run(cmd + _harness(ck, "--resume", "--out", out), check=True,
                   timeout=left(), **run)
    resumed = json.load(open(out))
    assert resumed["resumed_from_round"] == killed_at
    want = {r["round"]: r for r in strip(golden["history"])}
    got = strip(resumed["history"])
    assert got
    for row in got:
        assert row == want[row["round"]]
    assert resumed["resilience"]["quarantined_clients"] == \
        golden["resilience"]["quarantined_clients"]


def test_harness_rejects_the_pipelined_flags(tmp_path):
    """The pipelined flags are ported: they reach the Engine's config and
    build the pipelined schedule; the harness rejects only a staleness
    mode the reference does not have."""
    from repro_torch.resilience import harness
    for flags, depth, mode in ((["--pipeline-depth", "1"], 1, "sync"),
                               (["--pipeline-depth", "2",
                                 "--pipeline-staleness", "async"], 2,
                                "async")):
        args = harness.parser().parse_args(
            ["--ckpt-dir", str(tmp_path), "--device", "cpu", *flags])
        eng = harness.build_engine(args)
        assert (eng.cfg.pipeline_depth, eng.cfg.pipeline_staleness) == (
            depth, mode)
        assert eng.pipeline is not None
        assert eng.ring_depth == (depth if mode == "async" else 1)
    with pytest.raises(SystemExit):
        harness.parser().parse_args(["--ckpt-dir", str(tmp_path),
                                     "--pipeline-staleness", "eager"])
