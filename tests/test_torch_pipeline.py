"""The port's pipelined rounds, held against ``repro.api.Engine``'s on the
CPU.

The sync schedule (extract(k+1) after Commit(k)) and the async one
(extract(k+L) from the pre-tail state of round k, realized lag <= L)
run through both Engines from one carried init on the reference's
resample plans (``torch_parity.check_program``, ``torch_runtime_parity
.run_pair``), with their tolerances: per-round metrics rtol 1e-4,
states within 1e-5 but for 0.1% of a leaf, each within Adam's 2 * lr *
steps.  Against the port itself the sync run equals the sequential one
bit for bit, the async run equals the schedule re-executed by hand, a
resumed pipelined run equals the unbroken one, and ``build_pipelined_
train_steps`` composes to ``build_train_step``'s round: all exactly.
Every comparison is against the reference's live output, not its
goldens.
"""
import argparse

import numpy as np
import pytest
import torch

from repro.api import ExperimentConfig as JConfig
from repro.api.phases import split_program as j_split_program
from repro.api.registry import get_program as j_get_program
from repro_torch.api import Engine, ExperimentConfig
from repro_torch.api.phases import split_program
from repro_torch.api.registry import algorithm_names, get_program
from repro_torch.configs import InputShape, smoke_config
from repro_torch.core.cyclesl import CycleConfig
from repro_torch.core.feature_store import StaleFeatureRing
from repro_torch.launch.steps import (build_pipelined_train_steps,
                                      build_train_step)
from repro_torch.resilience import FaultConfig, ResilienceConfig
from repro_torch.utils.tree import tree_leaves
from torch_parity import Recorder, check_program
from torch_runtime_parity import (assert_pair_close, config, port_setup,
                                  run_pair, run_port, states_equal, strip)
from torch_threads import one_thread  # noqa: F401

QUIET = dict(log=lambda *a, **k: None)


def _pipeline_stats_equal(port, ref):
    keys = ("active", "mode", "depth", "ring_depth", "staleness_weighting",
            "max_theta_s_lag_rounds", "realized_lags")
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}


# ----------------------------------------------------------------- ring
def test_ring_bounds_order_and_rewind():
    ring = StaleFeatureRing(2)
    ring.push(0, 0, "s0", "i0", "j0")
    ring.push(1, 0, "s1", "i1", "j1")
    with pytest.raises(AssertionError, match="overflow"):
        ring.push(2, 0, "s2", "i2", "j2")
    with pytest.raises(AssertionError, match="ring head"):
        ring.pop(1)
    e = ring.pop(0)
    assert (e.round, e.src_round, e.stage, e.ready) == (0, 0, "s0", None)
    with pytest.raises(AssertionError, match="lag bound"):
        ring.push(2, -1, "s2", "i2", "j2")
    with pytest.raises(AssertionError, match="non-contiguous"):
        ring.push(3, 2, "s3", "i3", "j3")
    ring.push(2, 1, "s2", "i2", "j2")
    ring.rewind(lambda inj: "re-" + inj, src_round=1)
    assert [(x.stage, x.src_round) for x in ring._entries] == [
        ("re-j1", 1), ("re-j2", 1)]
    ring.pop(1), ring.pop(2)
    assert ring.realized_lags == [0, 0, 1] and ring.max_realized_lag == 1
    with pytest.raises(ValueError):
        StaleFeatureRing(0)


@pytest.mark.parametrize("algo", algorithm_names())
def test_split_program_matches_reference(algo):
    """The fused sequential programs (ssl, sflv2, fedavg) have no head to
    split on, as in the reference."""
    got, want = split_program(get_program(algo)), j_split_program(
        j_get_program(algo))
    assert (got is None) == (want is None)
    if got is not None:
        assert [type(p).__name__ for p in got[1]] == [
            type(p).__name__ for p in want[1]]


# ---------------------------------------------------------- sync == seq
@pytest.mark.parametrize("depth", [1, 2])
def test_sync_matches_reference_and_the_sequential_run(depth):
    """Sync pipelining against the reference's pipelined Engine, and bit
    for bit against the port's own sequential run."""
    teng, _, _ = check_program("cyclesfl", "padded", 1, pipeline_depth=depth)
    assert teng.ring_depth == 1
    seq = ExperimentConfig.from_dict({**teng.cfg.to_dict(),
                                      "pipeline_depth": 0})
    state0 = Engine(teng.cfg, device="cpu", **QUIET).init_state()
    r_pipe, r_seq = Recorder(), Recorder()
    Engine(teng.cfg, device="cpu", callbacks=[r_pipe], **QUIET).run(
        state=state0)
    Engine(seq, device="cpu", callbacks=[r_seq], **QUIET).run(state=state0)
    assert r_pipe.rows == r_seq.rows
    assert states_equal(r_pipe.state, r_seq.state)


# ---------------------------------------------------------------- async
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("algo", ["cyclesfl", "psl"])
def test_async_matches_reference(algo, depth):
    """Bounded-stale extraction (lags 0, 1, .., L) against the
    reference's async Engine: the per-client program (psl, whose stage
    carries the gathered client stack and the θ_S^t snapshot) and the
    shared-client cycle program.  psl runs the harness's 2 rounds (lags
    0, 1): from its third round on, its sequential run already leaves
    the state tolerance through the harness's near-sign Adam noise, and
    the std over 2 rounds is held within 1e-5 of the mean norm."""
    rounds = 3 if algo == "cyclesfl" else 2
    teng, _, _ = check_program(algo, "padded", 1, rounds=rounds,
                               eval_every=rounds, pipeline_depth=depth,
                               pipeline_staleness="async",
                               rounds_std_atol=1e-5)
    assert teng.ring_depth == depth


@pytest.mark.parametrize("weighting", ["inverse", "exp"])
def test_staleness_weighting_matches_reference(weighting):
    pair = run_pair(config(rounds=4, pipeline_depth=1,
                           pipeline_staleness="async",
                           staleness_weighting=weighting,
                           staleness_lambda=0.7))
    assert_pair_close(pair)
    (_, jres, jrec), (_, res, rec) = pair
    _pipeline_stats_equal(res["pipeline"], jres["pipeline"])
    w = [r["stale_weight"] for r in rec.rows]
    want = ([1.0, 0.5, 0.5, 0.5] if weighting == "inverse"
            else [1.0] + [float(np.exp(np.float32(-0.7)))] * 3)
    np.testing.assert_allclose(w, want, rtol=1e-6)


@pytest.mark.parametrize("depth", [1, 2])
def test_async_engine_matches_manual_stale_schedule(depth):
    """The schedule itself, re-executed by hand: the first L stages
    extracted from the initial state (lags 0..L-1), then stage(k+L)
    from the PRE-tail state of round k; the Engine's run is equal bit
    for bit.  (A stage older than L rounds, a fresher one, or cohorts
    drawn out of round order would diverge.)"""
    cfg = config(rounds=5, eval_every=5, pipeline_depth=depth,
                 pipeline_staleness="async")
    setup = port_setup()
    eng, res, rec = run_port(cfg, setup)
    assert res["pipeline"]["realized_lags"] == [min(r, depth)
                                                for r in range(5)]
    assert res["telemetry"]["max_realized_lag"] == depth
    man = Engine(cfg, device="cpu", task=setup[0], fed=setup[1], **QUIET)
    state = man.init_state()
    rng = np.random.default_rng(cfg.seed + 1)
    ring = [(man._extract(state, ins), ins) for ins in
            [man.sample_round(rng) for _ in range(depth)]]
    rows = []
    for rnd in range(cfg.rounds):
        stage, inputs = ring.pop(0)
        if rnd + depth < cfg.rounds:
            nxt = man.sample_round(rng)
            ring.append((man._extract(state, nxt), nxt))
        state, metrics = man._tail(state, inputs, stage, man.round_key(rnd))
        rows.append({k: float(v) for k, v in metrics.items()})
    assert rows == rec.rows
    assert states_equal(state, rec.state)


def test_fused_sequential_programs_fall_back_to_whole_rounds():
    setup = port_setup()
    _, r0, rec0 = run_port(config(algo="ssl"), setup)
    eng, r1, rec1 = run_port(config(algo="ssl", pipeline_depth=2,
                                    pipeline_staleness="async"), setup)
    assert eng.pipeline is None and eng.ring_depth == 0
    assert r1["pipeline"]["active"] is False
    assert rec0.rows == rec1.rows and states_equal(rec0.state, rec1.state)


# ------------------------------------------------- resume and recovery
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_pipelined_resume(tmp_path, mode, depth):
    """Stopped after round 3 and resumed by a fresh Engine, the restored
    state primes the ring.  Sync: the resumed run is the unbroken one
    bit for bit.  Async: the primed stages are fresh (lags restart at 0,
    as in the reference) and the bound holds."""
    base = dict(rounds=6, eval_every=3, pipeline_depth=depth,
                pipeline_staleness=mode)
    setup = port_setup()
    _, golden, rec_g = run_port(config(ckpt_dir=str(tmp_path / "g"),
                                       **base), setup)
    ck = str(tmp_path / "p")
    run_port(config(ckpt_dir=ck, **{**base, "rounds": 3}), setup)
    _, res, rec = run_port(config(ckpt_dir=ck, resume=True, **base), setup)
    assert res["resumed_from_round"] == 3
    lags = res["pipeline"]["realized_lags"]
    if mode == "sync":
        assert lags == [0, 0, 0]
        assert strip(res["history"]) == strip(golden["history"])[1:]
        assert states_equal(rec.state, rec_g.state)
    else:
        assert lags == [min(r, depth) for r in range(3)]
        assert res["pipeline"]["max_theta_s_lag_rounds"] <= depth


@pytest.mark.parametrize("action", ["retry", "rollback"])
def test_pipelined_recovery_rewinds_the_ring(action):
    """A NaN-faulted async run: each recovered round extracts its cohort
    again from the candidate state and rewinds the ring to the accepted
    state; the summary equals the reference's exactly and the run stays
    within the harness's tolerances."""
    pair = run_pair(config(rounds=6, eval_every=3, pipeline_depth=1,
                           pipeline_staleness="async",
                           resilience=ResilienceConfig(
                               guard=True, on_nonfinite=action,
                               faults=FaultConfig(nan_rate=0.5, persist=0))))
    assert_pair_close(pair)
    (_, jres, _), (_, res, _) = pair
    assert res["resilience"]["faulted_rounds"] > 0
    _pipeline_stats_equal(res["pipeline"], jres["pipeline"])
    assert 0 in res["pipeline"]["realized_lags"][1:]     # rewound


def test_pipelined_quarantine_matches_reference():
    pair = run_pair(config(rounds=6, eval_every=3, pipeline_depth=1,
                           pipeline_staleness="sync",
                           resilience=ResilienceConfig(
                               guard=True, on_nonfinite="quarantine",
                               faults=FaultConfig(nan_rate=0.4,
                                                  persist=10))))
    assert_pair_close(pair)
    assert pair[1][1]["resilience"]["quarantined_clients"]


# ------------------------------------------------------ launcher steps
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "whisper-base"])
def test_pipelined_train_steps_compose_to_the_round(arch):
    cfg = smoke_config(arch)
    shape = InputShape("train_smoke", 16, 4, "train")
    whole = build_train_step(cfg, shape, CycleConfig(), cohort=2,
                             device="cpu")
    extract, tail = build_pipelined_train_steps(cfg, shape, CycleConfig(),
                                                cohort=2, device="cpu")
    server, clients = whole.init_state(0)
    xs, ys = whole.make_batch(1)
    s1, c1, m1 = whole.fn(server, clients, xs, ys, 3)
    feats, store = extract.fn(clients, xs, ys)
    s2, c2, m2 = tail.fn(server, clients, xs, ys, 3, feats, store)
    assert {k: float(v) for k, v in m1.items()} == {
        k: float(v) for k, v in m2.items()}
    for a, b in zip(tree_leaves((s1, c1)), tree_leaves((s2, c2))):
        assert torch.equal(a, b)
    assert extract.name == "train_extract" and tail.name == "train_tail"


# -------------------------------------------------------------- config
@pytest.mark.parametrize("kw", [
    dict(pipeline_depth=2, pipeline_staleness="async"),
    dict(pipeline_depth=1, staleness_weighting="exp", staleness_lambda=0.3),
    dict(pipeline_depth=3, pipeline_staleness="sync",
         staleness_weighting="inverse")], ids=["async", "exp", "inverse"])
def test_pipeline_config_round_trips_the_reference_dict(kw):
    jd = JConfig(**kw).validate().to_dict()
    cfg = ExperimentConfig.from_dict(jd).validate()
    assert cfg.to_dict() == jd
    Engine(cfg, device="cpu", **QUIET)


@pytest.mark.parametrize("kw", [
    dict(pipeline_depth=-1), dict(pipeline_staleness="eager"),
    dict(staleness_weighting="linear"), dict(staleness_lambda=-0.1)])
def test_pipeline_config_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        JConfig(**kw).validate()
    with pytest.raises(ValueError):
        ExperimentConfig(**kw).validate()


def test_pipeline_flags_reach_the_config():
    ap = ExperimentConfig.add_arguments(argparse.ArgumentParser())
    args = ap.parse_args(["--pipeline-depth", "2", "--pipeline-staleness",
                          "async", "--staleness-weighting", "exp",
                          "--staleness-lambda", "0.25"])
    cfg = ExperimentConfig.from_flags(args)
    assert (cfg.pipeline_depth, cfg.pipeline_staleness,
            cfg.staleness_weighting, cfg.staleness_lambda) == (
        2, "async", "exp", 0.25)
    with pytest.raises(SystemExit):
        ap.parse_args(["--pipeline-staleness", "eager"])
