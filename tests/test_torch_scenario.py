"""The port's scenario layer (``repro_torch.scenario`` and the Engine's
churn branches) against ``repro.scenario`` and ``repro.api.Engine``.

The streams are numpy fold-ins of (seed, salt, round), so profiles,
attendance weights, drop/lag events, telemetry, population clients and
cohort draws equal the reference's exactly; a run's metrics and state
are held to ``torch_runtime_parity.py``'s tolerances.  The null
scenario, and a uniform stream without churn, are the scenario-free
port bit for bit.
"""
import argparse
from dataclasses import asdict

import numpy as np
import pytest

from repro.api import ExperimentConfig as JConfig
from repro.scenario.population import PopulationFed as JPopulationFed
from repro.scenario.population import PopulationSpec as JPopulationSpec
from repro.scenario.population import run_population as j_run_population
from repro.scenario.profiles import ScenarioConfig as JScenarioConfig
from repro.scenario.profiles import build_profile_stream as j_build_stream
from repro_torch.api import ExperimentConfig, algorithm_names
from repro_torch.core.cyclesl import CycleConfig
from repro_torch.scenario import (STREAMS, ScenarioConfig,
                                  build_profile_stream, scenario_kinds)
from repro_torch.scenario.population import (PopulationFed, PopulationSpec,
                                             run_population)
from torch_runtime_parity import (N, assert_pair_close, config, port_setup,
                                  run_pair, run_port, states_equal, strip)
from torch_threads import one_thread  # noqa: F401

CHURN = dict(dropout=0.3, straggler=1.0, staleness_bound=1, amplitude=0.6,
             period=8)


@pytest.mark.parametrize("kind", sorted(STREAMS))
def test_stream_equals_the_reference(kind):
    """The clients' profiles equal the reference stream's exactly."""
    t = build_profile_stream(ScenarioConfig(kind=kind, **CHURN), 60, seed=5)
    j = j_build_stream(JScenarioConfig(kind=kind, **CHURN), 60, seed=5)
    for attr in ("compute", "bandwidth", "hazard", "bound", "phase"):
        np.testing.assert_array_equal(getattr(t, attr), getattr(j, attr))
    assert asdict(t.profile(7)) == asdict(j.profile(7))
    assert t.churns and t.kind == j.kind


@pytest.mark.parametrize("kind", sorted(STREAMS))
def test_events_and_weights_equal_the_reference(kind):
    """Per-round weights and events, over 30 rounds and random cohorts
    (min_live 1 and 3), equal the reference's exactly."""
    t = build_profile_stream(ScenarioConfig(kind=kind, **CHURN), 60, seed=5)
    j = j_build_stream(JScenarioConfig(kind=kind, **CHURN), 60, seed=5)
    rng = np.random.default_rng(0)
    for rnd in range(30):
        wt, wj = t.weights(rnd), j.weights(rnd)
        assert (wt is None) == (wj is None)
        if wt is not None:
            np.testing.assert_array_equal(wt, wj)
        cohort = rng.choice(60, size=int(rng.integers(1, 9)), replace=False)
        for min_live in (1, 3):
            et, ej = t.events(rnd, cohort, min_live), j.events(rnd, cohort,
                                                                min_live)
            for a, b in zip(et, ej):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("algo", algorithm_names())
def test_null_scenario_is_the_scenario_free_port(algo):
    """kind='none' and a zero-churn uniform stream give the
    scenario-free run, bit for bit, for every program."""
    setup = port_setup()
    base = config(algo=algo, rounds=3, eval_every=3)
    _, r0, rec0 = run_port(base, setup)
    for sc in (ScenarioConfig(kind="none"), ScenarioConfig(kind="uniform")):
        eng, r1, rec1 = run_port(config(algo=algo, rounds=3, eval_every=3,
                                        scenario=sc), setup)
        assert strip(r1["history"]) == strip(r0["history"])
        assert rec1.rows == rec0.rows
        assert states_equal(rec1.state, rec0.state)
        assert r1["telemetry"] == r0["telemetry"]
        assert r1["telemetry"]["dropped_total"] == 0


@pytest.mark.parametrize("kind", sorted(STREAMS))
def test_churn_round_matches_reference(kind):
    """A churny run (dropouts, deadline misses, and for diurnal-churn
    weighted cohort draws) under variable attendance: telemetry exactly,
    metrics and state within tolerance of the reference's Engine."""
    cfg = config(variable_attendance=True,
                 scenario=ScenarioConfig(kind=kind, **CHURN))
    pair = run_pair(cfg)
    assert_pair_close(pair)
    tel = pair[1][1]["telemetry"]
    assert tel["dropped_total"] > 0
    assert all(r["live"] + r["dropped"] == r["cohort"] and r["live"] >= 1
               for r in tel["per_round"])


def test_dropped_slots_zero_the_mask():
    """A dropped LIVE slot reads 0 in the mask and keeps its real id."""
    from repro_torch.api import Engine
    task, fed = port_setup()
    cfg = config(scenario=ScenarioConfig(kind="uniform", dropout=0.5))
    eng = Engine(cfg, device="cpu", task=task, fed=fed, log=lambda *a: None)
    rng = np.random.default_rng(cfg.seed + 1)
    saw_drop = False
    for _ in range(6):
        cohort, _, _, mask = eng.sample_round(rng)
        row = eng._telemetry[-1]
        live = row["cohort"]
        assert int(mask[:live].sum()) == row["live"]
        assert (cohort[:live] < N).all()
        assert mask[:live].sum() >= min(cfg.min_cohort, live)
        saw_drop |= row["dropped"] > 0
    assert saw_drop


def test_server_batch_guard_under_churn():
    from repro_torch.api import Engine
    task, fed = port_setup()
    big = CycleConfig(server_batch=64)
    for kw in (dict(variable_attendance=True),
               dict(scenario=ScenarioConfig(kind="uniform", dropout=0.2))):
        with pytest.raises(ValueError, match="server_batch"):
            Engine(config(cycle=big, **kw), device="cpu", task=task, fed=fed)
    Engine(config(cycle=big), device="cpu", task=task, fed=fed)
    with pytest.raises(ValueError, match="pad_cohorts"):
        config(pad_cohorts=False, scenario=ScenarioConfig(
            kind="uniform", dropout=0.2)).validate()


def test_scenario_config_and_flags_round_trip():
    sc = ScenarioConfig(kind="diurnal-churn", dropout=0.1, straggler=0.5,
                        staleness_bound=3, period=24, amplitude=0.5, seed=7)
    assert ScenarioConfig.from_dict(sc.to_dict()) == sc
    assert JScenarioConfig.from_dict(sc.to_dict()).to_dict() == sc.to_dict()
    cfg = ExperimentConfig(scenario=sc)
    back = ExperimentConfig.from_dict(cfg.to_dict())
    assert back == cfg and isinstance(back.scenario, ScenarioConfig)
    assert ExperimentConfig.from_dict(
        JConfig(scenario=JScenarioConfig(**sc.to_dict())).to_dict()) == cfg
    d = cfg.to_dict()
    del d["scenario"]
    assert ExperimentConfig.from_dict(d).scenario == ScenarioConfig()
    flags = ["--scenario", "diurnal-churn", "--scenario-dropout", "0.2",
             "--scenario-straggler", "0.5", "--scenario-staleness-bound",
             "2", "--scenario-period", "24", "--scenario-amplitude", "0.4",
             "--scenario-seed", "9"]
    ap = ExperimentConfig.add_arguments(argparse.ArgumentParser())
    got = ExperimentConfig.from_flags(ap.parse_args(flags))
    jap = JConfig.add_arguments(argparse.ArgumentParser())
    want = JConfig.from_flags(jap.parse_args(flags))
    assert got.scenario.to_dict() == want.scenario.to_dict()
    assert scenario_kinds()[0] == "none"
    assert set(scenario_kinds()[1:]) == set(STREAMS)
    with pytest.raises(KeyError, match="unknown scenario kind"):
        ScenarioConfig(kind="wat").validate()
    with pytest.raises(KeyError, match="unknown"):
        ScenarioConfig.from_dict({"kind": "uniform", "nope": 1})


def test_population_is_lazy_and_deterministic():
    """Clients exist on demand, as pure functions of (seed, id), equal to
    the reference's; the pooled test set too."""
    spec = PopulationSpec(n_clients=50_000, samples_per_client=12, seed=4)
    jspec = JPopulationSpec(n_clients=50_000, samples_per_client=12, seed=4)
    a, b, j = PopulationFed(spec), PopulationFed(spec), JPopulationFed(jspec)
    assert a.n_clients == 50_000 and a.materialized == 0
    for c in (0, 31_337, 49_999):
        ca, cb, cj = a.materialize(c), b.materialize(c), j.materialize(c)
        for f in ("x_train", "y_train", "x_test", "y_test"):
            np.testing.assert_array_equal(getattr(ca, f), getattr(cb, f))
            np.testing.assert_array_equal(getattr(ca, f), getattr(cj, f))
    assert a.materialized == 3 and len(a.clients) == 50_000
    for x, y in zip(a.test_arrays(), j.test_arrays()):
        np.testing.assert_array_equal(x, y)
    assert len(a.test_arrays()[0]) == spec.test_size
    with pytest.raises(IndexError):
        a.materialize(50_000)


@pytest.mark.parametrize("sc", [dict(kind="uniform", dropout=0.2),
                                dict(kind="diurnal-churn")],
                         ids=["uniform-dropout", "diurnal-churn"])
def test_population_run_matches_reference(sc):
    """100k virtual clients, cohort 8: the run touches only the clients
    that attended, the same ones as the reference's run, with the same
    telemetry; the port's record has no trace count."""
    spec = PopulationSpec(n_clients=100_000, test_size=256)
    res = run_population(spec, ScenarioConfig(**sc), cohort=8, rounds=3,
                         batch=4, width=8, device="cpu")
    jres = j_run_population(JPopulationSpec(n_clients=100_000,
                                            test_size=256),
                            JScenarioConfig(**sc), cohort=8, rounds=3,
                            batch=4, width=8)
    pop, jpop = res["population"], jres["population"]
    assert "trace_count" not in pop
    assert pop == {k: v for k, v in jpop.items() if k != "trace_count"}
    assert pop["clients_materialized"] <= 8 * 3
    assert res["telemetry"] == jres["telemetry"]
    assert np.isfinite(res["history"][-1]["test_loss"])
