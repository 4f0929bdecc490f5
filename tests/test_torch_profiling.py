"""The port's round profiling (``repro_torch.utils.profiling``) against
the reference's (``repro.utils.profiling``).

``Engine(..., profiler=RoundProfiler())`` opens the reference's host
sections with its call counts, on the sequential and the pipelined
schedule, and leaves the run's metrics bit for bit the unprofiled run's;
``phase_costs`` is keyed by every program's phases, in the reference's
names; ``round_census`` is a mesh's census of one round.
"""
import warnings

import pytest
import torch

from repro.api import Engine as JEngine
from repro.api import ExperimentConfig as JConfig
from repro.api.registry import get_program as j_program
from repro.api.registry import algorithm_names
from repro.utils.profiling import RoundProfiler as JProfiler
from repro_torch.api import Engine, ExperimentConfig
from repro_torch.api.registry import get_program
from repro_torch.utils.profiling import (RoundProfiler, phase_costs,
                                         phase_names, round_census)
from torch_threads import one_thread  # noqa: F401

# a small image run without a mesh, the host syncing every 2 rounds
CONFIG = dict(algo="cyclesfl", collect_timing=True, sync_every=2,
              task="image", rounds=3, n_clients=8, attendance=0.5, batch=4,
              width=4, eval_every=3, seed=0)
SCHEDULES = {"sequential": {},
             "pipelined": dict(pipeline_depth=1, pipeline_staleness="sync")}


def _quiet(msg):
    pass


def _calls(profile):
    return {k: v["calls"] for k, v in profile.items()}


def _port_run(cfg, profiler=None):
    rows = []

    class Rec:
        def on_round(self, engine, rnd, state, metrics):
            rows.append({k: v.clone() for k, v in metrics.items()})

    res = Engine(cfg, device="cpu", profiler=profiler, callbacks=[Rec()],
                 log=_quiet).run()
    return rows, res


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_profiled_engine_matches_the_reference_sections(schedule):
    kw = {**CONFIG, **SCHEDULES[schedule]}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = JEngine(JConfig(**kw), profiler=JProfiler(),
                       log=_quiet).run()["profile"]
    rows, res = _port_run(ExperimentConfig(**kw), RoundProfiler())
    assert _calls(res["profile"]) == _calls(want)
    if schedule == "sequential":
        assert _calls(want) == {"sample": 5, "dispatch": 3, "sync": 3,
                                "eval": 1}
    for v in res["profile"].values():
        assert v["total_s"] >= 0 and v["mean_ms"] >= 0
    plain_rows, plain = _port_run(ExperimentConfig(**kw))
    assert "profile" not in plain
    assert len(rows) == len(plain_rows) == kw["rounds"]
    for a, b in zip(rows, plain_rows):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    strip = lambda h: [{k: v for k, v in r.items() if k != "elapsed_s"}
                       for r in h]
    assert strip(res["history"]) == strip(plain["history"])


@pytest.mark.parametrize("algo", algorithm_names())
def test_phase_names_are_the_reference_programs(algo):
    want = []
    for p in j_program(algo).phases:
        name = type(p).__name__
        while name in want:
            name += "'"
        want.append(name)
    assert phase_names(get_program(algo)) == want


@pytest.mark.parametrize("algo", ["cyclesfl", "psl"])
def test_phase_costs_time_every_phase(algo):
    eng = Engine(ExperimentConfig(**{**CONFIG, "algo": algo}), device="cpu",
                 log=_quiet)
    clock = eng._sample_clock
    costs = phase_costs(eng, repeats=1)
    assert list(costs) == phase_names(get_program(algo))
    prev = 0.0
    for row in costs.values():
        assert row["cum_ms"] > 0
        assert row["delta_ms"] == pytest.approx(row["cum_ms"] - prev,
                                                abs=2e-3)
        prev = row["cum_ms"]
    # the borrowed draws leave the cohort stream where it was
    assert eng._sample_clock == clock and not eng._telemetry


@pytest.mark.parametrize("algo", algorithm_names())
def test_round_census_is_empty_off_the_mesh(algo):
    eng = Engine(ExperimentConfig(**{**CONFIG, "algo": algo}), device="cpu",
                 log=_quiet)
    assert round_census(eng) == {}


@pytest.fixture
def fake_world():
    """This process as rank 0 of torch's fake group of 4, ended after
    the test (so no later test in the worker finds it)."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import fake_group
    fake_group(4)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("algo", algorithm_names())
def test_round_census_on_a_mesh_counts_one_round(algo, fake_world):
    """Rank 0 of a (2, 2) mesh on ``meta`` over the fake group: the census
    is one round's collectives (the same each call), and the groups'
    running censuses are left as they were."""
    eng = Engine(ExperimentConfig(**{**CONFIG, "algo": algo,
                                     "mesh_shape": (2, 2)}),
                 device="meta", log=_quiet)
    eng.mesh.comm.census = {"before/x": {"calls": 1, "bytes": 4}}
    first, second = round_census(eng), round_census(eng)
    assert first and first == second
    assert all(r["calls"] > 0 and r["bytes"] > 0 for r in first.values())
    # every program splits the weights' columns over model
    assert any(k.startswith("model/") for k in first)
    assert eng.mesh.comm.census == {"before/x": {"calls": 1, "bytes": 4}}
