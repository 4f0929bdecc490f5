"""The Engine's pipelined rounds, health guard and recovery, checkpoints
and scenarios on a mesh, on the CPU over gloo, and the pipelined
transformer steps on the ``model`` axis.

The reference's mesh path does not run in this JAX (its meshes build
Explicit axes, which ``with_sharding_constraint`` refuses), so, as for
the round alone (``tests/test_torch_engine_tp.py``), the port's mesh is
held to the port's unsharded Engine, whose own parity with the
reference ``tests/test_torch_pipeline.py``, ``test_torch_resilience.py``,
``test_torch_checkpoint.py`` and ``test_torch_scenario.py`` hold:

- a (1, 1) mesh in this process is bit for bit the unsharded Engine
  (state, per-round metrics, result: history, telemetry, recovery log,
  pipeline stats, resume round) for each path: pipelined sync at depth
  2, async at depth 1 with inverse staleness weighting (guarded, so a
  recovered round re-extracts the ring), the guard under a NaN fault, a
  dispatch fault and torn checkpoints (quarantine and rollback), a
  checkpoint at round 2 resumed to round 4, and the diurnal-churn
  scenario;
- one spawned world of 4 runs each path on (2, 2) and on (4, 1)
  (femnist width 4, 8 clients, cohorts of 4, cuts 2): every rank's host
  outcomes (cohorts, masks, realized lags, telemetry, verdicts, actions,
  quarantine ledger, resume round) equal the unsharded run's exactly;
  the state and metrics within the reference's mesh criteria
  (``repro/launch/meshcheck.py``'s 1e-5, and for the pipelined runs the
  reference's own rtol 2e-5 / atol 1e-6, ``tests/test_pipeline.py``),
  a leaf's values exempt at 0.1% where Adam's near-sign first steps can
  move a weight by up to 2 * lr a step (``tests/torch_parity.py``);
- the guard, with a NaN planted in a slot the world's last rank holds:
  every rank's health vector is the same bits each round, and the
  census of its agreement is as counted below; the control (the
  non-finite flag left unsummed over ``model``) is refused;
- cyclepsl under diurnal churn, its per-client store rows over
  ``data``, checkpointed at round 2: resumed on the same mesh it is bit
  for bit the unbroken run there; resumed unsharded in this process it
  is within 1e-5 of the unsharded run; the file loads in
  ``repro.checkpoint.load_checkpoint`` with the leaf paths and, within
  1e-5, the values of the unsharded run's checkpoint; the host group's
  census is as counted;
- ``launch.steps.build_pipelined_train_steps(mesh=)`` for olmoe's smoke
  config (depth 2) on (1, 4): extract then tail is bit for bit
  ``build_train_step(mesh=)``'s round, and within rtol 1e-4 of the
  reference's unsharded round on the weights and plan carried across.

Jobs in ``tests/torch_engine_paths_ranks.py`` (no jax); this process
runs the unsharded references and the reference's round meanwhile.
"""
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.api import Engine as JEngine
from repro.api import ExperimentConfig as JConfig
from repro.checkpoint import load_checkpoint as j_load
from repro_torch.api import ExperimentConfig
from repro_torch.launch.meshcheck import spawn_ranks
from repro_torch.resilience import FaultConfig, FaultStream, ResilienceConfig
from repro_torch.scenario.profiles import ScenarioConfig
from repro_torch.utils.tree import tree_leaves

import test_torch_tp as tp
import torch_engine_paths_ranks as ranks

LR = 1e-3
BASE = dict(n_clients=8, attendance=0.5, batch=8, width=4, rounds=3,
            eval_every=3)
# the fault stream of seed 32 over cohorts of 4: NaN in slot 3 at round
# 0 (the last rank's on (2, 2) and (4, 1)) and in slot 1 at round 1, a
# dispatch error at round 2; quarantine takes the NaNs, rollback the
# error (to round 1's snapshot)
FAULTS = FaultConfig(nan_rate=0.4, error_rate=0.25, seed=32)
GUARD = ResilienceConfig(guard=True, on_nonfinite="quarantine",
                         on_error="rollback", faults=FAULTS)
# the async run is guarded too: a recovered round re-extracts the ring
PATHS = {"sync": dict(pipeline_depth=2),
         "async": dict(pipeline_depth=1, pipeline_staleness="async",
                       staleness_weighting="inverse", resilience=GUARD),
         "guard": dict(resilience=GUARD)}
# a per-client program under churn, checkpointed at round 2 of 4
CKPT = dict(algo="cyclepsl", scenario=ScenarioConfig(kind="diurnal-churn",
                                                    dropout=0.25),
            rounds=4, eval_every=2)
MESHES = {"(2, 2)": (2, 2), "(4, 1)": (4, 1)}
# what cyclesfl's round at cut 2 moves over a mesh of one rank (the
# gathered pool, the data-parallel server's gradients, the FedAvg)
ROUND_KEYS = {"all_gather/pool", "all_reduce/grads", "all_reduce/slot_mean"}
PIPELINED = ("sync", "async")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread here, as in every spawned rank."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _dirname(lab):
    return lab.strip("()").replace(", ", "x")


def _world_cases(root):
    cases = {}
    for lab, shape in MESHES.items():
        for name, kw in PATHS.items():
            cases[f"{name} {lab}"] = dict(BASE, **kw, mesh_shape=shape)
        d = os.path.join(root, _dirname(lab))
        cases[f"ckpt {lab}"] = dict(BASE, **CKPT, mesh_shape=shape,
                                    ckpt_dir=os.path.join(d, "unbroken"))
        part = os.path.join(d, "part")
        cases[f"partial {lab}"] = dict(BASE, **dict(CKPT, rounds=2),
                                       mesh_shape=shape, ckpt_dir=part)
        cases[f"resume {lab}"] = dict(BASE, **CKPT, mesh_shape=shape,
                                      ckpt_dir=part, resume=True)
    return cases


# --------------------------------------------------------------- (1, 1)
# name: (config, the unsharded world reference it shares, if any)
ONE_BY_ONE = {
    "pipelined sync depth 2": (dict(BASE, **PATHS["sync"]), "sync"),
    "pipelined async depth 1 inverse, guarded": (
        dict(BASE, **PATHS["async"]), "async"),
    "guard nan, dispatch and torn checkpoints": (dict(
        BASE, eval_every=1, ckpt_dir="ck", resilience=replace(
            GUARD, faults=replace(FAULTS, ckpt_rate=0.5))), None),
    "checkpoint at 2 resumed to 4": (dict(BASE, rounds=4, eval_every=2,
                                          ckpt_dir="ck", resume=True), None),
    "diurnal-churn scenario": (dict(
        BASE, scenario=ScenarioConfig(kind="diurnal-churn")), None),
}


def _one_by_one(kw, root, name):
    """``kw`` on a (1, 1) mesh, or off the mesh with ``mesh`` None, in a
    checkpoint directory of its own where it checkpoints (a resumed run
    after the partial run that writes its step 2)."""
    def run(mesh):
        cfg = dict(kw) if mesh is None else dict(kw, mesh_shape=mesh)
        if "ckpt_dir" in kw:
            cfg["ckpt_dir"] = os.path.join(root, "one", name, str(mesh))
        if kw.get("resume"):
            ranks.engine_run(dict(cfg, rounds=2, resume=False))
        return ranks.engine_run(cfg)
    return run


def _template():
    """The reference's TrainState of the checkpointed config: the
    template its ``load_checkpoint`` reads a step into."""
    cfg = JConfig.from_dict(ExperimentConfig(**dict(BASE, **CKPT)).to_dict())
    return jax.device_get(JEngine(cfg, log=lambda *a: None).init_state())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world of 4, and meanwhile in this process the reference's
    carried olmoe init (handed to the ranks by a file), its round and
    TrainState template, the unsharded Engine's runs and the (1, 1)
    cases; then each mesh's checkpoint resumed unsharded."""
    root = str(tmp_path_factory.mktemp("paths"))
    carried = os.path.join(root, "carried.pt")
    with ThreadPoolExecutor(3) as pool:
        world = pool.submit(spawn_ranks, 4, ranks.world,
                            (_world_cases(root), (1, 4), carried),
                            workdir=tmp_path_factory.mktemp("w4"),
                            shape=(2, 2))

        def reference():
            state0, plans, rounds = tp._reference_init(*tp.OLMOE)
            torch.save((state0, plans), carried + ".tmp")
            os.rename(carried + ".tmp", carried)
            return rounds()
        j_round = pool.submit(reference)
        template = pool.submit(_template)
        base = {name: ranks.engine_run(dict(BASE, **kw))
                for name, kw in PATHS.items()}
        u = os.path.join(root, "unsharded")
        base["ckpt"] = ranks.engine_run(dict(
            BASE, **CKPT, ckpt_dir=os.path.join(u, "unbroken")))
        base["partial"] = ranks.engine_run(dict(
            BASE, **dict(CKPT, rounds=2), ckpt_dir=os.path.join(u, "part")))
        one = {}
        for name, (kw, shared) in ONE_BY_ONE.items():
            run = _one_by_one(kw, root, name)
            one[name] = (base[shared] if shared else run(None), run((1, 1)))
        out = {"world": world.result(), "unsharded": base, "one": one,
               "reference": j_round.result(), "template": template.result(),
               "root": root}
    for lab in MESHES:
        src = os.path.join(root, _dirname(lab), "part", "step_2")
        dst = os.path.join(root, f"from {_dirname(lab)}")
        shutil.copytree(src, os.path.join(dst, "step_2"))
        out[f"from {lab}"] = ranks.engine_run(dict(
            BASE, **CKPT, ckpt_dir=dst, resume=True))
    return out


def _steps_bound(kw) -> int:
    """Adam steps a weight can take in a run: the server's per round (one
    server batch of the pool a step, cohorts of 4) and its retries."""
    return 2 * 4 * kw.get("rounds", BASE["rounds"])


def _state_within(want, got, steps, rtol=0.0, atol=1e-5):
    """The violations of the docstring's state rule."""
    bad = []
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        assert a.shape == b.shape
        if not a.is_floating_point():
            if not torch.equal(a, b):
                bad.append("step")
            continue
        d = (a.double() - b.double()).abs()
        if float(d.max()) > 2 * LR * steps + 1e-6:
            bad.append(("max", float(d.max())))
        over = int((d > atol + rtol * a.double().abs()).sum())
        if over > max(1, 1e-3 * d.numel()):
            bad.append(("count", over))
    return bad


def _rows_within(want, got, rtol):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k in w:
            scale = max(abs(w[k]), w.get("feat_grad_norm_mean", 0.0)
                        if k == "feat_grad_norm_std" else 0.0)
            assert abs(g[k] - w[k]) <= rtol * scale, (k, g[k], w[k])


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def _host(run) -> dict:
    """A run's host-side outcomes: what must agree exactly (the
    telemetry's totals are sums of its rows)."""
    res = run["result"]
    return {"drawn": run["drawn"],
            "telemetry": res.get("telemetry", {}).get("per_round"),
            "resilience": res.get("resilience"),
            "pipeline": res.get("pipeline"),
            "resumed": res.get("resumed_from_round"),
            "recovery log": [m for m in run["log"]
                             if m.startswith("[resilience]")]}


def _base_of(name):
    return name.split(" ")[0].replace("resume", "ckpt")


@pytest.mark.parametrize("name", list(ONE_BY_ONE))
def test_one_by_one_mesh_is_bit_for_bit_unsharded(name, runs):
    base, one = runs["one"][name]
    assert _equal(base["state"], one["state"])
    assert base["rows"] == one["rows"]
    assert base["health"] == one["health"]
    assert base["result"] == one["result"]
    assert _host(base) == _host(one)
    res = base["result"]
    if "guard" in name:
        s = res["resilience"]
        assert s["quarantine_events"] and s["rollbacks"]
        assert s["ckpt_corruptions"] or "ckpt_dir" not in ONE_BY_ONE[name][0]
    if "resumed" in name:
        assert res["resumed_from_round"] == 2
    # the paths add no collective of their own at one rank: a census
    # holds only the world-of-one calls of the round itself
    assert all(set(c) <= ROUND_KEYS for c in one["census"]), one["census"]


# ------------------------------------------------------------ the world
WORLD = [f"{p} {lab}" for lab in MESHES
         for p in (*PATHS, "ckpt", "resume")]


@pytest.mark.parametrize("name", WORLD)
def test_host_outcomes_equal_unsharded_on_every_rank(name, runs):
    """Cohorts, masks, realized lags, telemetry, verdicts, actions, the
    quarantine ledger and the resume round: the unsharded run's, on
    every rank."""
    want = _host(runs["unsharded"][_base_of(name)])
    if name.startswith("resume"):
        want.update(drawn=want["drawn"][2:],
                    telemetry=want["telemetry"][2:], resumed=2)
    for rank in runs["world"]:
        assert _host(rank[name]) == want


@pytest.mark.parametrize("name", WORLD)
def test_every_rank_reports_the_same_run(name, runs):
    """Metrics, health vectors, evaluations and the state's digest: the
    same bits on every rank."""
    first = runs["world"][0][name]
    for rank in runs["world"][1:]:
        got = rank[name]
        assert got["rows"] == first["rows"]
        assert got["health"] == first["health"]
        assert got["result"] == first["result"]
        assert got["digest"] == first["digest"]


@pytest.mark.parametrize("name", [n for n in WORLD
                                  if not n.startswith("resume")])
def test_mesh_run_held_to_unsharded(name, runs):
    """The state and metrics within the reference's criteria: 1e-5, and
    rtol 2e-5 / atol 1e-6 for the pipelined runs."""
    base = runs["unsharded"][_base_of(name)]
    got = runs["world"][0][name]
    piped = _base_of(name) in PIPELINED
    kw = dict(rtol=2e-5, atol=1e-6) if piped else {}
    assert not _state_within(base["state"], got["state"],
                             _steps_bound(CKPT if "ckpt" in name else {}),
                             **kw)
    _rows_within(base["rows"], got["rows"], 2e-5 if piped else 1e-5)
    for w, g in zip(base["result"]["history"], got["result"]["history"]):
        assert abs(g["test_loss"] - w["test_loss"]) <= \
            1e-5 * abs(w["test_loss"])


@pytest.mark.parametrize("lab", list(MESHES))
def test_guard_blames_the_last_ranks_slot_and_agrees(lab, runs):
    """The NaN planted at round 0 lies in a slot the last rank holds;
    every rank's health vector of each accepted round is the same bits
    (checked with the rest of the run above), and the census of the
    agreement is one gather of each rank's slots' blame and flag over
    the batch axes a dispatch, and on a model axis one sum of the flag."""
    shape = MESHES[lab]
    assert FaultStream(FAULTS, 0).nan_slots_for(0, 0, 4).tolist() == [3]
    c_local = 4 // shape[0]
    assert 3 >= 4 - c_local                 # the last rank's slots
    res = runs["world"][-1][f"guard {lab}"]["result"]["resilience"]
    assert res["quarantine_events"] == 2 and res["rollbacks"] == 1
    # a dispatch fault raises before its round runs; every other attempt
    # runs the round, and the guard with it
    ran = BASE["rounds"] + res["faults"]["nonfinite"] + res["faults"]["spike"]
    want = {"all_gather/health": {"calls": ran,
                                  "bytes": ran * (c_local + 1) * 4}}
    if shape[1] > 1:
        want["model/all_reduce/health"] = {"calls": ran, "bytes": ran * 4}
    for rank in runs["world"]:
        total = {}
        for c in rank[f"guard {lab}"]["census"]:
            for k, v in c.items():
                if "health" in k:
                    row = total.setdefault(k, {"calls": 0, "bytes": 0})
                    row["calls"] += v["calls"]
                    row["bytes"] += v["bytes"]
        assert total == want


def test_guard_control_unreduced_over_model_is_refused(runs):
    """A NaN in the last rank's ``model`` block of the server: agreed,
    every rank's vector reads non-finite alike; with the flag left
    unsummed over ``model``, the ranks part, which the agreement check
    refuses."""
    agreed = [r["control"]["agreed"] for r in runs["world"]]
    assert all(h == agreed[0] for h in agreed) and agreed[0][0] == 1.0
    parted = [r["control"]["unreduced over model"] for r in runs["world"]]
    assert not all(h == parted[0] for h in parted)


@pytest.mark.parametrize("lab", list(MESHES))
def test_resume_on_the_mesh_is_the_unbroken_run(lab, runs):
    """Checkpointed at round 2 and resumed to 4 on the same mesh: bit for
    bit the unbroken run there; the host group agreed the step and each
    write."""
    for rank in runs["world"]:
        assert rank[f"resume {lab}"]["digest"] == \
            rank[f"ckpt {lab}"]["digest"]
        assert rank[f"resume {lab}"]["rows"] == \
            rank[f"ckpt {lab}"]["rows"][2:]
        assert rank[f"partial {lab}"]["host_census"] == {
            "host/all_reduce/ckpt": {"calls": 1, "bytes": 4}}
        assert rank[f"resume {lab}"]["host_census"] == {
            "host/broadcast/ckpt_step": {"calls": 1, "bytes": 8},
            "host/all_reduce/ckpt": {"calls": 1, "bytes": 4}}
    assert _equal(runs["world"][0][f"resume {lab}"]["state"],
                  runs["world"][0][f"ckpt {lab}"]["state"])


@pytest.mark.parametrize("lab", list(MESHES))
def test_mesh_checkpoint_resumes_unsharded(lab, runs):
    """The mesh's step 2, resumed off the mesh, ends within 1e-5 of the
    unsharded run, its host outcomes equal."""
    got, want = runs[f"from {lab}"], runs["unsharded"]["ckpt"]
    assert got["result"]["resumed_from_round"] == 2
    assert not _state_within(want["state"], got["state"],
                             _steps_bound(CKPT))
    _rows_within(want["rows"][2:], got["rows"], 1e-5)
    assert got["drawn"] == want["drawn"][2:]


@pytest.mark.parametrize("lab", list(MESHES))
def test_mesh_checkpoint_loads_in_the_reference(lab, runs):
    """``repro.checkpoint.load_checkpoint`` reads the mesh's step 2 and
    the unsharded run's into the reference's TrainState: the same leaf
    paths, the values within 1e-5 (the same Adam exemption)."""
    mesh, _ = j_load(os.path.join(runs["root"], _dirname(lab), "part"),
                     runs["template"], step=2)
    base, _ = j_load(os.path.join(runs["root"], "unsharded", "part"),
                     runs["template"], step=2)
    pm = jax.tree_util.tree_flatten_with_path(mesh)[0]
    pb = jax.tree_util.tree_flatten_with_path(base)[0]
    assert [p for p, _ in pm] == [p for p, _ in pb]
    assert not _state_within([torch.from_numpy(np.array(v)) for _, v in pb],
                             [torch.from_numpy(np.array(v)) for _, v in pm],
                             _steps_bound(dict(rounds=2)))


@pytest.mark.parametrize("lab", list(MESHES))
def test_population_scenario_splits_the_store(lab, runs):
    """cyclepsl under churn holds its per-client store's rows over the
    batch axes, a rank's share each, and dropped clients in its rounds."""
    d = MESHES[lab][0]
    rows = [r[f"ckpt {lab}"]["store_rows"] for r in runs["world"]]
    per = 8 // d
    assert sorted(set(rows)) == [(i * per, (i + 1) * per, 8)
                                 for i in range(d)]
    tel = runs["world"][0][f"ckpt {lab}"]["result"]["telemetry"]
    assert tel["dropped_total"] > 0


# ------------------------------------------------- the transformer steps
def test_pipelined_steps_compose_to_the_train_step(runs):
    """olmoe on (1, 4): extract then tail is the train step's round bit
    for bit, on every rank."""
    for rank in runs["world"]:
        s = rank["steps"]
        assert s["digests"][0] == s["digests"][1]
        assert s["rows"][0] == s["rows"][1]


def test_pipelined_steps_match_the_reference(runs):
    """The (1, 4) pipelined round against the reference's unsharded round
    on the carried weights and plan: metrics within rtol 1e-4, the state
    under the Adam near-sign rule."""
    j_rows, (jserver, jclients) = runs["reference"]
    got = runs["world"][0]["steps"]
    tp._assert_rows_close(j_rows, got["rows"][1:], 1e-4)
    srv, cl = got["state"]
    for j_e, t_e, steps in ((jserver, srv, 2 * tp.ROUNDS),
                            (jclients, cl, tp.ROUNDS)):
        np.testing.assert_array_equal(np.asarray(t_e.step),
                                      np.asarray(j_e.step))
        tp._assert_adam_close(jax.tree.leaves(j_e.params),
                              tree_leaves(t_e.params), steps)
        tp._assert_adam_close(jax.tree.leaves(j_e.opt_state),
                              tree_leaves(t_e.opt_state), steps)
