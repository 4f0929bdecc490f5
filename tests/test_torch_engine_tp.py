"""The Engine on the reference's 2-D ``(data, model)`` mesh, on the CPU
over gloo: the ``model`` axis splits the stage models' ``lin/w``
columns (``models.cnn.dense``, the head gathered whole for the fused
``gather_loss``), and ``data`` holds the server's and the shared client
model's FSDP blocks (``sharding.specs.shard_plan``).

The reference's mesh path does not run in this JAX (its meshes build
Explicit axes, which ``with_sharding_constraint`` refuses), so, as for
the port's (N, 1) mesh (``tests/test_torch_mesh.py``), the placed
Engine is held to the port's unsharded Engine, whose own parity with
the reference the zoo's files hold:

- a (1, 1) mesh is bit for bit the unsharded Engine (state, metrics,
  history) at cut 2 and at cut 3 fused;
- on (1, 2) and (2, 2), for cyclesfl, cyclepsl, sflv1 and sglr at cut 2
  and at cut 3 fused, two rounds of femnist width 4 within 1e-5 of the
  unsharded Engine: per-round metrics and the history's test loss to
  rtol 1e-5 (the std of the feature-gradient norms against their mean),
  every state leaf within 1e-5 but for at most 0.1% of its values (one
  value in a leaf under 1000), each within the 2 * lr * steps that
  Adam's near-sign steps can move a weight (``tests/torch_parity.py``
  says why a bias at rounding noise flips the next round's ReLU at the
  images' zero pixels);
- (4, 1) (FSDP only) and (1, 4) (the image task's 10-class head stays
  whole there: 10 columns do not divide 4) are held the same way for
  cyclesfl;
- the census of one (4, 1) round is exact: the keys FSDP adds are
  counted from the plan's blocks, the others are those of the same run
  without FSDP;
- (pod, data, model) = (2, 2, 1), cyclesfl at cut 2 with the gradient
  clipped: the cohort splits over pod x data and the FSDP blocks over
  ``data`` alone (the data axis' own group, census ``data/...``), so a
  server gradient is all-reduced over the four ranks and sliced to the
  block, and the clip's norm sums the blocks' squares over ``data``;
  held to the unsharded Engine as above, its blocks' shapes and its
  census of one round exact;
- the control: the same run with each data reduce-scatter dropped
  (every rank keeps its own partial's block) fails that check;
- the transformer steps with FSDP, glm4's smoke config on (2, 1) (the
  server's minibatch data-parallel, its gradients reduce-scattered)
  and olmoe's on (2, 2) (replicated, sliced), as ``tests/test_torch_tp``
  holds the model axis alone: the server's loss and gradient through
  ``gather_from_data`` within 1e-5 of the leaf's scale, the round's
  metrics within rtol 1e-5 and its state under Adam's near-sign rule,
  the prefill's bf16 logits within one bf16 rounding, and every rank's
  Adam moments only its blocks; the prefill step on weights the caller
  cut (its ``init_state`` not called) gives its own init's logits;
- whole -> blocks -> whole over the process groups is exact.

One world of 2 and one of 4 are spawned at once (jobs in
``tests/torch_fsdp_ranks.py``, which must not import jax), one thread a
rank, while this process runs the unsharded references.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.api import Engine, ExperimentConfig
from repro_torch.core.cyclesl import CycleConfig
from repro_torch.launch.meshcheck import spawn_ranks
from repro_torch.serve import ServeConfig
from repro_torch.utils.tree import tree_leaves

import torch_fsdp_ranks as ranks

LR = 1e-3
# a cohort of 5 live clients: FedAvg over an odd count of first Adam
# steps (each +-lr on a bias) cannot cancel to float32 rounding noise,
# the tie ``tests/torch_parity.py`` exempts; on (2, 2) and (4, 1) the
# shard-aligned capacity adds dead slots, so the masked paths run too
ENGINE = dict(rounds=2, eval_every=2, n_clients=6, attendance=0.8,
              batch=8, width=4)
ALGOS = ("cyclesfl", "cyclepsl", "sflv1", "sglr")
CUTS = {"cut2": dict(cut=2), "cut3 fused": dict(
    cut=3, cycle=CycleConfig(fused_gather_loss=True))}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread here, as in every spawned rank."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(algo, cut, shape=None):
    kw = dict(ENGINE, algo=algo, **CUTS[cut])
    if shape is not None:
        kw["mesh_shape"] = shape
    return kw


def _cases(shape):
    return {f"{a} {c}": (_cfg(a, c, shape), None)
            for a in ALGOS for c in CUTS}


# the transformer steps: name -> (mesh, arch, depth, rounds, seed, the
# gradient's modes); glm4 (dense) on (2, 1), where the server's
# minibatch is data-parallel and its gradients are reduce-scattered into
# the FSDP blocks, olmoe on (2, 2), whose minibatch is replicated
# (tp_layout) and its gradients sliced: an MoE's groups, and so its
# capacity drops and its aux losses, change with split rows
STEPS2 = {"glm4 (2, 1)": ((2, 1), "glm4-9b", 2, 1, 0, ("scatter", "slice"))}
STEPS4 = {"olmoe (2, 2)": ((2, 2), "olmoe-1b-7b", 2, 1, 0, ("slice",))}
STEPS = {**STEPS2, **STEPS4}
STEP_LR = 3e-4
# (pod, data, model): FSDP over data beside a pod axis, with the clip's
# norm reduced over data
POD_SHAPE = (2, 2, 1)


def _pod_cfg(shape=None):
    kw = dict(_cfg("cyclesfl", "cut2", shape),
              cycle=CycleConfig(grad_clip=0.05))
    if shape is not None:
        kw["mesh_axes"] = ("pod", "data", "model")
    return kw


def _world4_cases():
    cases = _cases((2, 2))
    for mode in (None, "no fsdp", "dropped reduce"):
        cases[f"(4, 1) cyclesfl cut2{'' if mode is None else ' ' + mode}"] \
            = (_cfg("cyclesfl", "cut2", (4, 1)), mode)
    cases["(1, 4) cyclesfl cut3 fused"] = (
        _cfg("cyclesfl", "cut3 fused", (1, 4)), None)
    for mode in (None, "no fsdp"):
        cases[f"(2, 2, 1) cyclesfl cut2 clip"
              f"{'' if mode is None else ' ' + mode}"] = (
            _pod_cfg(POD_SHAPE), mode)
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawned worlds at once, and meanwhile, in this process, the
    unsharded references: the Engine's and the transformer steps'."""
    with ThreadPoolExecutor(2) as pool:
        w4 = pool.submit(spawn_ranks, 4, ranks.world,
                         (_world4_cases(), STEPS4),
                         workdir=tmp_path_factory.mktemp("e4"), shape=(2, 2))
        w2 = pool.submit(spawn_ranks, 2, ranks.world,
                         (_cases((1, 2)), STEPS2),
                         workdir=tmp_path_factory.mktemp("e2"), shape=(1, 2))
        engine = {f"{a} {c}": ranks.engine_run(_cfg(a, c))
                  for a in ALGOS for c in CUTS}
        engine["cyclesfl cut2 clip"] = ranks.engine_run(_pod_cfg())
        steps = {name: ranks.unsharded_steps(*args[1:])
                 for name, args in STEPS.items()}
        return {"world4": w4.result(), "world2": w2.result(),
                "unsharded": engine, "steps_unsharded": steps}


@pytest.fixture(scope="module")
def world2(runs):
    return runs["world2"]


@pytest.fixture(scope="module")
def world4(runs):
    return runs["world4"]


@pytest.fixture(scope="module")
def unsharded(runs):
    return runs["unsharded"]


def _state_within(want, got, steps):
    """The state rule of the docstring; returns the violations."""
    bad = []
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        assert a.shape == b.shape
        if a.dtype == torch.int32:
            if not torch.equal(a, b):
                bad.append("step")
            continue
        d = (a - b).abs()
        if float(d.max()) > 2 * LR * steps + 1e-6:
            bad.append(("max", float(d.max())))
        if int((d > 1e-5).sum()) > max(1, 1e-3 * d.numel()):
            bad.append(("count", int((d > 1e-5).sum())))
    return bad


def _rows_within(want, got, rtol=1e-5):
    for w, g in zip(want["rows"], got["rows"]):
        assert set(w) == set(g)
        for k in w:
            scale = max(abs(w[k]), w["feat_grad_norm_mean"]
                        if k == "feat_grad_norm_std" else 0.0)
            assert abs(g[k] - w[k]) <= rtol * scale, (k, g[k], w[k])
    for w, g in zip(want["history"], got["history"]):
        assert abs(g["test_loss"] - w["test_loss"]) <= \
            rtol * abs(w["test_loss"])


# ------------------------------------------------------------------ (1, 1)
@pytest.mark.parametrize("cut", list(CUTS))
def test_one_by_one_engine_is_bit_for_bit_unsharded(cut, unsharded):
    """A (1, 1) mesh runs the placement code (plans, whole-state
    gathers) with every axis of one rank: the unsharded Engine's bits,
    and no collective."""
    got = ranks.engine_run(_cfg("cyclesfl", cut, (1, 1)))
    want = unsharded[f"cyclesfl {cut}"]
    assert got["rows"] == want["rows"]
    assert got["history"] == [dict(h, elapsed_s=g["elapsed_s"])
                              for h, g in zip(want["history"],
                                              got["history"])]
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(want["state"]), tree_leaves(got["state"])))
    # one rank: the plan places nothing, so no weight moves
    assert not any(k.startswith("model/") or k.endswith(("/weights",
                                                         "/wgrads"))
                   for c in got["census"] for k in c)


# ------------------------------------------------------------ 2-D meshes
MESH_CASES = [(w, f"{a} {c}") for w in ("world2", "world4")
              for a in ALGOS for c in CUTS]


@pytest.mark.parametrize("world,name", MESH_CASES,
                         ids=[f"{'(1, 2)' if w == 'world2' else '(2, 2)'} "
                              f"{n}" for w, n in MESH_CASES])
def test_engine_on_the_mesh_matches_unsharded(world, name, request,
                                              unsharded):
    got = request.getfixturevalue(world)[0]["engine"][name]
    want = unsharded[name]
    _rows_within(want, got)
    assert _state_within(want["state"], got["state"], 8) == []


@pytest.mark.parametrize("name", ["(4, 1) cyclesfl cut2",
                                  "(1, 4) cyclesfl cut3 fused"])
def test_fsdp_only_and_model_only_meshes_match_unsharded(name, world4,
                                                         unsharded):
    got = world4[0]["engine"][name]
    want = unsharded[name.split(" ", 2)[2]]
    _rows_within(want, got)
    assert _state_within(want["state"], got["state"], 8) == []


def test_gathered_blocks_are_the_whole_weights(world2, world4):
    """Whole -> this rank's blocks -> whole over the process groups
    (``data`` then ``model``) is exact on (1, 2) and (2, 2): femnist
    width 4 at cut 3 and olmoe's smoke halves."""
    assert all(r["round_trip"] for r in world2 + world4)


def test_every_rank_reports_the_same(world2, world4):
    for world in (world2, world4):
        for name, res in world[0]["engine"].items():
            for other in world[1:]:
                assert other["engine"][name]["rows"] == res["rows"], name


def test_ranks_hold_their_blocks(world4):
    """On (2, 2) the server's femnist ``lin/w`` leaves at width 4 are
    blocks over both axes: stage 2's [392, 2048] as [196, 1024] at cut
    2, the head's [2048, 10] as [1024, 5]."""
    got = world4[0]["engine"]["cyclesfl cut2"]["local_shapes"]
    assert got == [(196, 1024), (1024, 5)]
    got = world4[3]["engine"]["cyclesfl cut3 fused"]["local_shapes"]
    assert got == [(1024, 5)]


def _fsdp_census(width, n, steps):
    """The keys FSDP adds to one (n, 1) cyclesfl round at cut 2, from
    the plan: the server's ``lin/w`` leaves [7 * 7 * 2w, 2048] and
    [2048, 10] float32, each split over its rows.  Every server step
    gathers each block once (``all_gather/weights``, a call a leaf, the
    payload a rank's block) and reduce-scatters each leaf's float32
    gradient once (``reduce_scatter/wgrads``, the payload the whole
    leaf); the frozen server of the feature gradients is gathered once
    more.  The shared client model (conv stages) has no ``lin/w``: its
    FedAvg stays an all-reduce."""
    whole = (7 * 7 * 2 * width * 2048 + 2048 * 10) * 4
    return {"all_gather/weights": {"calls": 2 * (steps + 1),
                                   "bytes": (steps + 1) * whole // n},
            "reduce_scatter/wgrads": {"calls": 2 * steps,
                                      "bytes": steps * whole}}


def test_census_of_one_round_is_exact(world4):
    """Round 1 of (4, 1) cyclesfl at cut 2: a cohort of 5 padded to the
    shard-aligned capacity 8 (two slots a rank), batch 8, one epoch of
    the capacity's 64 / 8 = 8 server steps (the masked loop runs them
    all), data-parallel (2 rows a rank a step).  FSDP's keys as :func:`_fsdp_census` counts
    them; ``all_reduce/grads`` now carries the loss alone (4 bytes a
    step, where it carried the whole gradients and the loss); every
    other key exactly as in the same round with every leaf whole over
    ``data`` (the round before FSDP)."""
    whole = (7 * 7 * 8 * 2048 + 2048 * 10) * 4
    for rank in world4:
        got = dict(rank["engine"]["(4, 1) cyclesfl cut2"]["census"][0])
        base = dict(
            rank["engine"]["(4, 1) cyclesfl cut2 no fsdp"]["census"][0])
        want = _fsdp_census(4, 4, 8)
        assert {k: got.pop(k) for k in want} == want
        assert got.pop("all_reduce/grads") == {"calls": 8, "bytes": 8 * 4}
        assert base.pop("all_reduce/grads") == {"calls": 8,
                                                "bytes": 8 * (whole + 4)}
        assert got == base


def test_pod_data_model_mesh_matches_unsharded(world4, unsharded):
    """(2, 2, 1) over ('pod', 'data', 'model'): two rounds within the
    unsharded Engine's bounds, every rank the same, and the server's
    ``lin/w`` leaves held as blocks over ``data`` alone (two ranks):
    [392, 2048] as [196, 2048], the head [2048, 10] as [1024, 10]."""
    want = unsharded["cyclesfl cut2 clip"]
    for rank in world4:
        got = rank["engine"]["(2, 2, 1) cyclesfl cut2 clip"]
        assert got["local_shapes"] == [(196, 2048), (1024, 10)]
    got = world4[0]["engine"]["(2, 2, 1) cyclesfl cut2 clip"]
    _rows_within(want, got)
    assert _state_within(want["state"], got["state"], 8) == []


def test_pod_census_of_one_round_is_exact(world4):
    """Round 1 of the (2, 2, 1) run: capacity 8 over the four ranks of
    pod x data, 8 data-parallel server steps as on (4, 1).  The blocks
    are gathered over the data axis' own group (``data/all_gather/
    weights``, a call a leaf a step and once for the frozen server, the
    payload a rank's half); each leaf's float32 gradient is summed over
    all four ranks, whose minibatch rows differ (``all_reduce/wgrads``,
    a call a leaf a step, the whole leaf), and sliced to the block; the
    clip's norm adds one float32 all-reduce a step over ``data``; the
    gradient all-reduce carries the loss alone; every other key as in
    the same run without FSDP."""
    whole = (7 * 7 * 8 * 2048 + 2048 * 10) * 4
    steps = 8
    for rank in world4:
        got = dict(rank["engine"]["(2, 2, 1) cyclesfl cut2 clip"]
                   ["census"][0])
        base = dict(rank["engine"]["(2, 2, 1) cyclesfl cut2 clip no fsdp"]
                    ["census"][0])
        want = {"data/all_gather/weights": {"calls": 2 * (steps + 1),
                                            "bytes": (steps + 1) * whole
                                            // 2},
                "all_reduce/wgrads": {"calls": 2 * steps,
                                      "bytes": steps * whole},
                "data/all_reduce/grad_norm": {"calls": steps,
                                              "bytes": steps * 4}}
        assert {k: got.pop(k, None) for k in want} == want
        assert got.pop("all_reduce/grads") == {"calls": steps,
                                               "bytes": steps * 4}
        assert base.pop("all_reduce/grads") == {
            "calls": steps, "bytes": steps * (whole + 4)}
        assert got == base


def test_dropped_data_reduce_fails_the_check(world4, unsharded):
    """With the reduce-scatter into the blocks dropped, the run leaves
    the unsharded Engine's bounds: the check that holds the sound run
    refuses it."""
    want = unsharded["cyclesfl cut2"]
    got = world4[0]["engine"]["(4, 1) cyclesfl cut2 dropped reduce"]
    assert _state_within(want["state"], got["state"], 8) != []
    for sound in ("(4, 1) cyclesfl cut2", "(4, 1) cyclesfl cut2 no fsdp"):
        got = world4[0]["engine"][sound]
        assert _state_within(want["state"], got["state"], 8) == []


# ------------------------------------------------------ transformer steps
@pytest.fixture(scope="module")
def steps_unsharded(runs):
    return runs["steps_unsharded"]


def _steps_run(name, world2, world4):
    return (world2 if name in STEPS2 else world4)


GRAD_CASES = [(n, mode) for n, a in STEPS.items() for mode in a[-1]]


@pytest.mark.parametrize("name,mode", GRAD_CASES,
                         ids=[f"{n}-{m}" for n, m in GRAD_CASES])
def test_step_server_gradient_through_fsdp_matches_unsharded(
        name, mode, world2, world4, steps_unsharded):
    """``gather_from_data`` both ways on the transformer's server (its
    blocks over ``model`` and ``data``): data-parallel rows with the
    gradient reduce-scattered, and the replicated batch with the
    gradient sliced.  The loss and every leaf's gradient, gathered
    whole, within 1e-5 of the unsharded one's (relative to the loss,
    and to the leaf's largest entry)."""
    got = _steps_run(name, world2, world4)[0]["steps"][name]["grads"][mode]
    want = steps_unsharded[name]
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    for a, b in zip(tree_leaves(want["grads"]), tree_leaves(got["grads"])):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()


@pytest.mark.parametrize("name", list(STEPS))
def test_step_round_and_prefill_match_unsharded(name, world2, world4,
                                                steps_unsharded):
    """The round's metrics within rtol 1e-5, its state gathered whole
    under Adam's near-sign rule (all but 0.1% of a leaf within 1e-6,
    every weight within 2 * lr * steps: the server takes 2 steps, each
    client 1), and the prefill's bf16 logits within one bf16 rounding,
    as ``tests/test_torch_tp.py`` holds the model axis alone; the same
    on every rank."""
    world = _steps_run(name, world2, world4)
    got, want = world[0]["steps"][name], steps_unsharded[name]
    for w, g in zip(want["rows"], got["rows"]):
        for k in w:
            scale = max(abs(w[k]), w["feat_grad_norm_mean"]
                        if k == "feat_grad_norm_std" else 0.0)
            assert abs(g[k] - w[k]) <= 1e-5 * scale, (k, g[k], w[k])
    for a, b in zip(tree_leaves(want["state"]), tree_leaves(got["state"])):
        d = np.abs(a - b)
        if d.size:
            assert d.max() <= 2 * STEP_LR * 2 + 1e-6
            assert (d > 1e-6).mean() <= 1e-3
    torch.testing.assert_close(got["prefill"], want["prefill"], rtol=8e-3,
                               atol=1e-3)
    for other in world[1:]:
        assert other["steps"][name]["rows"] == got["rows"]


@pytest.mark.parametrize("name", list(STEPS))
def test_prefill_step_takes_carried_weights(name, world2, world4):
    """The prefill step's placement is fixed when it is built: its step
    on blocks the caller cut from the same draw (carried weights, the
    bundle's ``init_state`` never called) gives its own init's logits,
    bit for bit, on every rank."""
    for rank in _steps_run(name, world2, world4):
        assert rank["steps"][name]["prefill_carried_equal"]


@pytest.mark.parametrize("name", list(STEPS))
def test_step_server_holds_only_its_blocks(name, world2, world4):
    """Each rank's Adam moments of the server are its blocks: every leaf
    the plan splits over ``data`` holds 1/d of that dim (1/m of its
    ``model`` dim where split there), so no rank holds a whole
    data-split leaf's moments."""
    from repro_torch.core.split import make_transformer_task
    from repro_torch.models.module import SHAPES
    from repro_torch.models.transformer import Transformer
    from repro_torch.sharding.specs import shard_plan
    shape, arch, depth = STEPS[name][:3]
    cfg = ranks.config(arch, depth)
    task = make_transformer_task(cfg)
    whole = [tuple(t.shape) for t in tree_leaves(
        task.init_server(SHAPES))]
    sizes = {"data": shape[0], "model": shape[1]}
    plan = tree_leaves(shard_plan(task.init_server(SHAPES), sizes,
                                  {"data": 0, "model": 0}, "server", cfg))
    assert any(s.ddim is not None for s in plan)
    for rank in _steps_run(name, world2, world4):
        got = rank["steps"][name]["server_block_shapes"]
        for w, g, s in zip(whole, got, plan):
            want = list(w)
            if s.ddim is not None:
                want[s.ddim] //= sizes["data"]
            if s.dim is not None:
                want[s.dim] //= sizes["model"]
            assert tuple(want) == g


def test_config_takes_a_model_axis_and_refuses_the_rest():
    """``(1, 2)`` and ``(2, 2)`` validate, and so does a mesh with a serve
    config; so does every combination the port once refused on a mesh
    (the pipelined rounds, a checkpoint, the guard, a scenario)."""
    for shape in ((1, 2), (2, 2)):
        cfg = ExperimentConfig(mesh_shape=shape)
        assert cfg.validate() is cfg
        cfg = ExperimentConfig.from_dict({
            **ExperimentConfig().to_dict(), "mesh_shape": shape,
            "serve": {**ServeConfig().to_dict(), "slots": 4}})
        assert cfg.validate() is cfg
    once = {"pipeline_depth": 1, "ckpt_dir": "ck",
            "resilience": {"guard": True},
            "scenario": {"kind": "diurnal-churn"}}
    for k, v in once.items():
        d = {**ExperimentConfig().to_dict(), "mesh_shape": (2, 2), k: v}
        if isinstance(v, dict):
            d[k] = {**d[k], **v}
        cfg = ExperimentConfig.from_dict(d)
        assert cfg.validate() is cfg
