"""The donated TrainState on the CPU: ``fused_adam_`` (the in-place Adam
step), ``entity_step(donate=, keep=)`` and ``Engine(donate=)``.

- the in-place step is the out-of-place step selected by ``keep``
  against the old values (``core.protocol.select_entities``), bit for
  bit, in float32 and bfloat16, for one entity and a [C] stack, with
  ``keep`` None, all ones and one zero; unmasked it matches the JAX
  package's Pallas kernel (in the Pallas interpreter) within
  ``tests/test_torch_kernels.py``'s tolerance; it refuses overlapping
  or strided operands and a ``keep`` of another dtype or shape, and a
  graph that saved a stepped tensor raises instead of reading the new
  values;
- a donated Engine round equals an undonated one bit for bit (metrics,
  state, history) for every program of the registry, padded under the
  attendance mask and unpadded, at cut 3 with ``fused_gather_loss``,
  and pipelined in sync and async mode; the donated run steps the very
  tensors of the state it was given (the same objects, the same
  ``data_ptr``) where the round donates them, and an async pipelined run
  leaves the state it was given as it was;
- the port donated is held to the reference's ``Engine(donate=True)``
  by ``tests/torch_parity.py``'s tolerances;
- resilience turns donation off and keeps the pre-round state;
  ``utils.profiling.phase_costs`` leaves the state it repeats from as
  it was; a schedule refuses a donated step;
- on a gloo (2, 2) world, a donated Engine equals an undonated one bit
  for bit on every rank, the server's FSDP blocks stepped in place.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Engine as JEngine
from repro.api import ExperimentConfig as JConfig
from repro.kernels.fused_adam import fused_adam as j_fused_adam
from repro_torch.api import Engine, ExperimentConfig
from repro_torch.api.phases import build_algorithm
from repro_torch.api.registry import algorithm_names, get_program
from repro_torch.api.tasks import build_task
from repro_torch.core.cyclesl import CycleConfig
from repro_torch.core.protocol import (entity_step, init_entity,
                                       select_entities)
from repro_torch.kernels import ops, ref
from repro_torch.launch.meshcheck import spawn_ranks
from repro_torch.optim import adam
from repro_torch.resilience import ResilienceConfig
from repro_torch.utils import profiling
from repro_torch.utils.tree import tree_leaves, tree_map
from repro_torch.utils.weights import train_state_from_reference

import torch_donate_ranks as ranks
import torch_parity as parity
from torch_threads import one_thread  # noqa: F401

RNG = np.random.default_rng(31)
KW = dict(lr=1e-3, weight_decay=0.01)
SMALL = {**parity.SMALL, "rounds": 3, "eval_every": 3}
# the programs whose round steps the state's server (and shared client)
# in place when donated: the others read θ_S^t after the server's step
# or average copies into a new entity
SERVER_IN_PLACE = {"cyclepsl", "cyclesfl", "cyclesglr", "cyclessl", "ssl",
                   "sflv2"}
CLIENT_IN_PLACE = {"cyclessl", "ssl"}


def _operands(dtype, stacked):
    shape, steps = ((4, 6, 5), [0, 3, 1, 7]) if stacked else ((6, 5), 5)
    p = torch.from_numpy(RNG.normal(size=shape).astype(np.float32)).to(dtype)
    g = torch.from_numpy(RNG.normal(size=shape).astype(np.float32)).to(dtype)
    m = torch.from_numpy((RNG.normal(size=shape) * 0.1).astype(np.float32))
    v = torch.from_numpy(np.abs(RNG.normal(size=shape) * 0.1)
                         .astype(np.float32))
    return p, g, m, v, torch.tensor(steps, dtype=torch.int32)


# ------------------------------------------------------------ the kernel
@pytest.mark.parametrize("keep", ["none", "ones", "one zero"])
@pytest.mark.parametrize("stacked", [False, True], ids=["one", "stack"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_inplace_step_is_the_copy_selected_by_keep(dtype, stacked, keep):
    p, g, m, v, step = _operands(dtype, stacked)
    k = None
    if keep != "none":
        k = torch.ones_like(step)
        if keep == "one zero":
            k.view(-1)[k.numel() // 2] = 0
    old = (p.clone(), m.clone(), v.clone())
    want = ref.fused_adam_ref(p, g, m, v, step, **KW)
    if k is not None:
        want = select_entities(k, want, old)
    got = ops.fused_adam_(p, g, m, v, step, keep=k, **KW)
    assert got[0] is p and got[1] is m and got[2] is v
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if keep == "one zero" and stacked:
        assert torch.equal(p[2], old[0][2]) and torch.equal(m[2], old[1][2])
    if keep == "one zero" and not stacked:
        assert all(torch.equal(a, b) for a, b in zip(got, old))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inplace_step_matches_the_jax_kernel(dtype):
    shape, step = (70001,), 3
    p = RNG.normal(size=shape).astype(np.float32)
    g = RNG.normal(size=shape).astype(np.float32)
    m = (RNG.normal(size=shape) * 0.1).astype(np.float32)
    v = (np.abs(RNG.normal(size=shape)) * 0.1).astype(np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    pw, mw, vw = j_fused_adam(jnp.asarray(p, jd), jnp.asarray(g, jd),
                              jnp.asarray(m), jnp.asarray(v), step,
                              block=4096, interpret=True, **KW)
    pt = torch.from_numpy(p).to(td)
    mt, vt = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    ops.fused_adam_(pt, torch.from_numpy(g).to(td), mt, vt,
                    torch.tensor(step, dtype=torch.int32), **KW)
    tol = 2e-2 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(pt.float().numpy(),
                               np.asarray(pw.astype(jnp.float32)), atol=tol)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mw), atol=1e-6)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vw), atol=1e-6)


@pytest.mark.parametrize("fault", ["overlap", "strided", "keep dtype",
                                   "keep shape"])
def test_inplace_step_refuses(fault):
    p, g, m, v, step = _operands(torch.float32, True)
    keep = None
    if fault == "overlap":
        buf = torch.zeros(2 * m.numel())
        m = buf[: m.numel()].view(m.shape)
        v = buf[m.numel() // 2: m.numel() // 2 + m.numel()].view(v.shape)
    elif fault == "strided":
        p = p.transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "keep dtype":
        keep = torch.ones(4)
    else:
        keep = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.fused_adam_(p, g, m, v, step, keep=keep, **KW)


def test_a_graph_that_saved_the_params_refuses_the_stepped_ones():
    p, g, m, v, step = _operands(torch.float32, False)
    x = torch.ones_like(p, requires_grad=True)
    y = (x * p).sum()                       # saves p for x's gradient
    ops.fused_adam_(p, g, m, v, step, **KW)
    with pytest.raises(RuntimeError, match="inplace"):
        y.backward()


def test_a_schedule_refuses_a_donated_step():
    sched = adam(lambda step: 1e-3 / (1.0 + step.float()))
    e = init_entity({"w": torch.zeros(3)}, sched)
    with pytest.raises(ValueError):
        entity_step(e, {"w": torch.ones(3)}, sched, donate=True)
    task, fed, _ = build_task("image", 4, 0.5, 0, 4, 2)
    with pytest.raises(ValueError):
        build_algorithm(get_program("cyclesfl"), task, sched, sched,
                        donate=True)


# ------------------------------------------------------------ the Engine
class Rows:
    """Each round's metrics and the last committed state."""

    def __init__(self):
        self.rows, self.state = [], None

    def on_round(self, engine, rnd, state, metrics):
        self.rows.append({k: v.clone() for k, v in metrics.items()})
        self.state = state


def _run(cfg, donate, state=None):
    rec = Rows()
    eng = Engine(cfg, device="cpu", donate=donate, callbacks=[rec],
                 log=lambda *a: None)
    res = eng.run(state=state)
    return eng, rec, res


def _same_runs(a, b):
    (_, ra, resa), (_, rb, resb) = a, b
    assert len(ra.rows) == len(rb.rows)
    for x, y in zip(ra.rows, rb.rows):
        assert x.keys() == y.keys()
        assert all(torch.equal(x[k], y[k]) for k in x)
    la, lb = tree_leaves(ra.state), tree_leaves(rb.state)
    assert len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))
    strip = lambda h: [{k: v for k, v in r.items() if k != "elapsed_s"}
                       for r in h]
    assert strip(resa["history"]) == strip(resb["history"])


def _given(cfg):
    """A fresh init, and its server's and shared client's leaves."""
    s0 = Engine(cfg, device="cpu", log=lambda *a: None).init_state()
    return s0, {"server": tree_leaves(s0.server.params),
                "client": ([] if s0.client_global is None
                           else tree_leaves(s0.client_global.params))}


def _donated_and_not(cfg):
    """The donated and the undonated run, each from an init it is
    handed: the runs, the leaves of the donated run's init and their
    ``data_ptr``s.  The undonated run leaves its init as it was."""
    s0, given = _given(cfg)
    ptrs = {k: [t.data_ptr() for t in v] for k, v in given.items()}
    donated = _run(cfg, True, state=s0)
    s1, kept = _given(cfg)
    undonated = _run(cfg, False, state=s1)
    assert donated[0].donate is True and undonated[0].donate is False
    _, fresh = _given(cfg)
    assert all(torch.equal(a, b) for k in kept
               for a, b in zip(kept[k], fresh[k]))
    assert not any(a is b for a, b in zip(
        tree_leaves(undonated[1].state.server.params), kept["server"]))
    return donated, undonated, given, ptrs


@pytest.mark.parametrize("mode", ["padded", "unpadded"])
@pytest.mark.parametrize("algo", algorithm_names())
def test_donated_engine_is_bit_equal(algo, mode):
    cfg = ExperimentConfig(algo=algo, seed=1, **SMALL, **parity.MODES[mode])
    donated, undonated, given, ptrs = _donated_and_not(cfg)
    _same_runs(donated, undonated)
    if mode == "padded":
        draws = parity.drawn_cohorts(donated[0], cfg.rounds)
        assert any((m == 0).any() for _, m in draws)
    final = donated[1].state
    if algo in SERVER_IN_PLACE:
        leaves = tree_leaves(final.server.params)
        assert all(a is b for a, b in zip(leaves, given["server"]))
        assert [t.data_ptr() for t in leaves] == ptrs["server"]
    if algo in CLIENT_IN_PLACE:
        leaves = tree_leaves(final.client_global.params)
        assert all(a is b for a, b in zip(leaves, given["client"]))
        assert [t.data_ptr() for t in leaves] == ptrs["client"]


PATHS = {
    "cyclesfl cut3 fused": dict(algo="cyclesfl", cut=3, cycle=CycleConfig(
        fused_gather_loss=True), variable_attendance=True),
    "cyclesfl sync1": dict(algo="cyclesfl", pipeline_depth=1,
                           variable_attendance=True),
    "cyclepsl sync1": dict(algo="cyclepsl", pipeline_depth=1),
    "psl sync1": dict(algo="psl", pipeline_depth=1,
                      variable_attendance=True),
    "cyclesfl async1": dict(algo="cyclesfl", pipeline_depth=1,
                            pipeline_staleness="async",
                            variable_attendance=True),
    "cyclepsl async2": dict(algo="cyclepsl", pipeline_depth=2,
                            pipeline_staleness="async"),
}


@pytest.mark.parametrize("name", sorted(PATHS))
def test_donated_paths_are_bit_equal(name):
    cfg = ExperimentConfig(seed=1, **{**SMALL, **PATHS[name]})
    donated, undonated, given, _ = _donated_and_not(cfg)
    _same_runs(donated, undonated)
    leaves = tree_leaves(donated[1].state.server.params)
    if cfg.pipeline_staleness == "async":
        # the state is not donated: the init it was given is intact
        _, fresh = _given(cfg)
        assert all(torch.equal(a, b) for k in given
                   for a, b in zip(given[k], fresh[k]))
        assert not any(a is b for a, b in zip(leaves, given["server"]))
    elif cfg.algo in SERVER_IN_PLACE:
        assert all(a is b for a, b in zip(leaves, given["server"]))


@pytest.mark.parametrize("algo,mode", [("cyclesfl", "padded"),
                                       ("cyclepsl", "padded"),
                                       ("sflv2", "unpadded")])
def test_donated_port_against_the_donated_reference(algo, mode):
    jcfg = JConfig(algo=algo, seed=1, **{**parity.SMALL,
                                         **parity.MODES[mode]})
    jrec, trec = parity.Recorder(), parity.Recorder()
    jeng = JEngine(jcfg, callbacks=[jrec], donate=True, log=lambda *a: None)
    state0 = jax.device_get(jeng.init_state())
    jeng.run(state=state0)
    teng = Engine(ExperimentConfig.from_dict(jcfg.to_dict()), device="cpu",
                  callbacks=[trec], donate=True, log=lambda *a: None,
                  plan_fn=parity.reference_plan_fn(jeng.padded_capacity
                                                   * jcfg.batch))
    # the carried init shares the reference's numpy memory: the donated
    # run steps a copy of it
    t0 = tree_map(lambda t: t.clone(), train_state_from_reference(state0))
    teng.run(state=t0)
    parity.assert_rows_close(jrec.rows, trec.rows)
    parity.assert_state_close(jax.device_get(jrec.state), trec.state)


def test_resilience_turns_donation_off_and_keeps_the_state():
    cfg = ExperimentConfig(algo="cyclesfl", seed=1,
                           resilience=ResilienceConfig(guard=True), **SMALL)
    eng = Engine(cfg, device="cpu", donate=True, log=lambda *a: None)
    assert eng.donate is False
    s0 = eng.init_state()
    before = tree_map(lambda t: t.clone(), s0)
    eng.run(state=s0)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s0),
                                                 tree_leaves(before)))


def test_phase_costs_leaves_the_state_it_repeats_from(monkeypatch):
    eng = Engine(ExperimentConfig(algo="cyclesfl", **SMALL), device="cpu",
                 donate=True, log=lambda *a: None)
    seen = []
    real = profiling._one_round_args

    def spy(e, algo):
        args = real(e, algo)
        seen.append((args[0], tree_map(lambda t: t.clone(), args[0])))
        return args
    monkeypatch.setattr(profiling, "_one_round_args", spy)
    costs = profiling.phase_costs(eng, repeats=2)
    assert len(seen) == len(costs) == len(get_program("cyclesfl").phases)
    for state, copy in seen:
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state),
                                                     tree_leaves(copy)))


# ------------------------------------------------------ a (2, 2) world
WORLD = dict(rounds=2, eval_every=2, n_clients=6, attendance=0.8, batch=8,
             width=4, mesh_shape=(2, 2))


def test_donated_engine_on_a_2x2_world_is_bit_equal():
    cases = {"cyclesfl": dict(algo="cyclesfl", **WORLD),
             "cyclepsl cut3 fused": dict(algo="cyclepsl", cut=3,
                                         cycle=CycleConfig(
                                             fused_gather_loss=True),
                                         **WORLD),
             "sflv1": dict(algo="sflv1", **WORLD)}
    per_rank = spawn_ranks(4, ranks.world, (cases,), "cpu", shape=(2, 2))
    for r in per_rank:
        for name, runs in r.items():
            d, u = runs[True], runs[False]
            assert d["donate"] is True and u["donate"] is False
            for x, y in zip(d["rows"], u["rows"]):
                assert all(torch.equal(x[k], y[k]) for k in x), name
            assert all(torch.equal(a, b) for a, b in zip(
                tree_leaves(d["state"]), tree_leaves(u["state"]))), name
            # a cycle program's server blocks are stepped in place
            if name != "sflv1":
                assert d["server_in_place"], name
