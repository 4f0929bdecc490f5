"""Rank jobs of ``tests/test_torch_engine_mesh_paths.py``: the Engine's
pipelined rounds, health guard and recovery, checkpoints and scenarios
on a mesh, and the pipelined transformer steps on the ``model`` axis.

``repro_torch.launch.meshcheck.spawn_ranks`` runs each job in spawned
ranks, which import this module: it imports torch and the port only,
never JAX.  Every job takes the spawned world's mesh first (the Engine
builds its own meshes over the same ranks) and returns what the test
compares, on the CPU.
"""
import contextlib
import hashlib
import os
import time

import torch

from repro_torch.api import Engine, ExperimentConfig
from repro_torch.api.phases import guard_axes, slot_split
from repro_torch.launch.mesh import make_engine_mesh
from repro_torch.launch.steps import (build_pipelined_train_steps,
                                      build_train_step)
from repro_torch.resilience import guards
from repro_torch.sharding.specs import shard_entity
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like
from repro_torch.utils.weights import from_shards

import torch_tp_ranks as tp_ranks

C = 4           # the Engine cases' cohort capacity


def digest(tree) -> str:
    """sha256 of a tree's leaves' bytes: equal digests, equal bits."""
    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def _census(eng) -> dict:
    """The census since the last take of every group the Engine's mesh
    reads (the batch axes, ``model`` and, beside a ``pod`` axis,
    ``data``)."""
    mesh = eng.mesh
    if mesh is None:
        return {}
    out = dict(mesh.comm.take_census())
    for other in (mesh.model_comm, mesh.data_comm):
        if other is not None and other is not mesh.comm:
            out.update(other.take_census())
    return out


def engine_run(kw: dict) -> dict:
    """``Engine.run()`` of ``ExperimentConfig(**kw)`` on the CPU: each
    round's scalar metrics, packed health vector and census, the last
    round's state gathered whole, the result without its wall-clock
    fields, each sampled round's cohort ids and mask, the host group's
    census, the log and the per-client store rows this rank holds."""
    rows, health, census, out = [], [], [], {}

    class Rec:
        def on_round(self, eng, rnd, state, metrics):
            rows.append({k: float(v) for k, v in metrics.items()
                         if v.numel() == 1})
            if "health" in metrics:
                health.append(metrics["health"].tolist())
            census.append(_census(eng))
            if rnd == eng.cfg.rounds - 1:
                out["state"] = tree_map(lambda t: t.detach().clone(),
                                        eng.whole_state(state))
                _census(eng)

    log, drawn = [], []
    eng = Engine(ExperimentConfig(**kw), device="cpu", callbacks=[Rec()],
                 log=log.append)
    sample = eng.sample_round

    def recorded(rng):
        got = sample(rng)
        drawn.append((got[0].tolist(),
                      None if got[3] is None else got[3].tolist()))
        return got
    eng.sample_round = recorded
    try:
        res = eng.run()
    finally:
        # a world of one started in the test's own process would outlive
        # the test: end it
        eng.close()
    res.pop("round_time_s", None)
    for row in res["history"]:
        row.pop("elapsed_s")
    out.update(rows=rows, health=health, census=census, result=res,
               log=log, drawn=drawn, host_census=(
                   eng.host.take_census() if eng.host is not None
                   else {}),
               store_rows=(None if eng.algo.store_rows is None
                           else tuple(eng.algo.store_rows)))
    return out


@contextlib.contextmanager
def unreduced_over_model():
    """The control: inside, the guard's non-finite flag is not summed
    over the ``model`` axis (each rank of a model group keeps its own)."""
    real = guards.agree

    def agree(slot_bad, part_ok, split=None, axes=()):
        return real(slot_bad, part_ok, split,
                    tuple(a for a in axes if a.axis != "model"))
    guards.agree = agree
    try:
        yield
    finally:
        guards.agree = real


def guard_control(kw: dict) -> dict:
    """The guard's check at a round's end on this rank's part of a state
    whose ``model`` block of the server's first split leaf holds a NaN
    on the world's last rank alone (its slots' features finite): the
    health vector as the port agrees it, and under
    :func:`unreduced_over_model`."""
    eng = Engine(ExperimentConfig(**kw), device="cpu", log=lambda *a: None)
    try:
        state = eng.init_state()
        plan = tree_leaves(eng.algo.task.plans["server"])
        i = next(j for j, s in enumerate(plan) if s.dim is not None)
        leaves = [t.clone() for t in tree_leaves(state.server.params)]
        dist = torch.distributed
        if dist.get_rank() == dist.get_world_size() - 1:
            leaves[i].view(-1)[0] = float("nan")
        bad = state._replace(server=state.server._replace(
            params=tree_unflatten_like(state.server.params, leaves)))
        split = slot_split(eng.algo.mesh, C)
        feats = torch.zeros(split.hi - split.lo, 2, 3)
        axes = guard_axes(eng.mesh, eng.algo.mesh, eng.algo.task)
        out = {}
        for name, ctx in (("agreed", contextlib.nullcontext),
                          ("unreduced over model", unreduced_over_model)):
            with ctx():
                h, _ = guards.health_vector(bad, torch.tensor(1.0), feats,
                                            None, None, None, 0.1, 4.0,
                                            split, axes)
            out[name] = h.tolist()
        return out
    finally:
        eng.close()


def pipelined_steps(mesh, state0, plans) -> dict:
    """olmoe's smoke config at depth 2 on ``mesh`` from the carried whole
    ``state0`` (server, [C, ...] clients) with the carried ``plans``: one
    round of ``build_pipelined_train_steps(mesh=)`` (extract, then tail)
    and one of ``build_train_step(mesh=)`` on the same batch, their
    metrics and digests, and the pipelined round's state gathered whole
    (numpy)."""
    cfg = tp_ranks.config("olmoe-1b-7b", 2)
    fixed = tp_ranks.FixedPlans(plans)
    whole = build_train_step(cfg, tp_ranks.SHAPE, cohort=tp_ranks.C,
                             device="cpu", plan_fn=fixed, mesh=mesh)
    ext, tail = build_pipelined_train_steps(
        cfg, tp_ranks.SHAPE, cohort=tp_ranks.C, device="cpu", plan_fn=fixed,
        mesh=mesh)
    p_srv, p_cl = tp_ranks._plans(mesh, cfg, *state0)
    s, c = shard_entity(state0[0], p_srv), shard_entity(state0[1], p_cl)
    split = tp_ranks.bundle_split(mesh)
    if split is not None:
        c = tree_map(lambda t: t[split[0]:split[1]], c)
    xs, ys = whole.make_batch(0)
    s1, c1, m1 = whole.fn(s, c, xs, ys, 0)
    feats, store = ext.fn(c, xs, ys)
    s2, c2, m2 = tail.fn(s, c, xs, ys, 0, feats, store)
    if split is not None:
        c2 = tree_unflatten_like(c2, mesh.comm.all_gather_tree(
            tree_leaves(c2), "test"))
    return {"rows": [{k: float(v) for k, v in m.items()} for m in (m1, m2)],
            "digests": [digest((s1, c1)), digest((s2, c2))],
            "state": (from_shards(s2, p_srv, mesh.model_comm,
                                  mesh.data_comm),
                      from_shards(c2, p_cl, mesh.model_comm))}


def _carried(path: str, timeout: float = 600.0):
    """``(state0, plans)`` from the file the test writes (by a rename, so
    it is whole once it exists) while the ranks run the Engine cases."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def world(mesh, cases: dict, steps_shape, carried: str) -> dict:
    """Each Engine case ``name: kwargs`` in turn (each builds its own
    mesh over these ranks), the guard control on the first (2, 2) case,
    and the pipelined transformer steps on a second mesh of
    ``steps_shape`` over the same ranks from the carried state the test
    writes to ``carried``.  A rank other than 0 keeps no state, only its
    digest; each case has its seconds."""
    lead = torch.distributed.get_rank() == 0
    out = {}
    for name, kw in cases.items():
        t = time.perf_counter()
        res = engine_run(kw)
        res["digest"] = digest(res["state"])
        res["seconds"] = time.perf_counter() - t
        if not lead:
            res.pop("state")
        out[name] = res
    out["control"] = guard_control(next(
        kw for kw in cases.values() if kw["mesh_shape"] == (2, 2)))
    state0, plans = _carried(carried)
    t = time.perf_counter()
    res = pipelined_steps(make_engine_mesh(steps_shape, ("data", "model"),
                                           "cpu"), state0, plans)
    res["seconds"] = time.perf_counter() - t
    if not lead:
        res.pop("state")
    out["steps"] = res
    return out
