"""Rank jobs of ``tests/test_torch_fsdp.py`` and
``tests/test_torch_engine_tp.py``: FSDP over ``data`` and the Engine on a
2-D mesh.

``repro_torch.launch.meshcheck.spawn_ranks`` runs each job in spawned
ranks, which import this module: it imports torch and the port only,
never JAX.  Every job takes the spawned world's mesh first (the jobs
build the meshes they need over the same ranks) and returns what the
test compares, on the CPU.
"""
import contextlib

import numpy as np
import torch

from repro_torch.api import Engine, ExperimentConfig
from repro_torch.configs import InputShape, smoke_config
from repro_torch.core import protocol
from repro_torch.core.cyclesl import _value_and_grad
from repro_torch.core.split import make_transformer_task
from repro_torch.launch.mesh import cohort_size, make_engine_mesh
from repro_torch.launch.steps import build_prefill_step, build_train_step
from repro_torch.models.module import SHAPES
from repro_torch.models.transformer import Transformer
from repro_torch.sharding import parallel
from repro_torch.sharding.parallel import gather_from_data
from repro_torch.sharding.specs import (Shard, gather_entity, gather_params,
                                        local_slots, shard_entity,
                                        shard_params, shard_plan)
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like

C = 2
SHAPE = InputShape("train_smoke", 32, 4, "train")        # b = 2 a client
PREFILL = InputShape("prefill_smoke", 24, 2, "prefill")


def config(arch: str, depth: int):
    return smoke_config(arch).with_(n_layers=depth)


# --------------------------------------------------------------- Engine
@contextlib.contextmanager
def dropped_data_reduce():
    """The control: inside, every reduction of a gradient or a slot sum
    into FSDP blocks keeps this rank's own partial's block, with no
    collective (what a missing reduce-scatter would do)."""
    real = parallel.reduce_to_blocks

    def own_block(comm, sum_over, tensors, dims, what):
        return [t.narrow(d, comm.rank * (t.shape[d] // comm.size),
                         t.shape[d] // comm.size)
                for t, d in zip(tensors, dims)]
    parallel.reduce_to_blocks = protocol.reduce_to_blocks = own_block
    try:
        yield
    finally:
        parallel.reduce_to_blocks = protocol.reduce_to_blocks = real


@contextlib.contextmanager
def without_fsdp():
    """Inside, tasks placed on a mesh keep every leaf whole over
    ``data`` (their ``fsdp`` None): the round as it ran before FSDP."""
    from repro_torch.core import split
    real = split.mesh_placement
    split.mesh_placement = lambda mesh, cfg=None: (real(mesh, cfg)[0], None)
    try:
        yield
    finally:
        split.mesh_placement = real


def engine_run(kw: dict, mode=None) -> dict:
    """``Engine.run()`` of ``ExperimentConfig(**kw)`` on the CPU (``mode``
    "dropped reduce": under :func:`dropped_data_reduce`; "no fsdp":
    under :func:`without_fsdp`): each round's metrics and census (batch
    axes, model axis and, beside a ``pod`` axis, the ``data`` axis' own
    group, read at the end of the round), the last round's
    state gathered whole, the history, and this rank's server leaf
    shapes as the run holds them."""
    rows, census, out = [], [], {}
    rounds = kw["rounds"]

    class Rec:
        def on_round(self, eng, rnd, state, metrics):
            rows.append({k: float(v) for k, v in metrics.items()})
            c = dict(eng.mesh.comm.take_census()) if eng.mesh else {}
            if eng.mesh is not None and eng.mesh.model_comm is not None:
                c.update(eng.mesh.model_comm.take_census())
            if eng.mesh is not None and eng.mesh.data_comm is not \
                    eng.mesh.comm:
                c.update(eng.mesh.data_comm.take_census())
            census.append(c)
            if rnd == rounds - 1:
                out["local_shapes"] = [tuple(t.shape) for t in
                                       tree_leaves(state.server.params)]
                out["state"] = tree_map(lambda t: t.detach().clone(),
                                        eng.whole_state(state))

    ctx = {"dropped reduce": dropped_data_reduce, "no fsdp": without_fsdp,
           None: contextlib.nullcontext}[mode]
    with ctx():
        eng = Engine(ExperimentConfig(**kw), device="cpu",
                     callbacks=[Rec()], log=lambda *a: None)
        try:
            res = eng.run()
        finally:
            # a (1, 1) mesh in the test's own process starts a group of
            # one, which would outlive the test: end it
            eng.close()
    out.update(rows=rows, census=census, history=res["history"])
    return out


def engines(mesh, cases: dict) -> dict:
    """Each case ``name: (config kwargs, mode)`` through the Engine
    (which builds its own mesh over these ranks)."""
    return {name: engine_run(kw, mode) for name, (kw, mode)
            in cases.items()}


# ------------------------------------------------------ transformer steps
def _whole_server(mesh, task, server):
    return gather_entity(server, task.plans["server"],
                         mesh.model_comm, mesh.data_comm)


def _whole_clients(mesh, task, clients):
    """The [C, ...] slot stack gathered over the batch axes and its model
    blocks gathered whole."""
    if cohort_size(mesh) > 1:
        leaves = mesh.comm.all_gather_tree(tree_leaves(clients), "test")
        clients = tree_unflatten_like(clients, leaves)
    return gather_entity(clients, tree_map(Shard.stacked,
                                           task.plans["client"]),
                         mesh.model_comm)


def _numpy(tree):
    return tree_map(lambda t: t.detach().float().numpy(), tree)


def server_grads(mesh, cfg, seed, modes=("scatter", "slice")):
    """The server's loss and gradient on one batch of features, its
    params this rank's blocks over ``model`` and ``data``, gathered at
    use, in each of ``modes``: "scatter", data-parallel (each rank half
    the rows, the loss scaled by its share, the blocks' gradients
    reduce-scattered and the whole leaves' all-reduced, as the server
    inner loop sums them), and "slice", replicated (the whole batch, the
    gradient sliced).  Each gradient is gathered whole."""
    task = make_transformer_task(cfg, mesh=mesh)
    plan = task.plans["server"]
    sp = shard_params(task.init_server(
        torch.Generator().manual_seed(seed)), plan, model=False)
    rng = np.random.default_rng(seed)
    b = 2
    f = torch.from_numpy(rng.standard_normal(
        (b, SHAPE.seq_len, cfg.d_model)).astype(np.float32)).to(
            cfg.torch_dtype)
    y = torch.from_numpy(rng.integers(0, cfg.vocab, (b, SHAPE.seq_len)))
    n, r = mesh.data_comm.size, mesh.data_comm.rank
    out = {}
    for mode in modes:
        if mode == "scatter":
            lo, hi = r * b // n, (r + 1) * b // n
            fb, yb, share, over = f[lo:hi], y[lo:hi], (hi - lo) / b, \
                mesh.data_comm
        else:
            fb, yb, share, over = f, y, 1.0, None

        def loss_fn(p):
            whole = gather_from_data(task.fsdp, p, plan, over)
            loss = task.server_loss(whole, fb, yb)
            return loss if share == 1.0 else loss * share
        loss, g = _value_and_grad(loss_fn, sp)
        if over is not None:
            leaves = tree_leaves(g)
            rest = [i for i, p in enumerate(tree_leaves(plan))
                    if p.ddim is None]
            summed = mesh.data_comm.all_reduce_tree(
                [leaves[i] for i in rest] + [loss], "test")
            for i, t in zip(rest, summed):
                leaves[i] = t
            g, loss = tree_unflatten_like(g, leaves), summed[-1]
        out[mode] = {"loss": float(loss), "grads": _numpy(gather_params(
            g, plan, mesh.model_comm, mesh.data_comm))}
    return out


def steps(mesh, shape, arch, depth, n_rounds, seed, modes):
    """On a ('data', 'model') mesh of ``shape`` over these ranks: the
    server's gradient in ``modes`` (:func:`server_grads`), ``n_rounds``
    train steps from the port's own init (metrics, census, the state
    gathered whole, this rank's server block shapes) and the prefill's
    logits, from its own init and from weights the caller cut."""
    m = make_engine_mesh(shape, ("data", "model"), "cpu")
    cfg = config(arch, depth)
    out = {"grads": server_grads(m, cfg, seed, modes)}
    bundle = build_train_step(cfg, SHAPE, cohort=C, device="cpu", mesh=m)
    task = make_transformer_task(cfg, mesh=m)
    s, c = bundle.init_state(seed)
    out["server_block_shapes"] = [tuple(t.shape)
                                  for t in tree_leaves(s.opt_state["m"])]
    m.comm.take_census()
    if m.model_comm is not None:
        m.model_comm.take_census()
    rows, census = [], []
    for r in range(n_rounds):
        s, c, met = bundle.fn(s, c, *bundle.make_batch(r), r)
        rows.append({k: float(v) for k, v in met.items()})
        cen = dict(m.comm.take_census())
        if m.model_comm is not None:
            cen.update(m.model_comm.take_census())
        census.append(cen)
    out.update(rows=rows, census=census, state=_numpy(
        (_whole_server(m, task, s), _whole_clients(m, task, c))))
    pf = build_prefill_step(cfg, PREFILL, device="cpu", mesh=m)
    (params,), (batch,) = pf.init_state(seed), pf.make_batch(seed)
    out["prefill"] = pf.fn(params, batch).float()
    # carried weights: a fresh bundle's step on this rank's blocks of the
    # same draw, cut by the caller (its init_state never called)
    carried = build_prefill_step(cfg, PREFILL, device="cpu", mesh=m)
    plan = shard_plan(Transformer.init(SHAPES, cfg), m.shape, m.coords,
                      "full", cfg)
    whole = Transformer.init(torch.Generator().manual_seed(seed), cfg)
    out["prefill_carried_equal"] = torch.equal(
        carried.fn(shard_params(whole, plan), batch).float(),
        out["prefill"])
    return out


def unsharded_steps(arch, depth, n_rounds, seed, modes=None):
    """:func:`steps` off the mesh, in one process: the references."""
    cfg = config(arch, depth)
    task = make_transformer_task(cfg)
    sp = task.init_server(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    f = torch.from_numpy(rng.standard_normal(
        (2, SHAPE.seq_len, cfg.d_model)).astype(np.float32)).to(
            cfg.torch_dtype)
    y = torch.from_numpy(rng.integers(0, cfg.vocab, (2, SHAPE.seq_len)))
    loss, g = _value_and_grad(lambda p: task.server_loss(p, f, y), sp)
    bundle = build_train_step(cfg, SHAPE, cohort=C, device="cpu")
    s, c = bundle.init_state(seed)
    rows = []
    for r in range(n_rounds):
        s, c, met = bundle.fn(s, c, *bundle.make_batch(r), r)
        rows.append({k: float(v) for k, v in met.items()})
    pf = build_prefill_step(cfg, PREFILL, device="cpu")
    (params,), (batch,) = pf.init_state(seed), pf.make_batch(seed)
    return {"loss": float(loss), "grads": _numpy(g), "rows": rows,
            "state": _numpy((s, c)), "prefill": pf.fn(params, batch).float()}


def round_trip(mesh) -> bool:
    """Whole weights -> this rank's blocks -> whole again over the mesh's
    process groups (``gather_params``: ``data`` then ``model``), for
    femnist width 4 at cut 3 (the head and stage 2's ``lin/w``) and
    olmoe's smoke halves: exact."""
    from repro_torch.api.tasks import build_task
    gen = torch.Generator().manual_seed(0)
    task = build_task("image", 4, 0.5, 0, 4, 3)[0]
    olmoe = make_transformer_task(config("olmoe-1b-7b", 2))
    trees = [(task.init_server(gen), "server", None),
             (task.init_client(gen), "full", None),
             (olmoe.init_server(gen), "server", olmoe_cfg()),
             (olmoe.init_client(gen), "full", olmoe_cfg())]
    ok = True
    for tree, role, cfg in trees:
        plan = shard_plan(tree, mesh.shape, mesh.coords, role, cfg)
        back = gather_params(shard_params(tree, plan), plan,
                             mesh.model_comm, mesh.data_comm)
        ok &= all(torch.equal(a, b) for a, b in zip(tree_leaves(tree),
                                                    tree_leaves(back)))
    return ok


def olmoe_cfg():
    return config("olmoe-1b-7b", 2)


def world(mesh, engine_cases: dict, step_cases: dict) -> dict:
    """Both kinds of job on one spawned world: the Engine cases and each
    step case ``name: (shape, arch, depth, rounds, seed)``.  A rank
    other than 0 keeps only its metrics, census and block shapes."""
    out = {"round_trip": round_trip(mesh),
           "engine": engines(mesh, engine_cases),
           "steps": {name: steps(mesh, *args)
                     for name, args in step_cases.items()}}
    if torch.distributed.get_rank() != 0:
        for part in (out["engine"], out["steps"]):
            for res in part.values():
                for k in ("state", "grads", "prefill", "history"):
                    res.pop(k, None)
    return out
