"""Rank jobs of ``tests/test_torch_tp.py``: the transformer steps on a
mesh's ``model`` axis.

``repro_torch.launch.meshcheck.spawn_ranks`` runs each job in spawned
ranks, which import this module: it imports torch and the port only,
never JAX.  Every job takes the rank's mesh first and returns what the
test compares, on the CPU.
"""
import hashlib

import torch

from repro_torch.configs import InputShape, smoke_config
from repro_torch.core.cyclesl import CycleConfig, _value_and_grad
from repro_torch.core.split import make_transformer_task
from repro_torch.launch.mesh import cohort_size, make_engine_mesh
from repro_torch.launch.steps import build_prefill_step, build_train_step
from repro_torch.models.transformer import Transformer
from repro_torch.models.module import SHAPES
from repro_torch.sharding.parallel import TensorParallel
from repro_torch.sharding.specs import (gather_params, local_slots,
                                        shard_entity, shard_params,
                                        shard_plan)
from repro_torch.utils.tree import tree_leaves, tree_unflatten_like
from repro_torch.utils.weights import from_shards

C = 2
SHAPE = InputShape("train_smoke", 32, 4, "train")        # b = 2 a client
PREFILL = InputShape("prefill_smoke", 24, 2, "prefill")


def config(arch: str, depth: int):
    return smoke_config(arch).with_(n_layers=depth)


class FixedPlans:
    """A ``plan_fn`` that returns the plan computed beforehand for the
    round's key."""

    def __init__(self, plans: dict):
        self.plans = plans

    def __call__(self, key, valid, epochs, sb):
        return self.plans[key]


def digest(tree) -> str:
    """sha256 of a tree's leaves' bytes: equal digests, equal bits."""
    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def model_axis(mesh) -> dict:
    """The mesh's sizes with every axis but ``model`` dropped: a plan of
    them cuts over ``model`` alone."""
    return {"model": mesh.shape.get("model", 1)}


def _plans(mesh, cfg, server, clients):
    """This rank's shard plans of the whole server entity (its FSDP
    blocks over ``data`` too, as the train step places it) and of the
    whole [C, ...] client stack."""
    return (shard_plan(server.params, mesh.shape, mesh.coords, "server",
                       cfg),
            shard_plan(clients.params, model_axis(mesh), mesh.coords,
                       "client", cfg))


def grads(mesh, cfg, server, clients, seed):
    """The end-to-end loss of slot 0's batch of ``make_batch(seed)`` and
    its gradients in every leaf of both halves, on this rank's shards of
    the carried whole weights, gathered whole (numpy)."""
    task = make_transformer_task(cfg, mesh=mesh)
    ps = shard_plan(server.params, model_axis(mesh), mesh.coords, "full",
                    cfg)
    client = tree_unflatten_like(clients.params,
                                 [t[0] for t in tree_leaves(clients.params)])
    pc = shard_plan(client, model_axis(mesh), mesh.coords, "full", cfg)
    cp = shard_params(client, pc)
    sp = shard_params(server.params, ps)
    xs, ys = build_train_step(cfg, SHAPE, cohort=C, device="cpu"
                              ).make_batch(seed)
    x, y = {"tokens": xs["tokens"][0]}, ys[0]
    loss, (gc, gs) = _value_and_grad(
        lambda p: task.e2e_loss(p[0], p[1], x, y), (cp, sp))
    return {"loss": float(loss),
            "grads": (from_shards(gc, pc, mesh.model_comm),
                      from_shards(gs, ps, mesh.model_comm))}


def prefill(mesh, cfg, seed):
    """The prefill step's bf16 logits and the float32 forward's
    last-position logits on this rank's shards of the seed's draw (its
    FSDP blocks gathered over ``data`` first, as the step does)."""
    bundle = build_prefill_step(cfg, PREFILL, device="cpu", mesh=mesh)
    (params,), (batch,) = bundle.init_state(seed), bundle.make_batch(seed)
    plan = shard_plan(Transformer.init(SHAPES, cfg), mesh.shape, mesh.coords,
                      "full", cfg)
    whole = gather_params(params, plan, None, mesh.data_comm)
    tp = TensorParallel.from_mesh(mesh, cfg)
    with torch.no_grad():
        logits, _ = Transformer.forward(whole, cfg, batch["tokens"], tp=tp)
    return {"step": bundle.fn(params, batch).float(), "f32": logits[:, -1]}


def rounds(mesh, cfg, server, clients, plans, n_rounds):
    """``n_rounds`` train steps on the mesh from the carried whole
    state, with the carried plans: per-round metrics and model census,
    the final state gathered whole (numpy, on every rank) and its
    digest."""
    bundle = build_train_step(cfg, SHAPE, CycleConfig(), cohort=C,
                              device="cpu", plan_fn=FixedPlans(plans),
                              mesh=mesh)
    p_srv, p_cl = _plans(mesh, cfg, server, clients)
    s, c = shard_entity(server, p_srv), shard_entity(clients, p_cl)
    split = bundle_split(mesh)
    if split is not None:
        c = type(c)(*(tree_unflatten_like(t, [x[split[0]:split[1]]
                                              for x in tree_leaves(t)])
                      for t in c))
    mesh.model_comm.take_census()
    mesh.comm.take_census()
    rows, census = [], []
    for r in range(n_rounds):
        xs, ys = bundle.make_batch(r)
        s, c, m = bundle.fn(s, c, xs, ys, r)
        rows.append({k: float(v) for k, v in m.items()})
        census.append({**mesh.model_comm.take_census(),
                       **mesh.comm.take_census()})
    if split is not None:
        c = type(c)(*(tree_unflatten_like(t, mesh.comm.all_gather_tree(
            tree_leaves(t), "test")) for t in c))
    state = (from_shards(s, p_srv, mesh.model_comm, mesh.data_comm),
             from_shards(c, p_cl, mesh.model_comm))
    return {"rows": rows, "census": census, "state": state,
            "digest": digest(tree_leaves(
                [torch.from_numpy(a) for a in tree_leaves(state)]))}


def bundle_split(mesh):
    """The slots [lo, hi) of the cohort this rank holds, or None when the
    batch axes hold one rank."""
    return None if cohort_size(mesh) == 1 else local_slots(mesh, C)


def case(mesh, arch, depth, state0, plans, n_rounds, grad_seed,
         prefill_seed):
    cfg = config(arch, depth)
    server, clients = state0
    out = rounds(mesh, cfg, server, clients, plans, n_rounds)
    out.update(grads(mesh, cfg, server, clients, grad_seed))
    out["prefill"] = prefill(mesh, cfg, prefill_seed)
    return out


def groups(mesh):
    """This rank's (batch-group sum, model-group sum) of the world ranks
    on ``mesh``, on a ('pod', 'data', 'model') mesh of (2, 1, 2) and on
    a ('model', 'pod', 'data') mesh of (2, 2, 1) over the same four
    ranks, and each group's (rank, size)."""
    me = torch.tensor([float(torch.distributed.get_rank())])
    out = {}
    for name, m in (("data,model", mesh),
                    ("pod,data,model", make_engine_mesh(
                        (2, 1, 2), ("pod", "data", "model"), "cpu")),
                    ("model,pod,data", make_engine_mesh(
                        (2, 2, 1), ("model", "pod", "data"), "cpu"))):
        out[name] = {ax: (float(c.all_reduce(me, "test")[0]), c.rank, c.size)
                     for ax, c in (("batch", m.comm),
                                   ("model", m.model_comm))}
    return out


def world(mesh, cases: dict):
    """Each case ``name: (shape, args)`` on the spawned mesh (``shape``
    None) or on a second mesh of ``shape`` over the same ranks:
    {name: result}.  A rank other than 0 keeps only its metrics, census
    and digest."""
    out = {}
    for name, (shape, args) in cases.items():
        m = mesh if shape is None else make_engine_mesh(
            shape, ("data", "model"), "cpu")
        res = case(m, *args)
        if torch.distributed.get_rank() != 0:
            res = {k: res[k] for k in ("rows", "census", "digest")}
        out[name] = res
    if mesh.shape["data"] > 1:
        out["groups"] = groups(mesh)
    return out
