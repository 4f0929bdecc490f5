"""Rank jobs of ``tests/test_torch_tp_ssm.py``: the Mamba, hybrid and
whisper steps on a mesh's ``model`` axis.

``repro_torch.launch.meshcheck.spawn_ranks`` runs each job in spawned
ranks, which import this module: it imports torch and the port only,
never JAX.  Every job takes the rank's mesh first and returns what the
test compares, on the CPU.
"""
import contextlib

import torch

from repro_torch.configs import InputShape, smoke_config
from repro_torch.core.cyclesl import CycleConfig, _value_and_grad
from repro_torch.core.split import make_transformer_task
from repro_torch.launch.mesh import make_engine_mesh
from repro_torch.launch.steps import (build_prefill_step, build_train_step,
                                      make_whisper_task)
from repro_torch.models import mamba2
from repro_torch.models.encdec import EncDec
from repro_torch.models.module import SHAPES
from repro_torch.models.transformer import Transformer
from repro_torch.sharding.parallel import TensorParallel
from repro_torch.sharding.specs import (gather_params, shard_entity,
                                        shard_params, shard_plan)
from repro_torch.utils.tree import tree_leaves, tree_unflatten_like
from repro_torch.utils.weights import from_shards

from torch_tp_ranks import (FixedPlans, bundle_split, digest, model_axis)

C = 2
SHAPE = InputShape("train_smoke", 32, 4, "train")        # b = 2 a client
PREFILL = InputShape("prefill_smoke", 32, 2, "prefill")
# arch: depth (decoder-only: blocks; whisper keeps its 2 + 2)
DEPTH = {"zamba2-1.2b": 2, "mamba2-2.7b": 2, "whisper-base": None}
# whisper's encoder reads the first FRAMES of the 1500 frames the batch
# makers draw (its position table covers any prefix), on every side
FRAMES = 64


def config(arch: str):
    cfg = smoke_config(arch)
    return cfg if DEPTH[arch] is None else cfg.with_(n_layers=DEPTH[arch])


def make_task(cfg, mesh=None):
    return (make_whisper_task(cfg, mesh=mesh) if cfg.family == "audio"
            else make_transformer_task(cfg, mesh=mesh))


def model_of(cfg):
    return EncDec if cfg.family == "audio" else Transformer


def cut_frames(batch: dict) -> dict:
    """``batch`` with its ``frames`` (if any) cut to the first FRAMES."""
    return {k: v[..., :FRAMES, :] if k == "frames" else v
            for k, v in batch.items()}


def slot_batch(cfg, seed):
    """Slot 0's batch of ``make_batch(seed)``: (x, y) of one client."""
    xs, ys = build_train_step(cfg, SHAPE, cohort=C, device="cpu"
                              ).make_batch(seed)
    xs = cut_frames(xs)
    x = {k: v[0] for k, v in xs.items()}
    y = {k: v[0] for k, v in ys.items()} if isinstance(ys, dict) else ys[0]
    return x, y


def forward_last(params, cfg, batch, tp=None):
    """The float32 forward's last-position logits (no gradient)."""
    with torch.no_grad():
        if cfg.family == "audio":
            logits = EncDec.forward(params, cfg, batch["frames"],
                                    batch["tokens"], tp=tp)
        else:
            logits, _ = Transformer.forward(params, cfg, batch["tokens"],
                                            tp=tp)
    return logits[:, -1]


def grads(mesh, cfg, server, clients, seed):
    """The end-to-end loss of slot 0's batch of ``make_batch(seed)`` and
    its gradients in every leaf of both halves, on this rank's shards of
    the carried whole weights, gathered whole (numpy)."""
    task = make_task(cfg, mesh=mesh)
    ps = shard_plan(server.params, model_axis(mesh), mesh.coords, "full",
                    cfg)
    client = tree_unflatten_like(clients.params,
                                 [t[0] for t in tree_leaves(clients.params)])
    pc = shard_plan(client, model_axis(mesh), mesh.coords, "full", cfg)
    cp, sp = shard_params(client, pc), shard_params(server.params, ps)
    x, y = slot_batch(cfg, seed)
    loss, (gc, gs) = _value_and_grad(
        lambda p: task.e2e_loss(p[0], p[1], x, y), (cp, sp))
    return {"loss": float(loss),
            "grads": (from_shards(gc, pc, mesh.model_comm),
                      from_shards(gs, ps, mesh.model_comm))}


def prefill(mesh, cfg, seed):
    """The prefill step's bf16 logits and the float32 forward's
    last-position logits on this rank's blocks of the seed's draw (its
    FSDP blocks gathered over ``data`` first, as the step does)."""
    bundle = build_prefill_step(cfg, PREFILL, device="cpu", mesh=mesh)
    (params,), (batch,) = bundle.init_state(seed), bundle.make_batch(seed)
    batch = cut_frames(batch)
    plan = shard_plan(model_of(cfg).init(SHAPES, cfg), mesh.shape,
                      mesh.coords, "full", cfg)
    whole = gather_params(params, plan, None, mesh.data_comm)
    tp = TensorParallel.from_mesh(mesh, cfg)
    return {"step": bundle.fn(params, batch).float(),
            "f32": forward_last(whole, cfg, batch, tp)}


def rounds(mesh, cfg, server, clients, plans, n_rounds):
    """``n_rounds`` train steps on the mesh from the carried whole
    state, with the carried plans: per-round metrics and census, the
    final state gathered whole (numpy, on every rank) and its digest."""
    bundle = build_train_step(cfg, SHAPE, CycleConfig(), cohort=C,
                              device="cpu", plan_fn=FixedPlans(plans),
                              mesh=mesh)
    p_srv = shard_plan(server.params, mesh.shape, mesh.coords, "server",
                       cfg)
    p_cl = shard_plan(clients.params, model_axis(mesh), mesh.coords,
                      "client", cfg)
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
        s, c, m = bundle.fn(s, c, cut_frames(xs), ys, r)
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


@contextlib.contextmanager
def bc_sum(mode: str):
    """The ``B``/``C`` branch's gradient sum over the ``model`` axis as
    ``mode`` says: ``"sound"`` as the port takes it; ``"dropped"``, the
    branch's weights and ``conv_b`` entering without ``copy_to_model``
    (each rank keeps its heads' share); ``"doubled"``, everything the
    block's ``copy_to_model`` takes entering through it twice (each
    gradient, the block input's too, summed twice)."""
    real = mamba2.copy_to_model

    def planted(tp, *xs, what="act_grad"):
        if what != "mamba_grad":
            return real(tp, *xs, what=what)
        if mode == "dropped":
            return (real(tp, xs[0], what=what),) + tuple(xs[1:])
        return real(tp, *real(tp, *xs, what=what), what=what)
    if mode != "sound":
        mamba2.copy_to_model = planted
    try:
        yield
    finally:
        mamba2.copy_to_model = real


def block_grads(mesh, cfg, params, x, modes):
    """One Mamba-2 block on this rank's heads of the whole ``params``:
    under each of ``modes`` (see :func:`bc_sum`) the gradients of a
    fixed projection of its output, in the block input and in every
    leaf, gathered whole."""
    tp = TensorParallel.from_mesh(mesh, cfg)
    plan = shard_plan({"mamba": params}, model_axis(mesh), mesh.coords,
                      "full", cfg)
    local = shard_params({"mamba": params}, plan)
    probe = torch.linspace(-1.0, 1.0, x.numel()).reshape(x.shape)
    out = {}
    for mode in modes:
        with bc_sum(mode):
            _, (gx, gp) = _value_and_grad(
                lambda p: torch.sum(mamba2.mamba_forward(
                    p[1]["mamba"], cfg, p[0], tp)[0] * probe), (x, local))
        out[mode] = {"x": gx, "params": from_shards(gp, plan,
                                                    mesh.model_comm)}
    return out


def split_rmsnorm(mesh, x, scale):
    """The gate norm over a last dimension split over the ``model``
    axis: this rank's columns of the output and the gradients of a fixed
    projection of it in ``x`` and the scale, gathered whole."""
    from repro_torch.models.layers import rmsnorm
    tp = TensorParallel.from_mesh(mesh, smoke_config("mamba2-2.7b"))
    m, r = tp.size, tp.rank
    w = x.shape[-1] // m
    xl = x[..., r * w:(r + 1) * w].contiguous()
    sl = scale[r * w:(r + 1) * w].contiguous()
    probe = torch.linspace(-1.0, 1.0, x.numel()).reshape(x.shape)
    pl = probe[..., r * w:(r + 1) * w]
    y, (gx, gs) = _value_and_grad(
        lambda p: torch.sum(rmsnorm({"scale": p[1]}, p[0], tp=tp) * pl),
        (xl, sl))
    with torch.no_grad():
        y = rmsnorm({"scale": sl}, xl, tp=tp)
    comm = mesh.model_comm
    cat = lambda t: comm.all_gather(t.movedim(-1, 0), "test").movedim(0, -1)
    return {"y": cat(y), "gx": cat(gx), "gs": cat(gs)}


def case(mesh, arch, state0, plans, n_rounds, grad_seed, prefill_seed):
    cfg = config(arch)
    server, clients = state0
    out = rounds(mesh, cfg, server, clients, plans, n_rounds)
    out.update(grads(mesh, cfg, server, clients, grad_seed))
    out["prefill"] = prefill(mesh, cfg, prefill_seed)
    return out


def world(mesh, cases: dict, extras: dict):
    """Each case ``name: (shape, args)`` on the spawned mesh (``shape``
    None) or on a second mesh of ``shape`` over the same ranks, then
    each extra job ``name: (fn name, shape, args)``: {name: result}.  A
    rank other than 0 keeps only each case's metrics, census and
    digest."""
    meshes = {None: mesh}

    def on(shape):
        if shape not in meshes:
            meshes[shape] = make_engine_mesh(shape, ("data", "model"), "cpu")
        return meshes[shape]
    out = {}
    for name, (shape, args) in cases.items():
        res = case(on(shape), *args)
        if torch.distributed.get_rank() != 0:
            res = {k: res[k] for k in ("rows", "census", "digest")}
        out[name] = res
    for name, (fn, shape, args) in extras.items():
        out[name] = globals()[fn](on(shape), *args)
    return out
