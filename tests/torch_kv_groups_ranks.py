"""Rank jobs of ``tests/test_torch_kv_groups.py``: glm4's attention split
over kv head groups on a (1, 4) mesh.

``repro_torch.launch.meshcheck.spawn_ranks`` runs the job in spawned
ranks, which import this module: it imports torch and the port only,
never JAX.  The job takes the rank's mesh first and returns what the
test compares, on the CPU.
"""
import contextlib
import hashlib

import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core.cyclesl import CycleConfig
from repro_torch.launch.steps import build_train_step
from repro_torch.sharding import parallel
from repro_torch.sharding.specs import gather_entity, shard_entity
from repro_torch.utils.profiling import mesh_comms
from repro_torch.utils.tree import tree_leaves
from repro_torch.utils.weights import from_shards

import torch_serve_mesh_ranks as serve_ranks
import torch_tp_ranks as tp_ranks

ARCH, DEPTH, ROUNDS = "glm4-9b", 2, 2


@contextlib.contextmanager
def dropped_group_sum():
    """The planted fault: the kv group's gradient sum dropped, so each
    rank keeps its own query heads' part of ``wk``'s and ``wv``'s
    gradients.  (The function inherits its backward from
    ``_CopyToModel``: the plant shadows it on the subclass alone.)"""
    cls = parallel._KVGroupSum
    assert "backward" not in vars(cls)
    cls.backward = staticmethod(lambda ctx, *gs: (None, None) + gs)
    try:
        yield
    finally:
        del cls.backward


def group_digest(trees, plans) -> str:
    """sha256 of the leaves a plan gives to a kv group (``Shard.rep`` >
    1): the rank's copy of its group's ``wk`` and ``wv``, in the
    params and the Adam moments of each entity."""
    h = hashlib.sha256()
    for ent, plan in zip(trees, plans):
        shards = tree_leaves(plan)
        for tree in (ent.params, ent.opt_state["m"], ent.opt_state["v"]):
            for x, s in zip(tree_leaves(tree), shards):
                if s.rep > 1:
                    h.update(x.detach().contiguous().reshape(-1)
                             .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def checkpoint(mesh, server, clients, plans, ckpt_dir) -> bool:
    """Save the state gathered whole (rank 0 writes), restore it on every
    rank and cut the rank's blocks (its group's kv head) from it:
    whether they are the live blocks, bit for bit."""
    whole = tuple(gather_entity(e, p, mesh.model_comm)
                  for e, p in zip((server, clients), plans))
    if torch.distributed.get_rank() == 0:
        save_checkpoint(ckpt_dir, 1, whole)
    torch.distributed.barrier()
    back, _ = load_checkpoint(ckpt_dir, whole, step=1)
    local = [shard_entity(e, p) for e, p in zip(back, plans)]
    return all(torch.equal(a, b) for a, b in zip(
        tree_leaves(local), tree_leaves((server, clients))))


def rounds(mesh, state0, plans, ckpt_dir=None) -> dict:
    """``ROUNDS`` train steps on the mesh from the carried whole state,
    with the carried plans (the state saved after the first where
    ``ckpt_dir`` is given): per-round metrics and census of every
    group (the kv groups' included), the digest of the rank's kv group
    leaves and the final state gathered whole (numpy)."""
    cfg = tp_ranks.config(ARCH, DEPTH)
    bundle = build_train_step(cfg, tp_ranks.SHAPE, CycleConfig(),
                              cohort=tp_ranks.C, device="cpu",
                              plan_fn=tp_ranks.FixedPlans(plans), mesh=mesh)
    p = tp_ranks._plans(mesh, cfg, *state0)
    s, c = shard_entity(state0[0], p[0]), shard_entity(state0[1], p[1])
    comms = mesh_comms(mesh)
    for cm in comms:
        cm.take_census()
    out = {"rows": [], "census": []}
    for r in range(ROUNDS):
        s, c, m = bundle.fn(s, c, *bundle.make_batch(r), r)
        out["rows"].append({k: float(v) for k, v in m.items()})
        out["census"].append({k: v for cm in comms
                              for k, v in cm.take_census().items()})
        if r == 0 and ckpt_dir is not None:
            out["restored_is_live"] = checkpoint(mesh, s, c, p, ckpt_dir)
    out["group_digest"] = group_digest((s, c), p)
    out["state"] = (from_shards(s, p[0], mesh.model_comm),
                    from_shards(c, p[1], mesh.model_comm))
    return out


def world(mesh, state0, plans, ckpt_dir, grad_seed, served):
    """The sound run (with its checkpoint), the run and the gradients
    under :func:`dropped_group_sum`, the teacher-forced decode and a
    ``ServeRuntime(mesh=)`` wave, on the (1, 4) mesh.  A rank other than
    0 keeps only what is compared rank by rank."""
    cfg = tp_ranks.config(ARCH, DEPTH)
    out = {"sound": rounds(mesh, state0, plans, ckpt_dir)}
    with dropped_group_sum():
        out["planted"] = rounds(mesh, state0, plans)
        out["planted_grads"] = tp_ranks.grads(mesh, cfg, *state0,
                                              grad_seed)["grads"]
    out["decode"] = serve_ranks.teacher_forced(mesh, ARCH)
    out["serve"] = serve_ranks.serve(mesh, ARCH, served)
    if torch.distributed.get_rank() != 0:
        out = {"sound": {k: out["sound"][k] for k in (
                   "rows", "census", "group_digest", "restored_is_live")},
               "planted": {"group_digest": out["planted"]["group_digest"]},
               "decode": {"logits": out["decode"]["logits"]},
               "serve": out["serve"]}
    return out
