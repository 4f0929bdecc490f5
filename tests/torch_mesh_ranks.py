"""Rank jobs of ``tests/test_torch_mesh.py``.

``repro_torch.launch.meshcheck.spawn_ranks`` runs each job in spawned
ranks, which import this module: it imports torch and the port only,
never JAX.  Every job takes the rank's mesh first and returns what the
test compares, on the CPU.
"""
import torch

from repro_torch.api import Engine, ExperimentConfig
from repro_torch.core.feature_store import (FeatureStore, shard_local_gather,
                                            shard_local_fused_loss)
from repro_torch.core.protocol import SlotSplit
from repro_torch.launch.meshcheck import drive, task_and_data

CYCLE = ("cyclepsl", "cyclesfl", "cyclesglr", "cyclessl")


class FixedPlans:
    """A ``plan_fn`` that returns the plan computed beforehand for the
    round's key (the JAX package's plan, carried in as tensors)."""

    def __init__(self, plans: dict):
        self.plans = plans

    def __call__(self, key, valid, epochs, sb):
        return self.plans[key]


def protocol(mesh, state0s: dict, plans: FixedPlans, fused_algo: str):
    """Every program at the meshcheck protocol from the carried states
    and plans: the gather-everything route, the shard-local route for
    the cycle programs, and ``fused_algo`` with the fused loss both
    ways.  Returns {name: {route: (state, rows, census)}}."""
    task, xs, ys = task_and_data()
    out = {}
    for name, state0 in state0s.items():
        routes = {"gather": dict(shard_local=False)}
        if name in CYCLE:
            routes["local"] = dict(shard_local=True)
        if name == fused_algo:
            routes["fused_gather"] = dict(shard_local=False, fused=True)
            routes["fused_local"] = dict(shard_local=True, fused=True)
        out[name] = {r: drive(name, task, xs, ys, mesh, state0=state0,
                              plan_fn=plans, **kw)
                     for r, kw in routes.items()}
    return out


def gathers(mesh, feats, labels, cases: dict, w):
    """``shard_local_gather`` for each case (idx, replicate_out) and
    ``shard_local_fused_loss`` (loss, dw) at ``cases['fused']``'s idx, on
    a pool whose rows split evenly over the ranks (this rank holds its
    slice)."""
    n, r = mesh.comm.size, mesh.comm.rank
    rows = feats.shape[0] // n
    store = FeatureStore(feats[r * rows:(r + 1) * rows],
                         labels[r * rows:(r + 1) * rows])
    split = SlotSplit(mesh, 2 * r, 2 * r + 2, 2 * n)
    comm = mesh.comm
    comm.take_census()
    ints = torch.arange(6, dtype=torch.int64).reshape(2, 3) + 10 * r
    floats = torch.full((2, 2, 2), float(r))
    out = {"collectives": (
        comm.broadcast(torch.arange(4.0) + r, "test", src=1),
        comm.all_gather_tree([ints, floats], "test"),
        comm.all_reduce_tree([ints, floats], "test"),
        comm.reduce_scatter_tree([torch.ones(2 * n, 3) * (r + 1)], "test"),
        comm.take_census())}
    for name, (idx, rep) in cases.items():
        if name == "fused":
            wt = w.clone().requires_grad_(True)
            loss = shard_local_fused_loss(store, idx, wt, split)
            loss.backward()
            out[name] = (loss.detach(), wt.grad)
        else:
            mesh.comm.take_census()
            out[name] = shard_local_gather(store, idx, split,
                                           replicate_out=rep)
            out[name + "/census"] = mesh.comm.take_census()
    return out


def engine(mesh, cfg: dict):
    """``Engine.run()`` of ``cfg`` on the ranks' mesh: the whole state,
    the per-round metrics, the history and the padded capacity."""
    rows, final = [], []

    class Rec:
        def on_round(self, eng, rnd, state, metrics):
            rows.append({k: v.detach() for k, v in metrics.items()})
            final[:] = [eng.whole_state(state)]

    eng = Engine(ExperimentConfig(**cfg), device="cpu", callbacks=[Rec()],
                 log=lambda *a: None)
    res = eng.run()
    return final[0], rows, res["history"], eng.padded_capacity


def protocol_and_engines(mesh, proto_args, cfgs: dict):
    return {"protocol": protocol(mesh, *proto_args),
            "engine": {name: engine(mesh, cfg) for name, cfg in cfgs.items()}}


def protocol_and_gathers(mesh, proto_args, gather_args):
    return {"protocol": protocol(mesh, *proto_args),
            "gathers": gathers(mesh, *gather_args)}
