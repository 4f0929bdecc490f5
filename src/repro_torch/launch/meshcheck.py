"""Mesh-invariance checker of the port: the sharded round must not change
numerics.

Port of ``repro/launch/meshcheck.py``.  For every registered program it
runs the same padded rounds (capacity C 8, live cohort sizes 5 + r % 3,
``mlp(8, [16], 4)`` cut 1, batch 8, 3 rounds, server epochs 2, Adam
5e-3) three ways and compares their states and per-round metrics:

  base   — the unsharded round, in this process,
  mesh1  — a (1, 1) mesh of one rank in this process: must match
           ``base`` BIT FOR BIT (at one rank every collective is the
           identity and the mesh round runs the unsharded arithmetic),
  meshN  — an (N, 1) mesh of N spawned ranks over ('data', 'model'),
           or the (d, m) mesh ``--shape d,m`` asks for (N = d * m): must
           match within float tolerance (the sums over ranks reorder
           float32 sums at ~1e-7), the same on every rank.  The task is
           placed on the mesh as the Engine places it
           (``core.split.make_stage_task(..., mesh=)``); the protocol's
           mlp has no ``lin/w`` leaf, so its weights stay whole and a
           (d, m) mesh checks the cohort's split over ``data`` beside a
           ``model`` axis (the Engine's tests and ``chip_smoke.py`` phase
           26 hold the placed femnist weights).

With ``--shard-local`` it checks instead, on both meshes, that the
shard-local resample is bit for bit the gather-everything route (the
non-cycle programs never resample: their equality pins that the knob is
inert there).  The JAX package also asserts one trace per program; an
eager round has no trace, so that check has no counterpart here.  The
census of each run's collectives comes with the report.

  PYTHONPATH=src python -m repro_torch.launch.meshcheck --ranks 4 \\
      --device cpu [--shard-local] [--shape 2,2]

The default, ``--device cuda``, runs the ranks over NCCL, one card
each, and exits 2 when there are fewer cards than ranks; the CPU runs
only when ``--device cpu`` asks for it.  Exit code 0 when every program
passed; the JSON report goes to stdout.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
from multiprocessing import connection
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api.phases import (build_algorithm, place_state,
                                    slot_split, whole_state)
from repro_torch.api.registry import algorithm_names, get_program
from repro_torch.core.cyclesl import CycleConfig
from repro_torch.core.split import make_stage_task
from repro_torch.launch.mesh import BACKEND, make_engine_mesh
from repro_torch.models.cnn import mlp
from repro_torch.optim import adam
from repro_torch.sharding.collectives import census_by_op
from repro_torch.utils.tree import tree_leaves, tree_map

C, B, ROUNDS = 8, 8, 3          # capacity 8 divides every swept mesh


def task_and_data(mesh=None):
    """The protocol's task (placed on ``mesh``) and its [C, B, 8] inputs
    and [C, B] labels (numpy's ``default_rng(0)``, as the JAX package
    draws them)."""
    task = make_stage_task(mlp(8, [16], 4), cut=1, kind="xent", mesh=mesh)
    rng = np.random.default_rng(0)
    w = rng.normal(size=(8, 4))
    xs = np.stack([rng.normal(size=(B, 8))
                   for _ in range(C)]).astype(np.float32)
    ys = np.argmax(xs @ w, axis=-1)
    return task, torch.from_numpy(xs), torch.from_numpy(ys)


def masks(rounds: int = ROUNDS) -> list:
    """Varying live cohort sizes at fixed capacity."""
    return [torch.from_numpy((np.arange(C) < 5 + r % 3).astype(np.float32))
            for r in range(rounds)]


def drive(name, task, xs, ys, mesh=None, rounds: int = ROUNDS,
          shard_local: bool = False, fused: bool = False, device="cpu",
          state0=None, plan_fn=None):
    """Run ``rounds`` padded rounds of one program, on ``mesh`` or
    unsharded, and return ``(whole state, metric rows, census a
    round)``.  ``state0`` (a whole TrainState) replaces the port's init,
    ``plan_fn`` its resample plan: the tests carry the JAX package's in.
    On a mesh the rank feeds its own slots; the state comes back whole
    (its store gathered), the census holds the rounds' collectives."""
    opt = adam(5e-3)
    ccfg = CycleConfig(server_epochs=2, shard_local_resample=shard_local,
                       fused_gather_loss=fused)
    algo = build_algorithm(get_program(name), task, opt, opt, ccfg,
                           plan_fn=plan_fn, device=device, mesh=mesh,
                           n_clients=C)
    state = (algo.init(0, C) if state0 is None
             else tree_map(lambda t: t.to(device), state0))
    state = place_state(state, algo.store_rows, algo.task)
    cohort = torch.arange(C, device=device)
    split = slot_split(algo.mesh, C)
    if split is not None:
        xs, ys = xs[split.lo:split.hi], ys[split.lo:split.hi]
    xs, ys = xs.to(device), ys.to(device)
    if mesh is not None:
        mesh.comm.take_census()
    rows, census = [], []
    for r, mask in enumerate(masks(rounds)):
        state, mets = algo.round(state, cohort, xs, ys, r, mask.to(device))
        rows.append({k: v.detach().cpu() for k, v in mets.items()})
        if mesh is not None:
            census.append(mesh.comm.take_census())
    if mesh is not None:
        state = whole_state(state, algo.store_rows, mesh.comm, algo.task)
    return tree_map(lambda t: t.cpu(), state), rows, census


def max_diff(a_state, a_rows, b_state, b_rows) -> float:
    d = 0.0
    for la, lb in zip(tree_leaves(a_state), tree_leaves(b_state)):
        d = max(d, float((la.double() - lb.double()).abs().max()))
    for ra, rb in zip(a_rows, b_rows):
        for k in ra:
            d = max(d, float((ra[k].double() - rb[k].double()).abs().max()))
    return d


# ------------------------------------------------------------ the ranks
def _rank_entry(rank, world, store, device, fn, args, out_dir, shape):
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(BACKEND[device], init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = make_engine_mesh(shape, ("data", "model"), device)
        out = fn(mesh, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(world: int, fn, args=(), device="cpu", workdir=None,
                timeout: float = 600.0, shape=None) -> list:
    """Run ``fn(mesh, *args)`` in ``world`` spawned ranks, each one over
    a ('data', 'model') mesh of ``shape`` (default (world, 1)) on
    ``device`` (gloo for ``cpu``, NCCL for ``cuda``, one card a rank),
    its process group started from a ``file://`` store under
    ``workdir``.  Returns every rank's result, in rank order; raises if
    a rank fails or outlives ``timeout``.  When one rank fails the
    others are ended at once: they would wait in a collective with it
    until the backend's own timeout."""
    shape = (world, 1) if shape is None else tuple(shape)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as d:
        store = os.path.join(d, "store")
        procs = [ctx.Process(target=_rank_entry,
                             args=(r, world, store, device, fn, args, d,
                                   shape))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            while (any(p.is_alive() for p in procs)
                   and not any(p.exitcode for p in procs)
                   and time.monotonic() < deadline):
                connection.wait([p.sentinel for p in procs
                                 if p.is_alive()], timeout=1.0)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RuntimeError(f"ranks failed (rank, exit code): {bad}")
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]


def _runs(mesh, algos, shard_local_sweep):
    """Every program on ``mesh``: the default route, or with
    ``shard_local_sweep`` both routes of the resample."""
    task, xs, ys = task_and_data(mesh)
    dev = mesh.device
    out = {}
    for name in algos:
        if shard_local_sweep:
            out[name] = {sl: drive(name, task, xs, ys, mesh, device=dev,
                                   shard_local=sl)
                         for sl in (False, True)}
        else:
            out[name] = drive(name, task, xs, ys, mesh, device=dev)
    return out


def _same_on_every_rank(per_rank, name, key=None) -> bool:
    runs = [r[name] if key is None else r[name][key] for r in per_rank]
    return all(max_diff(runs[0][0], runs[0][1], x[0], x[1]) == 0.0
               for x in runs[1:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="cuda (default): NCCL, one card a rank; cpu: "
                         "gloo, only when asked")
    ap.add_argument("--algos", default=None,
                    help="comma list (default: every registered program)")
    ap.add_argument("--tol", type=float, default=1e-5,
                    help="max abs diff tolerated for the N-rank mesh")
    ap.add_argument("--shard-local", action="store_true",
                    help="check the shard-local resample against the "
                         "gather-everything route instead")
    ap.add_argument("--shape", default=None,
                    help="d,m: the N-rank mesh's (data, model) shape "
                         "(default N,1, N = --ranks)")
    args = ap.parse_args(argv)
    shape = ((args.ranks, 1) if args.shape is None else
             tuple(int(x) for x in args.shape.split(",")))
    if len(shape) != 2:
        ap.error(f"--shape {args.shape}: expected d,m")
    n = shape[0] * shape[1]
    if args.device == "cuda" and torch.cuda.device_count() < n:
        print(json.dumps({"error": f"needs {n} cards, have "
                          f"{torch.cuda.device_count()}"}))
        return 2
    algos = args.algos.split(",") if args.algos else algorithm_names()
    dev = torch.device(args.device)
    mesh1 = make_engine_mesh((1, 1), ("data", "model"), args.device)
    try:
        one = _runs(mesh1, algos, args.shard_local)
    finally:
        mesh1.close()
    ranks = spawn_ranks(n, _runs, (algos, args.shard_local), args.device,
                        shape=shape)
    report = {"ranks": n, "shape": list(shape), "device": args.device,
              "capacity": C,
              "rounds": ROUNDS, "algos": {}}
    task, xs, ys = task_and_data()
    for name in algos:
        if args.shard_local:
            rec = {"ok": True}
            for label, runs in (("1rank", one[name]),
                                (f"{n}rank", ranks[0][name])):
                d = max_diff(runs[False][0], runs[False][1],
                             runs[True][0], runs[True][1])
                rec[label] = {"diff": d, "census": {
                    "gather_everything": census_by_op(runs[False][2][-1]),
                    "shard_local": census_by_op(runs[True][2][-1])}}
                rec["ok"] = rec["ok"] and d == 0.0
            rec["same_on_every_rank"] = all(
                _same_on_every_rank(ranks, name, sl) for sl in (False, True))
            rec["ok"] = rec["ok"] and rec["same_on_every_rank"]
        else:
            base_state, base_rows, _ = drive(name, task, xs, ys, device=dev)
            s1, r1, _ = one[name]
            sn, rn, census = ranks[0][name]
            d1 = max_diff(base_state, base_rows, s1, r1)
            dn = max_diff(base_state, base_rows, sn, rn)
            same = _same_on_every_rank(ranks, name)
            rec = {"exact_1dev_diff": d1, "ndev_diff": dn,
                   "same_on_every_rank": same,
                   "census_per_round": census_by_op(census[-1]),
                   "ok": bool(d1 == 0.0 and dn <= args.tol and same)}
        report["algos"][name] = rec
    report["ok"] = all(a["ok"] for a in report["algos"].values())
    print(json.dumps(report, indent=1))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
