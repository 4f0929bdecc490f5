"""Dry run: every (arch x input shape x mesh) step traced on ``meta``.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each step for a TPU mesh and reads XLA's memory and cost analyses; the
port builds the same step (``launch.steps.build_step``) on the
``meta`` device, whose tensors have shapes and dtypes but no data, and
runs it once as rank 0 of the mesh over torch's fake process group
(collectives that move nothing but are counted by the mesh's census).
Each record holds:

* ``state_bytes`` — a card's state: the parameters (and for a train
  step the optimizer's moments and steps) of the rank's blocks under
  ``sharding.specs.shard_plan``, the client slots it holds, and for
  decode the rank's block of the cache;
* ``peak_bytes`` — the estimate of a card's peak memory: the most bytes
  the step's tensors hold at once while it runs, from the state and the
  batch to every op's new outputs until each is freed, with a
  hand-written kernel's temporaries left out (its outputs kept), as
  ``utils.cost.count`` tracks storages.  The step runs as its bundle
  donates (``StepBundle.donated()``: the train step's state stepped in
  place), as the reference compiles it with ``donate_argnums``;
* ``cost`` — ``count``'s summary (FLOPs, eager traffic, collective
  bytes, by op and by kernel) and ``census``, the mesh's collectives;
* ``fits`` — whether ``peak_bytes`` fits an H100's 80 GB.

Mesh shapes default to an H100 node's of 1, 4 and 8 cards; the cohort
is the batch axes' ranks, as in the reference.  Long-context decode
skips the archs of ``LONG_SKIP``, the reference's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b \\
      --shape train_4k --mesh-shape 1,4
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--out f.json]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import (INPUT_SHAPES, InputShape, get_config,
                                 list_archs)
from repro_torch.core.cyclesl import CycleConfig
from repro_torch.launch.roofline import MEMORY_BYTES
from repro_torch.utils.cost import count
from repro_torch.utils.tree import tree_leaves

# long_500k applicability, the reference's: whisper is skipped outright;
# full-attention archs run their sliding-window serving variant, SSM and
# hybrid archs run natively
LONG_SKIP = {"whisper-base": "enc-dec, 448-pos decoder horizon; full attn"}
MESH_SHAPES = ((1, 1), (1, 4), (2, 2), (1, 8), (2, 4))


def fake_group(n: int):
    """This process as rank 0 of a world of ``n`` over torch's fake
    process group (a group of another kind or size is ended first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def meta_mesh(mesh_shape):
    """Rank 0 of a (data, model) mesh of ``mesh_shape`` on ``meta``."""
    from repro_torch.launch.mesh import make_engine_mesh
    fake_group(mesh_shape[0] * mesh_shape[1])
    return make_engine_mesh(mesh_shape, ("data", "model"), "meta")


def step_args(bundle, kind: str, seed: int = 0) -> tuple:
    """The arguments of one call of ``bundle.fn``: its state, a batch and
    (train) the round's key."""
    state, batch = bundle.init_state(seed), bundle.make_batch(seed)
    if kind == "train":
        return (*state, *batch, seed)
    if kind == "prefill":
        return (*state, *batch)
    params, dstate = state
    return (params, batch[0], dstate)


def state_bytes(args, kind: str) -> int:
    """Bytes of the step's state among ``args`` (all but the batch)."""
    state = ((args[0], args[2]) if kind == "decode"
             else args[:2] if kind == "train" else args[:1])
    return sum(t.numel() * t.element_size() for t in tree_leaves(state))


def dry_run(cfg, shape, mesh_shape=None, *, cohort: Optional[int] = None,
            cycle: CycleConfig = CycleConfig(), donate: bool = True) -> dict:
    """One step of ``cfg`` at ``shape`` built on ``meta`` and counted:
    the record's fields without its names.  ``mesh_shape`` None runs it
    unsharded; else as rank 0 of a fake group's mesh.  ``cohort``
    defaults to the batch axes' ranks.  ``donate`` runs the step as its
    bundle donates; False runs ``fn`` with its arguments kept."""
    from repro_torch.launch.mesh import cohort_size
    from repro_torch.launch.steps import build_step
    mesh = None if mesh_shape is None else meta_mesh(tuple(mesh_shape))
    if cohort is None:
        cohort = 1 if mesh is None else cohort_size(mesh)
    bundle = build_step(cfg, shape, cycle, cohort=cohort, device="meta",
                        mesh=mesh)
    args = step_args(bundle, shape.kind)
    cost = count(bundle.donated() if donate else bundle.fn, *args,
                 mesh=mesh)
    return {"step": bundle.name, "cohort": cohort,
            "state_bytes": state_bytes(args, shape.kind),
            "peak_bytes": cost.peak_bytes, "cost": cost.summary(),
            "census": dict(cost.census),
            "fits": cost.peak_bytes <= MEMORY_BYTES}


def run_one(arch: str, shape_name: str, mesh_shape=(1, 1), *,
            shape: Optional[InputShape] = None, depth: Optional[int] = None,
            **kw) -> dict:
    """The record of one (arch, shape, mesh), ``status`` ok, skipped or
    error (with the exception and its traceback).  ``shape`` gives an
    input shape of another name than ``INPUT_SHAPES``' and ``depth`` cuts
    the arch to that many layers (the record then carries its
    ``model_flops``); ``kw`` go to :func:`dry_run`."""
    from repro_torch.launch.roofline import model_flops
    shape = shape or INPUT_SHAPES[shape_name]
    cfg = get_config(arch)
    if depth is not None:
        cfg = cfg.with_(n_layers=depth)
    d, m = mesh_shape
    rec = {"arch": arch, "shape": shape_name, "mesh": f"{d}x{m}",
           "chips": d * m, "status": "ok"}
    if shape_name not in INPUT_SHAPES or depth is not None:
        rec["model_flops"] = model_flops(cfg, shape)
        rec["depth"] = cfg.n_layers
    if shape_name == "long_500k" and arch in LONG_SKIP:
        return {**rec, "status": "skipped", "reason": LONG_SKIP[arch]}
    t0 = time.time()
    try:
        rec.update(dry_run(cfg, shape, mesh_shape, **kw))
    except Exception as e:  # noqa: BLE001 — recorded, and main exits 1
        rec["status"] = "error"
        rec["error"] = repr(e)
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def _mesh_shape(text: str) -> tuple:
    d, m = (int(x) for x in text.split(","))
    return (d, m)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", action="append", default=None,
                    help="an arch (repeat for more; default every arch)")
    ap.add_argument("--shape", action="append", default=None,
                    choices=list(INPUT_SHAPES),
                    help="an input shape (repeat; default every shape)")
    ap.add_argument("--mesh-shape", action="append", type=_mesh_shape,
                    default=None, metavar="D,M",
                    help="a (data, model) mesh (repeat; default "
                         + " ".join(f"{d},{m}" for d, m in MESH_SHAPES) + ")")
    ap.add_argument("--seq", type=int, default=None,
                    help="with --global-batch: one train shape of this "
                         "sequence length in place of --shape")
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--cohort", type=int, default=None,
                    help="the train step's cohort (default: the batch "
                         "axes' ranks)")
    ap.add_argument("--server-batch", type=int, default=None,
                    help="the CycleSL server's inner-loop batch")
    ap.add_argument("--depth", type=int, default=None,
                    help="cut each arch to this many layers")
    ap.add_argument("--out", default="build/dryrun.json")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    archs = args.arch or list_archs()
    shapes = {s: None for s in args.shape or INPUT_SHAPES}
    if args.seq is not None:
        name = f"train_s{args.seq}_b{args.global_batch}"
        shapes = {name: InputShape(name, args.seq, args.global_batch,
                                   "train")}
    kw = {"cohort": args.cohort, "depth": args.depth,
          "cycle": CycleConfig(server_epochs=1,
                               server_batch=args.server_batch)}
    meshes = args.mesh_shape or list(MESH_SHAPES)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    results = []
    t0 = time.time()
    for mesh_shape in meshes:
        for arch in archs:
            for shape, custom in shapes.items():
                rec = run_one(arch, shape, mesh_shape, shape=custom, **kw)
                results.append(rec)
                c = rec.get("cost", {})
                print(f"[{rec['status']:7s}] {rec['mesh']:4s} {arch:22s} "
                      f"{shape:12s} {rec.get('total_s', 0):7.1f}s "
                      f"flops={c.get('flops', float('nan')):.3e} "
                      f"bytes={c.get('traffic_bytes', float('nan')):.3e} "
                      f"coll={c.get('collective_bytes', float('nan')):.3e} "
                      f"state={rec.get('state_bytes', 0) / 1e9:.2f}GB "
                      f"peak={rec.get('peak_bytes', 0) / 1e9:.2f}GB "
                      f"fits={rec.get('fits')}", flush=True)
                if rec["status"] == "error":
                    print(rec["error"], flush=True)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    n = {s: sum(r["status"] == s for r in results)
         for s in ("ok", "skipped", "error")}
    print(f"done in {time.time() - t0:.1f}s: {n['ok']} ok, {n['skipped']} "
          f"skipped, {n['error']} errors -> {args.out}")
    return 1 if n["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
