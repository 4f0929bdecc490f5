"""Rank jobs of ``tests/test_torch_serve_mesh.py``: decode and the
serving slot table on a mesh.

``repro_torch.launch.meshcheck.spawn_ranks`` runs each job in spawned
ranks, which import this module: it imports torch and the port only,
never JAX.  Every job takes the rank's mesh first and returns what the
test compares, on the CPU.
"""
import contextlib

import numpy as np
import torch

from repro_torch.configs import InputShape, smoke_config
from repro_torch.launch import inputs
from repro_torch.launch.mesh import make_engine_mesh
from repro_torch.launch.steps import build_decode_step
from repro_torch.models.transformer import Transformer
from repro_torch.serve import ServeConfig, ServeRuntime
from repro_torch.sharding.specs import (decode_rows, decode_state_plan,
                                        gather_params, rows_comm)

ARCHS = ("gemma2-2b", "olmoe-1b-7b", "zamba2-1.2b", "mamba2-2.7b",
         "whisper-base")
# batch 4 at a context of 16: on (2, 2) each rank decodes 2 rows
DECODE = InputShape("decode_smoke", 16, 4, "decode")
STEPS = 8
# whisper's decode state encodes the first FRAMES of the frames the step
# draws (its position table covers any prefix), on every side
FRAMES = 64
# the reference's own mesh test (tests/test_serving.py)
SERVE = ServeConfig(slots=8, max_prompt_len=4, max_new_tokens=3,
                    prefill_batch=4)
PROMPTS = [[1 + i, 2, 3][: 1 + i % 3] for i in range(10)]
SERVE_ARCHS = ("olmoe-1b-7b", "zamba2-1.2b")
# (site, tick, attempt) the planted hook fails on, on one rank alone
FAULTS = (("prefill", 1, 0), ("decode", 3, 0))


def teacher_tokens(cfg, seed=11) -> torch.Tensor:
    """[B, STEPS] tokens fed one a step (numpy)."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(DECODE.global_batch, STEPS), dtype=np.int32))


def teacher_forced(mesh, arch, seed=0):
    """``STEPS`` steps of ``build_decode_step(mesh=)`` (unsharded for
    ``mesh`` None) from ``init_state(seed)``, each step fed the rank's
    rows of :func:`teacher_tokens`: the float32 logits [B, STEPS, V] of
    every row (gathered over the batch axes), the final state gathered
    whole, and the census of each step (every axis' collectives)."""
    cfg = smoke_config(arch)
    bundle = build_decode_step(cfg, DECODE, device="cpu", mesh=mesh)
    with few_frames():
        params, state = bundle.init_state(seed)
    toks = teacher_tokens(cfg)
    lo, hi, axes = (0, DECODE.global_batch, None) if mesh is None else \
        decode_rows(mesh.shape, mesh.coords, DECODE.global_batch)
    comms = [] if mesh is None else [mesh.comm, mesh.model_comm]
    for c in comms:
        c.take_census()
    logits, census = [], []
    for t in range(STEPS):
        lg, state = bundle.fn(params, toks[lo:hi, t:t + 1], state)
        logits.append(lg[:, 0])
        census.append({k: v for c in comms
                       for k, v in c.take_census().items()})
    logits = torch.stack(logits, 1)
    if mesh is None:
        return {"logits": logits, "state": state, "census": census}
    rc = rows_comm(mesh, axes)
    if rc is not None:
        logits = rc.all_gather(logits, "test")
    whole_state = _whole_shapes(cfg, state, mesh)
    plan = decode_state_plan(whole_state, mesh.shape, mesh.coords, cfg)
    state = gather_params(state, plan, mesh.model_comm, rc)
    return {"logits": logits, "state": state, "census": census}


@contextlib.contextmanager
def few_frames():
    """The decode step's whisper frames cut to ``FRAMES`` meanwhile."""
    real = inputs.WHISPER_FRAMES
    inputs.WHISPER_FRAMES = FRAMES
    try:
        yield
    finally:
        inputs.WHISPER_FRAMES = real


def _whole_shapes(cfg, local, mesh):
    """A meta tree of the whole decode state whose rank's block is
    ``local``."""
    B = DECODE.global_batch
    if cfg.family == "audio":
        kv = local["kv"]
        meta = lambda t: torch.empty((t.shape[0], B, t.shape[2],
                                      cfg.n_kv_heads, cfg.hd), device="meta")
        return {"enc_out": torch.empty(
                    (B,) + tuple(local["enc_out"].shape[1:]), device="meta"),
                "kv": type(kv)(meta(kv.k), meta(kv.v), kv.idx),
                "pos": local["pos"]}
    return Transformer.init_decode_state(cfg, B, DECODE.seq_len,
                                         device="meta")


class CountingClock:
    """A clock that advances by 1 ms a read, from ``offset``: each rank
    reads its own, and a runtime that agrees reads rank 0's."""

    def __init__(self, offset=0.0):
        self.t = offset

    def __call__(self):
        self.t += 1e-3
        return self.t


class PlantedFaults:
    """A fault hook that fails at each ``FAULTS`` (site, tick, attempt)."""

    def __init__(self):
        self.fired = []

    def __call__(self, site, tick, attempt):
        if (site, tick, attempt) in FAULTS:
            self.fired.append((site, tick, attempt))
            raise RuntimeError(f"planted {site} fault at tick {tick}")


def serve(mesh, arch, whole, faulty_rank=None):
    """``ServeRuntime(SERVE, mesh=)`` over the reference test's prompts
    (``max_new`` 3), drained: every request's tokens, the records, the
    stats, the census of the serving loop by axis, and how many times
    the rank's planted hook fired.  Rank ``faulty_rank`` alone carries
    :class:`PlantedFaults`; every rank reads a clock of its own."""
    rank = 0 if mesh is None else torch.distributed.get_rank()
    hook = PlantedFaults() if rank == faulty_rank else None
    rt = ServeRuntime(smoke_config(arch), SERVE, params=whole, mesh=mesh,
                      clock=CountingClock(100.0 * rank), fault_hook=hook,
                      device="cpu")
    comms = [] if mesh is None else [c for c in (
        mesh.comm, mesh.model_comm, rt._host) if c is not None]
    for c in comms:
        c.take_census()
    for p in PROMPTS:
        rt.submit(p, max_new=3)
    rt.drain()
    census = {k: v for c in comms for k, v in c.take_census().items()}
    return {"tokens": {rid: rt.results[rid].tokens.tolist()
                       for rid in sorted(rt.results)},
            "records": rt.records(), "stats": rt.stats(),
            "census": census, "fired": [] if hook is None else hook.fired}


def world(mesh, decode_cases: dict, serve_cases: dict):
    """Each decode case ``name: (shape, arch)`` and serve case
    ``name: (shape, arch, whole, faulty_rank)`` on the spawned mesh
    (``shape`` None) or on a second mesh of ``shape`` over the same
    ranks: {name: result}."""
    meshes = {None: mesh}

    def on(shape):
        if shape not in meshes:
            meshes[shape] = make_engine_mesh(shape, ("data", "model"), "cpu")
        return meshes[shape]
    out = {}
    for name, (shape, arch) in decode_cases.items():
        out[name] = teacher_forced(on(shape), arch)
    for name, (shape, arch, whole, faulty) in serve_cases.items():
        out[name] = serve(on(shape), arch, whole, faulty)
    return out
