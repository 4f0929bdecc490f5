"""Step-function builders: the CycleSL round, prefill and decode.

Port of ``repro/launch/steps.py``.  For an (arch x input shape),
decoder-only or whisper's encoder-decoder, the builders return a
:class:`StepBundle`:

  train   — one full CycleSL round (paper Algorithm 1) over a cohort of
            clients: the paper's technique IS the train step (and
            ``build_pipelined_train_steps``: the same round as an
            extract and a tail call);
  prefill — composed-model forward, next-token logits of the last
            position;
  decode  — one token against a KV cache / SSM state (serving).

The step runs on the card unless ``device="cpu"`` is passed.

The train and prefill steps take a ``mesh`` (``launch.mesh.Mesh``), the
port's counterpart of the reference's ``NamedSharding``s of the train
state: on its ``model`` axis every family's weights are tensor-parallel
(``sharding.parallel``; each rank holds its shards): attention on whole
heads, the FFNs on hidden columns, the MoE on experts, the Mamba-2
blocks on whole SSD heads, whisper's encoder, decoder and
cross-attention on heads, the vocab on rows; over ``data`` the server's
and the prefill's weights are FSDP blocks (``sharding.specs.shard_plan``,
gathered at use, the gradient handed back as each rank's block), over
its batch axes the train step's
cohort is split as the Engine's is (each rank its slots), and the
server steps on the whole minibatch on every rank when its weights
split over ``model`` (the reference's ``tp_layout``), else
data-parallel; the prefill batch is replicated over the batch axes.
The decode step takes a mesh too: its weights are placed as the
prefill's, and its state by ``sharding.specs.decode_state_plan`` (the
port's counterpart of ``decode_state_shardings``: the batch rows over
the batch axes, the cache's and the SSM state's heads over ``model``),
which ``decode_state_zeros`` allocates.  The pipelined train steps
take the train step's mesh and placement (their extract and tail on the
rank's slots and shards compose to its round).
The mesh's device is the step's.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.api.engine import resolve_device
from repro_torch.api.phases import slot_split
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.cyclesl import (CycleConfig, PlanFn, cyclesl_extract,
                                      cyclesl_round, cyclesl_tail)
from repro_torch.core.protocol import SlotSplit, broadcast_entity, init_entity
from repro_torch.core.split import (SplitTask, make_transformer_task,
                                   mesh_placement, xent_loss)
from repro_torch.launch import inputs as inputs_lib
from repro_torch.launch.mesh import cohort_size
from repro_torch.models.encdec import EncDec
from repro_torch.models.module import SHAPES
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adam
from repro_torch.sharding.parallel import gather_from_data
from repro_torch.sharding.specs import (decode_rows, decode_state_zeros,
                                        rows_comm, shard_entity,
                                        shard_params, shard_plan,
                                        step_placement)


@dataclass
class StepBundle:
    """``fn(*init_state(seed), *make_batch(seed), ...)`` runs one step on
    ``device``; ``init_state`` draws random state there from a seed and
    ``make_batch`` draws a batch with numpy and moves it there.

    ``donate`` lists the arguments the step may consume, as the
    reference's ``donate_argnums``: ``fn`` itself leaves its arguments
    as they are (the reference's ``fn`` before ``jax.jit``), and
    :meth:`donated` is the step that updates them in place."""
    name: str
    fn: Callable
    init_state: Callable[[int], tuple]
    make_batch: Callable[[int], tuple]
    device: torch.device
    donate: tuple = ()

    def donated(self) -> Callable:
        """``fn`` with its ``donate`` arguments consumed, the port's
        counterpart of ``jax.jit(fn, donate_argnums=donate)``: the
        entities among them are stepped in place and the rest are the
        caller's to drop, so none of them may be read after the call.
        ``fn`` itself where the bundle donates nothing."""
        if not self.donate:
            return self.fn
        return functools.partial(self.fn, donate=True)


# ------------------------------------------------------------ whisper task
@dataclass(frozen=True)
class WhisperTask(SplitTask):
    """The encoder-decoder split: the encoder is the client, the decoder
    the server.  The decoder's tokens ride in the label tree, so the
    server's entry point is ``server_loss(θ_S, enc_out, {"tokens",
    "labels"})``, given here directly (the JAX package patches it onto a
    frozen ``SplitTask``); ``server_apply`` is not defined."""

    cfg: Optional[ArchConfig] = None

    def server_loss(self, sp, features, y):
        logits = EncDec.decode_train(sp, self.cfg, y["tokens"], features,
                                     self.tp)
        return xent_loss(logits, y["labels"])


def make_whisper_task(cfg: ArchConfig, mesh=None) -> SplitTask:
    """Whisper SplitTask: encoder = client, decoder = server.  Each side
    draws the whole model from its own generator and keeps its half.

    ``mesh`` places both halves as ``core.split.make_transformer_task``
    does: the plans come from a shape-only draw, the client (the encoder,
    role 'full': whole over ``data``) and the server (the decoder, role
    'server': FSDP blocks over ``data``, cut where the round places its
    state) keep their ``model`` blocks, and the forwards run over
    ``tp``."""
    tp = fsdp = plans = None
    if mesh is not None:
        tp, fsdp = mesh_placement(mesh, cfg)
        shapes = EncDec.init(SHAPES, cfg)
        plans = {"client": shard_plan(shapes["encoder"], mesh.shape,
                                      mesh.coords, "full", cfg),
                 "server": shard_plan(shapes["decoder"], mesh.shape,
                                      mesh.coords, "server", cfg)}

    def keep(half, key):
        return half if plans is None else shard_params(half, plans[key],
                                                       data=False)

    def server_apply(sp, features):
        raise NotImplementedError("the whisper server consumes (enc_out, "
                                  "tokens): call server_loss")

    return WhisperTask(
        f"{cfg.name}@encdec",
        init_client=lambda gen: keep(EncDec.init(gen, cfg)["encoder"],
                                     "client"),
        init_server=lambda gen: keep(EncDec.init(gen, cfg)["decoder"],
                                     "server"),
        client_forward=lambda cp, batch: EncDec.encode(cp, cfg,
                                                       batch["frames"], tp),
        server_apply=server_apply, loss=lambda out, y: out,
        metrics=lambda out, y: {}, tp=tp, fsdp=fsdp, plans=plans, cfg=cfg)


# ------------------------------------------------------------- train step
@dataclass
class _TrainSubstrate:
    """What the whole and the pipelined train-step builders share (one
    source, so they cannot drift): the task, the optimizers, the checked
    cycle config, the device, and the state and batch makers."""
    task: SplitTask
    opt_s: object
    opt_c: object
    cycle: CycleConfig
    device: torch.device
    init_state: Callable[[int], tuple]
    make_batch: Callable[[int], tuple]
    split: Optional[SlotSplit] = None


def _generator(dev: torch.device, seed: int):
    """The generator a step draws its state from: seeded on ``dev``, or on
    ``meta`` (which draws nothing) the shapes-only stand-in."""
    if dev.type == "meta":
        return SHAPES
    return torch.Generator(device=dev).manual_seed(seed)


def _mesh_device(mesh, device) -> torch.device:
    return resolve_device(device) if mesh is None else mesh.device


def _train_substrate(cfg: ArchConfig, shape: InputShape, cycle: CycleConfig,
                     cohort: int, device, mesh=None) -> _TrainSubstrate:
    inputs_lib.train_batch_specs(cfg, shape, cohort)  # validates cfg, split
    dev = _mesh_device(mesh, device)
    cycle = cycle.check_ported()
    task = (make_whisper_task(cfg, mesh=mesh) if cfg.family == "audio"
            else make_transformer_task(cfg, mesh=mesh))
    opt_s, opt_c = adam(3e-4), adam(3e-4)
    # the cohort's split over the batch axes (none on a mesh whose batch
    # axes hold one rank: its slots are every slot)
    split = (slot_split(mesh, cohort)
             if mesh is not None and cohort_size(mesh) > 1 else None)
    lo, hi = (0, cohort) if split is None else (split.lo, split.hi)

    def init_state(seed: int):
        gen_s, gen_c = _generator(dev, seed), _generator(dev, seed + 1)
        server = init_entity(task.init_server(gen_s), opt_s)
        if task.fsdp is not None:
            # FSDP: the server keeps its blocks over data (the cohort's
            # slot copies stay whole there, the reference's role client)
            server = shard_entity(server, task.plans["server"], model=False)
        clients = broadcast_entity(
            init_entity(task.init_client(gen_c), opt_c), hi - lo)
        return server, clients

    def make_batch(seed: int):
        if dev.type == "meta":           # shapes alone: nothing to draw
            xs, ys = inputs_lib.meta_batch(
                inputs_lib.train_batch_specs(cfg, shape, cohort))
        else:
            xs, ys = inputs_lib.make_train_batch(cfg, shape, cohort, seed)
        if split is not None:
            xs = {k: v[lo:hi] for k, v in xs.items()}
            ys = (ys[lo:hi] if not isinstance(ys, dict)
                  else {k: v[lo:hi] for k, v in ys.items()})
        return (inputs_lib.to_device(xs, cfg, dev),
                inputs_lib.to_device(ys, cfg, dev))

    return _TrainSubstrate(task, opt_s, opt_c, cycle, dev, init_state,
                           make_batch, split)


def build_train_step(cfg: ArchConfig, shape: InputShape,
                     cycle: CycleConfig = CycleConfig(), *, cohort: int,
                     device=None, plan_fn: Optional[PlanFn] = None,
                     mesh=None) -> StepBundle:
    """``fn(server, clients, xs, ys, key) -> (server', clients',
    metrics)``: one ``cyclesl_round`` of the arch's split task (the
    transformer cut, or whisper's encoder/decoder) with ``adam(3e-4)``
    on both sides, as the JAX package's train step.

    ``init_state(seed)`` gives (server, clients): the server entity and
    ``cohort`` copies of one client entity, stacked.  ``make_batch(seed)``
    gives (xs, ys): ``{"tokens": [C, b, S]}`` and next-token labels
    [C, b, S], b = global_batch / cohort; for audio ``{"frames": [C, b,
    1500, d]}`` and ``{"tokens", "labels"}`` [C, b, min(S, 448)].
    ``plan_fn`` replaces the round's resample plan (see
    ``core.cyclesl.PlanFn``).

    On ``mesh`` (see the module's docstring) ``init_state`` gives this
    rank's shards and slots, ``make_batch`` this rank's slots, and the
    step this rank's new shards and slots with metrics that are the same
    on every rank.

    The bundle donates ``(0, 1)``: ``donated()`` (``fn(...,
    donate=True)``) steps the server and the clients in place."""
    sub = _train_substrate(cfg, shape, cycle, cohort, device, mesh)

    def train_step(server, clients, xs, ys, key: int, *,
                   donate: bool = False):
        return cyclesl_round(sub.task, server, clients, sub.opt_s, sub.opt_c,
                             xs, ys, key, sub.cycle, plan_fn=plan_fn,
                             split=sub.split, donate=donate)

    return StepBundle("train", train_step, sub.init_state, sub.make_batch,
                      sub.device, donate=(0, 1))


def build_pipelined_train_steps(cfg: ArchConfig, shape: InputShape,
                                cycle: CycleConfig = CycleConfig(), *,
                                cohort: int, device=None,
                                plan_fn: Optional[PlanFn] = None,
                                mesh=None
                                ) -> tuple[StepBundle, StepBundle]:
    """The CycleSL round as two calls, the launcher-side mirror of the
    Engine's pipelined schedule: ``train_extract(clients, xs, ys) ->
    (feats, store)`` and ``train_tail(server, clients, xs, ys, key,
    feats, store) -> (server', clients', metrics)``, which compose to
    :func:`build_train_step`'s round exactly, on ``mesh`` too (placed
    as that step is: the extract's pool holds the rank's slots' rows,
    and the tail's server phase reads it over the cohort's split).
    Both bundles share ``init_state`` and ``make_batch``.  The tail
    donates ``(0, 1, 5, 6)``, as the reference's: its ``donated()`` steps
    the server and the clients in place, and the stage (``feats``,
    ``store``) dies with the round."""
    sub = _train_substrate(cfg, shape, cycle, cohort, device, mesh)

    def extract_step(clients, xs, ys):
        return cyclesl_extract(sub.task, clients, xs, ys)

    def tail_step(server, clients, xs, ys, key: int, feats, store, *,
                  donate: bool = False):
        return cyclesl_tail(sub.task, server, clients, sub.opt_s, sub.opt_c,
                            xs, ys, key, sub.cycle, feats, store,
                            plan_fn=plan_fn, split=sub.split, donate=donate)

    return (StepBundle("train_extract", extract_step, sub.init_state,
                       sub.make_batch, sub.device),
            StepBundle("train_tail", tail_step, sub.init_state,
                       sub.make_batch, sub.device, donate=(0, 1, 5, 6)))


# ----------------------------------------------------------- prefill step
def build_prefill_step(cfg: ArchConfig, shape: InputShape, *, device=None,
                       mesh=None) -> StepBundle:
    """``fn(params, batch) -> logits [B, vocab] bfloat16`` of the last
    position, from the full model's forward (no gradient).
    ``init_state(seed)`` gives (params,), ``make_batch(seed)`` gives
    (batch,) with ``batch["tokens"]`` [B, S] (and for audio
    ``batch["frames"]`` [B, 1500, d]).  On ``mesh`` the params are this
    rank's blocks of the whole draw (over ``model`` and, FSDP, over
    ``data``: gathered over ``data`` at use) and every rank returns the
    whole logits."""
    inputs_lib.prefill_specs(cfg, shape)             # validates cfg
    dev = _mesh_device(mesh, device)
    model = EncDec if cfg.family == "audio" else Transformer
    tp = fsdp = plan = None
    if mesh is not None:
        tp, fsdp, plan = step_placement(mesh, cfg, model.init(SHAPES, cfg))

    def init_state(seed: int):
        params = model.init(_generator(dev, seed), cfg)
        if plan is not None:
            params = shard_params(params, plan)
        return (params,)

    def make_batch(seed: int):
        if dev.type == "meta":
            return (inputs_lib.meta_batch(inputs_lib.prefill_specs(cfg,
                                                                   shape)),)
        return (inputs_lib.to_device(
            inputs_lib.make_prefill_batch(cfg, shape, seed), cfg, dev),)

    def prefill(params, batch):
        with torch.no_grad():
            if fsdp is not None:
                params = gather_from_data(fsdp, params, plan)
            if cfg.family == "audio":
                logits = EncDec.forward(params, cfg, batch["frames"],
                                        batch["tokens"], tp=tp)
            else:
                logits, _ = Transformer.forward(
                    params, cfg, batch["tokens"], batch.get("patch_embeds"),
                    tp=tp)
        return logits[:, -1].to(torch.bfloat16)

    return StepBundle("prefill", prefill, init_state, make_batch, dev)


# ------------------------------------------------------------ decode step
def build_decode_step(cfg: ArchConfig, shape: InputShape,
                      long_context: bool = False, *, device=None,
                      mesh=None) -> StepBundle:
    """``fn(params, token, state) -> (logits [B, 1, vocab] float32,
    state')``: one ``decode_step`` at a context of ``shape.seq_len`` (no
    gradient).  ``init_state(seed)`` gives (params, state) with an empty
    cache; for audio the state also holds the encoder's states of
    ``WHISPER_FRAMES`` frames drawn from numpy under ``seed``.
    ``make_batch(seed)`` gives (token,) [B, 1] int32 from numpy.

    On ``mesh`` the params are this rank's blocks of the whole draw, as
    :func:`build_prefill_step` places them (over ``model`` and, FSDP,
    over ``data``: gathered over ``data`` once a call), the state is this
    rank's block under ``sharding.specs.decode_state_plan`` (its rows of
    the batch, :func:`decode_rows`, and its heads), the token is its
    rows, and the step returns its rows' logits, whole over ``model``."""
    spec = inputs_lib.decode_token_spec(cfg, shape)
    dev = _mesh_device(mesh, device)
    audio = cfg.family == "audio"
    model = EncDec if audio else Transformer
    B = spec.shape[0]
    tp = fsdp = plan = rows = None
    lo, hi = 0, B
    if mesh is not None:
        tp, fsdp, plan = step_placement(mesh, cfg, model.init(SHAPES, cfg))
        lo, hi, axes = decode_rows(mesh.shape, mesh.coords, B)
        rows = rows_comm(mesh, axes)

    def whole_over_data(params):
        return params if fsdp is None else gather_from_data(fsdp, params,
                                                            plan)

    def init_state(seed: int):
        params = model.init(_generator(dev, seed), cfg)
        if plan is not None:
            params = shard_params(params, plan)
        empty = (EncDec.decode_cache if audio
                 else Transformer.init_decode_state)
        state = decode_state_zeros(empty(cfg, B, shape.seq_len,
                                         long_context, device="meta"),
                                   mesh, cfg, dev)
        if not audio:
            return params, state
        fshape = (B, inputs_lib.WHISPER_FRAMES, cfg.enc_d_model)
        if dev.type == "meta":
            frames = torch.empty(fshape, dtype=cfg.torch_dtype,
                                 device=dev)[lo:hi]
        else:
            frames = np.random.default_rng(seed).standard_normal(
                fshape)[lo:hi]
            frames = torch.from_numpy(frames.astype(np.float32)).to(
                device=dev, dtype=cfg.torch_dtype)
        with torch.no_grad():
            enc_out = EncDec.encode(whole_over_data(params)["encoder"], cfg,
                                    frames, tp)
        return params, {"enc_out": enc_out, **state}

    def make_batch(seed: int):
        tok = np.random.default_rng(seed).integers(
            0, cfg.vocab, size=spec.shape, dtype=np.int32)[lo:hi]
        return (torch.from_numpy(tok).to(dev),)

    def decode(params, token, state):
        extra = {} if audio else {"rows": rows}
        with torch.no_grad():
            return model.decode_step(whole_over_data(params), cfg, token,
                                     state, long_context=long_context, tp=tp,
                                     **extra)

    return StepBundle("decode", decode, init_state, make_batch, dev)


def build_step(cfg: ArchConfig, shape: InputShape,
               cycle: CycleConfig = CycleConfig(), *,
               cohort: Optional[int] = None,
               long_context: Optional[bool] = None,
               device=None, mesh=None) -> StepBundle:
    lc = shape.name == "long_500k" if long_context is None else long_context
    if shape.kind == "train":
        if cohort is None:
            raise ValueError("a train step needs the cohort size")
        return build_train_step(cfg, shape, cycle, cohort=cohort,
                                device=device, mesh=mesh)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, device=device, mesh=mesh)
    return build_decode_step(cfg, shape, long_context=lc, device=device,
                             mesh=mesh)
