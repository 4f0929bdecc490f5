"""Step-function builders: the CycleSL round, prefill and decode.

Port of ``repro/launch/steps.py`` without mesh or shardings (the
decode state's placement, ``decode_state_shardings``, waits for the
multi-GPU port).  For an (arch x input shape) the builders return a
:class:`StepBundle`:

  train   — one full CycleSL round (paper Algorithm 1) over a cohort of
            clients: the paper's technique IS the train step;
  prefill — composed-model forward, next-token logits of the last
            position;
  decode  — one token against a KV cache / SSM state (serving).

The step runs on the card unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.api.engine import resolve_device
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.cyclesl import CycleConfig, PlanFn, cyclesl_round
from repro_torch.core.protocol import broadcast_entity, init_entity
from repro_torch.core.split import make_transformer_task
from repro_torch.launch import inputs as inputs_lib
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adam


@dataclass
class StepBundle:
    """``fn(*init_state(seed), *make_batch(seed), ...)`` runs one step on
    ``device``; ``init_state`` draws random state there from a seed and
    ``make_batch`` draws a batch with numpy and moves it there."""
    name: str
    fn: Callable
    init_state: Callable[[int], tuple]
    make_batch: Callable[[int], tuple]
    device: torch.device


# ------------------------------------------------------------- train step
def build_train_step(cfg: ArchConfig, shape: InputShape,
                     cycle: CycleConfig = CycleConfig(), *, cohort: int,
                     device=None, plan_fn: Optional[PlanFn] = None
                     ) -> StepBundle:
    """``fn(server, clients, xs, ys, key) -> (server', clients',
    metrics)``: one ``cyclesl_round`` of the transformer split task with
    ``adam(3e-4)`` on both sides, as the JAX package's train step.

    ``init_state(seed)`` gives (server, clients): the server entity and
    ``cohort`` copies of one client entity, stacked.  ``make_batch(seed)``
    gives (xs, ys): ``{"tokens": [C, b, S]}`` and next-token labels
    [C, b, S], b = global_batch / cohort.  ``plan_fn`` replaces the
    round's resample plan (see ``core.cyclesl.PlanFn``)."""
    inputs_lib.train_batch_specs(cfg, shape, cohort)  # validates cfg, split
    dev = resolve_device(device)
    cycle = cycle.check_ported()
    task = make_transformer_task(cfg)
    opt_s, opt_c = adam(3e-4), adam(3e-4)

    def init_state(seed: int):
        gen_s = torch.Generator(device=dev).manual_seed(seed)
        gen_c = torch.Generator(device=dev).manual_seed(seed + 1)
        server = init_entity(task.init_server(gen_s), opt_s)
        clients = broadcast_entity(
            init_entity(task.init_client(gen_c), opt_c), cohort)
        return server, clients

    def make_batch(seed: int):
        xs, ys = inputs_lib.make_train_batch(cfg, shape, cohort, seed)
        return (inputs_lib.to_device(xs, cfg, dev),
                inputs_lib.to_device(ys, cfg, dev))

    def train_step(server, clients, xs, ys, key: int):
        return cyclesl_round(task, server, clients, opt_s, opt_c, xs, ys,
                             key, cycle, plan_fn=plan_fn)

    return StepBundle("train", train_step, init_state, make_batch, dev)


# ----------------------------------------------------------- prefill step
def build_prefill_step(cfg: ArchConfig, shape: InputShape, *, device=None
                       ) -> StepBundle:
    """``fn(params, batch) -> logits [B, vocab] bfloat16`` of the last
    position, from the full model's forward (no gradient).
    ``init_state(seed)`` gives (params,), ``make_batch(seed)`` gives
    (batch,) with ``batch["tokens"]`` [B, S]."""
    inputs_lib.prefill_specs(cfg, shape)             # validates cfg
    dev = resolve_device(device)

    def init_state(seed: int):
        return (Transformer.init(torch.Generator(device=dev).manual_seed(seed),
                                 cfg),)

    def make_batch(seed: int):
        return (inputs_lib.to_device(
            inputs_lib.make_prefill_batch(cfg, shape, seed), cfg, dev),)

    def prefill(params, batch):
        with torch.no_grad():
            logits, _ = Transformer.forward(
                params, cfg, batch["tokens"], batch.get("patch_embeds"))
        return logits[:, -1].to(torch.bfloat16)

    return StepBundle("prefill", prefill, init_state, make_batch, dev)


# ------------------------------------------------------------ decode step
def build_decode_step(cfg: ArchConfig, shape: InputShape,
                      long_context: bool = False, *, device=None
                      ) -> StepBundle:
    """``fn(params, token, state) -> (logits [B, 1, vocab] float32,
    state')``: one ``Transformer.decode_step`` at a context of
    ``shape.seq_len`` (no gradient).  ``init_state(seed)`` gives
    (params, state) with an empty cache; ``make_batch(seed)`` gives
    (token,) [B, 1] int32 from numpy."""
    if cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder decode step is not ported yet "
            f"(ROADMAP.md queue 1 item 5)")
    spec = inputs_lib.decode_token_spec(cfg, shape)
    dev = resolve_device(device)

    def init_state(seed: int):
        params = Transformer.init(
            torch.Generator(device=dev).manual_seed(seed), cfg)
        return params, Transformer.init_decode_state(
            cfg, spec.shape[0], shape.seq_len, long_context, device=dev)

    def make_batch(seed: int):
        tok = np.random.default_rng(seed).integers(
            0, cfg.vocab, size=spec.shape, dtype=np.int32)
        return (torch.from_numpy(tok).to(dev),)

    def decode(params, token, state):
        with torch.no_grad():
            return Transformer.decode_step(params, cfg, token, state,
                                           long_context=long_context)

    return StepBundle("decode", decode, init_state, make_batch, dev)


def build_step(cfg: ArchConfig, shape: InputShape,
               cycle: CycleConfig = CycleConfig(), *,
               cohort: Optional[int] = None,
               long_context: Optional[bool] = None,
               device=None) -> StepBundle:
    lc = shape.name == "long_500k" if long_context is None else long_context
    if shape.kind == "train":
        if cohort is None:
            raise ValueError("a train step needs the cohort size")
        return build_train_step(cfg, shape, cycle, cohort=cohort,
                                device=device)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, device=device)
    return build_decode_step(cfg, shape, long_context=lc, device=device)
