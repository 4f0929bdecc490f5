"""Initializers for param dicts, drawn from an explicit ``torch.Generator``.

Every draw is made on the generator's device: a CPU generator gives the
same weights on any machine (the CNN zoo's callers move them where they
run), and a generator created on the card draws a full-width
transformer there without a trip through host memory.  :data:`SHAPES`,
a stand-in generator on the ``meta`` device, draws nothing: an init
made with it gives the weights' shapes and dtypes alone, which is all a
sharding plan reads.

:func:`remat` is the port's ``jax.checkpoint``: the model stacks call
it as ``module.remat(fn, *args)`` for each group of blocks and each loss
chunk, so a training step keeps a group's input for the backward and
recomputes the rest there.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.utils.tree import tree_map


class _Shapes:
    """A generator stand-in on the ``meta`` device (see :data:`SHAPES`)."""
    device = torch.device("meta")


SHAPES = _Shapes()


def truncated_normal(gen: torch.Generator, shape, scale: float,
                     dtype=torch.float32) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``scale``."""
    w = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    if w.is_meta:
        return w.to(dtype)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: float | None = None):
    """Truncated-normal fan-in init (LeCun-style), [d_in, d_out]."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    return truncated_normal(gen, (d_in, d_out), scale, dtype)


def normal(gen: torch.Generator, shape, scale: float,
           dtype=torch.float32) -> torch.Tensor:
    """Standard normal times ``scale``, drawn in float32, cast last."""
    w = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    if w.is_meta:
        return w.to(dtype)
    w.normal_(generator=gen)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    return normal(gen, (vocab, d), 0.02, dtype)


def stacked_init(init_fn: Callable[[torch.Generator], object],
                 gen: torch.Generator, n: int):
    """``n`` draws of ``init_fn`` stacked along a new leading dim (the
    JAX package vmaps the init over split keys; here the draws come one
    after another from one generator).  Each draw is copied into its row
    as it is made, so the stack takes one draw's memory on top of its
    own, not its own twice."""
    first = init_fn(gen)
    out = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), first)
    for i in range(n):
        draw = first if i == 0 else init_fn(gen)
        tree_map(lambda o, x: o[i].copy_(x), out, draw)
        first = None
    return out


def remat(fn: Callable, *args):
    """``fn(*args)``, its activations rematerialised as under
    ``jax.checkpoint``: the tensors among ``args`` are kept for the
    backward, and whatever else ``fn``'s backward reads is recomputed
    there by running ``fn`` again, up to its last op that saves a tensor
    (torch's early stop: an op after it, whose output no backward reads,
    does not run again).  That recompute launches the group's kernels
    and issues its collectives a second time.

    The non-reentrant checkpoint, the form that
    ``torch.autograd.grad(..., inputs)`` takes.  The forward draws no
    random numbers, so no generator state is stashed.  Where grad is off
    (``no_grad``, ``inference_mode``: extraction, evaluation, prefill,
    decode, serving) nothing is recorded and ``fn`` runs once as it is."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)
