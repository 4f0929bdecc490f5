"""Initializers for param dicts, drawn from an explicit ``torch.Generator``.

Every draw is made on the generator's device: a CPU generator gives the
same weights on any machine (the CNN zoo's callers move them where they
run), and a generator created on the card draws a full-width
transformer there without a trip through host memory.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.utils.tree import tree_map


def truncated_normal(gen: torch.Generator, shape, scale: float,
                     dtype=torch.float32) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``scale``."""
    w = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
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
    w.normal_(generator=gen)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    return normal(gen, (vocab, d), 0.02, dtype)


def stacked_init(init_fn: Callable[[torch.Generator], object],
                 gen: torch.Generator, n: int):
    """``n`` draws of ``init_fn`` stacked along a new leading dim (the
    JAX package vmaps the init over split keys; here the draws come one
    after another from one generator)."""
    draws = [init_fn(gen) for _ in range(n)]
    return tree_map(lambda *xs: torch.stack(xs), *draws)
