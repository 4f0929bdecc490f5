"""Initializers for param dicts, drawn from an explicit ``torch.Generator``.

The draws are made on the CPU, so one seed gives the same weights on
any device; callers move them where they run.
"""
from __future__ import annotations

import math

import torch


def truncated_normal(gen: torch.Generator, shape, scale: float,
                     dtype=torch.float32) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``scale``."""
    w = torch.empty(tuple(shape), dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: float | None = None):
    """Truncated-normal fan-in init (LeCun-style), [d_in, d_out]."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    return truncated_normal(gen, (d_in, d_out), scale, dtype)
