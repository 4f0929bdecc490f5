"""Primitive layers: norms, embedding, rotary tables, softcap.

Port of ``repro/models/layers.py`` with the same casts: norms and rotary
math run in float32 and return the input's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------- norms
def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return y.to(dt) * params["scale"].to(dt)


# ------------------------------------------------------------ embedding
def embedding(params, ids):
    """Row lookup ``table[ids]`` (its backward sums rows in a fixed
    order, so card runs repeat bit for bit)."""
    return F.embedding(ids.long(), params["table"])


def unembed(params, x):
    """Tied unembedding: x @ table.T."""
    return x @ params["table"].T


# --------------------------------------------------------------- rotary
def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [Dh/2]
    ang = positions[..., :, None].float() * freqs           # [..., S, Dh/2]
    sin = torch.sin(ang)[..., :, None, :]                   # [..., S, 1, Dh/2]
    cos = torch.cos(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap: float | None):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
