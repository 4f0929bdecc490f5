"""Primitive layers: norms, linear, embedding, rotary tables, softcap.

Port of ``repro/models/layers.py`` with the same casts: norms and rotary
math run in float32 and return the input's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import module
from repro_torch.sharding.parallel import copy_to_model, reduce_from_model


# ---------------------------------------------------------------- norms
def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-5, tp=None):
    """RMS norm over the last dimension.  With ``tp`` that last dimension
    is split over the ``model`` axis (``x`` and the scale hold this
    rank's columns, a Mamba block's gate norm): the float32 sum of
    squares of the rank's columns is summed over the axis before the
    ``rsqrt`` and the mean divides by the whole width; its gradient,
    partial on each rank, is summed the same way.  Off the axis the op
    is the unsharded one, bit for bit."""
    dt = x.dtype
    xf = x.float()
    if tp is None or tp.size == 1:
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    else:
        ss = torch.sum(torch.square(xf), dim=-1, keepdim=True)
        ss = copy_to_model(tp, reduce_from_model(tp, ss, "norm"),
                           what="norm_grad")
        var = ss / (x.shape[-1] * tp.size)
    y = xf * torch.rsqrt(var + eps)
    return y.to(dt) * params["scale"].to(dt)


def layernorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x, eps: float = 1e-5):
    """Normalize and apply the affine in float32, cast once at the end
    (a bf16 input is neither normalized nor scaled in bf16)."""
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(dt)


# --------------------------------------------------------------- linear
def linear_init(gen, d_in: int, d_out: int, dtype=torch.float32,
                bias: bool = False):
    p = {"w": module.dense_init(gen, d_in, d_out, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def linear(params, x):
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


# ------------------------------------------------------------ embedding
def embedding_init(gen, vocab: int, d: int, dtype=torch.float32):
    return {"table": module.embed_init(gen, vocab, d, dtype)}


def embedding(params, ids, tp=None):
    """Row lookup ``table[ids]`` (its backward sums rows in a fixed
    order, so card runs repeat bit for bit).

    Vocab-parallel when ``tp`` splits the vocab: the table holds this
    rank's rows, ids of other ranks' rows look up zeros, and the sum over
    the ``model`` axis, which has one nonzero term a row, is exact."""
    if tp is None or not tp.on("vocab"):
        return F.embedding(ids.long(), params["table"])
    n = params["table"].shape[0]
    local = ids.long() - tp.rank * n
    ok = (local >= 0) & (local < n)
    rows = F.embedding(local.clamp(0, n - 1), params["table"])
    return reduce_from_model(tp, torch.where(ok[..., None], rows, 0),
                             "embed")


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
