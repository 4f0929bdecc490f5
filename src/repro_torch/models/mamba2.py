"""Mamba-2 block: SSD (state-space duality) with a chunked scan.

Port of the full-sequence half of ``repro/models/mamba2.py``
(arXiv:2405.21060): the block wrapper (input projection, depthwise
causal conv, gating) shared by the pure-SSM (mamba2-2.7b) and hybrid
(zamba2) archs.  The scan goes through ``kernels.ops.ssd_scan``: the
CUDA kernel on the card and, on the CPU, its plain version
``ssd_chunked`` (the JAX package's chunked oracle, kept in
``kernels.ref`` beside the kernel).  Decode (``mamba_decode``) is one
step of the recurrence in float32 (``ssd_decode_step``) with the causal
conv's last ``d_conv - 1`` inputs carried in ``MambaState``; no kernel
runs there.  On a mesh's ``model`` axis both run head-parallel
(``mamba_forward(..., tp)``, ``mamba_decode(..., tp)``).

Layout: x [B, L, H, P] (heads x head_dim), B/C [B, L, G, N] (groups x
state), dt [B, L, H], A [H] negative reals.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.kernels import ops
# the chunked scan lives beside the kernel as its plain version; this is
# its name in the JAX package's mamba2.py
from repro_torch.kernels.ref import ssd_chunked  # noqa: F401
from repro_torch.models import module
from repro_torch.models.layers import rmsnorm, rmsnorm_init
from repro_torch.sharding.parallel import (copy_to_model, packed_segments,
                                           rank_segments, reduce_from_model,
                                           take_segments)


def _conv_channels(cfg: ArchConfig) -> int:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner + 2 * s.n_groups * s.d_state


def mamba_init(gen, cfg: ArchConfig, dtype):
    """Block params drawn on ``gen``'s device; ``a_log``, ``dt_bias`` and
    ``D`` stay float32 whatever the model's dtype, as in the JAX
    package."""
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    H = d_inner // s.head_dim
    conv_ch = _conv_channels(cfg)
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + H
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "w_in": module.dense_init(gen, d, d_in_proj, dtype),
        "conv_w": module.normal(gen, (s.d_conv, conv_ch), 0.1, dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "dt_bias": torch.zeros((H,), **f32),
        "D": torch.ones((H,), **f32),
        "gate_norm": rmsnorm_init(d_inner, dtype, dev),
        "w_out": module.dense_init(gen, d_inner, d, dtype),
    }


def _split_in_proj(cfg: ArchConfig, zxbcdt):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    gN = s.n_groups * s.d_state
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * gN, H], dim=-1)
    return z, xbc, dt, d_inner, H, gN


def _causal_conv(w, b, xbc):
    """Depthwise causal conv over time as the JAX package writes it:
    K shifted products summed in order.  xbc [B, L, C]; w [K, C]."""
    K, L = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    y = sum(pad[:, i:i + L, :] * w[i] for i in range(K))
    return F.silu(y + b)


def _scan_gate_out(params, cfg: ArchConfig, z, xs, Bm, Cm, dt, tp=None):
    """The block past its conv: the SSD scan of ``xs`` [B, L, H * P]
    with ``Bm``/``Cm`` [B, L, G * N] and ``dt`` [B, L, H], the skip, the
    gated norm and ``w_out``.  Returns (y [B, L, d], final state
    [B, H, N, P] float32); with ``tp`` the heads are this rank's and y
    is its partial sum."""
    s = cfg.ssm
    Bsz, L, H = dt.shape
    xs = xs.reshape(Bsz, L, H, s.head_dim)
    Bm = Bm.reshape(Bsz, L, -1, s.d_state)
    Cm = Cm.reshape(Bsz, L, -1, s.d_state)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["a_log"])
    y, h = ops.ssd_scan(xs, dt, A, Bm, Cm, chunk=min(s.chunk, L))
    y = y + xs * params["D"][:, None].to(xs.dtype)
    y = y.reshape(Bsz, L, H * s.head_dim)
    y = rmsnorm(params["gate_norm"], y, tp=tp) * F.silu(z)
    return y @ params["w_out"], h


def mamba_forward(params, cfg: ArchConfig, x, tp=None):
    """Full-sequence forward of one mamba2 block.  x [B, L, d] ->
    (y [B, L, d], final SSD state [B, H, N, P] float32).

    Head-parallel when ``tp`` splits the ``mamba`` unit: the packed
    leaves hold this rank's whole SSD heads (``w_in``'s ``[z_r | x_r |
    B | C | dt_r]`` columns, ``conv_w``'s ``[x_r | B | C]`` channels,
    ``sharding.parallel.packed_segments``), the scan runs on its H / m
    heads, the gate norm sums its squares over the axis and ``w_out``'s
    rows give a partial sum reduced over it; the state returned is the
    rank's heads'."""
    if tp is not None and tp.on("mamba"):
        return _mamba_forward_split(params, cfg, x, tp)
    zxbcdt = x @ params["w_in"]
    z, xbc, dt, d_inner, H, gN = _split_in_proj(cfg, zxbcdt)
    xbc = _causal_conv(params["conv_w"], params["conv_b"], xbc)
    # column slices of one conv output; the kernel reads them in place
    xs, Bm, Cm = torch.split(xbc, [d_inner, gN, gN], dim=-1)
    return _scan_gate_out(params, cfg, z, xs, Bm, Cm, dt)


def _mamba_forward_split(params, cfg: ArchConfig, x, tp):
    """:func:`mamba_forward` on this rank's heads.  The ``B``/``C``
    branch of a one-group block is whole on every rank but read by each
    rank's heads alone, so its weights (``w_in``'s and ``conv_w``'s
    ``B``/``C`` parts) and ``conv_b`` (whole on every rank) have partial
    gradients: they enter with ``x`` through one ``copy_to_model``,
    which sums those gradients over the axis once, and the branch's
    share of ``x``'s gradient is summed with the rest of it, once."""
    s = cfg.ssm
    m, r = tp.size, tp.rank
    d_in = s.expand * cfg.d_model // m
    bc_whole = s.n_groups == 1
    gN = s.n_groups * s.d_state // (1 if bc_whole else m)
    H = d_in // s.head_dim
    zx_w, bc_w, dt_w = torch.split(params["w_in"], [2 * d_in, 2 * gN, H],
                                   dim=-1)
    cx_w, cbc_w = torch.split(params["conv_w"], [d_in, 2 * gN], dim=-1)
    if bc_whole:
        x, conv_b, bc_w, cbc_w = copy_to_model(
            tp, x, params["conv_b"], bc_w, cbc_w, what="mamba_grad")
    else:
        x, conv_b = copy_to_model(tp, x, params["conv_b"],
                                  what="mamba_grad")
    conv_b = take_segments(conv_b, rank_segments(
        packed_segments(cfg, "mamba/conv_w"), m, r))
    cx_b, cbc_b = torch.split(conv_b, [d_in, 2 * gN])
    z, xin = torch.split(x @ zx_w, [d_in, d_in], dim=-1)
    xs = _causal_conv(cx_w, cx_b, xin)
    Bm, Cm = torch.split(_causal_conv(cbc_w, cbc_b, x @ bc_w), [gN, gN],
                         dim=-1)
    y, h = _scan_gate_out(params, cfg, z, xs, Bm, Cm, x @ dt_w, tp)
    return reduce_from_model(tp, y, "mamba"), h


def ssd_decode_step(h, x, dt, A, Bm, Cm):
    """Single-token SSD update in float32.  h [B, H, N, P]; x [B, H, P];
    dt [B, H]; B/C [B, G, N].  Returns (y [B, H, P] in x's dtype, h')."""
    rep = x.shape[1] // Bm.shape[1]
    Bf = torch.repeat_interleave(Bm.float(), rep, dim=1)          # [B, H, N]
    Cf = torch.repeat_interleave(Cm.float(), rep, dim=1)
    dtf = dt.float()
    dA = torch.exp(dtf * A.float())                               # [B, H]
    dBx = torch.einsum("bh,bhn,bhp->bhnp", dtf, Bf, x.float())
    h = dA[:, :, None, None] * h + dBx
    y = torch.einsum("bhn,bhnp->bhp", Cf, h)
    return y.to(x.dtype), h


class MambaState(NamedTuple):
    """Decode-time recurrent state for a stack of mamba blocks.
    h: [L, B, H, N, P] float32; conv: [L, B, d_conv - 1, conv_ch]."""
    h: torch.Tensor
    conv: torch.Tensor


def mamba_decode(params, cfg: ArchConfig, x, h, conv_state, tp=None):
    """One-token decode.  x [B, 1, d]; h [B, H, N, P]; conv_state
    [B, d_conv - 1, conv_ch].  Returns (y [B, 1, d], h', conv_state').

    Head-parallel when ``tp`` splits the ``mamba`` unit, as
    :func:`_mamba_forward_split` reads the packed leaves: ``w_in`` gives
    this rank's ``[z_r | x_r | B | C | dt_r]``, the conv runs over its
    ``[x_r | B | C]`` channels (``conv_state`` holds those, and
    ``conv_b``, whole on every rank, is taken at them), the recurrence
    on its ``H / m`` heads (``B``/``C`` whole with one group), ``D``,
    ``dt_bias`` and ``a_log`` are its heads', the gate norm sums its
    squares over the axis and ``w_out``'s rows give a partial sum
    reduced over it.  Inference only: no gradient sum is taken."""
    s = cfg.ssm
    split = tp is not None and tp.on("mamba")
    m = tp.size if split else 1
    d_inner = s.expand * cfg.d_model // m
    gN = s.n_groups * s.d_state // (1 if s.n_groups == 1 else m)
    H = d_inner // s.head_dim
    zxbcdt = x[:, 0] @ params["w_in"]                       # [B, d_in_proj]
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * gN, H], dim=-1)
    conv_b = params["conv_b"]
    if split:
        conv_b = take_segments(conv_b, rank_segments(
            packed_segments(cfg, "mamba/conv_w"), m, tp.rank))
    # the conv over [conv_state; xbc], then shift the window by one
    full = torch.cat([conv_state, xbc[:, None, :]], dim=1)        # [B, K, C]
    y_conv = F.silu(torch.einsum("bkc,kc->bc", full, params["conv_w"])
                    + conv_b)
    conv_state = full[:, 1:]
    xs, Bm, Cm = torch.split(y_conv, [d_inner, gN, gN], dim=-1)
    Bsz = x.shape[0]
    xs = xs.reshape(Bsz, H, s.head_dim)
    Bm = Bm.reshape(Bsz, gN // s.d_state, s.d_state)
    Cm = Cm.reshape(Bsz, gN // s.d_state, s.d_state)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["a_log"])
    y, h = ssd_decode_step(h, xs, dt, A, Bm, Cm)
    y = y + xs * params["D"][:, None].to(xs.dtype)
    y = y.reshape(Bsz, d_inner)
    y = rmsnorm(params["gate_norm"], y, tp=tp if split else None) * F.silu(z)
    y = y @ params["w_out"]
    if split:
        y = reduce_from_model(tp, y, "mamba")
    return y[:, None, :], h, conv_state


def mamba_state_init(cfg: ArchConfig, n_blocks: int, batch: int, dtype,
                     device=None):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    return MambaState(
        h=torch.zeros((n_blocks, batch, H, s.d_state, s.head_dim),
                      dtype=torch.float32, device=device),
        conv=torch.zeros((n_blocks, batch, s.d_conv - 1, _conv_channels(cfg)),
                         dtype=dtype, device=device))
