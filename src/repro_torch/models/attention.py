"""Grouped-query attention with RoPE, logit softcap and sliding windows.

Port of the full-sequence half of ``repro/models/attention.py``; all
shapes are batch-first: x [B, S, D], heads [B, S, H, Dh].  Full-sequence
attention goes through ``kernels.ops.flash_attention``: the CUDA kernel
on the card, and on the CPU its plain version, which is ``sdpa`` (or
``sdpa_qchunked`` above ``kernels.ref.QCHUNK_THRESHOLD`` query rows).  The
decode half (``KVCache``, ``attend_decode``) comes with the port of
the serving path.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, AttnConfig
from repro_torch.kernels import ops
# the plain attention lives beside the kernel as its plain version;
# these names are its counterparts of the JAX package's attention.py
from repro_torch.kernels.ref import mask_bias as _mask_bias  # noqa: F401
from repro_torch.kernels.ref import sdpa, sdpa_qchunked  # noqa: F401
from repro_torch.models import module
from repro_torch.models.layers import apply_rope, rmsnorm, rmsnorm_init


def attn_init(gen, cfg: ArchConfig, dtype):
    """QKV + output projections (no biases, per the assigned archs)."""
    d, hd = cfg.d_model, cfg.hd
    p = {
        "wq": module.dense_init(gen, d, cfg.n_heads * hd, dtype),
        "wk": module.dense_init(gen, d, cfg.n_kv_heads * hd, dtype),
        "wv": module.dense_init(gen, d, cfg.n_kv_heads * hd, dtype),
        "wo": module.dense_init(gen, cfg.n_heads * hd, d, dtype),
    }
    if cfg.attn.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, gen.device)
        p["k_norm"] = rmsnorm_init(hd, dtype, gen.device)
    return p


def _split_heads(x, n, hd):
    return x.reshape(tuple(x.shape[:-1]) + (n, hd))


def _merge_heads(x):
    return x.reshape(tuple(x.shape[:-2]) + (-1,))


def _check_index_positions(positions, S: int) -> None:
    """The kernel masks by index, so the positions must be arange(S)
    (broadcast over the batch); checked on the device, without a host
    sync."""
    if positions.shape[-1] != S:
        raise ValueError(f"positions {tuple(positions.shape)} for a sequence "
                         f"of {S}")
    want = torch.arange(S, device=positions.device, dtype=positions.dtype)
    torch._assert_async(torch.all(positions == want))


def attend_full(params, cfg: ArchConfig, x, positions, window: Optional[int]):
    """Full-sequence (train / prefill) attention over causal index
    positions.  Returns (out, (k, v))."""
    a: AttnConfig = cfg.attn
    hd = cfg.hd
    q = _split_heads(x @ params["wq"], cfg.n_heads, hd)
    k = _split_heads(x @ params["wk"], cfg.n_kv_heads, hd)
    v = _split_heads(x @ params["wv"], cfg.n_kv_heads, hd)
    if "q_norm" in params:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if a.rope:
        q = apply_rope(q, positions, a.rope_theta)
        k = apply_rope(k, positions, a.rope_theta)
    _check_index_positions(positions, q.shape[1])
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              softcap=a.logit_softcap)
    return _merge_heads(out) @ params["wo"], (k, v)


def layer_window(cfg: ArchConfig, layer_idx_is_local: bool,
                 long_context: bool) -> Optional[int]:
    """The effective sliding window of a layer.

    - pattern 'global': no window, unless long_context forces the
      carve-out window;
    - pattern 'local_global': even layers local (cfg.attn.window), odd
      global (windowed only in long_context mode).
    """
    a = cfg.attn
    if a.pattern == "local_global" and layer_idx_is_local:
        return a.window
    if long_context:
        return cfg.long_context_window
    if a.pattern == "local":
        return a.window
    return None
