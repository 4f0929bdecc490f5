"""Grouped-query attention with RoPE, logit softcap, sliding windows and
a ring-buffer KV cache for decode.

Port of ``repro/models/attention.py``; all shapes are batch-first: x
[B, S, D], heads [B, S, H, Dh].  Full-sequence attention goes through
``kernels.ops.flash_attention``: the CUDA kernel on the card, and on the
CPU its plain version, which is ``sdpa`` (or ``sdpa_qchunked`` above
``kernels.ref.QCHUNK_THRESHOLD`` query rows).  One-token decode is a
masked product over the ring cache in plain torch (``sdpa``), as the
JAX package computes it outside any Pallas kernel.  Its position is one
per row: where the JAX package ``vmap``s a scalar position over the
serving runtime's slots, ``attend_decode`` takes ``pos`` as a [B]
tensor (a scalar broadcasts), so rows at different positions advance in
one call.  Both halves run head-parallel on a mesh's ``model`` axis
(``tp``); decode is inference only, so its inputs enter without
``copy_to_model`` (no gradient sum to take).  A block with fewer kv
heads than ranks splits over kv head groups
(``sharding.parallel.kv_replicas``): a rank runs its query heads against
the one kv head they read, which the ranks of its group hold alike.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig, AttnConfig
from repro_torch.kernels import ops
# the plain attention lives beside the kernel as its plain version;
# these names are its counterparts of the JAX package's attention.py
from repro_torch.kernels.ref import NEG_INF
from repro_torch.kernels.ref import mask_bias as _mask_bias  # noqa: F401
from repro_torch.kernels.ref import sdpa, sdpa_qchunked  # noqa: F401
from repro_torch.models import module
from repro_torch.models.layers import apply_rope, rmsnorm, rmsnorm_init
from repro_torch.sharding.parallel import (copy_to_model, kv_group_sum,
                                           reduce_from_model)


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


def attend_full(params, cfg: ArchConfig, x, positions, window: Optional[int],
                tp=None):
    """Full-sequence (train / prefill) attention over causal index
    positions.  Returns (out, (k, v)).

    Head-parallel when ``tp`` splits the attention unit: ``wq``, ``wk``
    and ``wv`` hold this rank's whole heads (columns), the norms, RoPE
    and the kernel run on them, and ``wo`` (its rows) gives a partial sum
    that is reduced over the ``model`` axis; ``x`` and the q/k norms'
    scales enter through one ``copy_to_model``.  Over kv head groups
    (``tp.kv_rep`` > 1) ``wk`` and ``wv`` hold the group's one kv head,
    and their gradients, each rank's from its own query heads, are
    summed over the group (``kv_group_sum``); ``x``'s sum over the axis
    already holds every rank's part."""
    a: AttnConfig = cfg.attn
    hd = cfg.hd
    split = tp is not None and tp.on("attn")
    norms = ([params["q_norm"], params["k_norm"]] if "q_norm" in params
             else [])
    wk, wv = params["wk"], params["wv"]
    if split:
        # the norms' scales are whole on every rank but meet only this
        # rank's heads: their gradients are partial, as x's is
        if norms:
            x, *scales = copy_to_model(tp, x, *(n["scale"] for n in norms))
            norms = [{"scale": s} for s in scales]
        else:
            x = copy_to_model(tp, x)
        wk, wv = kv_group_sum(tp, wk, wv)
    n_h, n_kv = (cfg.n_heads, cfg.n_kv_heads) if tp is None else \
        tp.heads(cfg)
    q = _split_heads(x @ params["wq"], n_h, hd)
    k = _split_heads(x @ wk, n_kv, hd)
    v = _split_heads(x @ wv, n_kv, hd)
    if norms:
        q = rmsnorm(norms[0], q)
        k = rmsnorm(norms[1], k)
    if a.rope:
        q = apply_rope(q, positions, a.rope_theta)
        k = apply_rope(k, positions, a.rope_theta)
    _check_index_positions(positions, q.shape[1])
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              softcap=a.logit_softcap)
    out = _merge_heads(out) @ params["wo"]
    return (reduce_from_model(tp, out, "attn") if split else out), (k, v)


class KVCache(NamedTuple):
    """Fixed-capacity ring buffer per layer stack.

    k, v: [L, B, C, Hkv, Dh] where C = capacity (window or full seq).
    idx:  int32, scalar or one per row [B]: tokens written so far (the
    global position of the next one).
    """
    k: torch.Tensor
    v: torch.Tensor
    idx: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


def kv_cache_init(cfg: ArchConfig, n_layers: int, batch: int, capacity: int,
                  dtype, device=None):
    shape = (n_layers, batch, capacity, cfg.n_kv_heads, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


def attend_decode(params, cfg: ArchConfig, x, layer_k, layer_v, pos,
                  window: Optional[int], tp=None):
    """One-token decode against a ring-buffer cache slice.

    x: [B, 1, D]; layer_k/v: [B, C, Hkv, Dh]; pos: int32 scalar or [B],
    the global position of each row's new token.  Row b writes its key
    and value to ring slot ``pos[b] % C`` and attends to the slots that
    hold positions in ``(pos[b] - window, pos[b]]``.  Returns (out
    [B, 1, D], new_k, new_v); the inputs are left as they were.

    Head-parallel when ``tp`` splits the attention unit, as
    :func:`attend_full` is: ``wq``/``wk``/``wv`` hold this rank's heads'
    columns, the cache slices are its [B, C, Hkv / m, Dh], and ``wo``'s
    rows give a partial sum reduced over the ``model`` axis.  Over kv
    head groups the cache slices hold the group's one head, [B, C, 1,
    Dh], which every rank of the group writes alike.
    """
    a: AttnConfig = cfg.attn
    hd = cfg.hd
    B, C = x.shape[0], layer_k.shape[1]
    split = tp is not None and tp.on("attn")
    n_h, n_kv = (cfg.n_heads, cfg.n_kv_heads) if tp is None else \
        tp.heads(cfg)
    q = _split_heads(x @ params["wq"], n_h, hd)
    k = _split_heads(x @ params["wk"], n_kv, hd)
    v = _split_heads(x @ params["wv"], n_kv, hd)
    if "q_norm" in params:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    posb = torch.broadcast_to(pos, (B,))
    if a.rope:
        q = apply_rope(q, posb[:, None], a.rope_theta)
        k = apply_rope(k, posb[:, None], a.rope_theta)
    rows = torch.arange(B, device=x.device)
    slot = (posb % C).long()
    layer_k = layer_k.index_put((rows, slot), k[:, 0])
    layer_v = layer_v.index_put((rows, slot), v[:, 0])
    # slot s holds the largest position p <= pos with p % C == s
    slots = torch.arange(C, dtype=torch.int32, device=x.device)
    k_pos = posb[:, None] - ((posb[:, None] - slots) % C)      # [B, C]
    valid = k_pos >= 0
    if window is not None:
        valid &= (posb[:, None] - k_pos) < window
    bias = torch.where(valid, 0.0, NEG_INF)[:, None, :]         # [B, 1, C]
    out = sdpa(q, layer_k, layer_v, bias, a.logit_softcap)
    out = _merge_heads(out) @ params["wo"]
    if split:
        out = reduce_from_model(tp, out, "attn")
    return out, layer_k, layer_v


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
