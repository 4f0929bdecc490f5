"""Mixture-of-Experts layer with sort-based (gather/scatter) dispatch.

Port of ``repro/models/moe.py`` without its sharding constraints (one
card has no mesh).  Assignments are sorted by expert id, ranked within
their expert and gathered into a capacity-bounded [E, C, d] buffer, so
the expert matmuls cost the active FLOPs (times the capacity slack).
Tokens over an expert's capacity are dropped (GShard semantics).

The router's top-k goes through ``kernels.ops.topk_gating`` (the CUDA
kernel on the card, its plain version on the CPU); the probabilities and
logits that the aux and z losses read stay plain torch.

Every scatter here gives the same bits run after run on the card: the
dispatch adds each kept row into its own slot and only exact zeros (the
dropped rows, times 0) into shared ones, and the combine puts each
token's k contributions back by the inverse of the sort permutation
into [S, k, d] and sums over k, instead of adding them with atomics in
an order that changes from run to run.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import ops
from repro_torch.models import module


def moe_init(gen, d: int, mcfg: MoEConfig, dtype):
    E, f = mcfg.n_experts, mcfg.d_ff_expert
    sub = lambda din, dout: module.stacked_init(
        lambda g: module.dense_init(g, din, dout, dtype), gen, E)
    return {
        "router": module.dense_init(gen, d, E, torch.float32, scale=0.02),
        "w_gate": sub(d, f),
        "w_up": sub(d, f),
        "w_down": sub(f, d),
    }


def router_probs(params, x2d):
    """x2d [T, d] -> (probs [T, E] float32, logits float32)."""
    logits = x2d.float() @ params["router"]
    return torch.softmax(logits, dim=-1), logits


def _dispatch_group(params, mcfg: MoEConfig, x2):
    """Sort-based dispatch + combine for ONE token group.  x2 [S, d]."""
    S, d = x2.shape
    E, k = mcfg.n_experts, mcfg.top_k
    C = max(1, int(S * k / E * mcfg.capacity_factor))
    dev = x2.device

    probs, logits = router_probs(params, x2)                     # [S, E]
    top_p, top_e = ops.topk_gating(logits, k)                    # [S, k]

    # ---- flatten assignments and sort by expert (stable) ----
    flat_e = top_e.reshape(-1).long()                            # [S*k]
    flat_w = top_p.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(S * k, device=dev)
    se, sw = flat_e[order], flat_w[order]
    # rank within expert segment
    starts = torch.searchsorted(se, torch.arange(E, device=dev))
    rank = torch.arange(S * k, device=dev) - starts[se]
    keep = rank < C
    slot = se * C + torch.clamp(rank, max=C - 1)                  # [S*k]

    # ---- gather tokens into the expert buffer [E*C, d] ----
    # x2[st] with st = flat_t[order]: token t's k copies, then the sort
    rows = x2.unsqueeze(1).expand(S, k, d).reshape(S * k, d)[order]
    rows = rows * keep[:, None].to(x2.dtype)
    buf = torch.zeros((E * C, d), dtype=x2.dtype, device=dev)
    buf = buf.index_add(0, slot, rows).reshape(E, C, d)

    # ---- per-expert SwiGLU: batched matmuls [E,C,d] x [E,d,f] ----
    g = F.silu(torch.bmm(buf, params["w_gate"]))
    u = torch.bmm(buf, params["w_up"])
    yb = torch.bmm(g * u, params["w_down"]).reshape(E * C, d)

    # ---- combine back to tokens ----
    contrib = yb[slot] * (sw * keep.float()).to(x2.dtype)[:, None]
    y = contrib[inv].reshape(S, k, d).sum(dim=1)

    # ---- router losses (per group; averaged by the caller) ----
    me = torch.mean(probs, dim=0)                                 # [E]
    one_hot = F.one_hot(top_e.long(), E).float()                  # [S,k,E]
    ce = torch.mean(torch.sum(one_hot, dim=1), dim=0) / k
    aux = E * torch.sum(me * ce)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return y, aux, z, ce


def moe_apply(params, mcfg: MoEConfig, x):
    """Apply the MoE block.  x: [..., d] -> (y, metrics).

    Tokens are dispatched in GROUPS of ``mcfg.group_size`` (per-group
    capacity); the last group is zero-padded, and its pad tokens are
    routed like any token, as in the JAX package.  metrics =
    {'aux_loss', 'z_loss', 'load'}; the caller adds
    ``aux_weight * aux_loss + router_z_weight * z_loss`` to its loss.
    """
    orig_shape = x.shape
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    T = x2.shape[0]
    gs = min(mcfg.group_size, T)
    n_pad = (-T) % gs
    if n_pad:
        x2 = F.pad(x2, (0, 0, 0, n_pad))
    outs = [_dispatch_group(params, mcfg, xg) for xg in x2.split(gs)]
    y = torch.cat([o[0] for o in outs])[:T]
    metrics = {"aux_loss": torch.stack([o[1] for o in outs]).mean(),
               "z_loss": torch.stack([o[2] for o in outs]).mean(),
               "load": torch.stack([o[3] for o in outs]).mean(0)}
    return y.reshape(orig_shape), metrics
