"""Mixture-of-Experts layer with sort-based (gather/scatter) dispatch.

Port of ``repro/models/moe.py``; on a mesh's ``model`` axis it runs
expert-parallel (or, for ``shard_mode='ffn'``, with each expert's hidden
columns split) instead of under the JAX package's sharding constraints.
Assignments are sorted by expert id, ranked within their expert and
gathered into a capacity-bounded [E, C, d] buffer, so
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
from repro_torch.sharding.parallel import copy_to_model, reduce_from_model


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


def _dispatch_groups(params, mcfg: MoEConfig, xg, tp=None):
    """Sort-based dispatch + combine for G token groups at once, each
    with its own capacity.  xg [G, S, d] -> (y [G, S, d], aux [G],
    z [G], ce [G, E]).  The router's top-k is one launch over all G * S
    rows, and the experts are one batched product over all groups.

    When ``tp`` splits the MoE unit, the tokens stay replicated: every
    rank routes, sorts, ranks and dispatches them the same way, then
    runs its own experts (the stacks hold ``E / m`` of them; the other
    experts' outputs come from their ranks), or in ``'ffn'`` mode every
    expert on its hidden columns.  Each rank's combine is a partial sum,
    reduced over the ``model`` axis.  The expert inputs and the combine
    weights meet this rank's part only, so their gradients are partial
    too: they enter through one ``copy_to_model``.  The router and its
    aux and z losses are the same on every rank and count once."""
    G, S, d = xg.shape
    E, k = mcfg.n_experts, mcfg.top_k
    C = max(1, int(S * k / E * mcfg.capacity_factor))
    n, dev = S * k, xg.device

    probs, logits = router_probs(params, xg.reshape(G * S, d))    # [G*S, E]
    top_p, top_e = ops.topk_gating(logits, k)                    # [G*S, k]

    # ---- flatten assignments and sort by expert (stable), per group ----
    flat_e = top_e.reshape(G, n).long()
    flat_w = top_p.reshape(G, n)
    split = tp is not None and tp.on("moe")
    if split:
        xg, flat_w = copy_to_model(tp, xg, flat_w, what="moe_grad")
    order = torch.argsort(flat_e, dim=1, stable=True)            # [G, n]
    ar = torch.arange(n, device=dev)
    inv = torch.empty_like(order).scatter_(1, order, ar.expand(G, n))
    se, sw = flat_e.gather(1, order), flat_w.gather(1, order)
    # rank within expert segment
    starts = torch.searchsorted(
        se, torch.arange(E, device=dev).expand(G, E).contiguous())
    rank = ar - starts.gather(1, se)
    keep = rank < C
    base = (torch.arange(G, device=dev) * (E * C))[:, None]
    slot = (base + se * C + torch.clamp(rank, max=C - 1)).reshape(-1)
    # row g * n + j: token j // k of group g, then the group's sort
    src = ((torch.arange(G, device=dev) * S)[:, None] + order // k).reshape(-1)

    # ---- gather tokens into the expert buffer [G*E*C, d] ----
    rows = xg.reshape(G * S, d)[src] * keep.reshape(-1, 1).to(xg.dtype)
    buf = torch.zeros((G * E * C, d), dtype=xg.dtype, device=dev)
    buf = buf.index_add(0, slot, rows)
    # expert-major for the products: [E, G*C, d] (a view when G is 1)
    buf = buf.reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    # expert-parallel: this rank's experts [e0, e0 + El) of the buffer,
    # and zeros for the other ranks' outputs.  The dispatch and the
    # combine keep the layout over all E experts, so their scatters
    # collide no more than the unsharded ones
    El = params["w_gate"].shape[0]
    e0 = tp.rank * El if El != E else 0
    if El != E:
        buf = buf[e0:e0 + El].clone()

    # ---- per-expert SwiGLU: batched matmuls [E,G*C,d] x [E,d,f] ----
    g = F.silu(torch.bmm(buf, params["w_gate"]))
    u = torch.bmm(buf, params["w_up"])
    yb = torch.bmm(g * u, params["w_down"])
    if El != E:
        yb = F.pad(yb, (0, 0, 0, 0, e0, E - e0 - El))
    yb = yb.reshape(E, G, C, d).transpose(0, 1).reshape(G * E * C, d)

    # ---- combine back to tokens ----
    contrib = yb[slot] * (sw * keep.float()).reshape(-1, 1).to(xg.dtype)
    flat_inv = ((torch.arange(G, device=dev) * n)[:, None] + inv).reshape(-1)
    y = contrib[flat_inv].reshape(G, S, k, d).sum(dim=2)
    if split:
        y = reduce_from_model(tp, y, "moe")

    # ---- router losses (per group; averaged by the caller) ----
    probs, logits = probs.reshape(G, S, E), logits.reshape(G, S, E)
    me = torch.mean(probs, dim=1)                                 # [G, E]
    one_hot = ops.one_hot(top_e.long(), E).reshape(G, S, k, E)
    ce = torch.mean(torch.sum(one_hot, dim=2), dim=1) / k         # [G, E]
    aux = E * torch.sum(me * ce, dim=-1)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)), dim=1)
    return y, aux, z, ce


def moe_apply(params, mcfg: MoEConfig, x, group_size=None, tp=None):
    """Apply the MoE block.  x: [..., d] -> (y, metrics).

    Tokens are dispatched in GROUPS of ``group_size`` (default
    ``mcfg.group_size``; per-group capacity); the last group is
    zero-padded, and its pad tokens are routed like any token, as in the
    JAX package.  ``group_size=1`` routes every token alone, which is
    what the JAX serving runtime's ``vmap`` over slots does.  metrics =
    {'aux_loss', 'z_loss', 'load'}; the caller adds
    ``aux_weight * aux_loss + router_z_weight * z_loss`` to its loss.
    ``tp`` splits the experts over a ``model`` axis (see
    :func:`_dispatch_groups`).
    """
    orig_shape = x.shape
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    T = x2.shape[0]
    gs = min(mcfg.group_size if group_size is None else group_size, T)
    n_pad = (-T) % gs
    if n_pad:
        x2 = F.pad(x2, (0, 0, 0, n_pad))
    y, aux, z, ce = _dispatch_groups(params, mcfg, x2.reshape(-1, gs, d),
                                     tp)
    metrics = {"aux_loss": aux.mean(), "z_loss": z.mean(),
               "load": ce.mean(0)}
    return y.reshape(-1, d)[:T].reshape(orig_shape), metrics
