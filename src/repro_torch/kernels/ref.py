"""Plain PyTorch versions of the ported kernels (the correctness contract).

Each mirrors the JAX package's oracle of the same name.  The kernel
wrappers run these for tensors on the CPU; on the card they are used
only to check the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch


def feature_resample_ref(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather: out[i] = src[idx[i]].  src [T, D], idx [M] -> [M, D]."""
    return torch.index_select(src, 0, idx)


def gather_loss_microbatch_ref(src, labels, idx, w,
                               b: Optional[torch.Tensor] = None):
    """Fused gather + linear-head cross-entropy (float32 math).

    ``out[i] = xent(src[idx[i]] @ w (+ b), labels[idx[i]])``: src [T, D],
    labels [T] int, idx [M], w [D, K], b [K] or None -> [M] float32.
    """
    f = torch.index_select(src, 0, idx).float()
    logits = f @ w.float()
    if b is not None:
        logits = logits + b.float()
    ll = torch.log_softmax(logits, dim=-1)
    y = torch.index_select(labels, 0, idx).long()
    return -torch.take_along_dim(ll, y[:, None], dim=1)[:, 0]


def fused_adam_ref(p, g, m, v, step, *, lr, b1=0.9, b2=0.999, eps=1e-8,
                   weight_decay=0.0):
    """One Adam step, bias-corrected at t = step + 1 in float32.

    ``step`` is an int tensor: a scalar, or one count per entity when the
    leaves are stacked [C, ...] (each row is corrected with its own t).
    Returns (p', m', v') and leaves the inputs untouched.
    """
    t = step.float() + 1.0
    t = t.reshape(t.shape + (1,) * (p.dim() - t.dim()))
    gf = g.float()
    m2 = b1 * m + (1 - b1) * gf
    v2 = b2 * v + (1 - b2) * gf * gf
    mh = m2 / (1 - torch.pow(b1, t))
    vh = v2 / (1 - torch.pow(b2, t))
    upd = -lr * mh / (torch.sqrt(vh) + eps)
    if weight_decay:
        upd = upd - lr * weight_decay * p.float()
    return (p.float() + upd).to(p.dtype), m2, v2
