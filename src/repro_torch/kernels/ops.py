"""Public entry points over the kernels, mirroring ``repro/kernels/ops.py``.

Every function here takes its kernel on CUDA tensors and the kernel's
plain version on CPU tensors; the choice follows the tensors' device
and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import feature_resample as _fr
from repro_torch.kernels import gather_loss as _gl
from repro_torch.kernels.fused_adam import fused_adam  # noqa: F401 (public)


def resample_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``out[i] = src[idx[i]]`` for any trailing shape: rows
    are flattened to 2-D for the ``feature_resample`` kernel and the
    trailing shape is restored."""
    flat = src.reshape(src.shape[0], -1)
    out = _fr.feature_resample(flat, idx)
    return out.reshape((idx.shape[0],) + tuple(src.shape[1:]))


def gather_loss_microbatch(src, labels, idx, w, b=None) -> torch.Tensor:
    """Per-row fused gather + linear-head cross-entropy (rows flattened
    like the head's ``x.reshape(B, -1)``).  src [T, ...], labels [T],
    idx [M], w [prod(...), K] -> [M] float32."""
    return _gl.gather_loss_microbatch(src.reshape(src.shape[0], -1), labels,
                                      idx, w, b)


class _FusedGatherLossMean(torch.autograd.Function):
    """Mean fused gather + loss, differentiable in ``w`` only: the pooled
    features are data to the server (paper Eq. 3)."""

    @staticmethod
    def forward(ctx, src, labels, idx, w):
        ctx.save_for_backward(src, labels, idx, w)
        return torch.mean(gather_loss_microbatch(src, labels, idx, w))

    @staticmethod
    def backward(ctx, g):
        # the analytic linear-head xent VJP, dw = f^T (softmax - onehot) g / M,
        # over a re-gather of the M rows (M << T), in plain torch as the
        # JAX package computes it in jnp outside its kernel
        src, labels, idx, w = ctx.saved_tensors
        f = torch.index_select(src.reshape(src.shape[0], -1), 0, idx).float()
        logits = f @ w.float()
        y = torch.index_select(labels, 0, idx).long()
        p = torch.softmax(logits, dim=-1)
        onehot = torch.nn.functional.one_hot(y, w.shape[1]).float()
        dlogits = (p - onehot) * (g / idx.shape[0])
        return None, None, None, (f.T @ dlogits).to(w.dtype)


def fused_gather_loss_mean(src, labels, idx, w) -> torch.Tensor:
    """Mean over one microbatch of ``gather_loss_microbatch``; its
    gradient reaches ``w`` alone."""
    return _FusedGatherLossMean.apply(src, labels, idx, w)
