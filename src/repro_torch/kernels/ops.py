"""Public entry points over the kernels, mirroring ``repro/kernels/ops.py``.

Every function here takes its kernel on CUDA tensors and the kernel's
plain version on CPU and ``meta`` tensors; the choice follows the
tensors' device and nothing else.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import feature_resample as _fr
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gather_loss as _gl
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import topk_gating as _tk
from repro_torch.kernels.fused_adam import (  # noqa: F401 (public)
    fused_adam, fused_adam_)


def resample_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``out[i] = src[idx[i]]`` for any trailing shape: rows
    are flattened to 2-D for the ``feature_resample`` kernel and the
    trailing shape is restored."""
    flat = src.reshape(src.shape[0], -1)
    out = _fr.feature_resample(flat, idx)
    return out.reshape((idx.shape[0],) + tuple(src.shape[1:]))


def one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot rows of ``ids`` over ``n`` classes, by one
    comparison against ``arange(n)``: the same ops on every device
    (``F.one_hot`` reads its input back to check it on the CPU alone and
    takes another path on ``meta``), so a work count sees one step on
    each."""
    return (ids.unsqueeze(-1) == torch.arange(n, device=ids.device)).float()


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
        onehot = one_hot(y, w.shape[1])
        dlogits = (p - onehot) * (g / idx.shape[0])
        return None, None, None, (f.T @ dlogits).to(w.dtype)


def fused_gather_loss_mean(src, labels, idx, w) -> torch.Tensor:
    """Mean over one microbatch of ``gather_loss_microbatch``; its
    gradient reaches ``w`` alone."""
    return _FusedGatherLossMean.apply(src, labels, idx, w)


class _FlashAttention(torch.autograd.Function):
    """Attention whose forward is the ``flash_attention`` kernel (its
    plain version on the CPU) and whose backward recomputes the plain
    version under autograd, one query chunk of ``ref.query_chunks`` at a
    time (the JAX package has no kernel backward and differentiates its
    einsum attention the same way, checkpointed per chunk)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, softcap)
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        causal, window, cap = ctx.opts
        q_pos = torch.arange(q.shape[1], device=q.device)[None]
        k_pos = torch.arange(k.shape[1], device=q.device)[None]
        kd = k.detach().requires_grad_(True)
        vd = v.detach().requires_grad_(True)
        dq, dk, dv = [], None, None
        for lo, hi, bias in ref.query_chunks(q_pos, k_pos, window, causal):
            qd = q[:, lo:hi].detach().requires_grad_(True)
            with torch.enable_grad():
                out = ref.sdpa(qd, kd, vd, bias, cap)
                dqc, dkc, dvc = torch.autograd.grad(out, (qd, kd, vd),
                                                    g[:, lo:hi])
            dq.append(dqc)
            # float32 sums across chunks, cast once
            dk = dkc.float() if dk is None else dk + dkc.float()
            dv = dvc.float() if dv is None else dv + dvc.float()
        return (torch.cat(dq, dim=1), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Differentiable full-sequence attention (see
    ``kernels.flash_attention.flash_attention`` for the function)."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap)


class _TopkGating(torch.autograd.Function):
    """Router gating whose forward is the ``topk_gating`` kernel (its
    plain version on the CPU).  The weights' backward recomputes
    ``softmax(logits)`` gathered at the saved ids and the
    renormalization under autograd: exactly what autodiff of
    ``lax.top_k`` gives in the JAX package."""

    @staticmethod
    def forward(ctx, logits, k):
        w, ids = _tk.topk_gating(logits, k)
        ctx.save_for_backward(logits, ids)
        ctx.mark_non_differentiable(ids)
        return w, ids

    @staticmethod
    def backward(ctx, gw, _gids):
        logits, ids = ctx.saved_tensors
        x = logits.detach().requires_grad_(True)
        with torch.enable_grad():
            top = torch.gather(torch.softmax(x.float(), dim=-1), -1,
                               ids.long())
            w = top / torch.clamp(top.sum(-1, keepdim=True), min=1e-9)
            (dx,) = torch.autograd.grad(w, x, gw)
        return dx, None


def topk_gating(logits, k: int):
    """Differentiable router gating: (weights [T, k] float32, ids [T, k]
    int32) of ``kernels.topk_gating.topk_gating``; ids carry no
    gradient."""
    return _TopkGating.apply(logits, k)


class _SSDScan(torch.autograd.Function):
    """The SSD scan whose forward is the ``ssd_scan`` kernel (its plain
    version on the CPU) and whose backward recomputes that plain version,
    ``ref.ssd_chunked``, under autograd (the JAX package has no kernel
    backward and differentiates ``ssd_chunked`` the same way).  The one
    difference that remains from the JAX package's remat: its
    ``mamba2.py:50`` checkpoints each SSD chunk, so its backward holds
    one chunk's intermediates at a time, where this recompute runs every
    chunk at once, folded into the batch, from the states entering the
    chunks; their float32 [B * L / Q, Q, Q, H] tensors are 268 MB each
    at zamba2-1.2b's B 2, L 2048, Q 256, H 64, some 1.6 GB for the few
    that autograd keeps while one block's backward runs; a loop over
    chunks would keep an eighth of that but launch eight times the
    kernels.  (The block around the scan is itself rematerialised, as a
    group of ``models.transformer``.)  The final state carries no
    gradient."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        y, h = _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(h)
        return y, h

    @staticmethod
    def backward(ctx, gy, _gh):
        leaves = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, _ = ref.ssd_chunked(*leaves, ctx.chunk)
            grads = torch.autograd.grad(y, leaves, gy)
        return (*grads, None)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int):
    """Differentiable SSD scan: (y [B, L, H, P] in x's dtype, final
    state h [B, H, N, P] float32 without gradient) of
    ``kernels.ssd_scan.ssd_scan``; gradients reach x, dt, A, B and C."""
    return _SSDScan.apply(x, dt, A, Bm, Cm, chunk)
