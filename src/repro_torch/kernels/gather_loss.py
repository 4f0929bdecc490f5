"""Fused resample gather + linear-head cross-entropy, one loss per row.

Port of ``repro/kernels/gather_loss.py``.  On CUDA tensors the wrapper
launches the hand-written kernel in ``csrc/gather_loss.cu``; on CPU
tensors it runs the plain version, ``ref.gather_loss_microbatch_ref``.
"""
from __future__ import annotations

from ctypes import c_int, c_int64, c_void_p
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

launches = 0          # kernel launches since the last reset

_ARGTYPES = [c_void_p] * 6 + [c_int64] * 3 + [c_int] * 4 + [c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LABELS = {torch.int32: 4, torch.int64: 8}


def gather_loss_microbatch(src, labels, idx, w,
                           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[i] = xent(src[idx[i]] @ w (+ b), labels[idx[i]])``.

    src [T, D] float32 or bfloat16, labels [T] int32 or int64, idx [M]
    int32, w [D, K] float32 or bfloat16, b [K] float32 or None -> [M]
    float32.  On the card an index or label out of range gives NaN.
    """
    if src.dim() != 2 or labels.shape != src.shape[:1] or idx.dim() != 1:
        raise ValueError(f"expected src [T, D], labels [T], idx [M]; got "
                         f"{tuple(src.shape)}, {tuple(labels.shape)}, "
                         f"{tuple(idx.shape)}")
    if w.dim() != 2 or w.shape[0] != src.shape[1]:
        raise ValueError(f"w must be [D={src.shape[1]}, K], got "
                         f"{tuple(w.shape)}")
    K = w.shape[1]
    if b is not None and (b.shape != (K,) or b.dtype != torch.float32):
        raise ValueError(f"b must be float32 [K={K}]")
    if (src.dtype not in _DTYPES or w.dtype not in _DTYPES
            or labels.dtype not in _LABELS or idx.dtype != torch.int32):
        raise TypeError(f"unsupported dtypes: src {src.dtype}, w {w.dtype}, "
                        f"labels {labels.dtype}, idx {idx.dtype}")
    ts = [t for t in (src, labels, idx, w, b) if t is not None]
    if len({t.device for t in ts}) != 1:
        raise ValueError("src, labels, idx, w and b must lie on one device")
    if src.device.type == "cpu":
        return ref.gather_loss_microbatch_ref(src, labels, idx, w, b)
    if src.device.type != "cuda":
        raise ValueError(f"no gather_loss kernel for {src.device}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("gather_loss needs contiguous operands")
    if not 0 < K <= 8192:
        raise ValueError(f"gather_loss takes 1 to 8192 classes, got {K}")
    T, D = src.shape
    M = idx.shape[0]
    out = torch.empty((M,), dtype=torch.float32, device=src.device)
    if M == 0:
        return out
    fn = _build.entry("gather_loss", _ARGTYPES)
    global launches
    launches += 1
    _build.check(fn(src.data_ptr(), labels.data_ptr(), idx.data_ptr(),
                    w.data_ptr(), None if b is None else b.data_ptr(),
                    out.data_ptr(), T, M, D, K, _DTYPES[src.dtype],
                    _DTYPES[w.dtype], _LABELS[labels.dtype],
                    _build.stream_of(src)),
                 "gather_loss")
    return out
