"""Full-sequence attention with an online softmax (forward).

Port of ``repro/kernels/flash_attention.py``.  On CUDA tensors the
wrapper launches the hand-written kernel in ``csrc/flash_attention.cu``;
on CPU tensors it runs the plain version, ``ref.flash_attention_ref``.
``ops.flash_attention`` is the differentiable entry point.
"""
from __future__ import annotations

from ctypes import c_double, c_int, c_int64, c_void_p
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

launches = 0          # kernel launches since the last reset

_ARGTYPES = ([c_void_p] * 4 + [c_int] * 6 + [c_int64] * 9
             + [c_int, c_int, c_double, c_int, c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Sk, Hkv, D] -> [B, Sq, H, D] in q's
    dtype.  Query head h reads kv head h // (H / Hkv); the mask is by
    index: causal keeps key j <= query i, the window keeps i - j <
    window; softcap is c * tanh(s / c) after the 1/sqrt(D) scale."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B, Sq, H, D] and k, v [B, Sk, Hkv, "
                         f"D], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"match (batch, head dim, H % Hkv == 0)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v must lie on one device")
    if Sk == 0:
        raise ValueError("attention over zero keys")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} has no kernel instance "
                         f"({HEAD_DIMS})")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs unit stride in the head dim")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _build.entry("flash_attention", _ARGTYPES)
    global launches
    launches += 1
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, Sq, Sk, H, Hkv, D,
                    q.stride(0), q.stride(1), q.stride(2),
                    k.stride(0), k.stride(1), k.stride(2),
                    v.stride(0), v.stride(1), v.stride(2),
                    int(causal), window or 0, softcap or 0.0,
                    _DTYPES[q.dtype], _build.stream_of(q)),
                 "flash_attention")
    return out
