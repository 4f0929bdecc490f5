"""Mamba-2 SSD chunked scan (forward).

Port of ``repro/kernels/ssd_scan.py``.  On CUDA tensors the wrapper
launches the hand-written kernel in ``csrc/ssd_scan.cu``; on CPU tensors
it runs the plain version, ``ref.ssd_chunked``.  ``ops.ssd_scan`` is the
differentiable entry point.
"""
from __future__ import annotations

from ctypes import c_int, c_int64, c_void_p

import torch

from repro_torch.kernels import _build, ref

launches = 0          # kernel launches since the last reset

_ARGTYPES = [c_void_p] * 7 + [c_int] * 6 + [c_int64] * 12 + [c_int, c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 128       # the kernel's shared memory holds N <= 128


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int):
    """The SSD scan of ``ref.ssd_chunked``: x [B, L, H, P], dt [B, L, H],
    A [H], B/C [B, L, G, N] with head h reading group h // (H / G) ->
    (y [B, L, H, P] in x's dtype, final state h [B, H, N, P] float32).
    L % chunk == 0; the chunk sets where the plain version rounds, not
    the function."""
    ref.check_ssd(x, dt, A, Bm, Cm)
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if chunk < 1 or L % chunk:
        raise ValueError(f"L={L} not divisible by chunk={chunk}")
    if len({x.device, dt.device, A.device, Bm.device, Cm.device}) != 1:
        raise ValueError("x, dt, A, B and C must lie on one device")
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dt, A, Bm, Cm, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no ssd_scan kernel for {x.device}")
    if x.dtype not in _DTYPES or not (x.dtype == Bm.dtype == Cm.dtype):
        raise TypeError(f"ssd_scan takes x, B and C of one dtype, float32 "
                        f"or bfloat16, got {x.dtype}, {Bm.dtype}, "
                        f"{Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan takes float32 dt and A, got {dt.dtype}, "
                        f"{A.dtype}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"state size {N} has no kernel instance "
                         f"(1..{MAX_STATE})")
    if any(t.stride(3) != 1 for t in (x, Bm, Cm)):
        raise ValueError("ssd_scan needs unit stride in the last dim of x, "
                         "B and C")
    y = torch.empty((Bsz, L, H, P), dtype=x.dtype, device=x.device)
    h = torch.empty((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, h.zero_()
    A = A.contiguous()
    fn = _build.entry("ssd_scan", _ARGTYPES)
    global launches
    launches += 1
    _build.check(fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                    Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), h.data_ptr(),
                    Bsz, L, H, G, P, N,
                    x.stride(0), x.stride(1), x.stride(2),
                    dt.stride(0), dt.stride(1), dt.stride(2),
                    Bm.stride(0), Bm.stride(1), Bm.stride(2),
                    Cm.stride(0), Cm.stride(1), Cm.stride(2),
                    _DTYPES[x.dtype], _build.stream_of(x)),
                 "ssd_scan")
    return y, h
