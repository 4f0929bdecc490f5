"""Row gather ``out[i] = src[idx[i]]``: the server's resample (Eq. 3).

Port of ``repro/kernels/feature_resample.py``.  On a CUDA tensor the
wrapper launches the hand-written kernel in ``csrc/feature_resample.cu``;
on a CPU or ``meta`` tensor it runs the plain version,
``ref.feature_resample_ref``.
"""
from __future__ import annotations

from ctypes import c_int64, c_void_p

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._count import (PLAIN_DEVICES, counted,
                                        kernel_layout)

launches = 0          # kernel launches since the last reset

_ARGTYPES = [c_void_p, c_void_p, c_void_p, c_int64, c_int64, c_int64,
             c_void_p]


@counted("feature_resample")
def feature_resample(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = src[idx[i]].  src [T, D] of any dtype, idx [M] int32 ->
    [M, D].  An index outside [0, T) gives a zero row on the card."""
    if src.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"expected src [T, D] and idx [M], got "
                         f"{tuple(src.shape)} and {tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if src.device != idx.device:
        raise ValueError(f"src on {src.device} but idx on {idx.device}")
    if src.device.type in PLAIN_DEVICES:
        return kernel_layout(ref.feature_resample_ref(src, idx))
    if src.device.type != "cuda":
        raise ValueError(f"no feature_resample kernel for {src.device}")
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError("feature_resample needs contiguous src and idx")
    T, D = src.shape
    M = idx.shape[0]
    out = torch.empty((M, D), dtype=src.dtype, device=src.device)
    if M == 0 or D == 0:
        return out
    fn = _build.entry("feature_resample", _ARGTYPES)
    global launches
    launches += 1
    _build.check(fn(src.data_ptr(), idx.data_ptr(), out.data_ptr(), T, M,
                    D * src.element_size(), _build.stream_of(src)),
                 "feature_resample")
    return out
