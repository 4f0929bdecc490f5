"""MoE router gating: softmax, top-k by rounds of argmax, renormalize.

Port of ``repro/kernels/topk_gating.py``.  On CUDA tensors the wrapper
launches the hand-written kernel in ``csrc/topk_gating.cu``; on CPU
or ``meta`` tensors it runs the plain version, ``ref.topk_gating_ref``.
``ops.topk_gating`` is the differentiable entry point.
"""
from __future__ import annotations

from ctypes import c_int, c_int64, c_void_p

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._count import (PLAIN_DEVICES, counted,
                                        kernel_layout)

launches = 0          # kernel launches since the last reset

_ARGTYPES = [c_void_p] * 3 + [c_int64] + [c_int] * 5 + [c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_EXPERTS = 256
EXPERTS_PER_LANE = 8      # the kernel's registers a lane


def lanes_per_row(E: int) -> int:
    """The lanes of a warp that hold one row of E logits: the power of
    two that gives each lane at most 8 experts (E = 64: 8 lanes, 4 rows
    a warp; E <= 8: 1 lane, 32 rows a warp)."""
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"topk_gating holds 1 to {MAX_EXPERTS} experts a "
                         f"row, got {E}")
    lanes = 1
    while lanes * EXPERTS_PER_LANE < E:
        lanes *= 2
    return lanes


@counted("topk_gating")
def topk_gating(logits: torch.Tensor, k: int):
    """logits [T, E] -> (weights [T, k] float32, ids [T, k] int32): the
    k largest softmax probabilities of each row (a tie goes to the lower
    expert index), renormalized by max(sum, 1e-9).  Any T."""
    if logits.dim() != 2:
        raise ValueError(f"expected logits [T, E], got {tuple(logits.shape)}")
    T, E = logits.shape
    if not 1 <= k <= E:
        raise ValueError(f"k must lie in [1, E={E}], got {k}")
    if logits.device.type in PLAIN_DEVICES:
        return kernel_layout(ref.topk_gating_ref(logits, k))
    if logits.device.type != "cuda":
        raise ValueError(f"no topk_gating kernel for {logits.device}")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"topk_gating takes float32 or bfloat16 logits, got "
                        f"{logits.dtype}")
    if E > MAX_EXPERTS:
        raise ValueError(f"topk_gating holds at most {MAX_EXPERTS} experts "
                         f"a row, got {E}")
    if not logits.is_contiguous():
        raise ValueError("topk_gating needs contiguous logits")
    w = torch.empty((T, k), dtype=torch.float32, device=logits.device)
    ids = torch.empty((T, k), dtype=torch.int32, device=logits.device)
    if T == 0:
        return w, ids
    # each lane's experts load as 4-element vectors when rows and base allow
    vec = E % 4 == 0 and logits.data_ptr() % 16 == 0
    fn = _build.entry("topk_gating", _ARGTYPES)
    global launches
    launches += 1
    _build.check(fn(logits.data_ptr(), w.data_ptr(), ids.data_ptr(), T, E, k,
                    _DTYPES[logits.dtype], lanes_per_row(E), int(vec),
                    _build.stream_of(logits)),
                 "topk_gating")
    return w, ids
