"""Fused resample gather + linear-head cross-entropy, one loss per row.

Port of ``repro/kernels/gather_loss.py``.  On CUDA tensors the wrapper
launches the hand-written kernel in ``csrc/gather_loss.cu``; on CPU
or ``meta`` tensors it runs the plain version,
``ref.gather_loss_microbatch_ref``.
"""
from __future__ import annotations

from ctypes import c_int, c_int64, c_void_p
from typing import Callable, Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._count import (PLAIN_DEVICES, counted,
                                        kernel_layout)

launches = 0          # kernel launches since the last reset

_ARGTYPES = [c_void_p] * 6 + [c_int64] * 3 + [c_int] * 9 + [c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LABELS = {torch.int32: 4, torch.int64: 8}
ROW_TILE, D_CHUNK, MAX_CLUSTER = 32, 128, 8    # the kernel's tiles


def class_tile(K: int) -> int:
    """The kernel's class tile for K classes: 16, 32 or 64, the smallest
    that holds K, at most 64."""
    k_tile = 16
    while k_tile < min(K, 64):
        k_tile *= 2
    return k_tile


def launch_shape(M: int, D: int, K: int, sms: int,
                 max_clusters: Optional[Callable[[int], int]] = None) -> dict:
    """How the kernel covers an [M] x [D, K] call on a card of ``sms``
    SMs (one block of 8 warps an SM): row tiles of 32 gathered rows; a
    class tile of 16, 32 or 64 (the smallest that holds K, at most 64,
    walked in turn past that); and a cluster of 1 to 8 blocks that split
    D, doubled while the blocks still fit the SMs, every block keeps a
    128-wide chunk of D and, where ``max_clusters(c)`` says how many
    clusters of c blocks the card holds at once, the launch stays one
    wave."""
    k_tile = class_tile(K)
    tiles = -(-M // ROW_TILE)
    chunks = -(-D // D_CHUNK)
    cluster = 1
    while (cluster < MAX_CLUSTER and cluster * 2 <= chunks
           and tiles * cluster * 2 <= sms
           and (max_clusters is None or tiles <= max_clusters(cluster * 2))):
        cluster *= 2
    return {"row_tiles": tiles, "k_tile": k_tile, "cluster": cluster}


def copy_bytes(t: torch.Tensor) -> int:
    """Bytes of one copy of a row of ``t`` [rows, n] into shared memory:
    16, 8 or 4 where the base and the row length allow (no copy then
    straddles a row's end), else 2 (bfloat16 rows of odd length)."""
    row = t.shape[1] * t.element_size()
    for c in (16, 8, 4):
        if t.data_ptr() % c == 0 and row % c == 0:
            return c
    return 2


_SMS: dict = {}          # card index -> its SM count
_CLUSTERS: dict = {}     # (card, src, w, k_tile, cluster) -> clusters at once


def card_shape(src: torch.Tensor, w: torch.Tensor, M: int) -> dict:
    """``launch_shape`` on the card that holds ``src`` [T, D] and ``w``
    [D, K], with its SM count and its answer to how many clusters of c
    blocks it holds at once (asked once per kernel instance and c)."""
    card = src.device.index
    if card not in _SMS:
        _SMS[card] = torch.cuda.get_device_properties(
            card).multi_processor_count
    K = w.shape[1]
    key = (card, _DTYPES[src.dtype], _DTYPES[w.dtype], class_tile(K))
    fn = _build.entry("gather_loss_max_clusters", [c_int] * 4,
                      source="gather_loss")

    def max_clusters(c: int) -> int:
        if key + (c,) not in _CLUSTERS:
            n = fn(*key[1:], c)
            if n < 0:
                raise RuntimeError("gather_loss: the occupancy query failed")
            _CLUSTERS[key + (c,)] = n
        return _CLUSTERS[key + (c,)]
    return launch_shape(M, src.shape[1], K, _SMS[card], max_clusters)


@counted("gather_loss")
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
    if src.device.type in PLAIN_DEVICES:
        return kernel_layout(ref.gather_loss_microbatch_ref(src, labels,
                                                            idx, w, b))
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
    shape = card_shape(src, w, M)
    fn = _build.entry("gather_loss", _ARGTYPES)
    global launches
    launches += 1
    _build.check(fn(src.data_ptr(), labels.data_ptr(), idx.data_ptr(),
                    w.data_ptr(), None if b is None else b.data_ptr(),
                    out.data_ptr(), T, M, D, K, _DTYPES[src.dtype],
                    _DTYPES[w.dtype], _LABELS[labels.dtype], shape["k_tile"],
                    shape["cluster"], copy_bytes(src), copy_bytes(w),
                    int(w.data_ptr() % 16 == 0), _build.stream_of(src)),
                 "gather_loss")
    return out
