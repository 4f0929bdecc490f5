"""Mamba-2 SSD chunked scan (forward).

Port of ``repro/kernels/ssd_scan.py``.  On CUDA tensors the wrapper
launches one of the two hand-written kernels in ``csrc/ssd_scan.cu``, as
``design`` routes the call: bf16 at state size 64 or 128 and head dim 64
on the tensor cores (``wgmma``, split-bf16 products), everything else on
the CUDA cores (``simt``, float32 products).  On CPU or ``meta``
tensors it runs the plain version, ``ref.ssd_chunked``.  ``ops.ssd_scan`` is the
differentiable entry point.
"""
from __future__ import annotations

from ctypes import POINTER, byref, c_int, c_int64, c_void_p

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._count import (PLAIN_DEVICES, counted,
                                        kernel_layout)

launches = 0          # kernel launches since the last reset
design_launches = {"wgmma": 0, "simt": 0}    # the same, by design

_ARGTYPES = ([c_void_p] * 7 + [c_int] * 6 + [c_int64] * 12
             + [c_int, c_int, c_int, c_void_p, c_void_p])
_SEGMENTS_ARGTYPES = [c_int] * 5 + [POINTER(c_int)]
_segments: dict = {}   # (device, B, L, H, N, P) -> wgmma segment count
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DESIGNS = {"simt": 0, "wgmma": 1}
MAX_STATE = 128       # the kernels' shared memory holds N <= 128
WGMMA_SHAPES = ((64, 64), (128, 64))    # (N, P) of the tensor-core kernel


def design(dtype: torch.dtype, N: int, P: int) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` (products on the tensor
    cores, float32 operands as bf16 hi/lo pairs) for bf16 at (N, P) in
    ``WGMMA_SHAPES``, the paths' shapes; ``"simt"`` (float32 products on
    the CUDA cores) for float32, whose checks hold the kernel to full
    float32 products, and for bf16 at any other shape.  Raises for a
    dtype or state size that has no kernel."""
    if dtype not in _DTYPES:
        raise TypeError(f"ssd_scan takes float32 or bfloat16, got {dtype}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"state size {N} has no kernel instance "
                         f"(1..{MAX_STATE})")
    if dtype == torch.bfloat16 and (N, P) in WGMMA_SHAPES:
        return "wgmma"
    return "simt"


def check_wgmma_layout(name: str, t: torch.Tensor) -> None:
    """The wgmma kernel copies rows of x, B and C in 16-byte pieces:
    raise ValueError unless ``t``'s base is 16-byte aligned and its
    [B, L, *] strides are multiples of 16 bytes."""
    _build.check_16b_rows("ssd_scan", name, t, "[B, L, *]")


def segments(device: torch.device, Bsz: int, L: int, H: int, N: int,
             P: int) -> int:
    """How many sequence segments the wgmma design runs a [Bsz, L, H]
    scan in on ``device``: enough (head, batch, segment) blocks to fill
    the card at once, each segment's starting state from a states-only
    pass.  Asked of the kernel library once per shape."""
    key = (device.index, Bsz, L, H, N, P)
    if key not in _segments:
        fn = _build.entry("ssd_scan_segments", _SEGMENTS_ARGTYPES,
                          source="ssd_scan")
        out = c_int(0)
        _build.check(fn(Bsz, L, H, N, P, byref(out)), "ssd_scan_segments")
        _segments[key] = out.value
    return _segments[key]


@counted("ssd_scan")
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
    if x.device.type in PLAIN_DEVICES:
        return kernel_layout(ref.ssd_chunked(x, dt, A, Bm, Cm, chunk))
    if x.device.type != "cuda":
        raise ValueError(f"no ssd_scan kernel for {x.device}")
    if x.dtype not in _DTYPES or not (x.dtype == Bm.dtype == Cm.dtype):
        raise TypeError(f"ssd_scan takes x, B and C of one dtype, float32 "
                        f"or bfloat16, got {x.dtype}, {Bm.dtype}, "
                        f"{Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan takes float32 dt and A, got {dt.dtype}, "
                        f"{A.dtype}")
    kind = design(x.dtype, N, P)
    if any(t.stride(3) != 1 for t in (x, Bm, Cm)):
        raise ValueError("ssd_scan needs unit stride in the last dim of x, "
                         "B and C")
    if kind == "wgmma":
        for name, t in (("x", x), ("B", Bm), ("C", Cm)):
            check_wgmma_layout(name, t)
    y = torch.empty((Bsz, L, H, P), dtype=x.dtype, device=x.device)
    h = torch.empty((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, h.zero_()
    A = A.contiguous()
    fn = _build.entry("ssd_scan", _ARGTYPES)
    count, ws = 1, None
    if kind == "wgmma":
        count = segments(x.device, Bsz, L, H, N, P)
        if count > 1:
            ws = torch.empty((count - 1) * Bsz * H * (N * P + 1),
                             dtype=torch.float32, device=x.device)
    global launches
    launches += 1
    design_launches[kind] += 1
    _build.check(fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                    Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), h.data_ptr(),
                    Bsz, L, H, G, P, N,
                    x.stride(0), x.stride(1), x.stride(2),
                    dt.stride(0), dt.stride(1), dt.stride(2),
                    Bm.stride(0), Bm.stride(1), Bm.stride(2),
                    Cm.stride(0), Cm.stride(1), Cm.stride(2),
                    _DTYPES[x.dtype], _DESIGNS[kind], count,
                    None if ws is None else ws.data_ptr(),
                    _build.stream_of(x)),
                 "ssd_scan")
    return y, h
