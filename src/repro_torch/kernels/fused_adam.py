"""One fused Adam step over one leaf.

Port of ``repro/kernels/fused_adam.py``.  Two entries: ``fused_adam``
returns new (p, m, v), and ``fused_adam_`` updates them in place (the
donated step: no second copy of the state, and a masked no-op step
skips an entity in the kernel instead of selecting against a kept
copy).  On CUDA tensors each launches its hand-written kernel in
``csrc/fused_adam.cu``; on CPU or ``meta`` tensors it runs the plain
version, ``ref.fused_adam_ref`` or ``ref.fused_adam_ref_``.

Both entries launch one kernel body with a plan made here
(:func:`plan`): a block takes a tile of 256 16-byte vectors of one
entity's row, and the elements of a row before its first vector and
after its last are stepped one at a time.  Where the operands lie on
16 bytes at no common element, the whole leaf takes the kernel's scalar
path.
"""
from __future__ import annotations

from ctypes import c_double, c_int, c_int64, c_void_p
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._count import (PLAIN_DEVICES, counted,
                                        kernel_layout)

launches = 0          # kernel launches since the last reset, both entries
design_launches = {"copy": 0, "inplace": 0}   # the same, by entry

# n, n_per_entity, dtype, and the plan's phase and tiles
_LEAF_ARGTYPES = [c_int64, c_int64, c_int, c_int, c_int64]
_ARGTYPES = [c_void_p] * 8 + _LEAF_ARGTYPES + [c_double] * 5 + [c_void_p]
_INPLACE_ARGTYPES = [c_void_p] * 6 + _LEAF_ARGTYPES + [c_double] * 5 + [
    c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's constants (csrc/fused_adam.cu: kThreads, Width<P>): p's
# elements in 16 bytes, and the vectors a thread issues at once
THREADS = 256
VEC = {torch.float32: 4, torch.bfloat16: 8}
UNROLL = {torch.float32: 1, torch.bfloat16: 1}


class Plan(NamedTuple):
    """How one launch covers a leaf of ``rows`` entities of
    ``n_per_entity`` elements: block (x, y) takes tile x of row y (and of
    rows y + 65535, ...).  ``phase`` is the first element, counted from
    the leaf's start, at which every operand lies on 16 bytes, or -1:
    then every element takes the scalar path."""
    phase: int
    tiles: int          # blocks along a row
    rows: int
    n_per_entity: int
    vec: int            # elements a vector
    tile: int           # elements a block takes of its row


def plan(spans, dtype, n: int, rows: int) -> Plan:
    """The launch plan of a leaf of ``n`` elements of ``dtype`` over
    ``rows`` entities, whose operands (read and written) start at the
    ``(address, element size)`` pairs ``spans``."""
    vec = VEC[dtype]
    tile = THREADS * UNROLL[dtype] * vec
    npe = n // rows
    phase = next((k for k in range(vec)
                   if all((a + k * s) % 16 == 0 for a, s in spans)), -1)
    return Plan(phase, -(-npe // tile), rows, npe, vec, tile)


def plan_of(tensors, rows: int) -> Plan:
    """:func:`plan` for these operands (p first), over ``rows`` entities."""
    p = tensors[0]
    return plan([(t.data_ptr(), t.element_size()) for t in tensors],
                p.dtype, p.numel(), rows)


def _check(p, g, m, v, step):
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError(f"shape mismatch: p {tuple(p.shape)}, g "
                         f"{tuple(g.shape)}, m {tuple(m.shape)}, v "
                         f"{tuple(v.shape)}")
    if p.dtype not in _DTYPES or g.dtype != p.dtype:
        raise TypeError(f"p and g must share float32 or bfloat16, got "
                        f"{p.dtype} and {g.dtype}")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError("m and v must be float32")
    if step.dtype != torch.int32 or tuple(step.shape) != tuple(
            p.shape[:step.dim()]):
        raise ValueError(f"step must be int32 of shape () or the leading "
                         f"dims of p, got {step.dtype} {tuple(step.shape)}")
    if len({t.device for t in (p, g, m, v, step)}) != 1:
        raise ValueError("p, g, m, v and step must lie on one device")


def _check_inplace(p, g, m, v, step, keep):
    """What the in-place step needs beyond :func:`_check`: a ``keep`` of
    int32 flags shaped as ``step`` on its device, every operand
    contiguous, and no two operands sharing a byte (the kernel's
    pointers are ``__restrict__``, and a written operand that another
    reads would be read half updated)."""
    ops = [p, g, m, v, step]
    if keep is not None:
        if keep.dtype != torch.int32 or keep.shape != step.shape:
            raise ValueError(f"keep must be int32 of step's shape "
                             f"{tuple(step.shape)}, got {keep.dtype} "
                             f"{tuple(keep.shape)}")
        if keep.device != p.device:
            raise ValueError("keep must lie on the operands' device")
        ops.append(keep)
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("fused_adam_ needs contiguous operands")
    if p.device.type == "meta":          # no addresses to compare
        return
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
                   for t in ops if t.numel())
    for (_, end), (start, _) in zip(spans, spans[1:]):
        if start < end:
            raise ValueError("fused_adam_ operands overlap: each of p, g, m, "
                             "v, step and keep needs storage of its own")


@counted("fused_adam")
def fused_adam(p, g, m, v, step, *, lr: float, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0):
    """One Adam step; returns new (p, m, v) and leaves the inputs as
    they are.  p and g are float32 or bfloat16 of one shape, m and v
    float32.  ``step`` is an int32 tensor on the same device: a scalar,
    or [C] for a leaf stacked over C entities ([C, ...]), each row then
    corrected with its own count."""
    _check(p, g, m, v, step)
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if p.device.type in PLAIN_DEVICES:
        return kernel_layout(ref.fused_adam_ref(p, g, m, v, step, **kw))
    if p.device.type != "cuda":
        raise ValueError(f"no fused_adam kernel for {p.device}")
    if not all(t.is_contiguous() for t in (p, g, m, v, step)):
        raise ValueError("fused_adam needs contiguous operands")
    p2, m2, v2 = (torch.empty_like(p), torch.empty_like(m),
                  torch.empty_like(v))
    n = p.numel()
    if n == 0:
        return p2, m2, v2
    pl = plan_of((p, g, m, v, p2, m2, v2), step.numel())
    fn = _build.entry("fused_adam", _ARGTYPES)
    global launches
    launches += 1
    design_launches["copy"] += 1
    _build.check(fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                    step.data_ptr(), p2.data_ptr(), m2.data_ptr(),
                    v2.data_ptr(), n, pl.n_per_entity, _DTYPES[p.dtype],
                    pl.phase, pl.tiles, lr, b1, b2, eps, weight_decay,
                    _build.stream_of(p)),
                 "fused_adam")
    return p2, m2, v2


@counted("fused_adam")
def fused_adam_(p, g, m, v, step, *, keep=None, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0):
    """The step of :func:`fused_adam` written into ``p``, ``m`` and ``v``
    themselves; returns them, the same objects.  ``keep`` (None, or an
    int32 flag an entity, shaped as ``step``) leaves the entities whose
    flag is 0 untouched: ``select_entities(keep, fused_adam(...), old)``
    without the old copy.  Each written tensor's autograd version is
    bumped, so a graph that saved one of them raises instead of reading
    the new values."""
    _check(p, g, m, v, step)
    _check_inplace(p, g, m, v, step, keep)
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if p.device.type in PLAIN_DEVICES:
        return ref.fused_adam_ref_(p, g, m, v, step, keep=keep, **kw)
    if p.device.type != "cuda":
        raise ValueError(f"no fused_adam kernel for {p.device}")
    n = p.numel()
    if n == 0:
        return p, m, v
    pl = plan_of((p, g, m, v), step.numel())
    fn = _build.entry("fused_adam_inplace", _INPLACE_ARGTYPES,
                      source="fused_adam")
    global launches
    launches += 1
    design_launches["inplace"] += 1
    _build.check(fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                    step.data_ptr(), None if keep is None else keep.data_ptr(),
                    n, pl.n_per_entity, _DTYPES[p.dtype], pl.phase, pl.tiles,
                    lr, b1, b2, eps, weight_decay, _build.stream_of(p)),
                 "fused_adam_inplace")
    for t in (p, m, v):
        torch.autograd.graph.increment_version(t)
    return p, m, v
