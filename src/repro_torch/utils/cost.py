"""The work of a step: FLOPs, memory traffic, collective bytes, peak memory.

The port's counterpart of ``repro/utils/hlo.py`` (``flops_and_bytes``,
``collective_stats``) and ``repro/utils/hlo_cost.py`` (``module_cost``,
``collective_census``).  The reference reads a compiled XLA module's
text; the port runs eagerly, so it counts the step as it runs:

* :func:`count` runs ``fn`` under a ``TorchDispatchMode`` that sees every
  aten op.  FLOPs come from ``torch.utils.flop_counter``'s formulas
  (matmuls, convolutions, attention, and their backwards); bytes are
  each op's tensor inputs read plus its outputs written.  Nothing is
  fused in eager execution, so that is the step's traffic if no op
  found its input in the L2 cache.  Views and uninitialized
  allocations move nothing and count nothing.  A Python loop of k trips
  runs its ops k times and is counted k times: the port's answer to the
  reference's ``known_trip_count`` multipliers.
* Each call of a hand-written kernel's wrapper (``kernels.ops`` and the
  six kernel modules) is counted once, by :func:`kernel_cost`, whatever
  runs it: the kernel on the card, its plain version on the CPU or on
  ``meta``.  The ops inside the wrapper (its allocations, the plain
  version) count nothing, so a step counts the same on every device.
* Collective bytes are the mesh's census (``sharding.collectives``):
  the payload each rank hands to each call.
* The peak is the most bytes that tensors on the step's device held at
  once, from the arguments' storages and every op's new outputs until
  each storage is freed (inside a kernel's wrapper only its outputs).

:func:`kernel_cost` is the single source of each kernel's least work:
each input read once and each output written once, and the operations
of the function, not of one implementation of it.  ``chip_smoke.py``
takes its bounds from it.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _count
from repro_torch.utils.tree import tree_leaves as _leaves

KERNELS = ("feature_resample", "fused_adam", "gather_loss",
           "flash_attention", "topk_gating", "ssd_scan")

# allocations that write nothing
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _rows_read(idx: torch.Tensor, data: bool) -> int:
    """The distinct rows a gather reads: counted from the index's values
    where they are there to read (``data`` and not on ``meta``), else
    one a gathered row."""
    if data and idx.device.type != "meta":
        return len(set(idx.tolist()))
    return idx.shape[0]


@lru_cache(maxsize=256)
def _pairs(Sq: int, Sk: int, causal: bool, window: Optional[int]) -> int:
    """The (query i, key j) pairs a mask keeps: all of them, or j <= i
    with ``causal``, and i - j < window with a window."""
    n = 0
    for i in range(Sq):
        hi = min(i, Sk - 1) if causal else Sk - 1
        lo = 0 if window is None else max(0, i - window + 1)
        n += max(0, hi - lo + 1)
    return n


def kernel_cost(name: str, *args, data: bool = True, **kw):
    """``(flops, bytes, dtype)`` of one call of kernel ``name`` with the
    wrapper's arguments (``kernels.<name>``'s public function): the
    least bytes the function moves (each input read once, each output
    written once) and its operations; ``dtype`` picks the peak the
    operations run against.  ``data`` counts a gather's distinct rows
    from its index (see :func:`_rows_read`); the work of a mask or a
    shape needs no data."""
    if name == "feature_resample":
        src, idx = args[:2]
        row = _nbytes(src) // max(1, src.shape[0])
        m = idx.shape[0]
        return 0, (_rows_read(idx, data) + m) * row + 4 * m, src.dtype
    if name == "fused_adam":
        # either entry: the in-place one moves the same bytes, and its
        # per-entity keep flags besides
        p, _g, _m, _v, step = args[:5]
        n = p.numel()
        keep = kw.get("keep")
        return (14 * n, n * (3 * p.element_size() + 4 * 4) + 4 * step.numel()
                + (0 if keep is None else 4 * keep.numel()), p.dtype)
    if name == "gather_loss":
        src, labels, idx, w = args[:4]
        b = args[4] if len(args) > 4 else kw.get("b")
        m, (d, k) = idx.shape[0], w.shape
        nbytes = (_rows_read(idx, data) * d * src.element_size()
                  + d * k * w.element_size() + m * labels.element_size()
                  + m * 4 + m * 4 + (4 * k if b is not None else 0))
        return 2 * m * d * k + 6 * m * k, nbytes, src.dtype
    if name == "flash_attention":
        q, k, v = args[:3]
        B, Sq, H, D = q.shape
        pairs = _pairs(Sq, k.shape[1], kw.get("causal", True),
                       kw.get("window"))
        return (4 * B * H * D * pairs,
                (2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
                q.dtype)
    if name == "topk_gating":
        x, k = args[0], (args[1] if len(args) > 1 else kw["k"])
        T, E = x.shape
        return T * E * (4 + 2 * k), _nbytes(x) + T * k * 8, x.dtype
    if name == "ssd_scan":
        x, dt, A, Bm, Cm = args[:5]
        Bsz, L, H, P = x.shape
        N = Bm.shape[3]
        el = x.element_size()
        # the recurrence's least work, whatever the chunk: the decay and
        # dt B x^T update of h (3 N P a row and head) and y = C h (2 N P)
        return (5 * Bsz * L * H * N * P,
                2 * x.numel() * el + (Bm.numel() + Cm.numel()) * el
                + 4 * (dt.numel() + A.numel() + Bsz * H * N * P), x.dtype)
    raise KeyError(f"no kernel {name!r}; the kernels are {KERNELS}")


# ------------------------------------------------------------- counting
@dataclass
class StepCost:
    """What :func:`count` saw.  ``flops`` and ``traffic_bytes`` are aten
    ops' and kernels' together; ``flops_by_dtype`` splits the FLOPs by
    the operands' dtype (the peak they run against); ``by_op`` and
    ``by_kernel`` hold calls, flops and bytes; ``census`` is the mesh's
    collectives over the call; ``peak_bytes`` the most bytes live on the
    step's device."""
    flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: float = 0.0
    flops_by_dtype: dict = field(default_factory=dict)
    by_op: dict = field(default_factory=dict)
    by_kernel: dict = field(default_factory=dict)
    census: dict = field(default_factory=dict)
    peak_bytes: int = 0

    def _add(self, table: dict, key: str, flops, nbytes, dtype):
        row = table.setdefault(key, {"calls": 0, "flops": 0, "bytes": 0})
        row["calls"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes
        self.flops += flops
        self.traffic_bytes += nbytes
        if flops:
            d = str(dtype).replace("torch.", "")
            self.flops_by_dtype[d] = self.flops_by_dtype.get(d, 0) + flops

    def kernel_calls(self) -> dict:
        return {k: v["calls"] for k, v in self.by_kernel.items()}

    def summary(self) -> dict:
        return {
            "flops": self.flops,
            "traffic_bytes": self.traffic_bytes,
            "collective_bytes": self.collective_bytes,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "peak_bytes": self.peak_bytes,
            "by_op": {k: dict(v) for k, v in sorted(self.by_op.items())},
            "by_kernel": {k: dict(v) for k, v in sorted(
                self.by_kernel.items())},
            "census": {k: dict(v) for k, v in sorted(self.census.items())},
        }


class _Live:
    """Bytes of the storages on one device that are alive, and their
    peak: a storage is added once, when first seen, and leaves when it
    is freed."""

    def __init__(self, device: torch.device):
        self.device = device
        self.bytes = 0
        self.peak = 0
        self._refs: dict = {}

    def add(self, t):
        if not isinstance(t, torch.Tensor) or t.device != self.device:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs and self._refs[key][0]() is st:
            return
        n = st.nbytes()

        def freed(_ref, key=key, n=n):
            if self._refs.get(key, (None,))[0] is _ref:
                del self._refs[key]
                self.bytes -= n
        self._refs[key] = (weakref.ref(st, freed), n)
        self.bytes += n
        self.peak = max(self.peak, self.bytes)


class _Counter(TorchDispatchMode):
    def __init__(self, cost: StepCost, live: _Live):
        super().__init__()
        self.cost = cost
        self.live = live
        self.depth = 0          # > 0 inside a kernel's wrapper

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.depth or func.namespace != "aten":
            return out
        for t in _leaves(out):
            self.live.add(t)
        name = func._overloadpacket.__name__
        if func.is_view or name in _NO_TRAFFIC:
            return out
        ins = [t for t in _leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        nbytes = sum(_nbytes(t) for t in ins) + sum(
            _nbytes(t) for t in _leaves(out) if isinstance(t, torch.Tensor))
        flops, dtype = 0, None
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            flops = int(fn(*args, **kwargs, out_val=out))
            dtype = ins[0].dtype if ins else None
        self.cost._add(self.cost.by_op, f"aten.{name}", flops, nbytes, dtype)
        return out

    def kernel(self, name, fn, args, kw):
        """The wrapper of kernel ``name`` called with ``args``/``kw``:
        counted once at :func:`kernel_cost`, its body not at all."""
        if self.depth:
            return fn(*args, **kw)
        flops, nbytes, dtype = kernel_cost(name, *args, data=False, **kw)
        self.cost._add(self.cost.by_kernel, name, flops, nbytes, dtype)
        self.depth += 1
        try:
            out = fn(*args, **kw)
        finally:
            self.depth -= 1
        for t in _leaves(out):
            self.live.add(t)
        return out


def _census(comms) -> dict:
    out: dict = {}
    for c in comms:
        for k, row in c.census.items():
            out[k] = dict(row)
    return out


def count(fn, *args, mesh=None, device=None, **kw) -> StepCost:
    """Run ``fn(*args, **kw)`` once and count its work (see the module's
    docstring).  ``mesh`` adds its collectives' census over the call
    (the groups' running censuses go on as they were); ``device`` is
    where the peak is taken, by default the first tensor argument's."""
    from repro_torch.utils.profiling import mesh_comms
    tensors = [t for t in _leaves((args, kw)) if isinstance(t, torch.Tensor)]
    if device is None:
        device = tensors[0].device if tensors else torch.device("cpu")
    cost = StepCost()
    live = _Live(torch.device(device))
    for t in tensors:
        live.add(t)
    comms = mesh_comms(mesh) if mesh is not None else []
    before = [_census([c]) for c in comms]
    mode = _Counter(cost, live)
    if _count.recorder is not None:
        raise RuntimeError("count() does not nest")
    _count.recorder = mode.kernel
    try:
        with mode:
            fn(*args, **kw)
    finally:
        _count.recorder = None
    for c, old in zip(comms, before):
        for k, row in c.census.items():
            was = old.get(k, {"calls": 0, "bytes": 0})
            if row["calls"] != was["calls"]:
                cost.census[k] = {"calls": row["calls"] - was["calls"],
                                  "bytes": row["bytes"] - was["bytes"]}
    cost.collective_bytes = sum(r["bytes"] for r in cost.census.values())
    cost.peak_bytes = live.peak
    return cost
