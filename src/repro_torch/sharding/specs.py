"""Path-regex sharding rules (t5x-style) for every repro model, and the
placement they give a rank.

Port of the spec logic of ``repro/sharding/specs.py``.  A spec is a
tuple with one entry per dim of a leaf: an axis name, a tuple of axis
names, or ``None`` (replicated), as the JAX package's ``PartitionSpec``
holds them.  The functions read only ``mesh.shape``, a mapping of axis
name to size, so any object with that attribute will do.

Rules give a spec template for the trailing dims of a leaf; leading
dims (the stacked layer dim, the stacked client dim of a cohort) are
handled by role:

  role='server'/'full' — stacked-layer leading dim replicated.
  role='client'        — an extra leading cohort dim sharded over
                         ('pod','data'); the 'data' FSDP component inside
                         the rule is dropped (an axis may appear once).

The reference places every weight 2-D by these rules, FSDP over
``data`` and tensor-parallel over ``model``; GSPMD then inserts the
collectives.  The port places plain blocks: :func:`shard_plan` reads a
tree's specs into each leaf's :class:`Shard`, the dimension it splits
over ``model`` (under the whole-unit rule of ``sharding.parallel``) and
over ``data`` (roles 'server' and 'full'), and this rank's range of
each; :func:`shard_params` / :func:`gather_params` move a tree between
whole and this rank's blocks.  A Mamba-2 block's packed ``w_in`` and
``conv_w`` are cut over ``model`` segment by segment, on whole SSD heads
(``sharding.parallel.packed_segments``): a rank's block of such a leaf
is the concatenation of its part of each segment, not one contiguous
range.  GSPMD in the reference cuts these leaves contiguously wherever
``shard_if_divisible`` allows; the cut on heads computes the same
function and lets each rank scan its own heads.  Likewise an attention
block with fewer kv heads than ``model`` ranks (``sharding.parallel.
kv_replicas``): GSPMD cuts ``wk``'s and ``wv``'s columns contiguously,
inside a kv head; the port gives each rank its group's kv head whole
(:class:`Shard`'s ``rep``), held alike by the ``m / n_kv_heads`` ranks
of the group, which computes the same function and lets each rank run
its query heads against the one kv head they read.  The round gathers
the ``data`` blocks at
use (``sharding.parallel.gather_from_data``); the cohort's split is
:func:`local_slots`, the port's counterpart of ``slot_shard_map``.  The
layout pins of the JAX package (``constrain_*``) have no counterpart.
"""
from __future__ import annotations

import re
from typing import Optional, Sequence

import torch

from repro_torch.sharding.parallel import (TensorParallel, kv_replicas,
                                           packed_segments, rank_segments,
                                           sharded_units, take_segments,
                                           unit_of)
from repro_torch.utils.tree import (map_with_path, tree_leaves, tree_map,
                                    tree_unflatten_like)

BATCH_AXES = ("pod", "data")

# (regex over '/'-joined leaf path, trailing-dims spec template)
# templates use axis names; None = replicated dim.
RULES: list[tuple[str, tuple]] = [
    # embeddings / heads
    (r"embed/table$", ("model", "data")),
    (r"lm_head/w$", ("data", "model")),
    (r"(encoder|decoder)/pos$", (None, "data")),
    # attention projections
    (r"attn/wq$", ("data", "model")),
    (r"attn/wk$", ("data", "model")),
    (r"attn/wv$", ("data", "model")),
    (r"attn/wo$", ("model", "data")),
    # dense ffn
    (r"ffn/w_gate$", ("data", "model")),
    (r"ffn/w_up$", ("data", "model")),
    (r"ffn/w_down$", ("model", "data")),
    (r"ffn/w_in$", ("data", "model")),
    (r"ffn/b_in$", ("model",)),
    (r"ffn/w_out$", ("model", "data")),
    # moe (expert-parallel by default; grok overrides via shard_mode)
    (r"moe/router$", ("data", None)),
    (r"moe/w_gate$", ("model", "data", None)),
    (r"moe/w_up$", ("model", "data", None)),
    (r"moe/w_down$", ("model", None, "data")),
    # CNN/MLP dense layers (the server stage at the deep cuts): FSDP over
    # the input dim + TP over the output dim
    (r"lin/w$", ("data", "model")),
    # mamba2
    (r"mamba/w_in$", ("data", "model")),
    (r"mamba/conv_w$", (None, "model")),
    (r"mamba/w_out$", ("model", "data")),
    (r"mamba/(a_log|dt_bias|D)$", ("model",)),
    (r"mamba/gate_norm/scale$", ("model",)),
    # everything else (norms, biases, conv_b): replicated
    (r".*", ()),
]

MOE_FFN_MODE_RULES: list[tuple[str, tuple]] = [
    (r"moe/w_gate$", (None, "data", "model")),
    (r"moe/w_up$", (None, "data", "model")),
    (r"moe/w_down$", (None, "model", "data")),
]


def batch_axes(mesh) -> tuple[str, ...]:
    """The mesh's batch axes, ('pod', 'data') or those of them it has."""
    return tuple(a for a in BATCH_AXES if a in mesh.shape)


def _axes_size(mesh, axes) -> int:
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def shard_if_divisible(dim: int, axis, mesh):
    """Drop a sharding axis when the dim doesn't divide the axis size."""
    if axis is None:
        return None
    axes = axis if isinstance(axis, tuple) else (axis,)
    if any(a not in mesh.shape for a in axes):
        return None
    return axis if dim % _axes_size(mesh, axes) == 0 else None


def _spec_for(path: str, shape: Sequence[int], mesh,
              rules: list[tuple[str, tuple]], role: str) -> tuple:
    template: tuple = ()
    for pat, tpl in rules:
        if re.search(pat, path):
            template = tpl
            break
    nd, nt = len(shape), len(template)
    axes = [None] * (nd - nt) + list(template[:nd])
    if role == "client":
        # drop 'data' (used by the cohort dim), then shard the leading
        # cohort dim over ('pod','data') / 'data'
        axes = [None if a == "data" else a for a in axes]
        cohort_axes = batch_axes(mesh)
        if axes:
            axes[0] = cohort_axes if len(cohort_axes) > 1 else (
                cohort_axes[0] if cohort_axes else None)
    return tuple(shard_if_divisible(d, a, mesh) if a is not None else None
                 for d, a in zip(shape, axes))


def param_specs(params, mesh, role: str = "full",
                moe_shard_mode: str = "expert"):
    """A tree of specs matching ``params`` (tensors, on any device,
    the ``meta`` one included).

    role: 'full'/'server' — plain model params;
          'client'        — params stacked with a leading cohort dim.
    """
    rules = RULES
    if moe_shard_mode == "ffn":
        rules = MOE_FFN_MODE_RULES + RULES
    return map_with_path(
        lambda path, leaf: _spec_for(path, tuple(leaf.shape), mesh, rules,
                                     role), params)


def _batch_axes_for(mesh, n: int) -> Optional[tuple[str, ...]]:
    """The batch axes a leading dim of ``n`` rows shards over:
    ('pod', 'data') when n divides their combined size, else 'data'
    alone when n divides it, else None."""
    axes = batch_axes(mesh)
    if axes and n % _axes_size(mesh, axes) == 0:
        return axes
    if "data" in mesh.shape and n % mesh.shape["data"] == 0:
        return ("data",)
    return None


def pool_shard_info(mesh, total: int
                    ) -> Optional[tuple[tuple[str, ...], int, int]]:
    """Per-shard pool-slice geometry for the shard-local resample:
    ``(axes, n_shards, rows_per_shard)``; shard ``s`` owns the contiguous
    global rows ``[s * rows_per_shard, (s+1) * rows_per_shard)``.
    ``None`` when there is no mesh or the pool rows divide no batch
    axis."""
    if mesh is None:
        return None
    axes = _batch_axes_for(mesh, total)
    if axes is None:
        return None
    size = _axes_size(mesh, axes)
    return axes, size, total // size


def _lead(axes: tuple):
    return axes if len(axes) > 1 else axes[0]


def pool_slice_spec(mesh, total: int, ndim: int) -> Optional[tuple]:
    """Spec of one pooled ``[T, ...]`` array under
    :func:`pool_shard_info`'s geometry (leading rows over the batch
    axes, trailing dims replicated); ``None`` when the pool has no even
    slicing."""
    info = pool_shard_info(mesh, total)
    if info is None:
        return None
    return (_lead(info[0]),) + (None,) * (ndim - 1)


def batch_spec(mesh, batch: int, extra_dims: int = 1) -> tuple:
    """Shard the leading batch dim over ('pod','data') if divisible."""
    axes = _batch_axes_for(mesh, batch)
    if axes is None:
        return (None,) * (1 + extra_dims)
    return (_lead(axes),) + (None,) * extra_dims


def cohort_shard_axes(mesh, n_slots: int) -> Optional[tuple]:
    """Batch-axis tuple the [C, ...] cohort dim shards over, or None when
    there is no mesh / the dim doesn't divide the combined axis size."""
    if mesh is None:
        return None
    return _batch_axes_for(mesh, n_slots)


def shard_aligned_capacity(mesh, capacity: int) -> int:
    """Round a cohort capacity up to a multiple of the batch-axis shard
    count so no shard runs under-filled.  Padded rounds are
    capacity-invariant, which is what makes this round-up numerically
    free.  Identity off-mesh and at 1 device."""
    if mesh is None:
        return capacity
    size = _axes_size(mesh, batch_axes(mesh))
    if size <= 1:
        return capacity
    return ((capacity + size - 1) // size) * size


def shard_range(mesh, axes, n: int) -> tuple[int, int]:
    """``(lo, hi)``: the rows of a leading dim of ``n`` that this rank
    holds when the dim shards over ``axes`` (an axis name, a tuple of
    them, or None = replicated, every row).  ``mesh.coords`` maps each
    axis to the rank's coordinate; the shard index folds them row-major,
    as the JAX package lays a sharded dim over its axes."""
    if axes is None:
        return 0, n
    axes = axes if isinstance(axes, tuple) else (axes,)
    per = n // _axes_size(mesh, axes)
    s = 0
    for a in axes:
        s = s * mesh.shape[a] + mesh.coords[a]
    return s * per, (s + 1) * per


def local_slots(mesh, n_slots: int) -> tuple[int, int]:
    """The slots of a [n_slots, ...] cohort dim this rank owns, or every
    slot when :func:`cohort_shard_axes` is None: the port's counterpart
    of ``slot_shard_map``, whose slot-wise work each rank does for its
    own range."""
    return shard_range(mesh, cohort_shard_axes(mesh, n_slots), n_slots)


def store_rows(mesh, n_clients: int, shard_cohort: bool = True
               ) -> tuple[int, int]:
    """The rows of the per-client [N, ...] store this rank holds: its
    leading dim's spec under :func:`train_state_shardings` (role
    'client', or replicated with ``shard_cohort`` off)."""
    if mesh is None or not shard_cohort:
        return 0, n_clients
    lead = _spec_for("step", (n_clients,), mesh, RULES, "client")[0]
    return shard_range(mesh, lead, n_clients)


def train_state_shardings(state, mesh, moe_shard_mode: str = "expert",
                          shard_cohort: bool = True):
    """A spec tree for a TrainState-like NamedTuple ``(server, clients,
    client_global)``: server / client_global as plain model entities
    (role 'server' / 'full'); clients, the persistent [N, ...]
    per-client stack, with its leading dim over the batch axes (role
    'client') unless ``shard_cohort`` is off."""
    def _field(sub, role):
        if sub is None:
            return None
        return param_specs(sub, mesh, role, moe_shard_mode)

    return type(state)(
        _field(state.server, "server"),
        _field(state.clients, "client" if shard_cohort else "full"),
        _field(state.client_global, "full"))


# ---------------------------------------------------------- the placement
class Shard:
    """How a leaf lies on a mesh: split along ``dim`` over the ``model``
    axis, this rank holding ``[lo, hi)`` of it, and along ``ddim`` over
    ``data`` (FSDP), this rank holding ``[dlo, dhi)`` of it; a None dim
    is whole on that axis.  The two dims are never the same (an axis
    appears once in a spec), so the cuts commute.

    A packed leaf (a Mamba block's ``w_in``, ``conv_w``) has ``segs``,
    this rank's ranges ``((lo, hi, split), ...)`` of ``dim`` in the
    order its block concatenates them (``sharding.parallel.
    rank_segments``); its ``[lo, hi)`` is then the block's place in the
    rank-order concatenation of every rank's block, what an all-gather
    along ``dim`` returns.  ``segs`` is None for a contiguous cut.

    A kv head held by a group of ranks (an attention block's ``wk``,
    ``wv`` and its cache, where ``sharding.parallel.kv_replicas`` is
    above 1) has ``rep``, the group's size: ``rep`` consecutive ranks of
    the axis hold the same block, ``[lo, hi)`` of the whole ``dim``, so
    the whole leaf is the first rank of each group's block, in group
    order.  ``rep`` is 1 for every other cut."""
    __slots__ = ("dim", "lo", "hi", "ddim", "dlo", "dhi", "segs", "rep")

    def __init__(self, dim: Optional[int] = None, lo: int = 0, hi: int = 0,
                 ddim: Optional[int] = None, dlo: int = 0, dhi: int = 0,
                 segs: Optional[tuple] = None, rep: int = 1):
        self.dim, self.lo, self.hi = dim, lo, hi
        self.ddim, self.dlo, self.dhi = ddim, dlo, dhi
        self.segs, self.rep = segs, rep

    def model_only(self) -> "Shard":
        """The same leaf whole over ``data`` (a cohort slot's copy)."""
        return Shard(self.dim, self.lo, self.hi, segs=self.segs,
                     rep=self.rep)

    def stacked(self) -> "Shard":
        """The leaf of a [N, ...] stack of copies (role 'client': the
        cohort or the per-client store): its model split one dim on,
        whole over ``data``."""
        return Shard(None if self.dim is None else self.dim + 1,
                     self.lo, self.hi, segs=self.segs, rep=self.rep)


class _Sizes:
    def __init__(self, shape: dict):
        self.shape = shape


def shard_plan(params, sizes, coords, role: str = "full", cfg=None,
               local: bool = False):
    """For each leaf of ``params`` (whole leaves, on any device, or
    anything with a ``shape``): a :class:`Shard`, the placement of
    :func:`param_specs` on a mesh of ``sizes`` (axis name -> size) for
    the rank at ``coords``.

    ``model``: the dimension its spec puts on the axis, where its unit
    splits (``sharding.parallel.sharded_units``): a transformer unit
    (``cfg``, an ``ArchConfig``) splits only on whole heads, experts,
    hidden columns or vocab rows; a stage model's ``lin`` unit (``cfg``
    None) splits each ``lin/w`` whose columns divide the axis, as
    ``shard_if_divisible`` reads its spec; a Mamba block's packed
    ``w_in`` and ``conv_w`` are cut segment by segment
    (:class:`Shard`'s ``segs``); where the attention splits over kv head
    groups (``sharding.parallel.kv_replicas``), ``wk`` and ``wv`` give
    the rank its group's kv head whole (:class:`Shard`'s ``rep``).
    ``data`` (FSDP), for roles
    'server' and 'full' only: the spec's ``data`` dimension where it
    divides the axis ('client', a [C, ...] stack, drops ``data`` as
    :func:`param_specs` does).  ``local`` reads ``params`` as this
    rank's model shards (a split dim 1/m of the whole), the plan they
    were cut by; it places nothing over ``data``."""
    m, r = sizes.get("model", 1), coords.get("model", 0)
    d, q = sizes.get("data", 1), coords.get("data", 0)
    units = sharded_units(cfg, sizes)
    rep = kv_replicas(cfg, m) if units["attn"] else 1
    mode = (cfg.moe.shard_mode if cfg is not None and cfg.moe is not None
            else "expert")
    rules = MOE_FFN_MODE_RULES + RULES if mode == "ffn" else RULES
    on_model = _Sizes({"model": 1 if local else m})
    on_data = _Sizes({"data": d})
    fsdp = d > 1 and role in ("server", "full") and not local

    def one(path, leaf):
        shape = tuple(leaf.shape)
        s = Shard()
        unit = unit_of(path)
        if unit is not None and units[unit]:
            # a packed leaf is cut on its segments and a grouped kv head
            # whole, whatever the leaf's width
            segs = packed_segments(cfg, path)
            grouped = rep > 1 and re.search(r"attn/(wk|wv)$", path)
            spec = _spec_for(path, shape, on_model if segs is None
                             and not grouped else _Sizes({"model": 1}),
                             rules, role)
            if "model" in spec and grouped:
                s.dim, s.rep = spec.index("model"), rep
                per = shape[s.dim] if local else shape[s.dim] // (m // rep)
                s.lo, s.hi = r // rep * per, (r // rep + 1) * per
            elif "model" in spec:
                s.dim = spec.index("model")
                per = shape[s.dim] if local else shape[s.dim] // m
                if segs is not None:
                    s.segs = rank_segments(segs, m, r)
                    per = sum(hi - lo for lo, hi, _ in s.segs)
                    if shape[s.dim] != (per if local else
                                        sum(w for w, _ in segs)):
                        raise ValueError(f"{path} {shape}: not the packed "
                                         f"layout {segs}")
                s.lo, s.hi = r * per, (r + 1) * per
            elif unit != "lin":
                raise ValueError(f"{path} {shape}: its unit {unit} splits "
                                 f"over {m} ranks but its spec {spec} "
                                 "does not")
        if fsdp:
            spec = _spec_for(path, shape, on_data, rules, role)
            if "data" in spec:
                s.ddim = spec.index("data")
                per = shape[s.ddim] // d
                s.dlo, s.dhi = q * per, (q + 1) * per
        return s
    return map_with_path(one, params)


def _cut(x, s: Shard, model: bool, data: bool):
    out = x
    if model and s.dim is not None:
        out = (out.narrow(s.dim, s.lo, s.hi - s.lo) if s.segs is None
               else take_segments(out, s.segs, s.dim))
    if data and s.ddim is not None:
        out = out.narrow(s.ddim, s.dlo, s.dhi - s.dlo)
    return x if out is x else out.contiguous()


def shard_params(full, plan, model: bool = True, data: bool = True):
    """This rank's part of a tree under ``plan``: a contiguous copy of
    each split leaf's block (the kernels take contiguous leaves; a leaf
    split over both axes is a 2-D block), each whole leaf as it is.
    ``model``/``data`` pick the axes to cut (a tree already cut over
    ``model`` takes ``model=False``)."""
    return tree_map(lambda x, s: _cut(x, s, model, data), full, plan)


def gather_params(local, plan, comm=None, data_comm=None):
    """The whole tree from every rank's part: the leaves split over
    ``data`` all-gathered over ``data_comm`` along their data dim in
    one call per dtype (census ``all_gather/weights``), then each leaf
    split over ``model`` all-gathered over ``comm`` (the mesh's
    ``model_comm``) along its dimension, in rank order, a packed leaf's
    segments put back in place (:func:`unpack_segments`) and a kv head
    held by a group of ranks taken once, from the group's first rank
    (``Shard.rep``).  An axis whose
    collectives are None is not gathered (a tree cut over one axis, or
    one whose blocks over an axis stay)."""
    leaves, shards = tree_leaves(local), tree_leaves(plan)
    idx = [i for i, s in enumerate(shards) if s.ddim is not None]
    if idx and data_comm is not None:
        got = data_comm.all_gather_tree(
            [leaves[i].movedim(shards[i].ddim, 0) for i in idx], "weights")
        for i, g in zip(idx, got):
            leaves[i] = g.movedim(0, shards[i].ddim).contiguous()

    def whole(x, s):
        if s.dim is None or comm is None:
            return x
        g = comm.all_gather(x.movedim(s.dim, 0), "params")
        if s.segs is not None:
            g = unpack_segments(g, s.segs, comm.size)
        if s.rep > 1:
            g = torch.cat(torch.chunk(g, comm.size)[::s.rep])
        return g.movedim(0, s.dim).contiguous()
    return tree_unflatten_like(local, [whole(x, s)
                                       for x, s in zip(leaves, shards)])


def unpack_segments(g, segs, m: int):
    """The whole packed dimension (dim 0 of ``g``) from the rank-order
    concatenation ``g`` of ``m`` ranks' blocks, each laid out as
    ``segs`` (one rank's :class:`Shard` ranges): a split segment is every
    rank's part in rank order, a whole one the first rank's copy."""
    widths = [hi - lo for lo, hi, _ in segs]
    blocks = [torch.split(b, widths) for b in torch.chunk(g, m)]
    return torch.cat([torch.cat([b[j] for b in blocks]) if split
                      else blocks[0][j]
                      for j, (_, _, split) in enumerate(segs)])


def _entity_map(fn, entity, plan):
    """``fn(tree, plan)`` over an ``EntityState``'s params and each of
    its optimizer state's params-like trees (Adam's ``m`` and ``v``)."""
    opt = entity.opt_state
    if isinstance(opt, dict):
        opt = {k: fn(v, plan) for k, v in opt.items()}
    return type(entity)(fn(entity.params, plan), opt, entity.step)


def shard_entity(entity, plan, model: bool = True, data: bool = True):
    """:func:`shard_params` of an entity's params and optimizer moments."""
    return _entity_map(lambda t, p: shard_params(t, p, model, data),
                       entity, plan)


def gather_entity(entity, plan, comm=None, data_comm=None):
    """:func:`gather_params` of an entity's params and optimizer
    moments."""
    return _entity_map(lambda t, p: gather_params(t, p, comm, data_comm),
                       entity, plan)


# ------------------------------------------------- a step's placement
def mesh_placement(mesh, cfg=None):
    """``(tp, fsdp)`` of a task on ``mesh``: its ``model`` axis (the
    whole-unit rule of ``cfg``, or a stage model's for ``cfg`` None) and
    the ``data`` axis' collectives where that axis has more than one
    rank (None otherwise)."""
    fsdp = mesh.data_comm if mesh.shape.get("data", 1) > 1 else None
    return TensorParallel.from_mesh(mesh, cfg), fsdp


def step_placement(mesh, cfg, shapes):
    """``(tp, fsdp, plan)`` of a whole model's inference step (prefill,
    decode, serving) on ``mesh``: :func:`mesh_placement`, and the plan of
    the weights ``shapes`` (a shape-only draw) under role 'full' where
    the ``model`` axis or FSDP cuts them (None where every leaf stays
    whole)."""
    tp, fsdp = mesh_placement(mesh, cfg)
    plan = None
    if tp.size > 1 or fsdp is not None:
        plan = shard_plan(shapes, mesh.shape, mesh.coords, "full", cfg)
    return tp, fsdp, plan


# ------------------------------------------------------- the decode state
# (regex over a decode-state leaf's path, its kind): the reference's
# ``_DECODE_RULES`` (``repro/launch/steps.py``)
DECODE_RULES: list[tuple[str, str]] = [
    (r"kv/(k|v)$", "kvcache"),           # [L, B, C, Hkv, Dh]
    (r"mamba/h$", "mamba_h"),            # [L, B, H, N, P]
    (r"mamba/conv$", "mamba_conv"),      # [L, B, K-1, ch]
    (r"enc_out$", "enc_out"),            # [B, T, d]
]


class _Grid:
    def __init__(self, sizes: dict, coords: dict):
        self.shape, self.coords = sizes, coords


def decode_rows(sizes, coords, n: int
                ) -> tuple[int, int, Optional[tuple[str, ...]]]:
    """``(lo, hi, axes)``: the rows of a decode state's batch (or the
    serving runtime's slot) axis of ``n`` that the rank at ``coords`` of
    a mesh of ``sizes`` holds, and the batch axes they split over (None:
    every row on every rank).  The rows split as a batch spec does
    (``batch_spec``: over ('pod', 'data') where ``n`` divides their
    size, else over 'data' where it divides that), and stay whole where
    it divides neither, as ``shard_if_divisible`` leaves them, or where
    the axes hold one rank."""
    grid = _Grid(sizes, coords)
    axes = _batch_axes_for(grid, n)
    if axes is None or _axes_size(grid, axes) == 1:
        return 0, n, None
    lo, hi = shard_range(grid, axes, n)
    return lo, hi, axes


def rows_comm(mesh, axes):
    """The collectives of the ranks among which ``decode_rows``' ``axes``
    split the rows (the ranks of this rank's ``model`` coordinate):
    ``mesh.comm`` for every batch axis, ``mesh.data_comm`` for 'data'
    alone; None for rows whole on every rank."""
    if axes is None:
        return None
    return mesh.comm if tuple(axes) == batch_axes(mesh) else mesh.data_comm


def decode_state_plan(state, sizes, coords, cfg):
    """For each leaf of a decode state (or of the serving runtime's slot
    table, its slot axis in the batch position; whole leaves, on any
    device, the ``meta`` one included): a :class:`Shard`, the placement
    of the reference's ``decode_state_shardings`` for the rank at
    ``coords`` of a mesh of ``sizes``, the port's counterpart of its
    ``_DECODE_RULES`` (:data:`DECODE_RULES`).

    The batch axis (the slots) splits over the batch axes where it
    divides (:func:`decode_rows`), as ``ddim`` (over the batch axes
    here, not 'data' alone); over ``model``, as ``dim``, under the
    whole-unit rule of ``sharding.parallel.sharded_units``, so that the
    state meets the weights it is read with:

      ``kv/k``, ``kv/v`` [L, B, C, Hkv, Dh]: the rank's heads, where the
        attention unit splits on them (``n_kv_heads % m == 0``); where it
        splits over kv head groups (``sharding.parallel.kv_replicas``)
        the group's one head ``[g, g + 1)``, held alike by the group's
        ranks (``Shard.rep``), with the length C whole, so that a rank
        reads only the head its queries use and no softmax partials are
        merged across ranks at each layer and step: 1 / ``n_kv_heads``
        of the cache a card, where the reference's
        ``_decode_state_spec`` cuts C over ``model`` (1 / m a card; at
        batch 1 C over 'data' too, ROADMAP item 9b); whole where the unit
        stays whole;
      ``mamba/h`` [L, B, H, N, P]: the rank's ``H / m`` SSD heads;
      ``mamba/conv`` [L, B, K-1, ch]: the rank's ``[x_r | B | C]``
        channels, the segmented cut of ``conv_w`` (``Shard.segs``), so
        the carried inputs and the weight they meet hold the same
        columns (the reference cuts ``ch`` evenly, which is a layout of
        the same values, not a cut on heads);
      ``enc_out`` [B, T, d]: whole over ``model`` (the cross-attention
        is head-parallel and reads all of ``d``; the reference's cut of
        ``d`` is a layout);
      ``pos``, ``kv/idx``: over the batch axes where they are one per
        row, else whole.

    :func:`shard_params` cuts a whole state by the plan, and
    :func:`gather_params` with the mesh's ``model_comm`` and
    :func:`rows_comm` puts it back whole."""
    m, r = sizes.get("model", 1), coords.get("model", 0)
    units = sharded_units(cfg, sizes)
    rep = kv_replicas(cfg, m) if units["attn"] else 1

    def one(path, leaf):
        shape = tuple(leaf.shape)
        kind = next((k for pat, k in DECODE_RULES if re.search(pat, path)),
                    None)
        s = Shard()
        bdim = 0 if kind == "enc_out" or len(shape) == 1 else (
            1 if kind is not None else None)
        if bdim is not None:
            lo, hi, axes = decode_rows(sizes, coords, shape[bdim])
            if axes is not None:
                s.ddim, s.dlo, s.dhi = bdim, lo, hi
        split = {"kvcache": "attn", "mamba_h": "mamba",
                 "mamba_conv": "mamba"}.get(kind)
        if split is not None and units[split]:
            s.dim = {"kvcache": 3, "mamba_h": 2, "mamba_conv": 3}[kind]
            per = shape[s.dim] // m
            if kind == "kvcache" and rep > 1:     # the group's one head
                s.rep, s.lo, s.hi = rep, r // rep, r // rep + 1
                return s
            if kind == "mamba_conv":
                s.segs = rank_segments(packed_segments(cfg, "mamba/conv_w"),
                                       m, r)
                per = sum(hi - lo for lo, hi, _ in s.segs)
            s.lo, s.hi = r * per, (r + 1) * per
        return s
    return map_with_path(one, state)


def decode_state_zeros(state, mesh, cfg, device):
    """An empty decode state (or slot table) on ``device``: zeros of this
    rank's block of ``state``, a whole state's shapes (the ``meta`` one
    will do), under :func:`decode_state_plan`; off a mesh (``mesh``
    None) zeros of the whole.  The one place a decode's state is given
    its placement."""
    if mesh is not None:
        state = shard_params(state, decode_state_plan(state, mesh.shape,
                                                      mesh.coords, cfg))
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                          device=device), state)
