"""Round/entity state containers shared by the SL algorithms.

Port of ``repro/core/protocol.py``.  Each *entity* (the server, or one
client) owns params + its own optimizer state + an int32 step counter.
A cohort of clients is one ``EntityState`` whose leaves are stacked
along a leading slot dim [C, ...] (``step`` is then [C]).  Every
function is functional: it returns new tensors and never writes its
inputs.

On a mesh a rank holds only its slots of a cohort ([lo, hi) of C, a
:class:`SlotSplit`) and only its rows of the per-client [N, ...] store
(a :class:`StoreRows`).  The cross-slot reductions then reduce each
rank's partial over its slots with ``all_reduce``; a reduction over
every slot is written so that at one rank it runs exactly the
unsharded ops (a mean over slots is each rank's mean scaled by its
share of the slots, and the share 1 is never multiplied in).  A mean
into an entity whose leaves split over ``data`` (FSDP, ``into``: a
:class:`DataBlocks`) hands each rank its block of the sum instead
(``sharding.parallel.reduce_to_blocks``), the other leaves' sums all
reduced as before.

One exception to the functional rule: a *donated* step
(``entity_step(..., donate=True)``) writes the new params and moments
into the entity's own storages, the port's counterpart of the
reference's donated TrainState buffers; its caller reads the old
entity no more.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.optim import Optimizer
from repro_torch.optim.optimizer import apply_updates
from repro_torch.sharding.parallel import reduce_to_blocks
from repro_torch.utils.tree import (tree_leaves, tree_map,
                                    tree_unflatten_like)


class EntityState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor           # int32 scalar, or [C] when stacked


class SlotSplit(NamedTuple):
    """The slots ``[lo, hi)`` of a C-slot cohort this rank holds on
    ``mesh`` (a ``launch.mesh.Mesh``), whose collectives reach the other
    ranks' slots."""
    mesh: Any
    lo: int
    hi: int
    total: int

    @property
    def comm(self):
        return self.mesh.comm

    def local(self, x):
        """This rank's part of a full [C, ...] tensor (the mask, say)."""
        return x[self.lo:self.hi]

    @property
    def share(self) -> float:
        return (self.hi - self.lo) / self.total

    @property
    def whole(self) -> bool:
        """True when this rank holds every slot (the cohort is not
        split, or the world is one rank)."""
        return self.hi - self.lo == self.total


class StoreRows(NamedTuple):
    """The rows ``[lo, hi)`` of the per-client [N, ...] store this rank
    holds (every row when the store is replicated)."""
    lo: int
    hi: int
    n: int

    @property
    def sharded(self) -> bool:
        return self.hi - self.lo < self.n


def init_entity(params, opt: Optimizer) -> EntityState:
    device = tree_leaves(params)[0].device
    return EntityState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=device))


def entity_step(entity: EntityState, grads, opt: Optimizer, *,
                donate: bool = False, keep=None) -> EntityState:
    """One optimizer step; works on one entity or a stacked cohort.

    ``keep`` (a scalar, or [C] for a stacked cohort, > 0 where a slot
    steps) makes the others a no-op: they keep their params, moments and
    step.  ``donate`` writes the step into the entity's own storages
    (the fused Adam kernel's in-place entry, the masked slots skipped
    in the kernel) and returns an EntityState over them; only the step
    counter is a new tensor, ``step + keep``.  Undonated, the step
    returns new tensors and ``keep`` selects them against the old ones
    (:func:`select_entities`), the same numbers.  A schedule (no fused
    step) cannot donate."""
    if donate:
        if opt.apply_ is None:
            raise ValueError("a donated step needs the fused Adam step (a "
                             "constant lr): this optimizer has none")
        k = None if keep is None else (torch.as_tensor(keep) > 0).to(
            device=entity.step.device, dtype=torch.int32)
        params, opt_state = opt.apply_(grads, entity.opt_state,
                                       entity.params, entity.step, keep=k)
        return EntityState(params, opt_state,
                           entity.step + (1 if k is None else k))
    if opt.apply is not None:
        # fused path (the fused-Adam kernel): one pass that produces new
        # params + new optimizer state directly
        new_params, new_opt = opt.apply(grads, entity.opt_state,
                                        entity.params, entity.step)
        new = EntityState(new_params, new_opt, entity.step + 1)
    else:
        updates, new_opt = opt.update(grads, entity.opt_state, entity.params,
                                      entity.step)
        new = EntityState(apply_updates(entity.params, updates), new_opt,
                          entity.step + 1)
    return new if keep is None else select_entities(keep, new, entity)


def stack_entities(entities: list[EntityState]) -> EntityState:
    """Stack entities (or any trees of one structure, such as their
    gradients) along a new leading cohort dim: contiguous [C, ...]
    leaves, as the fused Adam kernel takes them."""
    return tree_map(lambda *xs: torch.stack(xs), *entities)


class DataBlocks(NamedTuple):
    """Where a mean over the slots lands when its target holds FSDP
    blocks: the ``data`` axis' collectives and each leaf's data dim
    (None: whole over ``data``), in ``tree_leaves`` order."""
    comm: Any
    dims: list


def data_blocks(comm, plan, entity: Optional[EntityState] = None
                ) -> Optional[DataBlocks]:
    """The :class:`DataBlocks` of a tree under ``plan`` (a
    ``sharding.specs`` plan of the params), or with ``entity`` of that
    EntityState over it (its params, each params-like tree of its
    optimizer state, its step); None when ``comm`` (the data axis'
    collectives) is None: the target is whole."""
    if comm is None:
        return None
    dims = [s.ddim for s in tree_leaves(plan)]
    if entity is not None:
        n_opt = (len(entity.opt_state)
                 if isinstance(entity.opt_state, dict) else 0)
        dims = dims * (1 + n_opt) + [None]
    return DataBlocks(comm, dims)


def _reduced_sums(sums: list, split: Optional[SlotSplit],
                  into: Optional[DataBlocks] = None) -> list:
    """The sums over every rank's slots of each rank's partial ``sums``:
    all-reduced, or for the leaves ``into`` puts on ``data`` this rank's
    block of it."""
    if split is None:
        return sums
    if into is None or all(b is None for b in into.dims):
        return split.comm.all_reduce_tree(sums, "slot_mean")
    out = list(sums)
    rest = [i for i, b in enumerate(into.dims) if b is None]
    blk = [i for i, b in enumerate(into.dims) if b is not None]
    if rest:
        got = split.comm.all_reduce_tree([sums[i] for i in rest],
                                         "slot_mean")
        for i, t in zip(rest, got):
            out[i] = t
    got = reduce_to_blocks(into.comm, split.comm, [sums[i] for i in blk],
                           [into.dims[i] for i in blk], "slot_mean")
    for i, t in zip(blk, got):
        out[i] = t.contiguous()
    return out


def entity_mean(stacked: EntityState,
                split: Optional[SlotSplit] = None,
                into: Optional[DataBlocks] = None) -> EntityState:
    """FedAvg over the leading cohort dim, dtype-preserving (the int32
    step stays int32: every member stepped once, so its mean is exact).
    With ``split`` the sum runs over every rank's slots; with ``into``
    (:func:`data_blocks`) into this rank's FSDP blocks."""
    leaves = tree_leaves(stacked)
    n = leaves[0].shape[0] if split is None else split.total
    sums = _reduced_sums([x.sum(0) for x in leaves], split, into)
    return tree_unflatten_like(
        stacked, [(s / n).to(x.dtype) for s, x in zip(sums, leaves)])


def broadcast_entity(entity: EntityState, n: int,
                     fresh: bool = False) -> EntityState:
    """Replicate one entity n times along a new leading dim.  The copies
    are materialized: the fused kernels take contiguous leaves.  At
    ``n == 1`` they are a view of ``entity``'s storage unless ``fresh``
    asks for storage of their own (copies a donated step may write)."""
    if fresh and n == 1:
        return tree_map(lambda x: x.unsqueeze(0).clone(
            memory_format=torch.contiguous_format), entity)
    return tree_map(lambda x: x.unsqueeze(0).expand((n,) + tuple(x.shape))
                    .contiguous(), entity)


def take_entities(stacked: EntityState, idx: torch.Tensor,
                  rows: Optional[StoreRows] = None,
                  split: Optional[SlotSplit] = None) -> EntityState:
    """Gather cohort slots.  Padded slots carry the sentinel id N; it is
    clamped to a real client (the slot is masked out downstream).

    On a mesh (``rows`` and ``split`` given) the result is this rank's
    slots.  From a row-sharded store each rank gathers the cohort rows
    it holds and zeros the others, and the sum over ranks, which has one
    owner for every row and is therefore exact, comes back
    ``reduce_scatter``ed to the slots' owners (``all_reduce``d when the
    cohort is not split)."""
    if rows is None or not rows.sharded:
        ids = idx if split is None else split.local(idx)
        return tree_map(lambda x: torch.index_select(
            x, 0, ids.clamp(0, x.shape[0] - 1)), stacked)
    local = idx.clamp(0, rows.n - 1) - rows.lo
    ok = (local >= 0) & (local < rows.hi - rows.lo)
    safe = local.clamp(0, rows.hi - rows.lo - 1)

    def owned(x):
        got = torch.index_select(x, 0, safe)
        return torch.where(ok.reshape((-1,) + (1,) * (got.dim() - 1)), got, 0)
    leaves = [owned(x) for x in tree_leaves(stacked)]
    comm = split.comm
    got = (comm.all_reduce_tree(leaves, "store_read") if split.whole
           else comm.reduce_scatter_tree(leaves, "store_read"))
    return tree_unflatten_like(stacked, got)


def put_entities(stacked: EntityState, idx: torch.Tensor,
                 values: EntityState, rows: Optional[StoreRows] = None,
                 split: Optional[SlotSplit] = None) -> EntityState:
    """Scatter cohort slots back; writes at the sentinel id N (or any id
    out of range) are dropped, so padded slots are no-ops.

    On a mesh ``values`` holds this rank's slots: they are
    ``all_gather``ed (unless the cohort is not split), and each rank
    writes the rows of its part of the store."""
    if split is not None and not split.whole:
        leaves = split.comm.all_gather_tree(tree_leaves(values),
                                            "store_write")
        values = tree_unflatten_like(values, leaves)
    if rows is not None and rows.sharded:
        # ids another rank holds fall out of [0, rows) and are dropped
        idx = torch.where(idx < rows.n, idx - rows.lo, -1)
    n = stacked.step.shape[0]
    # out-of-range ids land in one extra scratch row that is cut off
    dst = torch.where((idx >= 0) & (idx < n), idx, n).long()

    def one(x, v):
        ext = torch.cat([x, x[:1]])
        return ext.index_copy(0, dst, v)[:n]
    return tree_map(one, stacked, values)


def _masked_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mb = mask.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(mb > 0, x, torch.zeros((), dtype=x.dtype,
                                              device=x.device)).sum(0)


def slot_mean(tree, mask=None, split: Optional[SlotSplit] = None,
              into: Optional[DataBlocks] = None):
    """The mean over the leading slot axis of every leaf of a [C, ...]
    tree (a tensor is a tree of one leaf): over the live slots when
    ``mask`` is given (rows with mask 0 contribute exact zeros, the
    count is the mask's; dtype-preserving), and with ``split`` over
    every rank's slots, one ``all_reduce`` per dtype (into this rank's
    FSDP blocks for the leaves ``into`` puts on ``data``).  Unmasked,
    each rank's mean is scaled by its share of the slots before the sum
    (at one rank: the plain mean)."""
    leaves = tree_leaves(tree)
    if mask is None:
        parts = [x.mean(0) for x in leaves]
        if split is not None:
            if split.share != 1.0:
                parts = [p * split.share for p in parts]
            parts = _reduced_sums(parts, split, into)
        return tree_unflatten_like(tree, parts)
    m = mask if split is None else split.local(mask)
    sums = _reduced_sums([_masked_sum(x, m) for x in leaves], split, into)
    count = mask.sum()
    return tree_unflatten_like(
        tree, [(s / count).to(x.dtype) for s, x in zip(sums, leaves)])


def masked_entity_mean(stacked: EntityState, mask: torch.Tensor,
                       split: Optional[SlotSplit] = None,
                       into: Optional[DataBlocks] = None) -> EntityState:
    """FedAvg over the live slots only: ``mask`` is [C] with 1.0 for
    live cohort members, 0.0 for padded slots.  With ``split`` the
    stack holds this rank's slots of the full [C] ``mask``: the masked
    partial sums are reduced over ranks, the count is the mask's."""
    return slot_mean(stacked, mask, split, into)


def gather_slots(x: torch.Tensor, split: Optional[SlotSplit]
                 ) -> torch.Tensor:
    """Every slot's row of a per-slot [C_local, ...] tensor (a loss or a
    norm a slot), in slot order: ``all_gather``ed on a split cohort."""
    if split is None or split.whole:
        return x
    return split.comm.all_gather(x, "metrics")


def select_entities(mask, new: EntityState, old: EntityState) -> EntityState:
    """Per-slot select: live slots (mask > 0) take ``new``, the others
    keep ``old``.  ``mask`` is [C], or a scalar for one entity."""
    m = torch.as_tensor(mask)

    def one(n, o):
        mb = m.reshape(tuple(m.shape) + (1,) * (n.dim() - m.dim()))
        return torch.where(mb > 0, n, o)
    return tree_map(one, new, old)
