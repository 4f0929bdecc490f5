"""Round/entity state containers shared by the SL algorithms.

Port of ``repro/core/protocol.py``.  Each *entity* (the server, or one
client) owns params + its own optimizer state + an int32 step counter.
A cohort of clients is one ``EntityState`` whose leaves are stacked
along a leading slot dim [C, ...] (``step`` is then [C]).  Every
function is functional: it returns new tensors and never writes its
inputs.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim import Optimizer
from repro_torch.optim.optimizer import apply_updates
from repro_torch.utils.tree import tree_leaves, tree_map


class EntityState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor           # int32 scalar, or [C] when stacked


def init_entity(params, opt: Optimizer) -> EntityState:
    device = tree_leaves(params)[0].device
    return EntityState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=device))


def entity_step(entity: EntityState, grads, opt: Optimizer) -> EntityState:
    """One optimizer step; works on one entity or a stacked cohort."""
    if opt.apply is not None:
        # fused path (the fused-Adam kernel): one pass that produces new
        # params + new optimizer state directly
        new_params, new_opt = opt.apply(grads, entity.opt_state,
                                        entity.params, entity.step)
        return EntityState(new_params, new_opt, entity.step + 1)
    updates, new_opt = opt.update(grads, entity.opt_state, entity.params,
                                  entity.step)
    return EntityState(apply_updates(entity.params, updates), new_opt,
                       entity.step + 1)


def stack_entities(entities: list[EntityState]) -> EntityState:
    """Stack entities (or any trees of one structure, such as their
    gradients) along a new leading cohort dim: contiguous [C, ...]
    leaves, as the fused Adam kernel takes them."""
    return tree_map(lambda *xs: torch.stack(xs), *entities)


def entity_mean(stacked: EntityState) -> EntityState:
    """FedAvg over the leading cohort dim, dtype-preserving (the int32
    step stays int32: every member stepped once, so its mean is exact)."""
    return tree_map(lambda x: (x.sum(0) / x.shape[0]).to(x.dtype), stacked)


def broadcast_entity(entity: EntityState, n: int) -> EntityState:
    """Replicate one entity n times along a new leading dim.  The copies
    are materialized: the fused kernels take contiguous leaves."""
    return tree_map(lambda x: x.unsqueeze(0).expand((n,) + tuple(x.shape))
                    .contiguous(), entity)


def take_entities(stacked: EntityState, idx: torch.Tensor) -> EntityState:
    """Gather cohort slots.  Padded slots carry the sentinel id N; it is
    clamped to a real client (the slot is masked out downstream)."""
    def one(x):
        return torch.index_select(x, 0, idx.clamp(0, x.shape[0] - 1))
    return tree_map(one, stacked)


def put_entities(stacked: EntityState, idx: torch.Tensor,
                 values: EntityState) -> EntityState:
    """Scatter cohort slots back; writes at the sentinel id N (or any id
    out of range) are dropped, so padded slots are no-ops."""
    n = stacked.step.shape[0]
    # out-of-range ids land in one extra scratch row that is cut off
    dst = torch.where((idx >= 0) & (idx < n), idx, n).long()

    def one(x, v):
        ext = torch.cat([x, x[:1]])
        return ext.index_copy(0, dst, v)[:n]
    return tree_map(one, stacked, values)


def masked_axis0_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked, dtype-preserving mean over the leading axis: rows with
    mask 0 contribute exact zeros and are excluded from the count."""
    mb = mask.reshape((-1,) + (1,) * (x.dim() - 1))
    total = torch.where(mb > 0, x, torch.zeros((), dtype=x.dtype,
                                               device=x.device)).sum(0)
    return (total / mask.sum()).to(x.dtype)


def masked_entity_mean(stacked: EntityState, mask: torch.Tensor
                       ) -> EntityState:
    """FedAvg over the live slots only: ``mask`` is [C] with 1.0 for
    live cohort members, 0.0 for padded slots."""
    return tree_map(lambda x: masked_axis0_mean(x, mask), stacked)


def select_entities(mask, new: EntityState, old: EntityState) -> EntityState:
    """Per-slot select: live slots (mask > 0) take ``new``, the others
    keep ``old``.  ``mask`` is [C], or a scalar for one entity."""
    m = torch.as_tensor(mask)

    def one(n, o):
        mb = m.reshape(tuple(m.shape) + (1,) * (n.dim() - m.dim()))
        return torch.where(mb > 0, n, o)
    return tree_map(one, new, old)
