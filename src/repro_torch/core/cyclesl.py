"""CycleSL round — paper Algorithm 1.

Port of ``repro/core/cyclesl.py``.

  1. clients extract features        B_i^f = θ_C_i(B_i^x)
  2. server pools a feature dataset  D_S^f = ⨄ B_i^f           (Eq. 3)
  3. server trains E epochs on resampled shuffled minibatches   (Eq. 3)
  4. server FREEZES θ_S^{t+1} and computes feature gradients
     B_i^g = ∇_{B_i^f} L(θ_S^{t+1}(B_i^f))                     (Eq. 5)
  5. clients pull B_i^g through their local VJP and step        (Eq. 5)

PyTorch runs eagerly, so the JAX package's ``vmap`` over cohort slots is
a Python loop over slots here, and its ``scan`` over server steps a
Python loop.  Nothing in the loops reads a value back to the host.

On a mesh (a ``SlotSplit`` passed as ``split``) the slot loops run over
the rank's own slots, D_S^f stays row-sharded, and the server, the same
on every rank, steps data-parallel: each rank's part of a minibatch,
its loss and gradients reduced over ranks (see
:func:`server_inner_loop`).  On a ``model`` axis (the task's ``tp``)
every rank of a model group draws the same plan and resamples the same
minibatch, the reference's replicated server batch, and the halves run
on the rank's shards; gradient norms (the clip, the reported client
norms) sum the shards' squares over the axis (``sharding.parallel``).
With FSDP over ``data`` (the task's ``fsdp``: set only where the round
splits the cohort, ``api.phases.build_algorithm``) the server holds its blocks of the leaves its plan splits over ``data``:
every step gathers them at use, and the backward hands each rank its
block of the gradient, reduce-scattered from the data-parallel
minibatch's partial sums or sliced from the replicated one's; the step
runs on the blocks.

``donate`` (every entry point's keyword, off by default) steps the
server and the clients in place (``core.protocol.entity_step(...,
donate=True)``): the caller reads the entities it passed in no more.  A
masked step is then skipped in the kernel (``keep``) instead of selected
against a kept copy, so a round holds each entity's state once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.core.feature_store import (FeatureStore, gather_batch,
                                            gather_everything,
                                            masked_resample_plan, pool_store,
                                            resample_plan,
                                            shard_local_fused_loss,
                                            shard_local_gather)
from repro_torch.core.protocol import (EntityState, SlotSplit, entity_step,
                                       gather_slots, slot_mean)
from repro_torch.core.split import SplitTask
from repro_torch.kernels import ops
from repro_torch.optim import Optimizer, clip_by_global_norm
from repro_torch.sharding.parallel import gather_from_data, global_norm
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like

# plan_fn(key, valid, epochs, server_batch) -> (plan [E, steps, sb] int,
# step_ok [E, steps] bool or None): the resample plan, injectable so that
# tests can feed both packages one plan
PlanFn = Callable[..., tuple]


@dataclass(frozen=True)
class CycleConfig:
    server_epochs: int = 1          # E in Algorithm 1 (Table 5 ablation)
    server_batch: Optional[int] = None  # default: the client batch size b
    # cap on resampled minibatch STEPS per epoch (None = full coverage)
    server_steps: Optional[int] = None
    avg_client_grads: bool = False  # CycleSGLR: SGLR-style grad averaging
    # global-norm clip on every server and client step (None = off)
    grad_clip: Optional[float] = None
    # on a mesh, resample each server minibatch shard-LOCAL (each rank
    # gathers the rows of its pool slice, a masked sum assembles the
    # minibatch) instead of gathering the whole pool to every rank; bit
    # for bit the same minibatches.  Inert off the mesh.
    shard_local_resample: bool = False
    # the JAX package's kernel override; the port picks the kernel by
    # device, so this must stay None
    resample_use_kernel: Optional[bool] = None
    # fuse the resample gather with the server head's loss (the
    # gather_loss kernel).  Engages only for tasks exposing a linear head
    # (SplitTask.server_head) with integer labels; ignored otherwise.
    fused_gather_loss: bool = False

    def check_ported(self) -> "CycleConfig":
        if self.resample_use_kernel is not None:
            raise NotImplementedError(
                "cycle.resample_use_kernel: the port takes the kernel on "
                "CUDA tensors and its plain version on CPU tensors")
        return self


def _slot(tree, c: int):
    """Cohort slot ``c`` of a [C, ...]-stacked batch: a tensor, or any
    tree of them (the transformer task's ``{"tokens": [C, b, S]}``), as
    the JAX package's vmap takes any pytree."""
    return tree_map(lambda a: a[c], tree)


def _n_slots(tree) -> int:
    return tree_leaves(tree)[0].shape[0]


def _maybe_clip(grads, max_norm: Optional[float], tp=None, plan=None,
                data=None):
    """Clip to ``max_norm``; with a model axis (``tp``) or a ``data``
    split the norm is that of the whole tree, summed over the blocks
    (``plan`` says which leaves are blocks)."""
    if max_norm is None:
        return grads
    clipped, _ = clip_by_global_norm(grads, max_norm,
                                     global_norm(grads, tp, plan, data))
    return clipped


def task_plan(task: SplitTask, half: str):
    """The task's plan of ``half`` ('server' or 'client'), or None."""
    return None if task.plans is None else task.plans.get(half)


def server_whole(task: SplitTask, params):
    """The server's params whole over ``data``, outside autograd (the
    frozen server of the feature gradients, a replica's copy)."""
    if task.fsdp is None:
        return params
    with torch.no_grad():
        return gather_from_data(task.fsdp, params, task_plan(task, "server"))


def _value_and_grad(loss_fn, params):
    """(loss, d loss / d params) for a scalar ``loss_fn(params)``; a leaf
    the loss does not use gets a zero gradient, as under ``jax.grad``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten_like(params, leaves))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(l) if g is None else g
             for l, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten_like(params, grads)


def server_inner_loop(task: SplitTask, server: EntityState, opt_s: Optimizer,
                      store: FeatureStore, key: int, ccfg: CycleConfig,
                      batch: int, plan_fn: Optional[PlanFn] = None,
                      grad_scale=None, split: Optional[SlotSplit] = None,
                      donate: bool = False
                      ) -> tuple[EntityState, torch.Tensor]:
    """E epochs of minibatch training on the resampled feature dataset.

    With a row-validity mask on the store (padded cohort) the loop runs
    the capacity's worth of steps, but a step whose rows are not all live
    is an exact no-op (the entity passes through unchanged and its loss
    is left out of the mean), so the result equals an unpadded pool of
    the live rows.  The loss sum is a sequential carry and its
    denominator is floored at 1.

    ``key`` is the round's integer key; ``plan_fn`` replaces the port's
    own plan (see ``PlanFn``).  ``ccfg.fused_gather_loss`` fuses gather
    and head loss through ``kernels.ops.fused_gather_loss_mean`` when the
    task exposes a linear server head.  ``grad_scale`` (a scalar tensor,
    or None) multiplies every clipped gradient before the optimizer
    step: the staleness-weighting hook of pipelined rounds.  ``donate``
    steps ``server`` in place (a masked step skipped by ``keep``).

    ``split`` puts the loop on a mesh: ``store`` holds this rank's pool
    slice, the plan (from the full validity, the same on every rank)
    indexes the whole pool, and each minibatch comes shard-local
    (``ccfg.shard_local_resample``) or from the pool gathered once.  When
    the minibatch's rows divide the ranks, each rank takes the loss of
    its part, scaled by its share of the rows (1 at one rank, never
    multiplied in), and the loss and gradients are summed with one
    ``all_reduce``; the fused loss reduces its own.  A server split over
    a model axis (the task's ``tp``) takes the whole minibatch on every
    rank instead, as the reference's ``tp_layout`` does.  Clipping and the
    step follow on the summed gradients, so the server stays the same on
    every rank.
    """
    device = store.features.device
    n = 1 if split is None else split.comm.size
    total = store.size * n
    sb = min(ccfg.server_batch or batch, total)
    labels = store.labels
    fused = (ccfg.fused_gather_loss and task.server_head is not None
             and isinstance(labels, torch.Tensor)
             and labels.dtype in (torch.int32, torch.int64))
    if plan_fn is not None:
        plan, step_ok = plan_fn(key, store.valid, ccfg.server_epochs, sb)
    elif store.valid is None:
        plan = resample_plan(key, total, ccfg.server_epochs, sb, device)
        step_ok = None
    else:
        plan, step_ok = masked_resample_plan(key, store.valid,
                                             ccfg.server_epochs, sb)
    if ccfg.server_steps is not None:
        plan = plan[:, : ccfg.server_steps]
        if step_ok is not None:
            step_ok = step_ok[:, : ccfg.server_steps]
    plan2 = (plan.reshape(-1, sb).to(device=device, dtype=torch.int32)
             .contiguous())
    shard_local = split is not None and ccfg.shard_local_resample
    pool = store
    if split is not None and not shard_local:
        pool = gather_everything(store, split)
    flat = pool.features.reshape(pool.size, -1)
    # the reference's tp_layout: a server whose weights split over a
    # model axis takes the whole minibatch on every rank (its MoE groups,
    # and so its capacity drops, stay those of the unsharded step);
    # else a data-parallel minibatch, this rank's rows [m0, m1) a step
    plan = task_plan(task, "server")
    tp_layout = (plan is not None and task.tp.size > 1
                 and any(s.dim is not None for s in tree_leaves(plan)))
    dp = split is not None and not fused and sb % n == 0 and not tp_layout
    if dp:
        m0 = split.comm.rank * (sb // n)
        m1 = m0 + sb // n
        share = (m1 - m0) / sb
    # FSDP: the leaves split over data are gathered at use; from the
    # data-parallel minibatch their gradients come back reduce-scattered
    # (this rank's block of the sum), from a replicated one sliced
    fsdp = task.fsdp
    if fsdp is not None and split is None:
        raise ValueError("a server in FSDP blocks steps on a cohort split "
                         "over the mesh")
    blocked = ({i for i, s in enumerate(tree_leaves(plan))
                if s.ddim is not None}
               if fsdp is not None and plan is not None else set())

    def whole(p):
        return p if fsdp is None else gather_from_data(
            fsdp, p, plan, split.comm if dp else None)

    def step_loss_and_grads(params, idx):
        if fused:
            if shard_local:
                loss_fn = lambda p: shard_local_fused_loss(
                    store, idx, task.server_head(whole(p)), split)
            else:
                loss_fn = lambda p: ops.fused_gather_loss_mean(
                    flat, pool.labels, idx, task.server_head(whole(p)))
            return _value_and_grad(loss_fn, params)
        if shard_local:
            f, y = shard_local_gather(store, idx, split,
                                      replicate_out=tp_layout)
        else:
            f, y = gather_batch(pool, idx[m0:m1] if dp else idx)
        if not dp:
            return _value_and_grad(
                lambda p: task.server_loss(whole(p), f, y), params)
        loss_fn = ((lambda p: task.server_loss(whole(p), f, y))
                   if share == 1.0 else
                   (lambda p: task.server_loss(whole(p), f, y) * share))
        loss, grads = _value_and_grad(loss_fn, params)
        leaves = tree_leaves(grads)
        rest = [i for i in range(len(leaves)) if i not in blocked]
        summed = split.comm.all_reduce_tree([leaves[i] for i in rest]
                                            + [loss], "grads")
        for i, g in zip(rest, summed):
            leaves[i] = g
        return summed[-1], tree_unflatten_like(grads, leaves)

    def apply_step(entity, idx, keep=None):
        loss, grads = step_loss_and_grads(entity.params, idx)
        grads = _maybe_clip(grads, ccfg.grad_clip, task.tp, plan, fsdp)
        if grad_scale is not None:
            grads = tree_map(lambda g: g * grad_scale, grads)
        return entity_step(entity, grads, opt_s, donate=donate,
                           keep=keep), loss

    if step_ok is None:
        losses = []
        for s in range(plan2.shape[0]):
            server, loss = apply_step(server, plan2[s])
            losses.append(loss)
        return server, torch.stack(losses).mean()

    ok2 = step_ok.to(device=device, dtype=torch.bool).reshape(-1)
    loss_sum = torch.zeros((), dtype=torch.float32, device=device)
    for s in range(plan2.shape[0]):
        # a step whose rows are not all live passes the server through
        server, loss = apply_step(server, plan2[s], keep=ok2[s])
        loss_sum = loss_sum + torch.where(ok2[s], loss, 0.0)
    denom = torch.clamp(ok2.sum().float(), min=1.0)
    return server, loss_sum / denom


def feature_gradients(task: SplitTask, server_params, feats, ys,
                      ccfg: CycleConfig, mask=None,
                      split: Optional[SlotSplit] = None) -> torch.Tensor:
    """B_i^g for every cohort member, with θ_S^{t+1} frozen (Eq. 5).

    Each client's gradient is that of ITS OWN batch-mean loss: the sum of
    the per-client losses is differentiated (one pooled mean over all
    C·b rows would scale every gradient by 1/C).  ``mask`` restricts the
    SGLR-style cohort mean to live slots.  With ``split``, ``feats`` and
    ``ys`` are this rank's slots, ``mask`` the full [C] mask, and the
    cohort mean runs over every rank's slots.
    """
    frozen = server_whole(task, tree_map(lambda p: p.detach(), server_params))
    f = feats.detach().requires_grad_(True)
    with torch.enable_grad():
        total = sum(task.server_loss(frozen, f[c], _slot(ys, c))
                    for c in range(f.shape[0]))
        (grads,) = torch.autograd.grad(total, f)
    if ccfg.avg_client_grads:
        mean = slot_mean(grads, mask, split)
        grads = mean.unsqueeze(0).expand_as(grads).contiguous()
    return grads


def _client_grads(task: SplitTask, params, x, g, grad_clip):
    """One client's VJP of its feature gradient ``g``, clipped, and the
    global norm of the clipped grads."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        out = task.client_forward(tree_unflatten_like(params, leaves), x)
        grads = torch.autograd.grad(out, leaves, grad_outputs=g.to(out.dtype))
    # a slot's copy is whole over data: its plan's model blocks only
    plan = task_plan(task, "client")
    grads = _maybe_clip(tree_unflatten_like(params, list(grads)), grad_clip,
                        task.tp, plan)
    return grads, global_norm(grads, task.tp, plan)


def client_update_one(task: SplitTask, entity: EntityState, x, g,
                      opt_c: Optimizer, grad_clip: Optional[float] = None,
                      *, donate: bool = False, keep=None
                      ) -> tuple[EntityState, torch.Tensor]:
    """One client's phase-5 step: pull ``g`` through the local VJP,
    optionally clip, take one optimizer step (``donate`` and ``keep`` as
    ``core.protocol.entity_step`` takes them).  Returns the stepped
    entity and the global norm of the applied (clipped) grads."""
    grads, gnorm = _client_grads(task, entity.params, x, g, grad_clip)
    return entity_step(entity, grads, opt_c, donate=donate, keep=keep), gnorm


def client_updates(task: SplitTask, clients: EntityState, opt_c: Optimizer,
                   xs, feat_grads, grad_clip: Optional[float] = None,
                   mask=None, donate: bool = False
                   ) -> tuple[EntityState, torch.Tensor]:
    """Pull B_i^g through each slot's VJP and step the stacked cohort.

    The per-slot gradients are stacked and the whole cohort steps at
    once: the fused Adam kernel bias-corrects each slot with its own
    step.  With ``mask`` set, padded slots pass through unchanged and
    their grad norm reads 0.  ``donate`` steps ``clients`` in place.
    """
    per_slot = [_client_grads(task, tree_map(lambda p: p[c], clients.params),
                              _slot(xs, c), feat_grads[c], grad_clip)
                for c in range(_n_slots(xs))]
    grads = tree_map(lambda *gs: torch.stack(gs),
                     *(g for g, _ in per_slot))
    gnorms = torch.stack([n for _, n in per_slot])
    new_clients = entity_step(clients, grads, opt_c, donate=donate,
                              keep=mask)
    if mask is not None:
        gnorms = torch.where(mask > 0, gnorms, 0.0)
    return new_clients, gnorms


def extract_features(task: SplitTask, client_params, xs) -> torch.Tensor:
    """Smashed data of every cohort slot, [C, b, ...], outside autograd
    (the client phase recomputes its forward under its own VJP)."""
    with torch.no_grad():
        return torch.stack([task.client_forward(
            tree_map(lambda p: p[c], client_params), _slot(xs, c))
            for c in range(_n_slots(xs))])


def cyclesl_extract(task: SplitTask, clients: EntityState, xs, ys
                    ) -> tuple[torch.Tensor, FeatureStore]:
    """Phases 1-2 of Algorithm 1: client feature extraction plus the
    pooled D_S^f handoff (Eq. 3).  Returns ``(feats, store)``."""
    feats = extract_features(task, clients.params, xs)
    return feats, pool_store(feats, ys)


def cyclesl_tail(task: SplitTask, server: EntityState, clients: EntityState,
                 opt_s: Optimizer, opt_c: Optimizer, xs, ys, key: int,
                 ccfg: CycleConfig, feats, store: FeatureStore,
                 plan_fn: Optional[PlanFn] = None,
                 split: Optional[SlotSplit] = None, donate: bool = False):
    """Phases 3-5 of Algorithm 1 on an extract handoff.  Returns
    (server', clients', metrics).  With ``split`` the cohort arrays and
    ``clients`` are this rank's slots, and the metrics run over every
    rank's (the same on every rank).  ``donate`` steps ``server`` and
    ``clients`` in place: the feature gradients read the updated server
    alone, so nothing reads the old one."""
    batch = tree_leaves(ys)[0].shape[1]
    server, server_loss = server_inner_loop(
        task, server, opt_s, store, key, ccfg, batch=batch, plan_fn=plan_fn,
        split=split, donate=donate)
    fgrads = feature_gradients(task, server.params, feats, ys, ccfg,
                               split=split)
    fg_flat = fgrads.reshape(fgrads.shape[0], -1).float()
    per_sample_norm = gather_slots(torch.linalg.vector_norm(fg_flat, dim=-1)
                                   / fg_flat.shape[-1] ** 0.5, split)
    clients, client_gnorms = client_updates(task, clients, opt_c, xs, fgrads,
                                            grad_clip=ccfg.grad_clip,
                                            donate=donate)
    client_gnorms = gather_slots(client_gnorms, split)
    metrics = {
        "server_loss": server_loss,
        "feat_grad_norm_mean": per_sample_norm.mean(),
        "feat_grad_norm_std": per_sample_norm.std(correction=0),
        "client_grad_norm_mean": client_gnorms.mean(),
    }
    return server, clients, metrics


def cyclesl_round(task: SplitTask, server: EntityState, clients: EntityState,
                  opt_s: Optimizer, opt_c: Optimizer, xs, ys, key: int,
                  ccfg: CycleConfig, plan_fn: Optional[PlanFn] = None,
                  split: Optional[SlotSplit] = None, donate: bool = False):
    """One full CycleSL round (Algorithm 1) on cohort-stacked [C, b, ...]
    batches and a cohort-stacked client EntityState: extract ∘ tail.
    Returns (server', clients', metrics).  ``split`` runs it on a mesh's
    batch axes, the batches and ``clients`` this rank's slots;
    ``donate`` steps ``server`` and ``clients`` in place."""
    feats, store = cyclesl_extract(task, clients, xs, ys)
    return cyclesl_tail(task, server, clients, opt_s, opt_c, xs, ys, key,
                        ccfg, feats, store, plan_fn=plan_fn, split=split,
                        donate=donate)
