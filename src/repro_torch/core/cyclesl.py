"""CycleSL round — paper Algorithm 1.

Port of ``repro/core/cyclesl.py`` without the mesh and pipeline hooks.

  1. clients extract features        B_i^f = θ_C_i(B_i^x)
  2. server pools a feature dataset  D_S^f = ⨄ B_i^f           (Eq. 3)
  3. server trains E epochs on resampled shuffled minibatches   (Eq. 3)
  4. server FREEZES θ_S^{t+1} and computes feature gradients
     B_i^g = ∇_{B_i^f} L(θ_S^{t+1}(B_i^f))                     (Eq. 5)
  5. clients pull B_i^g through their local VJP and step        (Eq. 5)

PyTorch runs eagerly, so the JAX package's ``vmap`` over cohort slots is
a Python loop over slots here, and its ``scan`` over server steps a
Python loop.  Nothing in the loops reads a value back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.core.feature_store import (FeatureStore, gather_batch,
                                            masked_resample_plan, pool_store,
                                            resample_plan)
from repro_torch.core.protocol import (EntityState, entity_step,
                                       masked_axis0_mean, select_entities)
from repro_torch.core.split import SplitTask
from repro_torch.kernels import ops
from repro_torch.optim import Optimizer, clip_by_global_norm
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
    # mesh-only knob of the JAX package; not ported (must stay False)
    shard_local_resample: bool = False
    # the JAX package's kernel override; the port picks the kernel by
    # device, so this must stay None
    resample_use_kernel: Optional[bool] = None
    # fuse the resample gather with the server head's loss (the
    # gather_loss kernel).  Engages only for tasks exposing a linear head
    # (SplitTask.server_head) with integer labels; ignored otherwise.
    fused_gather_loss: bool = False

    def check_ported(self) -> "CycleConfig":
        if self.shard_local_resample:
            raise NotImplementedError(
                "cycle.shard_local_resample needs a mesh, which the port "
                "does not have yet")
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


def _maybe_clip(grads, max_norm: Optional[float]):
    if max_norm is None:
        return grads
    clipped, _ = clip_by_global_norm(grads, max_norm)
    return clipped


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
                      batch: int, plan_fn: Optional[PlanFn] = None
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
    task exposes a linear server head.
    """
    device = store.features.device
    sb = min(ccfg.server_batch or batch, store.size)
    labels = store.labels
    fused = (ccfg.fused_gather_loss and task.server_head is not None
             and isinstance(labels, torch.Tensor)
             and labels.dtype in (torch.int32, torch.int64))
    if plan_fn is not None:
        plan, step_ok = plan_fn(key, store.valid, ccfg.server_epochs, sb)
    elif store.valid is None:
        plan = resample_plan(key, store.size, ccfg.server_epochs, sb, device)
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
    flat = store.features.reshape(store.size, -1)

    def apply_step(entity, idx):
        if fused:
            loss_fn = lambda p: ops.fused_gather_loss_mean(
                flat, labels, idx, task.server_head(p))
        else:
            f, y = gather_batch(store, idx)
            loss_fn = lambda p: task.server_loss(p, f, y)
        loss, grads = _value_and_grad(loss_fn, entity.params)
        grads = _maybe_clip(grads, ccfg.grad_clip)
        return entity_step(entity, grads, opt_s), loss

    if step_ok is None:
        losses = []
        for s in range(plan2.shape[0]):
            server, loss = apply_step(server, plan2[s])
            losses.append(loss)
        return server, torch.stack(losses).mean()

    ok2 = step_ok.to(device=device, dtype=torch.bool).reshape(-1)
    loss_sum = torch.zeros((), dtype=torch.float32, device=device)
    for s in range(plan2.shape[0]):
        stepped, loss = apply_step(server, plan2[s])
        server = select_entities(ok2[s], stepped, server)
        loss_sum = loss_sum + torch.where(ok2[s], loss, 0.0)
    denom = torch.clamp(ok2.sum().float(), min=1.0)
    return server, loss_sum / denom


def feature_gradients(task: SplitTask, server_params, feats, ys,
                      ccfg: CycleConfig, mask=None) -> torch.Tensor:
    """B_i^g for every cohort member, with θ_S^{t+1} frozen (Eq. 5).

    Each client's gradient is that of ITS OWN batch-mean loss: the sum of
    the per-client losses is differentiated (one pooled mean over all
    C·b rows would scale every gradient by 1/C).  ``mask`` restricts the
    SGLR-style cohort mean to live slots.
    """
    frozen = tree_map(lambda p: p.detach(), server_params)
    f = feats.detach().requires_grad_(True)
    with torch.enable_grad():
        total = sum(task.server_loss(frozen, f[c], _slot(ys, c))
                    for c in range(f.shape[0]))
        (grads,) = torch.autograd.grad(total, f)
    if ccfg.avg_client_grads:
        mean = (grads.mean(0) if mask is None
                else masked_axis0_mean(grads, mask))
        grads = mean.unsqueeze(0).expand_as(grads).contiguous()
    return grads


def _client_grads(task: SplitTask, params, x, g, grad_clip):
    """One client's VJP of its feature gradient ``g``, clipped, and the
    global norm of the clipped grads."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        out = task.client_forward(tree_unflatten_like(params, leaves), x)
        grads = torch.autograd.grad(out, leaves, grad_outputs=g.to(out.dtype))
    grads = _maybe_clip(tree_unflatten_like(params, list(grads)), grad_clip)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(l.float()))
                           for l in tree_leaves(grads)))
    return grads, gnorm


def client_update_one(task: SplitTask, entity: EntityState, x, g,
                      opt_c: Optimizer, grad_clip: Optional[float] = None
                      ) -> tuple[EntityState, torch.Tensor]:
    """One client's phase-5 step: pull ``g`` through the local VJP,
    optionally clip, take one optimizer step.  Returns the stepped entity
    and the global norm of the applied (clipped) grads."""
    grads, gnorm = _client_grads(task, entity.params, x, g, grad_clip)
    return entity_step(entity, grads, opt_c), gnorm


def client_updates(task: SplitTask, clients: EntityState, opt_c: Optimizer,
                   xs, feat_grads, grad_clip: Optional[float] = None,
                   mask=None) -> tuple[EntityState, torch.Tensor]:
    """Pull B_i^g through each slot's VJP and step the stacked cohort.

    The per-slot gradients are stacked and the whole cohort steps at
    once: the fused Adam kernel bias-corrects each slot with its own
    step.  With ``mask`` set, padded slots pass through unchanged and
    their grad norm reads 0.
    """
    per_slot = [_client_grads(task, tree_map(lambda p: p[c], clients.params),
                              _slot(xs, c), feat_grads[c], grad_clip)
                for c in range(_n_slots(xs))]
    grads = tree_map(lambda *gs: torch.stack(gs),
                     *(g for g, _ in per_slot))
    gnorms = torch.stack([n for _, n in per_slot])
    new_clients = entity_step(clients, grads, opt_c)
    if mask is not None:
        new_clients = select_entities(mask, new_clients, clients)
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
                 plan_fn: Optional[PlanFn] = None):
    """Phases 3-5 of Algorithm 1 on an extract handoff.  Returns
    (server', clients', metrics)."""
    batch = tree_leaves(ys)[0].shape[1]
    server, server_loss = server_inner_loop(
        task, server, opt_s, store, key, ccfg, batch=batch, plan_fn=plan_fn)
    fgrads = feature_gradients(task, server.params, feats, ys, ccfg)
    fg_flat = fgrads.reshape(fgrads.shape[0], -1).float()
    per_sample_norm = (torch.linalg.vector_norm(fg_flat, dim=-1)
                       / fg_flat.shape[-1] ** 0.5)
    clients, client_gnorms = client_updates(task, clients, opt_c, xs, fgrads,
                                            grad_clip=ccfg.grad_clip)
    metrics = {
        "server_loss": server_loss,
        "feat_grad_norm_mean": per_sample_norm.mean(),
        "feat_grad_norm_std": per_sample_norm.std(correction=0),
        "client_grad_norm_mean": client_gnorms.mean(),
    }
    return server, clients, metrics


def cyclesl_round(task: SplitTask, server: EntityState, clients: EntityState,
                  opt_s: Optimizer, opt_c: Optimizer, xs, ys, key: int,
                  ccfg: CycleConfig, plan_fn: Optional[PlanFn] = None):
    """One full CycleSL round (Algorithm 1) on cohort-stacked [C, b, ...]
    batches and a cohort-stacked client EntityState: extract ∘ tail.
    Returns (server', clients', metrics)."""
    feats, store = cyclesl_extract(task, clients, xs, ys)
    return cyclesl_tail(task, server, clients, opt_s, opt_c, xs, ys, key,
                        ccfg, feats, store, plan_fn=plan_fn)
