"""Minimal functional optimizers over param trees (dicts and lists of
tensors), mirroring ``repro/optim/optimizer.py``.

An ``Optimizer`` is an (init, update) pair with an optional fused step:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)

``step`` is an int32 tensor on the params' device: a scalar for one
entity, or [C] for params stacked over C entities (leaves [C, ...]),
each row then bias-corrected with its own count.  Nothing here reads the
step back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.sharding.parallel import global_norm
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]   # (grads, state, params, step)
    # optional fused step: (grads, state, params, step) -> (params', state').
    # When set, repro_torch.core.protocol.entity_step uses it instead of
    # update + apply_updates: one kernel pass over each leaf.  Must be
    # numerically equivalent to the update path.
    apply: Optional[Callable[..., tuple[Any, Any]]] = None
    # its in-place form (the donated step): (grads, state, params, step,
    # keep=None) -> (params, state), the same tensors updated where they
    # lie; an entity whose int32 ``keep`` flag is 0 is left as it was
    apply_: Optional[Callable[..., tuple[Any, Any]]] = None


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def _rows_like(x, leaf: torch.Tensor):
    """A scalar or [C] tensor (t, a scheduled lr) shaped to broadcast
    over ``leaf``: from a [C] step each row of a [C, ...] leaf takes its
    own value, as the JAX package's vmap over a stacked step gives.  A
    Python float (a constant lr) passes as it is."""
    if not isinstance(x, torch.Tensor):
        return x
    x = x.to(leaf.device)
    return x.reshape(x.shape + (1,) * (leaf.dim() - x.dim()))


def sgd(lr: float | Callable[[Any], Any], momentum: float = 0.0) -> Optimizer:
    sched = lr if callable(lr) else (lambda step: lr)

    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)

    def update(grads, state, params=None, step=0):
        lr_t = sched(step)
        if momentum == 0.0:
            return tree_map(lambda g: -_rows_like(lr_t, g) * g.float(),
                            grads), state
        new_m = tree_map(lambda m, g: momentum * m + g.float(), state, grads)
        return tree_map(lambda m: -_rows_like(lr_t, m) * m, new_m), new_m

    return Optimizer(init, update)


def adam(lr: float | Callable[[Any], Any], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0,
         fused: Optional[bool] = None) -> Optimizer:
    """Adam with an optional fused step.

    ``fused=None`` (the default) takes the fused step for a constant
    ``lr``: ``kernels.ops.fused_adam`` launches the CUDA kernel on CUDA
    params and runs its plain version on CPU params.  ``fused=False``
    keeps the tree-map update on any device.  The kernel takes ``lr`` as
    a constant, so a schedule with ``fused=True`` raises.
    """
    sched = lr if callable(lr) else (lambda step: lr)
    if fused is None:
        fused = not callable(lr)
    if fused and callable(lr):
        raise ValueError("fused adam requires a constant lr "
                         "(the kernel takes it as a constant); pass "
                         "fused=False for schedules")

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params=None, step=0):
        lr_t = sched(step)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.float() * g.float(),
                     state["v"], grads)

        def one(mm, vv, p):
            t = _rows_like(torch.as_tensor(step).float() + 1.0, mm)
            lr = _rows_like(lr_t, mm)
            mh = mm / (1 - torch.pow(b1, t))
            vh = vv / (1 - torch.pow(b2, t))
            u = -lr * mh / (torch.sqrt(vh) + eps)
            if weight_decay and p is not None:
                u = u - lr * weight_decay * p.float()
            return u

        if params is None:
            upd = tree_map(lambda mm, vv: one(mm, vv, None), m, v)
        else:
            upd = tree_map(one, m, v, params)
        return upd, {"m": m, "v": v}

    def leafwise(kernel, grads, state, params, step, **extra):
        # leafwise fused update: each (p, g, m, v) is read once and
        # (p, m, v) written once per step; a gradient that autograd left
        # strided (through a permute) is packed for the kernel
        outs = [kernel(p, g.contiguous(), m, v, step, lr=lr, b1=b1, b2=b2,
                       eps=eps, weight_decay=weight_decay, **extra)
                for p, g, m, v in zip(tree_leaves(params),
                                      tree_leaves(grads),
                                      tree_leaves(state["m"]),
                                      tree_leaves(state["v"]))]
        return (tree_unflatten_like(params, [o[0] for o in outs]),
                {"m": tree_unflatten_like(params, [o[1] for o in outs]),
                 "v": tree_unflatten_like(params, [o[2] for o in outs])})

    def apply(grads, state, params, step):
        return leafwise(ops.fused_adam, grads, state, params, step)

    def apply_(grads, state, params, step, keep=None):
        return leafwise(ops.fused_adam_, grads, state, params, step,
                        keep=keep)

    return (Optimizer(init, update, apply, apply_) if fused
            else Optimizer(init, update))


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """Scale ``grads`` so their global norm is at most ``max_norm``;
    returns (clipped, norm) with the norm left on the device.  ``norm``
    is the tree's norm where the caller has it (a tree of blocks on a
    mesh, ``sharding.parallel.global_norm(grads, tp, plan, data)``)."""
    gn = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gn
