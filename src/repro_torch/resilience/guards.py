"""Health-guard math: NaN/Inf and loss-spike detection.

Port of ``repro/resilience/guards.py`` in plain torch ops on values the
round already computes — the committed TrainState, the round's server
loss, the cohort's smashed data and feature gradients — so the
:class:`~repro_torch.api.phases.HealthGuard` phase adds a few small
launches to the round and no host read.  The Engine reads back one
small ``health`` vector per round (the single host sync the guard costs)
and the per-slot blame array only when the verdict is bad.

The whole-tree check takes one max-abs pass over all leaves
(``torch._foreach_norm`` with ord inf, a multi-tensor launch on the
card; a NaN propagates through the max) rather than an ``isfinite``
launch or two a leaf.

On a mesh each rank checks only its part: its cohort slots' features
and feature gradients, and its shards of the state (its rows of the
per-client store, its FSDP blocks, its ``model`` blocks).  The slot
blame is then gathered to the whole [C] over the batch axes, and the
rank's non-finite flag rides in the same gather and is summed over
every other axis of the mesh (:func:`agree`), so the packed vector
holds the same bits on every rank: every rank reaches the same verdict
and takes the same recovery path, whose collectives would otherwise
part.  The loss and the EMA carry are the same on every rank already.

Layout of the packed ``metrics['health']`` vector (float32 [4]):

    [0] nonfinite — 1.0 when the loss, the committed params/opt state,
        or any live slot's features/feature-gradients contain NaN/Inf
    [1] spike     — 1.0 when the loss exceeds ``spike_factor`` x the
        EMA of accepted losses (armed only once the EMA is warm; the
        Engine additionally host-gates on ``spike_warmup`` rounds)
    [2] new_ema   — the EMA updated with this round's loss (fed back as
        next round's ``ema`` input IF the round is accepted)
    [3] slot_bad_any — 1.0 when any live slot is to blame (quarantine
        has a target)
"""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_leaves

# metrics['health'] slot names, in packing order
HEALTH_NONFINITE, HEALTH_SPIKE, HEALTH_EMA, HEALTH_SLOT_ANY = range(4)


def _inexact(leaves) -> list:
    """The non-empty floating-point tensors among ``leaves``: integer
    leaves (step counters, index plans) are finite by construction."""
    return [l for l in leaves if isinstance(l, torch.Tensor)
            and (l.is_floating_point() or l.is_complex()) and l.numel()]


def _true(leaves, device=None) -> torch.Tensor:
    dev = leaves[0].device if leaves else device
    return torch.ones((), dtype=torch.bool, device=dev)


def tree_all_finite(tree, device=None) -> torch.Tensor:
    """Scalar bool tensor: every inexact leaf of ``tree`` is NaN/Inf-free.

    Integer leaves are skipped.  ``device`` places the answer for a
    tree without inexact leaves (default: the CPU).
    """
    leaves = _inexact(tree_leaves(tree))
    if not leaves:
        return _true(leaves, device)
    peaks = torch._foreach_norm(leaves, float("inf"))
    return torch.isfinite(torch.stack([p.float() for p in peaks])).all()


def slot_nonfinite(arrs, n_slots: int, mask=None,
                   device=None) -> torch.Tensor:
    """[C] float32 blame vector: 1.0 where a LIVE cohort slot delivered
    NaN/Inf in any of ``arrs`` (each a [C, ...] stack or None).

    Padded/churn-dropped slots (mask 0) are never blamed — their zeroed
    payloads are clean by construction and quarantining them is a no-op.
    """
    present = [a for a in arrs if a is not None]
    dev = present[0].device if present else device
    bad = torch.zeros((n_slots,), dtype=torch.float32, device=dev)
    for a in present:
        flat = a.reshape(a.shape[0], -1)
        bad = torch.maximum(bad, (~torch.isfinite(flat)).any(-1).float())
    if mask is not None:
        bad = bad * (mask > 0).float()
    return bad


def masked_tree_all_finite(tree, mask=None, device=None) -> torch.Tensor:
    """:func:`tree_all_finite`, but leaves whose leading axis matches the
    [C] ``mask`` are checked on LIVE slots only.

    Per-slot intermediates (feature gradients, per-slot losses) carry a
    quarantined slot's NaN harmlessly — every consumer where-masks it
    out (pooled means, ``select_entities`` commits) — so a health check
    that read those entries would flag a round the recovery already
    fixed and spin until the retry budget burns out.
    """
    if mask is None:
        return tree_all_finite(tree, device)
    live = mask > 0
    n = live.shape[0]
    leaves = []
    for leaf in _inexact(tree_leaves(tree)):
        if leaf.dim() >= 1 and leaf.shape[0] == n:
            # a dead slot's entries read 0: the select, not a product,
            # since NaN * 0 is NaN
            leaf = torch.where(live.reshape((n,) + (1,) * (leaf.dim() - 1)),
                               leaf, 0)
        leaves.append(leaf)
    return tree_all_finite(leaves, mask.device)


def ema_update(ema, loss, alpha: float) -> torch.Tensor:
    """One EMA step over ACCEPTED losses.  ``ema == 0`` is the unarmed
    sentinel (seeded by the first finite loss); a non-finite loss leaves
    the EMA untouched so a faulted round cannot poison the detector."""
    ema = ema.float()
    loss = loss.float()
    seeded = torch.where(ema != 0.0, (1.0 - alpha) * ema + alpha * loss,
                         loss)
    return torch.where(torch.isfinite(loss), seeded, ema)


def agree(slot_bad, part_ok, split=None, axes=()
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(slot_bad [C], ok)`` of the whole mesh from this rank's part:
    ``slot_bad`` its slots' blame (``split``, a ``core.protocol.SlotSplit``
    of the cohort, None when the rank holds every slot) and ``part_ok``
    whether its shards are finite.  The blame and the rank's flag go
    over the batch axes in one ``all_gather`` (census
    ``all_gather/health``); the flag is then summed over each of
    ``axes`` (the ``Collectives`` of the mesh's axes the slots do not
    split: the ``model`` axis, and the batch axes when every rank runs
    the whole cohort; census ``{axis/}all_reduce/health``).  Off the
    mesh and at one rank: the inputs, with no collective."""
    gather = split is not None and not split.whole
    if not gather and not axes:
        return slot_bad, part_ok
    flag = (~part_ok).float().reshape(1)
    if gather:
        rows = split.comm.all_gather(torch.cat([slot_bad, flag]),
                                     "health").reshape(split.comm.size, -1)
        slot_bad, flag = rows[:, :-1].reshape(-1), rows[:, -1:].amax(0)
    for comm in axes:
        flag = comm.all_reduce(flag, "health")
    return slot_bad, flag[0] == 0


def health_vector(state, loss, feats, fgrads, mask, ema,
                  alpha: float, spike_factor: float, split=None, axes=()
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The packed [4] health vector + the [C] slot-blame array.

    ``feats``/``fgrads`` may be None (fused sequential programs carry no
    per-slot intermediates) — slot blame then stays all-zero and the
    Engine's quarantine policy escalates to retry.

    Slot BLAME reads the smashed data only: features are produced
    per-client BEFORE anything is shared, so a NaN there names the
    offending client unambiguously.  Feature gradients are NOT blamed —
    one poisoned slot's rows pollute the pooled server update and every
    slot's gradient goes NaN downstream of it (guilt by contagion, not a
    culprit).  ``fgrads`` still feeds the round-level nonfinite check —
    on LIVE slots only, so a freshly-quarantined slot's inert NaN
    gradient cannot re-flag the round it was just excised from.

    On a mesh (``split``, ``axes``: see :func:`agree`) ``feats``,
    ``fgrads`` and ``state`` are this rank's parts, ``mask`` the whole
    [C] one; the blame comes back whole and the vector the same on
    every rank.
    """
    loss = loss.float()
    dev = loss.device
    local = mask if split is None or mask is None else split.local(mask)
    n_slots = feats.shape[0] if feats is not None else 1
    slot_bad = slot_nonfinite([feats], n_slots, mask=local, device=dev)
    fgrads_ok = (masked_tree_all_finite(fgrads, local, dev)
                 if fgrads is not None else _true([], dev))
    slot_bad, part_ok = agree(slot_bad, tree_all_finite(state, dev)
                              & fgrads_ok, split, axes)
    bad_any = slot_bad.max() > 0
    finite = part_ok & torch.isfinite(loss) & ~bad_any
    ema = (torch.zeros((), dtype=torch.float32, device=dev) if ema is None
           else ema.float())
    spike = (ema != 0.0) & torch.isfinite(loss) & (loss > spike_factor * ema)
    health = torch.stack([(~finite).float(), spike.float(),
                          ema_update(ema, loss, alpha), bad_any.float()])
    return health, slot_bad
