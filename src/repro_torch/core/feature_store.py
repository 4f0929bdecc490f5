"""The server-side global feature dataset + resampler (paper Eq. 3).

Port of ``repro/core/feature_store.py``: the pool, its plans and
gathers, the mesh's shard-local resample, and the ``StaleFeatureRing``
of in-flight extracted stages (pipelined rounds).

On a mesh each rank pools the features of its own cohort slots, so it
holds the contiguous rows ``[s * R, (s+1) * R)`` of D_S^f (shard ``s``,
R rows a shard), while the [T] row-validity mask, which the plan reads,
is built from the full attendance mask on every rank.  A resampled
minibatch then comes either shard-LOCAL (:func:`shard_local_gather`,
:func:`shard_local_fused_loss`: each rank gathers the plan rows it
holds, and a masked sum over ranks, exact because every row has one
owner, assembles the minibatch) or from the gathered pool
(:func:`gather_everything`, one ``all_gather`` of D_S^f a round).

``D_S^f = ⨄_i B_i^f``: client feature batches are pooled and the server
resamples shuffled minibatches that are no longer client-bound.

The plans cannot reproduce the JAX package's threefry bits, so they keep
its invariant instead: row r's sort key is a counter-based hash of
(round key, epoch, r) alone, never of the pool's capacity, and padded
rows sort after every live row.  The order of the live rows is therefore
the same at any padded capacity.  The hash is integer arithmetic on the
device, so the CPU and the card draw the same plan and no host sync is
needed.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.sharding.specs import pool_shard_info, shard_range
from repro_torch.utils.tree import (tree_leaves, tree_map,
                                    tree_unflatten_like)

_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer finalizer (lowbias32) on Python ints or int64
    tensors holding values in [0, 2**32).  An int64 product may wrap,
    but its low 32 bits, the only ones kept, are exact either way."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def valid_from_mask(mask: torch.Tensor, batch: int) -> torch.Tensor:
    """Broadcast a [C] cohort attendance mask to the [C*b] per-row
    validity mask over the pooled feature axis."""
    return torch.repeat_interleave(mask.float(), batch)


class FeatureStore(NamedTuple):
    """Pooled smashed data: features [T, ...], labels [T, ...] (a tree).

    ``valid`` is an optional [T] row mask (1.0 = live row, 0.0 = a row of
    a padded cohort slot); ``None`` means every row is live.
    """
    features: torch.Tensor
    labels: torch.Tensor
    valid: Optional[torch.Tensor] = None

    @classmethod
    def pool(cls, feature_batches, label_batches, mask=None) -> "FeatureStore":
        """[C, b, ...] per-client batches -> pooled [C*b, ...]."""
        merge = lambda a: a.reshape((-1,) + tuple(a.shape[2:])).contiguous()
        valid = None
        if mask is not None:
            valid = valid_from_mask(mask, feature_batches.shape[1])
        return cls(merge(feature_batches), tree_map(merge, label_batches),
                   valid)

    @property
    def size(self) -> int:
        return self.features.shape[0]


def masked_resample_plan(key: int, valid: torch.Tensor, epochs: int,
                         batch: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Padded-pool plan: [epochs, steps, batch] int32 row indices and the
    [epochs, steps] bool step-validity mask.

    Live rows are ordered by a hash of (key, epoch, row); padded rows go
    after them.  A step is valid iff all ``batch`` of its rows are live,
    which reproduces the dense plan's drop-the-tail truncation for the
    live row count.
    """
    total = valid.shape[0]
    steps = total // batch
    rows = torch.arange(total, dtype=torch.int64, device=valid.device)
    row_mix = _mix32(rows)
    live = valid > 0
    seed = _mix32(_mix32(key & _M32) ^ ((key >> 32) & _M32))
    perms = []
    for e in range(epochs):
        u = _mix32(row_mix ^ _mix32(seed ^ e))
        sort_key = torch.where(live, u, (1 << 32) + rows)
        perms.append(torch.sort(sort_key, stable=True).indices)
    plan = torch.stack(perms)[:, : steps * batch].reshape(epochs, steps, batch)
    n_valid = live.sum()
    step_ok = (torch.arange(1, steps + 1, device=valid.device) * batch
               <= n_valid)
    return plan.to(torch.int32), step_ok.expand(epochs, steps)


def resample_plan(key: int, total: int, epochs: int, batch: int,
                  device="cpu") -> torch.Tensor:
    """Dense plan [epochs, steps, batch]: a fresh shuffle of every row per
    server epoch, truncating the tail that does not fill a batch."""
    valid = torch.ones(total, device=device)
    return masked_resample_plan(key, valid, epochs, batch)[0]


def gather_batch(store: FeatureStore, idx: torch.Tensor):
    """Resample one server minibatch ``out[i] = store[idx[i]]`` through
    the ``feature_resample`` kernel (its plain version on the CPU)."""
    take = lambda a: ops.resample_rows(a, idx)
    return take(store.features), tree_map(take, store.labels)


def pool_store(feats, ys, mask=None) -> FeatureStore:
    """The pooled D_S^f handoff for one cohort: the features are data to
    the server, so they are detached from any client graph.  On a mesh
    ``feats`` and ``ys`` are this rank's slots and ``mask`` the full [C]
    mask: the store holds the rank's rows and the full [T] validity."""
    return FeatureStore.pool(feats.detach(), ys, mask=mask)


def shard_slice_indices(idx: torch.Tensor, shard: int, rows_per_shard: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Translate global gather indices into ONE shard's pool-slice frame.

    Shard ``s`` owns the contiguous global rows ``[s * rows_per_shard,
    (s+1) * rows_per_shard)``; a global index lands in exactly one
    shard's slice, so across shards the ``ok`` masks partition the
    gather.  Returns ``(local, ok)``: ``local`` is clipped into ``[0,
    rows_per_shard)`` so masked-off rows still index safely (int32, as
    the kernels take it)."""
    local = idx.long() - shard * rows_per_shard
    ok = (local >= 0) & (local < rows_per_shard)
    return local.clamp(0, rows_per_shard - 1).to(torch.int32), ok


def _slice_of(store: FeatureStore, split) -> tuple[int, int]:
    """(shard, rows a shard) of this rank's pool slice, by the pool's
    geometry on the mesh (``sharding.specs.pool_shard_info``)."""
    total = store.size * split.comm.size
    info = pool_shard_info(split.mesh, total)
    if info is None or info[2] != store.size:
        raise ValueError(f"a pool of {total} rows does not split into "
                         f"slices of this rank's {store.size} over "
                         f"{split.mesh.shape}")
    axes, n_shards, rows = info
    return shard_range(split.mesh, axes, n_shards)[0], rows


def _zero_unowned(rows: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok.reshape((-1,) + (1,) * (rows.dim() - 1)), rows, 0)


def shard_local_gather(store: FeatureStore, idx: torch.Tensor, split,
                       replicate_out: bool = False):
    """Shard-LOCAL resample ``out[i] = store[idx[i]]`` on a mesh, where
    ``store`` holds this rank's pool slice and ``split`` (a
    ``core.protocol.SlotSplit``) says which.

    Each rank runs the ``feature_resample`` kernel over its slice with
    the translated indices (:func:`shard_slice_indices`), zeros the rows
    that other ranks own, and the masked rows are summed over ranks:
    ``reduce_scatter`` when the minibatch's M rows divide the ranks (rank
    r keeps rows ``[r M/n, (r+1) M/n)``, its data-parallel part) and
    ``replicate_out`` is off, else ``all_reduce`` (every rank gets all M
    rows).  Every row has one owner, so the sum is exact and the rows
    are bit for bit those of the gather of the whole pool.  On the wire:
    the [M, ...] minibatch instead of the [T, ...] pool."""
    shard, rows = _slice_of(store, split)
    local, ok = shard_slice_indices(idx, shard, rows)
    leaves = [store.features] + tree_leaves(store.labels)
    taken = [_zero_unowned(ops.resample_rows(a, local), ok) for a in leaves]
    comm = split.comm
    if idx.shape[0] % comm.size == 0 and not replicate_out:
        out = comm.reduce_scatter_tree(taken, "minibatch")
    else:
        out = comm.all_reduce_tree(taken, "minibatch")
    return out[0], tree_unflatten_like(store.labels, out[1:])


class _ShardLocalFusedLoss(torch.autograd.Function):
    """Mean fused gather + linear-head loss over one minibatch, from this
    rank's pool slice; differentiable in ``w`` only.  Forward: the
    ``gather_loss`` kernel over the slice at the translated indices, the
    rows other ranks own zeroed, the mean over the M rows, and a scalar
    ``all_reduce``.  Backward: the analytic ``dw = fᵀ (softmax -
    onehot) g / M`` over the rows this rank owns, ``all_reduce``d."""

    @staticmethod
    def forward(ctx, src, labels, local, ok, w, comm):
        ctx.save_for_backward(src, labels, local, ok, w)
        ctx.comm = comm
        losses = ops.gather_loss_microbatch(src, labels, local, w)
        return comm.all_reduce(torch.mean(torch.where(ok, losses, 0.0)),
                               "loss")

    @staticmethod
    def backward(ctx, g):
        src, labels, local, ok, w = ctx.saved_tensors
        f = torch.index_select(src.reshape(src.shape[0], -1), 0,
                               local).float()
        logits = f @ w.float()
        y = torch.index_select(labels, 0, local).long()
        p = torch.softmax(logits, dim=-1)
        onehot = ops.one_hot(y, w.shape[1])
        dlogits = (p - onehot) * (g / local.shape[0])
        # rows other ranks own contribute exact zeros to dw
        dlogits = torch.where(ok[:, None], dlogits, 0.0)
        dw = ctx.comm.all_reduce(f.T @ dlogits, "head_grad").to(w.dtype)
        return None, None, None, None, dw, None


def shard_local_fused_loss(store: FeatureStore, idx: torch.Tensor, w,
                           split) -> torch.Tensor:
    """The minibatch-mean fused gather + head loss on a mesh without the
    pool crossing ranks: one float32 scalar on the wire forward, the
    head's [D, K] gradient backward.  At one rank it runs the ops of
    ``ops.fused_gather_loss_mean``."""
    shard, rows = _slice_of(store, split)
    local, ok = shard_slice_indices(idx, shard, rows)
    flat = store.features.reshape(store.size, -1)
    return _ShardLocalFusedLoss.apply(flat, store.labels, local, ok, w,
                                      split.comm)


def gather_everything(store: FeatureStore, split) -> FeatureStore:
    """The whole pool on every rank: this rank's slice ``all_gather``ed
    (one call per dtype), the validity unchanged (it is whole already).
    The other route of the mesh's resample: ``gather_batch`` then runs
    on it as off the mesh."""
    leaves = split.comm.all_gather_tree(
        [store.features] + tree_leaves(store.labels), "pool")
    return FeatureStore(leaves[0],
                        tree_unflatten_like(store.labels, leaves[1:]),
                        store.valid)


class RingEntry(NamedTuple):
    """One in-flight cohort awaiting its tail: the round it will be
    consumed at, the round whose pre-tail state its extract read
    (``src_round``; consumption round - src_round = realized θ_S lag),
    the extracted :class:`~repro_torch.api.phases.PipelineStage`, the
    host-side cohort inputs (clean and fault-injected) the tail and any
    recovery re-extract need, and ``ready``: a CUDA event the consumer
    waits on when the extract ran on a side stream (None otherwise)."""
    round: int
    src_round: int
    stage: Any
    inputs: Any
    inj_inputs: Any
    ready: Any = None


class StaleFeatureRing:
    """Bounded buffer of in-flight extracted stages: the structure that
    delivers a round-k extract into the round-k+L pool.

    The Engine pushes ``extract(k+L)`` (dispatched against round k's
    pre-tail state) and pops entry ``k`` just before ``tail(k)``, so at
    most ``depth`` stages are ever in flight and the realized snapshot
    lag of any consumed entry is bounded by ``depth`` by construction
    (``push`` asserts the bound; ``pop`` asserts FIFO order and records
    the realized lag).  ``rewind`` is the recovery hook: after a retried
    or rolled-back round every buffered stage was extracted from a
    discarded state, so each is re-extracted from the accepted one.
    """

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError(f"ring depth must be >= 1, got {depth}")
        self.depth = depth
        self._entries: list[RingEntry] = []
        self.realized_lags: list[int] = []

    def __len__(self) -> int:
        return len(self._entries)

    def push(self, round: int, src_round: int, stage, inputs, inj_inputs,
             ready=None):
        assert len(self._entries) < self.depth, \
            f"ring overflow: {len(self._entries)} stages in flight " \
            f"(depth {self.depth})"
        assert round - src_round <= self.depth, \
            f"stage for round {round} extracted at {src_round} would " \
            f"exceed the lag bound {self.depth}"
        if self._entries:
            assert round == self._entries[-1].round + 1, "non-contiguous push"
        self._entries.append(
            RingEntry(round, src_round, stage, inputs, inj_inputs, ready))

    def pop(self, round: int) -> RingEntry:
        assert self._entries and self._entries[0].round == round, \
            f"expected round {round} at ring head, have " \
            f"{[e.round for e in self._entries]}"
        entry = self._entries.pop(0)
        self.realized_lags.append(entry.round - entry.src_round)
        return entry

    def rewind(self, extract_fn, src_round: int):
        """Re-extract every buffered stage from the accepted state
        (recovery rewound the run past the states they were read from).
        ``extract_fn(inj_inputs)`` must read the accepted state, on the
        consumer's stream (the new stages need no event)."""
        self._entries = [
            e._replace(stage=extract_fn(e.inj_inputs), src_round=src_round,
                       ready=None)
            for e in self._entries]

    @property
    def max_realized_lag(self) -> int:
        return max(self.realized_lags, default=0)
