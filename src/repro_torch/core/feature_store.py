"""The server-side global feature dataset + resampler (paper Eq. 3).

Port of the single-device half of ``repro/core/feature_store.py``, and
its ``StaleFeatureRing`` of in-flight extracted stages (pipelined
rounds).

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
from repro_torch.utils.tree import tree_map

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
    the server, so they are detached from any client graph."""
    return FeatureStore.pool(feats.detach(), ys, mask=mask)


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
