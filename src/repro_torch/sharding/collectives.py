"""The cross-rank ops of the mesh path, over one process group.

Every value that crosses ranks on the mesh path passes through one
:class:`Collectives` object, which keeps a census of its calls and
bytes by op.  The JAX package counts the collectives of its compiled
round from HLO text (``repro/utils/hlo.py``); the census is the port's
counterpart, read by the tests and by ``launch.meshcheck``.

Each call names what it moves (``what``: "pool", "minibatch", "grads",
...), and the census counts calls and bytes under ``"{op}/{what}"``.
A mesh keeps one object per group: the batch axes' (keys as above) and
the ``model`` axis' (keys ``"model/{op}/{what}"``), so a round's census
splits by axis.  FSDP's weight gathers and gradient reduce-scatters run
over the batch axes (``all_gather/weights``, ``reduce_scatter/wgrads``,
``reduce_scatter/slot_mean`` for a FedAvg into blocks), or under
``"data/..."`` where a ``pod`` axis > 1 gives ``data`` a group of its
own.
The bytes of a call are the payload one rank hands to it: the tensor of
an ``all_reduce`` or a ``broadcast``, the whole input of a
``reduce_scatter``, the local chunk of an ``all_gather``.

The ``*_tree`` forms move a list of tensors in one call per dtype: the
tensors are flattened into one buffer (laid out rank block by rank
block for the dim-0 ops, so tensors of different row counts share it),
which changes no value, since every op is elementwise over the buffer.
All ops sum; a sum whose other terms are exact zeros (an owner-masked
gather) is exact.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

# the single-tensor forms were renamed after torch 2.11; take whichever
# this torch has
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


class Collectives:
    """all_reduce, reduce_scatter, all_gather and broadcast over ``group``
    (None = the default group), each counted in :attr:`census` under
    ``"{op}/{what}"``, prefixed ``"{axis}/"`` when ``axis`` names the
    group's mesh axis.  ``rank`` and ``size`` are this process's rank in
    the group and the group's size."""

    def __init__(self, group=None, axis: Optional[str] = None):
        self.group = group
        self.axis = axis
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.census: dict[str, dict[str, int]] = {}

    def _count(self, op: str, what: str, t: torch.Tensor):
        key = f"{op}/{what}" if self.axis is None else \
            f"{self.axis}/{op}/{what}"
        row = self.census.setdefault(key, {"calls": 0, "bytes": 0})
        row["calls"] += 1
        row["bytes"] += t.numel() * t.element_size()

    def take_census(self) -> dict:
        """The census since the last take, and a fresh one."""
        out, self.census = self.census, {}
        return out

    # ------------------------------------------------------------ tensors
    def all_reduce(self, t: torch.Tensor, what: str) -> torch.Tensor:
        """The sum over ranks, as a new tensor on every rank."""
        return self._all_reduce_(t.contiguous().clone(), what)

    def _all_reduce_(self, t: torch.Tensor, what: str) -> torch.Tensor:
        """:meth:`all_reduce` in place, into a buffer of the caller's."""
        self._count("all_reduce", what, t)
        dist.all_reduce(t, group=self.group)
        return t

    def reduce_scatter(self, t: torch.Tensor, what: str) -> torch.Tensor:
        """The sum over ranks of ``t`` [n * k, ...]; rank r keeps rows
        ``[r * k, (r + 1) * k)``."""
        t = t.contiguous()
        if t.shape[0] % self.size:
            raise ValueError(f"reduce_scatter of {t.shape[0]} rows over "
                             f"{self.size} ranks")
        out = t.new_empty((t.shape[0] // self.size,) + tuple(t.shape[1:]))
        self._count("reduce_scatter", what, t)
        _reduce_scatter(out, t, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor, what: str) -> torch.Tensor:
        """Every rank's ``t`` [k, ...], concatenated in rank order along
        dim 0."""
        t = t.contiguous()
        out = t.new_empty((t.shape[0] * self.size,) + tuple(t.shape[1:]))
        self._count("all_gather", what, t)
        _all_gather(out, t, group=self.group)
        return out

    def broadcast(self, t: torch.Tensor, what: str, src: int = 0
                  ) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank."""
        out = t.contiguous().clone()
        self._count("broadcast", what, out)
        dist.broadcast(out, dist.get_global_rank(self.group, src)
                       if self.group is not None else src, group=self.group)
        return out

    # -------------------------------------------------------------- trees
    def _by_dtype(self, tensors: list, rows: Optional[str], op, what: str):
        """Run ``op`` once per dtype over the tensors flattened into one
        1-D buffer and split the result back into the tensors' shapes.
        ``rows`` 'gather': each rank's tensors [k_i, ...] side by side,
        the result every rank's in rank order, [n * k_i, ...] each;
        'scatter': each tensor [n * k_i, ...] laid out rank block by
        rank block, this rank's rows [k_i, ...] of each back; None: the
        op is elementwise over the buffer."""
        out: list[Optional[torch.Tensor]] = [None] * len(tensors)
        groups: dict = {}
        for i, t in enumerate(tensors):
            groups.setdefault(t.dtype, []).append(i)
        n = self.size
        for idx in groups.values():
            ts = [tensors[i] for i in idx]
            if rows == "scatter":
                flat = torch.cat([t.reshape(n, -1) for t in ts],
                                 dim=1).reshape(-1)
                res = op(flat, what)
                parts = torch.split(res, [t.numel() // n for t in ts])
                for i, t, p in zip(idx, ts, parts):
                    out[i] = p.reshape((t.shape[0] // n,)
                                       + tuple(t.shape[1:]))
            else:
                # a fresh buffer, even of one tensor: the op may write it
                flat = torch.cat([t.reshape(-1) for t in ts])
                res = op(flat, what)
                if rows == "gather":
                    parts = torch.split(res.reshape(n, -1),
                                        [t.numel() for t in ts], dim=1)
                    for i, t, p in zip(idx, ts, parts):
                        out[i] = p.reshape((n * t.shape[0],)
                                           + tuple(t.shape[1:]))
                else:
                    parts = torch.split(res, [t.numel() for t in ts])
                    for i, t, p in zip(idx, ts, parts):
                        out[i] = p.reshape(t.shape)
        return out

    def all_reduce_tree(self, tensors: list, what: str) -> list:
        return self._by_dtype(tensors, None, self._all_reduce_, what)

    def reduce_scatter_tree(self, tensors: list, what: str) -> list:
        """Each tensor [n * k, ...] -> this rank's [k, ...] rows of the
        sum."""
        return self._by_dtype(tensors, "scatter", self.reduce_scatter, what)

    def all_gather_tree(self, tensors: list, what: str) -> list:
        """Each tensor [k, ...] -> every rank's rows, [n * k, ...]."""
        return self._by_dtype(tensors, "gather", self.all_gather, what)


def census_by_op(census: dict) -> dict:
    """A census's calls and bytes summed by op (an axis prefix kept:
    ``"model/all_reduce"`` beside ``"all_reduce"``)."""
    out: dict = {}
    for key, row in census.items():
        tot = out.setdefault(key.rsplit("/", 1)[0], {"calls": 0, "bytes": 0})
        tot["calls"] += row["calls"]
        tot["bytes"] += row["bytes"]
    return out
