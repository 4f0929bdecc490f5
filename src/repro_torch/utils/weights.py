"""Carry weights and training state between the JAX package and the port.

The JAX package's trees hold numpy-convertible arrays (for example after
``jax.device_get``) in nested lists, tuples, dicts and NamedTuples: the
CNN zoo's stage lists, a ``Transformer`` parameter dict with its stacked
[L, ...] blocks, and the ``EntityState``/``TrainState`` around them.  The
port keeps the same layout, so carrying is a leafwise conversion; the
NamedTuples ``TrainState`` and ``EntityState`` are matched by field
name, so nothing of the JAX package is imported here.  On a mesh a rank
holds blocks over ``model`` and ``data`` (``sharding.specs.shard_plan``):
:func:`to_shards` carries whole weights into a rank's blocks and
:func:`from_shards` a rank's blocks back to a whole numpy tree, a Mamba
block's packed leaves (cut on whole SSD heads, segment by segment) as
any other.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.api.phases import TrainState
from repro_torch.core.protocol import EntityState
from repro_torch.sharding.specs import (gather_entity, gather_params,
                                        shard_params)
from repro_torch.utils.tree import tree_map


def to_torch(tree: Any, device="cpu") -> Any:
    """Numpy-convertible leaves -> tensors on ``device`` (dtype kept;
    bfloat16, which numpy lacks, goes through float32 exactly)."""
    def one(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(device)
    return tree_map(one, tree)


def to_numpy(tree: Any) -> Any:
    """Tensors -> numpy arrays (bfloat16 widened to float32)."""
    def one(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(one, tree)


def entity_from_reference(e, device="cpu") -> EntityState | None:
    """A JAX-package ``EntityState`` (one entity or a [C]-stacked
    cohort; numpy or JAX leaves, bfloat16 included) -> the port's: the
    params tree leaf for leaf (a ``Transformer`` split half keeps its
    stacked [L, ...] blocks), Adam's ``{"m", "v"}`` and the int32 step."""
    if e is None:
        return None
    return EntityState(to_torch(e.params, device),
                       to_torch(e.opt_state, device),
                       to_torch(e.step, device))


def train_state_from_reference(state: Any, device="cpu") -> TrainState:
    """A JAX-package ``TrainState`` (numpy or JAX leaves) -> the port's,
    with its Adam moments ``{"m", "v"}`` and int32 step counters."""
    return TrainState(entity_from_reference(state.server, device),
                      entity_from_reference(state.clients, device),
                      entity_from_reference(state.client_global, device))


def to_shards(tree: Any, plan, device="cpu") -> Any:
    """Whole weights (numpy-convertible leaves) -> this rank's shards
    under ``plan`` on ``device``."""
    return shard_params(to_torch(tree, device), plan)


def from_shards(local: Any, plan, comm, data_comm=None) -> Any:
    """A rank's blocks (a params tree or an ``EntityState``) -> the whole
    tree as numpy arrays, gathered over ``comm`` (the mesh's
    ``model_comm``) and, for blocks over ``data``, ``data_comm`` (the
    mesh's); every rank of each axis takes part."""
    if isinstance(local, EntityState):
        return to_numpy(gather_entity(local, plan, comm, data_comm))
    return to_numpy(gather_params(local, plan, comm, data_comm))
