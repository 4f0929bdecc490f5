"""Device meshes over ``torch.distributed``: one process a rank, one card
a rank.

Port of ``repro/launch/mesh.py``.  The JAX package lays one program over
the devices of a ``jax.sharding.Mesh``; here each rank is a process
driving one device, and a :class:`Mesh` is the
``torch.distributed.device_mesh.DeviceMesh`` over an initialized process
group plus what the round needs of it: the axis sizes, this rank's
coordinates and two :class:`~repro_torch.sharding.collectives.Collectives`,
``comm`` over the batch axes (the cohort's split) and ``model_comm``
over the ``model`` axis (the weights' tensor- and expert-parallel
split, ``sharding.parallel``), and one more for each size of a group of
consecutive ``model`` ranks (``kv_comms``: the ranks that hold a kv
head alike where an attention block has fewer kv heads than the axis
has ranks, ``sharding.parallel.kv_replicas``).

The process group comes from ``torchrun`` (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), or from a caller that
spawns the ranks and initializes the group itself.  A world of 1 with
no group starts its own over a ``file://`` store.  The backend follows
the device: NCCL for ``cuda``, gloo for ``cpu``, and for ``meta`` (which
holds no data: ``launch.dryrun`` traces a rank's step on it) torch's
fake group, which the caller starts and whose collectives move
nothing.

Production meshes:

  Single pod : (data=16, model=16)            = 256 chips
  Multi-pod  : (pod=2, data=16, model=16)     = 512 chips

The reference places a round's weights 2-D, FSDP over ``data`` and
tensor-parallel over ``model`` (``sharding.specs.shard_plan``): the
Engine's round and every family's train and prefill steps hold each
leaf's block on a rank, gather it at use over ``data_comm`` and split
their products over ``model_comm`` (``sharding.parallel``).
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.sharding.collectives import Collectives
from repro_torch.sharding.specs import BATCH_AXES, batch_axes
from repro_torch.utils.device import resolve_device

BACKEND = {"cuda": "nccl", "cpu": "gloo", "meta": "fake"}


@dataclass
class Mesh:
    """A device mesh of this process's world.

    ``shape`` maps axis name to size (what the spec functions read),
    ``coords`` maps it to this rank's coordinate, ``device`` is the card
    (or the CPU) this rank drives, ``comm`` moves every cross-rank
    value of the round over the batch axes and ``model_comm`` every one
    over the ``model`` axis (census keys ``"model/..."``; None without
    that axis).  ``data_comm`` is the ``data`` axis' own (FSDP's weight
    gathers and gradient reduce-scatters): ``comm`` itself unless a
    ``pod`` axis > 1 shares the batch axes, then the group of the ranks
    that differ only in their ``data`` coordinate (census keys
    ``"data/..."``).  ``kv_comms`` maps each divisor k > 1 of the
    ``model`` axis' size to the collectives of this rank's group of k
    consecutive ``model`` ranks (census keys ``"kv/..."``; at k = m the
    model axis' own group), built once with the mesh.  ``owns_group`` is
    True when
    :func:`make_engine_mesh` started the process group, so :meth:`close`
    ends it (and removes the file store of a world of 1)."""
    device_mesh: Any
    shape: dict
    coords: dict
    device: torch.device
    comm: Collectives
    model_comm: Optional[Collectives]
    data_comm: Optional[Collectives] = None
    kv_comms: dict = field(default_factory=dict)
    owns_group: bool = False
    store_dir: Optional[str] = None

    def close(self):
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False
        if self.store_dir is not None:
            shutil.rmtree(self.store_dir, ignore_errors=True)
            self.store_dir = None


def _start_group(backend: str, n: int) -> tuple[bool, Optional[str]]:
    """Join the process group torchrun describes, or start a world of 1
    over a file store: (whether this call started a group, the store's
    directory)."""
    if dist.is_initialized():
        return False, None
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return True, None
    if n != 1:
        raise RuntimeError(
            f"a mesh of {n} ranks needs a process group of {n}: launch with "
            f"`torchrun --nproc-per-node {n}`, or spawn the ranks and call "
            "torch.distributed.init_process_group in each first")
    store_dir = tempfile.mkdtemp(prefix="repro_mesh_")
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(store_dir, 'store')}",
        rank=0, world_size=1)
    return True, store_dir


def make_engine_mesh(shape, axes, device=None) -> Mesh:
    """Mesh from the serializable ``ExperimentConfig.mesh_shape`` /
    ``mesh_axes`` knobs, over the world of this process group.

    ``device=None`` means the card (it raises without one).  Raises when
    the shape's product is not the world size, when a ``cuda`` mesh
    asks for more ranks than there are cards (NCCL refuses two ranks on
    one card) and when the group's backend does not follow the device."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh_shape {shape} and mesh_axes {axes} must "
                         "have equal length")
    sizes = dict(zip(axes, shape))
    if not set(axes) <= set(BATCH_AXES) | {"model"} or "data" not in sizes:
        raise ValueError(f"mesh axes {axes}: expected 'data', and 'pod' and "
                         "'model' where wanted")
    dev = resolve_device(device)
    n = math.prod(shape)
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(
            f"mesh {sizes} needs {n} ranks, one card each, but this machine "
            f"has {torch.cuda.device_count()} (NCCL refuses two ranks on "
            "one card)")
    backend = BACKEND.get(dev.type)
    if backend is None:
        raise ValueError(f"no mesh backend for device {dev}")
    if dev.type == "meta" and not dist.is_initialized():
        raise RuntimeError("a meta mesh runs over a fake process group the "
                           "caller starts (see launch.dryrun)")
    owns, store_dir = _start_group(backend, n)
    if dist.get_backend() != backend:
        raise RuntimeError(f"a {dev.type} mesh runs over {backend}, but the "
                           f"process group uses {dist.get_backend()}")
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {sizes} has {n} ranks, the process group "
                         f"{dist.get_world_size()}")
    if dev.type == "cuda":
        local = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    coords = dict(zip(axes, dm.get_coordinate()))
    comm = _batch_comm(dm, sizes)
    data_comm = (Collectives(dm["data"].get_group(), axis="data")
                 if sizes.get("pod", 1) > 1 else comm)
    if data_comm.rank != coords["data"]:
        raise RuntimeError(f"the data axis' group ranks this rank "
                           f"{data_comm.rank}, its coordinate is "
                           f"{coords['data']}")
    model_comm = _model_comm(dm, sizes)
    return Mesh(dm, sizes, coords, dev, comm, model_comm, data_comm,
                _kv_comms(dm, sizes, model_comm), owns, store_dir)


def _batch_comm(dm, sizes) -> Collectives:
    """The batch axes' collectives.  With no ``model`` axis > 1 they span
    the world, so the default group is theirs (the census and the calls
    of a (N, 1) mesh stay as they were); one batch axis takes its
    sub-mesh's group; ``pod`` and ``data`` beside a model axis take the
    group of the ranks that share this rank's model coordinate, read
    off the mesh's rank grid in any axis order (every rank builds every
    such group, in one order)."""
    m = sizes.get("model", 1)
    if m == 1:
        return Collectives(None)
    axes = tuple(a for a in BATCH_AXES if a in sizes)
    if len(axes) == 1:
        return Collectives(dm[axes[0]].get_group())
    grid = dm.mesh.movedim(list(sizes).index("model"), -1).reshape(-1, m)
    group, _ = dist.new_subgroups_by_enumeration(grid.t().tolist())
    return Collectives(group)


def _model_comm(dm, sizes) -> Optional[Collectives]:
    """The ``model`` axis' collectives, over its sub-mesh's group, counted
    under ``"model/..."``; None without a model axis (the model code
    then takes no collective)."""
    if "model" not in sizes:
        return None
    return Collectives(dm["model"].get_group(), axis="model")


def _kv_comms(dm, sizes, model_comm) -> dict:
    """{k: the collectives of this rank's group of k consecutive ``model``
    ranks} for each divisor k > 1 of the axis' size, counted under
    ``"kv/..."``: the groups whose ranks hold one kv head alike
    (``sharding.parallel.kv_replicas``).  The group of the whole axis is
    the model axis' own; every rank builds every smaller group, in one
    order, off the mesh's rank grid."""
    m = sizes.get("model", 1)
    out = {}
    if m == 1:
        return out
    grid = dm.mesh.movedim(list(sizes).index("model"), -1).reshape(-1, m)
    for k in range(2, m + 1):
        if m % k:
            continue
        if k == m:
            group = model_comm.group
        else:
            group, _ = dist.new_subgroups_by_enumeration(
                grid.reshape(-1, k).tolist())
        out[k] = Collectives(group, axis="kv")
    return out


def host_comm(mesh) -> Optional[Collectives]:
    """Collectives over a host group of ``mesh``'s whole world, for the
    host decisions every rank must share (a clock, a fault flag, a
    checkpoint's step): the default group on a CPU mesh, a gloo group
    beside NCCL's on the card, census keys ``"host/..."``; None for a
    world of one.  Every rank calls it at the same point (a new group
    is collective)."""
    if dist.get_world_size() == 1:
        return None
    group = None if mesh.device.type == "cpu" else dist.new_group(
        backend="gloo")
    return Collectives(group, axis="host")


def make_local_mesh(device=None) -> Mesh:
    """Degenerate (1, 1) mesh of one rank."""
    return make_engine_mesh((1, 1), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_engine_mesh(shape, axes, device)


def cohort_size(mesh) -> int:
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.shape[a]
    return n
