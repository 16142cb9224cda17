"""Meshes over ``torch.distributed`` ranks.

A :class:`Mesh` is an ordered mapping of axis name -> size.  A
shape-only mesh (no process group) is what the sharding rules read
(:mod:`repro_torch.distributed.sharding`): the 16x16 production mesh
needs no 256 ranks to resolve specs on.  A mesh over live ranks also
holds, per axis, the ``torch.distributed`` group its collectives run on
and this rank's coordinate on it.  The seed replay's cohort mesh
(:func:`make_replay_mesh`) is one axis, "clients", over the ranks of the
default group; the datacenter step's mesh (:func:`make_local_mesh`) is
("data", "model") over all of them, the model axis fastest.

Nothing here starts a group as a side effect: :func:`make_replay_mesh`
and :func:`make_local_mesh` read the default group (the replay mesh
raises when none is running; the local mesh is then one shape-only
device).  The entry points start it with :func:`init_distributed` and
destroy it.
"""
from __future__ import annotations

import os
from typing import Mapping

import torch
import torch.distributed as dist


class Mesh:
    """Axis name -> size, in order; ``groups`` maps each axis of a mesh
    over live ranks to its process group (empty for a shape-only mesh);
    ``coords`` gives this rank's coordinate on an axis without reading
    its group (a shape-only mesh placed at a coordinate, in tests)."""

    def __init__(self, shape: Mapping[str, int], groups=None, coords=None):
        self.shape = dict(shape)
        self.groups = dict(groups or {})
        self.coords = dict(coords or {})
        unknown = (set(self.groups) | set(self.coords)) - set(self.shape)
        if unknown:
            raise ValueError(f"groups for axes {sorted(unknown)} not in mesh "
                             f"axes {tuple(self.shape)}")

    def group(self, axis: str):
        """The process group of ``axis``; a shape-only mesh has none."""
        if axis not in self.groups:
            raise ValueError(f"mesh axis {axis!r} has no process group (a "
                             f"shape-only mesh {self.shape})")
        return self.groups[axis]

    def rank(self, axis: str) -> int:
        """This process's coordinate on ``axis`` (0 on an axis of size 1
        that has no group)."""
        if axis in self.coords:
            return self.coords[axis]
        if axis not in self.groups and self.shape.get(axis) == 1:
            return 0
        r = dist.get_rank(self.group(axis))
        if r < 0:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh's "
                             f"{axis!r} group")
        return r


def init_distributed(device=None, backend: str | None = None) -> bool:
    """Start the default process group if none is running: torchrun's
    environment when ``RANK`` and ``WORLD_SIZE`` are set, else one rank
    on an in-memory store.  ``backend`` by default: NCCL for a CUDA
    ``device`` when this host's ranks (``LOCAL_WORLD_SIZE``) have a card
    each, else gloo.  Returns True when it started the group (the caller
    then owns it: ``torch.distributed.destroy_process_group``)."""
    if dist.is_initialized():
        return False
    if backend is None:
        dev = torch.device("cpu" if device is None else device)
        local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        backend = ("nccl" if dev.type == "cuda"
                   and local_ranks <= torch.cuda.device_count() else "gloo")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def local_device(device="cuda") -> torch.device:
    """``device`` for this rank: under torchrun a bare ``cuda`` is the
    card ``LOCAL_RANK`` modulo the cards visible (ranks share a card when
    there are more ranks than cards)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and \
            "LOCAL_RANK" in os.environ and torch.cuda.is_available():
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                           % torch.cuda.device_count())
    return dev


def make_replay_mesh(n_devices: int | None = None, *,
                     axis: str = "clients") -> Mesh:
    """The 1-D cohort mesh of the sharded seed replay: ``axis`` over the
    ranks of the running default group, or over its first ``n_devices``
    (a new group, so every rank must call it)."""
    if not dist.is_initialized():
        raise RuntimeError("the replay mesh spans the ranks of the default "
                           "process group, and no process group is "
                           "running: start one first (init_distributed)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices {n} outside 1..{world} ranks")
    group = dist.group.WORLD if n == world else dist.new_group(
        list(range(n)))
    return Mesh({axis: n}, {axis: group})


def make_local_mesh(model_parallel: int = 1) -> Mesh:
    """The datacenter step's ("data", "model") mesh over the ranks of the
    default group, as the reference's ``jax.make_mesh((n // mp, mp))``:
    rank ``d * mp + m`` sits at (d, m), the model axis fastest.  A
    ``model_parallel`` that does not divide the world falls back to 1.
    Every rank builds one group per row (a model group) and one per
    column (a data group), in the same order, and keeps its own two.
    With no group running it is one shape-only device."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    mp = model_parallel if model_parallel > 0 and world % model_parallel \
        == 0 else 1
    dp = world // mp
    if not dist.is_initialized():
        return Mesh({"data": dp, "model": mp})
    rank = dist.get_rank()
    groups = {}
    for d in range(dp):
        g = dist.new_group([d * mp + m for m in range(mp)])
        if rank // mp == d:
            groups["model"] = g
    for m in range(mp):
        g = dist.new_group([d * mp + m for d in range(dp)])
        if rank % mp == m:
            groups["data"] = g
    return Mesh({"data": dp, "model": mp}, groups,
                {"data": rank // mp, "model": rank % mp})
