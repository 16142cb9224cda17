"""Meshes of the port, as :mod:`repro.launch.mesh`.

The mesh type, the default group's start, the cohort mesh of the sharded
seed replay and the datacenter step's local ("data", "model") mesh live
in :mod:`repro_torch.distributed.mesh` and are named here too.  The
production mesh is shape-only: the sharding rules resolve specs on it
without 256 ranks.  The dry run's mesh (:func:`make_dryrun_mesh`) is the
production mesh over the live ranks of a fake-backend process group.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.distributed.mesh import (Mesh, init_distributed,  # noqa: F401
                                          local_device, make_local_mesh,
                                          make_replay_mesh)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The shape-only production mesh: 16x16 ("data", "model"), or
    2x16x16 ("pod", "data", "model")."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def make_dryrun_mesh(*, multi_pod: bool = False, rank: int = 0) -> Mesh:
    """The production mesh over live ranks of a fake-backend process
    group started in this process (``torch.testing``'s ``fake`` backend:
    every collective returns at once and moves nothing), this process
    being ``rank``: 16x16 ("data", "model") on 256 ranks, or 2x16x16
    ("pod", "data", "model") on 512.  The groups are
    :func:`make_local_mesh`'s, the model axis fastest; on 2x16x16 the
    "data" group spans the 32 (pod, data) rows, over which the batch is
    sharded (``sharding.DATA_AXES``), so the loss and gradient sums run
    over the whole batch.  A dry run counts one rank's program on
    ``meta`` slabs against it.  The caller destroys the group
    (``torch.distributed.destroy_process_group``).  Raises where the
    installed torch has no fake backend, or a group is running."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("the dry-run mesh needs torch's fake process "
                           "group backend (torch.testing._internal."
                           "distributed.fake_pg), which this torch "
                           "lacks") from e
    if dist.is_initialized():
        raise RuntimeError("make_dryrun_mesh starts its own process group; "
                           "one is running")
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    mp = shape["model"]
    world = mp * (32 if multi_pod else 16)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside the mesh's {world} ranks")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    rows = world // mp
    groups = {}
    for r in range(rows):
        g = dist.new_group([r * mp + m for m in range(mp)])
        if rank // mp == r:
            groups["model"] = g
    for m in range(mp):
        g = dist.new_group([r * mp + m for r in range(rows)])
        if rank % mp == m:
            groups["data"] = g
    row = rank // mp
    coords = {"data": row % 16, "model": rank % mp}
    if multi_pod:
        coords["pod"] = row // 16
    return Mesh(shape, groups, coords)
