"""Meshes of the port, as :mod:`repro.launch.mesh`.

The mesh type, the default group's start, the cohort mesh of the sharded
seed replay and the datacenter step's local ("data", "model") mesh live
in :mod:`repro_torch.distributed.mesh` and are named here too.  The
production mesh is shape-only: the sharding rules resolve specs on it
without 256 ranks.
"""
from __future__ import annotations

from repro_torch.distributed.mesh import (Mesh, init_distributed,  # noqa: F401
                                          local_device, make_local_mesh,
                                          make_replay_mesh)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The shape-only production mesh: 16x16 ("data", "model"), or
    2x16x16 ("pod", "data", "model")."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})
