"""Meshes of the port, as :mod:`repro.launch.mesh`.

The mesh type, the default group's start and the cohort mesh of the
sharded seed replay live in :mod:`repro_torch.distributed.mesh` and are
named here too.  The two layouts below are shape-only until the
datacenter step's mesh mode (ROADMAP queue 1 item 7) reads them; today
only the tests do.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.distributed.mesh import (Mesh, init_distributed,  # noqa: F401
                                          local_device, make_replay_mesh)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The shape-only production mesh: 16x16 ("data", "model"), or
    2x16x16 ("pod", "data", "model")."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def make_local_mesh(model_parallel: int = 1) -> Mesh:
    """The ("data", "model") layout of the ranks: every rank of the
    default group (one when there is none) on the data axis.  A model
    axis wider than 1 is the datacenter step's mesh mode, ROADMAP queue
    1 item 7, and raises."""
    if model_parallel > 1:
        raise NotImplementedError("model_parallel > 1: the datacenter "
                                  "step's mesh mode is ROADMAP queue 1 "
                                  "item 7")
    if not dist.is_initialized():
        return Mesh({"data": 1, "model": 1})
    return Mesh({"data": dist.get_world_size(), "model": 1},
                {"data": dist.group.WORLD})
