"""Logical-axis sharding rules, as :mod:`repro.distributed.sharding`.

The model code names array axes *logically* ("batch", "seq", "heads",
"kv_heads", "d_model", "d_ff", "vocab", "experts", "clients", ...).  An
:class:`AxisRules` maps logical names to mesh axis names.  A logical axis
is sharded only when its size is divisible by the mesh axis size;
otherwise it falls back to replication (12-head attention on a 16-way
model axis is legal and simply replicated).

A spec is a tuple with one entry per array axis: ``None`` (replicated), a
mesh axis name, or a tuple of mesh axis names.  The rules read a mesh
only through its named sizes (``mesh.shape``), so they work on a
shape-only :class:`repro_torch.distributed.mesh.Mesh` with no process
group, such as the 16x16 production mesh.

Pinning placements (the reference's ``sharding_for``, ``constrain``,
``tree_shardings``, ``shard_map_compat``) belongs to the datacenter
step's mesh mode, ROADMAP queue 1 item 7, and is not here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

# "data-like" axes shard the batch, the client cohort and FSDP storage;
# the "model" axis is tensor / expert parallelism
DATA_AXES: tuple[str, ...] = ("pod", "data")
MODEL_AXIS: str = "model"

DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": DATA_AXES,
    "clients": DATA_AXES,      # federated client cohort (seed replay)
    "seq": (),                 # replicated by default
    "seq_shard": DATA_AXES,    # explicit sequence sharding
    "seq_model": (MODEL_AXIS,),
    "heads": (MODEL_AXIS,),
    "kv_heads": (MODEL_AXIS,),
    "head_dim": (),
    "d_model": (),
    "d_ff": (MODEL_AXIS,),
    "vocab": (MODEL_AXIS,),
    "experts": (MODEL_AXIS,),
    "expert_ff": (),
    "fsdp": DATA_AXES,         # parameter storage sharding (ZeRO-3)
    "layers": (),
    "conv": (),
    "lru": (MODEL_AXIS,),
}

Spec = tuple


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Maps logical axis names to mesh axes, with divisibility fallback.
    ``mesh``: anything with a ``shape`` mapping of axis name -> size, or
    None (every axis replicated); ``enable_fsdp=False`` resolves "fsdp"
    to replication."""

    rules: Mapping[str, tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))
    mesh: Any = None
    enable_fsdp: bool = True

    def with_updates(self, **updates: tuple[str, ...]) -> "AxisRules":
        new = dict(self.rules)
        new.update(updates)
        return dataclasses.replace(self, rules=new)

    def _axis_size(self, mesh_axes: Sequence[str]) -> int:
        return mesh_axis_size(self.mesh, *mesh_axes)

    def resolve(self, logical: Sequence[str | None]) -> Spec:
        """The spec of logical axis names: a dim is sharded over the
        rule's mesh axes that the mesh has and that no earlier dim of the
        spec took.  Divisibility is :meth:`spec_for`'s."""
        used: set[str] = set()
        out: list[Any] = []
        for name in logical:
            if name is None or (name == "fsdp" and not self.enable_fsdp):
                out.append(None)
                continue
            axes = tuple(a for a in self.rules.get(name, ())
                         if self.mesh is not None and a in self.mesh.shape
                         and a not in used)
            if not axes:
                out.append(None)
            elif len(axes) == 1:
                out.append(axes[0])
                used.add(axes[0])
            else:
                out.append(axes)
                used.update(axes)
        return tuple(out)

    def spec_for(self, shape: Sequence[int],
                 logical: Sequence[str | None]) -> Spec:
        """:meth:`resolve`, keeping a dim's sharding only where its size
        divides the dim; otherwise the longest run of its axes (size-1
        axes dropped) that does, or replication."""
        assert len(shape) == len(logical), (shape, logical)
        base = self.resolve(logical)
        out: list[Any] = []
        for dim, entry in zip(shape, base):
            if entry is None:
                out.append(None)
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            size = self._axis_size(axes)
            if size > 1 and dim % size == 0:
                out.append(entry)
                continue
            kept: list[str] = []
            rem = dim
            for a in axes:
                s = self._axis_size((a,))
                if s > 1 and rem % s == 0:
                    kept.append(a)
                    rem //= s
            out.append(None if not kept else
                       kept[0] if len(kept) == 1 else tuple(kept))
        return tuple(out)


def mesh_axis_size(mesh, *names: str) -> int:
    """The product of the named axes' sizes (1 for an axis the mesh
    lacks, and without a mesh)."""
    if mesh is None:
        return 1
    size = 1
    for n in names:
        size *= mesh.shape.get(n, 1)
    return size
