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

Placements are eager.  A :class:`Placement` (:meth:`AxisRules.
sharding_for`, :func:`tree_shardings`) says which mesh axes shard each
dim of a global array and which ``[start, stop)`` of it this rank holds;
:func:`shard` cuts a full array to the rank's slab and :func:`gather`
all-gathers the slabs back.  There is no compiler to re-lay an array:
each rank runs its own slab, and the model code calls the collectives
itself (:mod:`repro_torch.distributed.tensor_parallel`).  So
:func:`constrain`, the reference's ``with_sharding_constraint``, moves
nothing: it checks that an activation is the slab its spec implies.  The
reference's ``shard_map_compat`` is a shim over JAX versions for
``shard_map``, a per-device program; here every rank's program already is
one, so it has no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import tree_map

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
class Logical:
    """A leaf's logical axis names, one per dim (the reference's tuple of
    names; a class of its own because the port's trees take tuples for
    containers)."""
    names: tuple

    def __iter__(self):
        return iter(self.names)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A global array on this rank: its ``spec`` (mesh axes per dim, as
    :meth:`AxisRules.spec_for`), its global ``shape`` and this rank's
    ``bounds``, a ``[start, stop)`` per dim.  ``mesh`` runs the
    collectives of :func:`gather`."""
    spec: Spec
    shape: tuple
    bounds: tuple
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def local_shape(self) -> tuple:
        return tuple(b - a for a, b in self.bounds)

    @property
    def sharded(self) -> bool:
        return self.local_shape != tuple(self.shape)

    def dim_axes(self, d: int) -> tuple:
        """The mesh axes of dim ``d`` (major first; () if replicated)."""
        e = self.spec[d]
        return () if e is None else (e,) if isinstance(e, str) else tuple(e)

    def slices(self) -> tuple:
        return tuple(slice(a, b) for a, b in self.bounds)

    def drop(self, d: int) -> "Placement":
        """The placement of this array reduced over dim ``d`` (a factored
        optimizer statistic: the other dims keep their slabs)."""
        d %= len(self.shape)
        cut = lambda t: tuple(t[:d]) + tuple(t[d + 1:])  # noqa: E731
        return Placement(cut(self.spec), cut(self.shape), cut(self.bounds),
                         self.mesh)


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Maps logical axis names to mesh axes, with divisibility fallback.
    ``mesh``: anything with a ``shape`` mapping of axis name -> size, or
    None (every axis replicated); ``enable_fsdp=False`` resolves "fsdp"
    to replication.  ``batch_split``: whether the activations' batch dim
    is this rank's slab over the data axes, or (where the batch does not
    divide them) the whole batch on every data rank, as
    :func:`repro_torch.data.pipeline.place_batch` decided for the batch
    in hand (its ``"batch_split"`` entry); only the MoE dispatch, whose
    capacity couples the batch, reads it."""

    rules: Mapping[str, tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))
    mesh: Any = None
    enable_fsdp: bool = True
    batch_split: bool = True

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


    def sharding_for(self, shape: Sequence[int],
                     logical: Sequence[str | None]) -> Placement | None:
        """The :class:`Placement` of a global array of ``shape``: its
        :meth:`spec_for` and this rank's bounds (a dim over axes ``(a1,
        a2)`` is cut into ``|a1| * |a2|`` equal slabs, ``a1`` major).
        None without a mesh."""
        if self.mesh is None:
            return None
        shape = tuple(int(d) for d in shape)
        spec = self.spec_for(shape, tuple(logical))
        bounds = []
        for dim, e in zip(shape, spec):
            axes = () if e is None else (e,) if isinstance(e, str) else e
            idx, size = 0, 1
            for a in axes:
                s = self.mesh.shape[a]
                idx, size = idx * s + self.mesh.rank(a), size * s
            n = dim // size
            bounds.append((idx * n, idx * n + n))
        return Placement(spec, shape, tuple(bounds), self.mesh)


def tree_shardings(rules: AxisRules, tree_logical, tree_shapes):
    """A tree of :class:`Placement` from matching trees of
    :class:`Logical` axes and of arrays (or shapes): ``rules.
    sharding_for`` leaf by leaf (None leaves without a mesh)."""
    return tree_map(lambda lg, x: rules.sharding_for(
        tuple(getattr(x, "shape", x)), tuple(lg)), tree_logical,
        tree_shapes)


def shard(x, placement: Placement | None):
    """This rank's slab of the full array ``x`` (a torch tensor or a
    numpy array), a contiguous copy; ``x`` itself when it is not
    sharded."""
    if placement is None or not placement.sharded:
        return x
    if tuple(x.shape) != tuple(placement.shape):
        raise ValueError(f"shard: array {tuple(x.shape)} is not the "
                         f"placement's global {placement.shape}")
    out = x[placement.slices()]
    if isinstance(x, torch.Tensor):
        return out.clone(memory_format=torch.contiguous_format)
    return np.ascontiguousarray(out)


def gather(x: torch.Tensor, placement: Placement | None) -> torch.Tensor:
    """The full array from this rank's slab ``x``: an all-gather over each
    sharded dim's axes (minor axis first), on every rank."""
    if placement is None or not placement.sharded:
        return x
    if tuple(x.shape) != placement.local_shape:
        raise ValueError(f"gather: slab {tuple(x.shape)} is not the "
                         f"placement's {placement.local_shape}")
    mesh = placement.mesh
    for d in range(len(placement.shape)):
        for a in reversed(placement.dim_axes(d)):
            parts = [torch.empty_like(x) for _ in range(mesh.shape[a])]
            dist.all_gather(parts, x.contiguous(), group=mesh.group(a))
            x = torch.cat(parts, dim=d)
    return x


def shard_tree(tree, placements):
    """:func:`shard` leaf by leaf (``placements`` None: ``tree``)."""
    if placements is None:
        return tree
    return tree_map(lambda x, p: shard(x, p), tree, placements)


def gather_tree(tree, placements):
    """:func:`gather` leaf by leaf (``placements`` None: ``tree``)."""
    if placements is None:
        return tree
    return tree_map(lambda x, p: gather(x, p), tree, placements)


def constrain(x: torch.Tensor, rules: AxisRules, logical, shape):
    """The reference's ``with_sharding_constraint`` in eager torch: every
    rank already holds its slab, so nothing moves.  Checks that ``x`` is
    the slab that ``rules`` give the global ``shape`` on this rank (a
    None entry of ``shape`` is not checked: the dim is taken as it is)
    and returns ``x``.  No-op without a mesh."""
    if rules.mesh is None:
        return x
    glob = tuple(x.shape[i] if g is None else int(g)
                 for i, g in enumerate(shape))
    names = tuple(None if g is None else n for n, g in zip(logical, shape))
    want = rules.sharding_for(glob, names).local_shape
    if tuple(x.shape) != want:
        raise ValueError(f"constrain: {tuple(x.shape)} is not the slab "
                         f"{want} of {glob} under {tuple(logical)}")
    return x


def mesh_axis_size(mesh, *names: str) -> int:
    """The product of the named axes' sizes (1 for an axis the mesh
    lacks, and without a mesh)."""
    if mesh is None:
        return 1
    size = 1
    for n in names:
        size *= mesh.shape.get(n, 1)
    return size
