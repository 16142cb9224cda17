"""The cost of one call, counted op by op: the port's counterpart of
:mod:`repro.launch.hlo_costs`.

The reference reads a jitted step's costs from its compiled HLO.  Eager
PyTorch has no such program, so :class:`CostCounter` counts what the
dispatcher sees while the call runs, on any device, ``meta`` included
(shapes alone: a full-width model costs seconds of host time):

* **FLOPs**: what :class:`torch.utils.flop_counter.FlopCounterMode`
  counts of the aten ops (its registry: the products, ``2 * M * K * N``
  a matmul, as the reference's dot count), plus each kernel launch's
  record
  (:mod:`repro_torch.kernels.records`: a launch is opaque to the
  dispatcher);
* **bytes**: the operand and result bytes of every aten op that is not a
  view (in place or not) and not an ``empty*`` allocation, plus the
  kernel records.  These are eager PyTorch's bytes, op by op and
  unfused, so they are not held to XLA's count, which takes fusions'
  boundaries only (the same count as ``fed/cutplan.py``'s);
* **collective bytes**: every ``c10d`` op by kind, by the reference's
  ring model over its group of ``g`` ranks (``launch/roofline.py`` of
  the reference): all-reduce ``2n(g-1)/g``, all-gather ``out(g-1)/g``,
  reduce-scatter ``shard(g-1)``, all-to-all ``out(g-1)/g``, a permute
  ``n``; a group whose ranks share one node of :data:`NODE_RANKS`
  counts under ``"nvlink"``, one that spans nodes under ``"network"``.
  The port's ``tensor_parallel.reduce_scatter`` is an all-reduce and a
  slice (gloo has no reduce-scatter), so it counts as the all-reduce it
  runs;
* **peak bytes**: the call's arguments plus the high-water mark of the
  storages its ops allocate, each counted from its first op's result
  until it is freed (a weak reference on the storage).

On ``meta`` tensors an op's result is its metadata alone, so the counter
runs each functional op (no view, no alias, no mutation) once per
signature (the op, its tensors' shapes, strides and dtypes, its other
arguments) and answers a repeat with fresh tensors of the recorded
metadata: the meta kernels are Python functions of ~0.1 ms, and a 32k
prefill's attention tiles repeat a few signatures a million times.

:func:`total_costs` returns the reference's keys (``flops``, ``bytes``,
``collective_bytes``, ``collectives``) and ``kernel_records``,
``collective_links``, ``argument_bytes``, ``output_bytes`` and
``peak_bytes``.
"""
from __future__ import annotations

import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import records as REC

# GPUs of one NVLink node (an H100 HGX board): a group within one node
# runs its collectives over NVLink, one across nodes over the network
NODE_RANKS = 8

_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "broadcast",
}


def _tensors(tree):
    leaves: list = []
    _flatten(tree, leaves)
    return [t for t in leaves if isinstance(t, torch.Tensor)]


def _flatten(x, leaves: list):
    """Append ``x``'s leaves (of nested tuples, lists and dicts) to
    ``leaves``; return its structure, for :func:`_unflatten`."""
    t = type(x)
    if t is tuple or t is list or isinstance(x, tuple):
        return (t, tuple(_flatten(v, leaves) for v in x))
    if t is dict:
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in x.items()))
    leaves.append(x)
    return None


def _unflatten(struct, it):
    if struct is None:
        return next(it)
    typ, items = struct
    if typ is dict:
        return {k: _unflatten(s, it) for k, s in items}
    return typ([_unflatten(s, it) for s in items])


class _Unkeyable(Exception):
    pass


def _sig(x, ts: list):
    """``x``'s signature (hashable): tensors by shape, strides, dtype and
    device (each appended to ``ts``), containers by their items, scalars
    by type and value.  Raises :class:`_Unkeyable` for anything else."""
    if isinstance(x, torch.Tensor):
        ts.append(x)
        return (x.shape, x.stride(), x.dtype, x.device.type)
    t = type(x)
    if t is tuple or t is list:
        for v in x:
            if type(v) is not int:
                return (t, tuple([_sig(v, ts) for v in x]))
        return (t, tuple(x))            # a size or dims
    if t is dict:
        return (t, tuple((k, _sig(v, ts)) for k, v in x.items()))
    if isinstance(x, _SCALARS):
        return (t, x)
    raise _Unkeyable


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def ring_bytes(kind: str, out_bytes: float, g: int) -> float:
    """The reference's per-rank ring traffic of one collective over ``g``
    ranks: ``out_bytes`` is the result's bytes (the shard of a
    reduce-scatter, the whole of an all-gather)."""
    g = max(int(g), 2)
    if kind == "all-reduce":
        return 2.0 * out_bytes * (g - 1) / g
    if kind in ("all-gather", "all-to-all"):
        return out_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return float(out_bytes * (g - 1))
    return float(out_bytes)


def _functional(func) -> bool:
    """Whether ``func`` returns fresh tensors: no view or alias of an
    argument, no argument written."""
    ok = _FUNCTIONAL.get(func)
    if ok is None:
        sch = func._schema
        ok = (func.namespace == "aten" and not func.is_view
              and not sch.is_mutable
              and "view" not in func._opname and "alias" not in func._opname
              and all(r.alias_info is None for r in sch.returns))
        _FUNCTIONAL[func] = ok
    return ok


_FUNCTIONAL: dict = {}
_SCALARS = (int, float, bool, str, torch.dtype, torch.device,
            torch.memory_format, torch.layout, type(None))


def _group_of(func, args, kwargs):
    """The process group a ``c10d`` op runs on (its ``process_group``
    argument)."""
    for i, a in enumerate(func._schema.arguments):
        if a.name == "process_group":
            obj = args[i] if i < len(args) else kwargs[a.name]
            return dist.ProcessGroup.unbox(obj)
    return None


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs, bytes, collectives and live storages of the
    aten and c10d ops it sees (:func:`count` adds the kernel records).
    The FLOPs are ``FlopCounterMode``'s: its registry's count of each op
    (the registry's functions of the op's shapes)."""

    def __init__(self, args=()):
        super().__init__()
        self.flops = 0
        self.bytes = 0.0
        self.collectives: dict[str, float] = {}
        self.links: dict[str, float] = {}
        self.n_collectives = 0
        self._meta_outs: dict = {}
        held = {id(t.untyped_storage()): t.untyped_storage()
                for t in _tensors(args)}
        self._held = held            # id -> storage, alive through the call
        self.argument_bytes = sum(st.nbytes() for st in held.values())
        self._refs: dict = {}        # id(storage) -> weak reference
        self._sizes: dict = {}       # id(weak reference) -> (id, bytes)
        self.live = 0
        self.peak_live = 0

    def _track(self, outs):
        """Count each new storage of ``outs`` live until it is freed."""
        for t in outs:
            st = t.untyped_storage()
            k = id(st)
            if k in self._refs or k in self._held:
                continue
            n = st.nbytes()
            ref = weakref.ref(st, self._free)
            self._refs[k] = ref
            self._sizes[id(ref)] = (k, n)
            self.live += n
            if self.live > self.peak_live:
                self.peak_live = self.live

    def _free(self, ref):
        k, n = self._sizes.pop(id(ref))
        del self._refs[k]
        self.live -= n

    def _collective(self, func, args, kwargs):
        kind = _C10D_KINDS.get(func._opname, func._opname)
        pg = _group_of(func, args, kwargs)
        g = pg.size() if pg is not None else 1
        # the result: the output list of an all-gather / all-to-all, the
        # (in place) tensors of an all-reduce, the shard of a
        # reduce-scatter: the op's first tensor argument
        out_bytes = _nbytes(_tensors(args[0]))
        nbytes = ring_bytes(kind, out_bytes, g)
        self.collectives[kind] = self.collectives.get(kind, 0.0) + nbytes
        ranks = dist.get_process_group_ranks(pg) if pg is not None else [0]
        link = ("nvlink" if len({r // NODE_RANKS for r in ranks}) == 1
                else "network")
        self.links[link] = self.links.get(link, 0.0) + nbytes
        self.n_collectives += 1

    def _run(self, func, args, kwargs, ts):
        """``func(*args, **kwargs)``; on meta tensors a functional op's
        repeat builds its results from the first call's metadata.
        ``ts`` collects the arguments' tensors."""
        key = None
        if _functional(func):
            try:
                key = (func, _sig(args, ts), _sig(kwargs, ts))
            except _Unkeyable:
                ts.clear()
        if key is None:
            ts.extend(_tensors((args, kwargs)))
            return func(*args, **kwargs)
        if not ts or not all(t.is_meta for t in ts):
            return func(*args, **kwargs)
        hit = self._meta_outs.get(key)
        if hit is None:
            out = func(*args, **kwargs)
            o_leaves: list = []
            o_spec = _flatten(out, o_leaves)
            # tensors by metadata (holding one would keep it alive)
            self._meta_outs[key] = (o_spec, [
                (True, (x.shape, x.stride(), x.dtype))
                if isinstance(x, torch.Tensor) else (False, x)
                for x in o_leaves])
            return out
        o_spec, metas = hit
        return _unflatten(o_spec, iter([
            torch.empty_strided(m[0], m[1], dtype=m[2], device="meta")
            if is_t else m for is_t, m in metas]))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.is_view:        # no FLOPs, no bytes, the base's storage
            return func(*args, **kwargs)
        if func.namespace == "c10d":
            self._collective(func, args, kwargs)
            return func(*args, **kwargs)
        ts: list = []
        out = self._run(func, args, kwargs, ts)
        outs = _tensors(out)
        self._track(outs)
        flop = flop_registry.get(func._overloadpacket)
        if flop is not None:
            self.flops += flop(*args, **kwargs, out_val=out)
        if not func.is_view and not func._opname.startswith("empty"):
            self.bytes += _nbytes(outs) + _nbytes(ts)
        return out


def total_costs(fn, *args, **kwargs) -> dict:
    """The costs of one call of ``fn``: ``flops``, ``bytes``,
    ``collective_bytes`` and ``collectives`` (bytes by kind), as the
    reference's ``hlo_costs.total_costs``; ``kernel_records`` (launches,
    FLOPs and bytes by kernel, included in ``flops`` and ``bytes``),
    ``collective_links`` (bytes over NVLink or the network),
    ``n_collectives``, ``argument_bytes``, ``output_bytes`` and
    ``peak_bytes`` (arguments plus the high-water mark of what the call
    allocated)."""
    cc = CostCounter((args, kwargs))
    with REC.recording() as recs, cc:
        out = fn(*args, **kwargs)
    kernels: dict[str, dict] = {}
    for name, flops, nbytes in recs:
        k = kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                      "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
    out_bytes = sum(st.nbytes() for st in {
        id(t.untyped_storage()): t.untyped_storage()
        for t in _tensors(out)}.values())
    return {
        "flops": float(cc.flops) + sum(k["flops"] for k in kernels.values()),
        "bytes": cc.bytes + sum(k["bytes"] for k in kernels.values()),
        "collective_bytes": sum(cc.collectives.values()),
        "collectives": dict(cc.collectives),
        "collective_links": dict(cc.links),
        "n_collectives": cc.n_collectives,
        "kernel_records": kernels,
        "argument_bytes": float(cc.argument_bytes),
        "output_bytes": float(out_bytes),
        "peak_bytes": float(cc.argument_bytes + cc.peak_live),
    }
