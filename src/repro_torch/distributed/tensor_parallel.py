"""The collectives of the datacenter step's mesh mode, as
``torch.autograd.Function``s, and the vocab-parallel pieces built on
them.

Every rank of a mesh axis computes the same replicated values (the
loss above all), and a parameter's gradient on a rank is the full
gradient of its slab.  Five collectives, in conjugate pairs, keep that
true through the backward (Megatron-LM's scheme; each backward is the
other function, so FSL-SAGE's double backward differentiates through
them too):

* :func:`copy_to`: forward identity, backward all-reduce (a replicated
  input entering a column-parallel product, whose input gradients are
  partial sums);
* :func:`reduce_from`: forward all-reduce, backward identity (the partial
  outputs of a row-parallel product; the data group's loss sums);
* :func:`gather_from`: forward all-gather on a dim, backward this rank's
  slice (a slab that replicated code needs whole), or with ``partial``
  the slice of the gradient's sum over the axis, a reduce-scatter (a
  slab whose whole each rank reads only in part: the k / v heads of a
  rank's own q heads);
* :func:`split_to`: forward this rank's slice, backward all-gather;
* :func:`reduce_scatter`: forward this rank's slice of the sum over the
  axis, backward all-gather (the partial outputs of a row-parallel
  product whose sum each rank reads only in its own columns: the
  RG-LRU's gate projections); the conjugate of ``gather_from(partial=
  True)``.  (``reduce_from`` and a slice would pass each rank only its
  own columns' gradient back to its partial product.)

:func:`all_to_all` (the reference's tiled ``lax.all_to_all``, the MoE
expert exchange) is its own conjugate: its backward is the inverse
exchange.  :func:`all_gather_ints` gathers small integer tensors outside
autograd (the MoE dispatch's per-expert counts).

Each is the identity on an axis of size 1 or without a mesh.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _live(mesh, axis) -> bool:
    return mesh is not None and mesh.shape.get(axis, 1) > 1


def _all_reduce(x, mesh, axis, op=dist.ReduceOp.SUM):
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=mesh.group(axis))
    return out


def _all_gather(x, mesh, axis, dim):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x, group=mesh.group(axis))
    return torch.cat(parts, dim=dim)


def _slice(x, mesh, axis, dim):
    n = x.shape[dim] // mesh.shape[axis]
    return x.narrow(dim, mesh.rank(axis) * n, n).contiguous()


def _exchange(x, mesh, axis, split_dim, concat_dim):
    """Chunk ``i`` of ``x`` on ``split_dim`` goes to rank ``i`` of the
    axis; the chunks received, in rank order, are concatenated on
    ``concat_dim``.  (gloo runs it on a card's tensors by copying them
    through host memory; NCCL card to card.)"""
    buf = torch.stack(x.chunk(mesh.shape[axis], dim=split_dim))
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=mesh.group(axis))
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return _exchange(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return (_AllToAll.apply(g, mesh, axis, concat_dim, split_dim), None,
                None, None, None)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g, ctx.mesh, ctx.axis), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.mesh, ctx.axis), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _Split.apply(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _GatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_ReduceScatter.apply(g, ctx.mesh, ctx.axis, ctx.dim), None,
                None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _slice(_all_reduce(x, mesh, axis), mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_GatherPartial.apply(g, ctx.mesh, ctx.axis, ctx.dim), None,
                None, None)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _slice(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def copy_to(x, mesh, axis: str = "model"):
    return _Copy.apply(x, mesh, axis) if _live(mesh, axis) else x


def reduce_from(x, mesh, axis: str = "model"):
    return _Reduce.apply(x, mesh, axis) if _live(mesh, axis) else x


def gather_from(x, mesh, axis: str = "model", dim: int = -1,
                partial: bool = False):
    if not _live(mesh, axis):
        return x
    fn = _GatherPartial if partial else _Gather
    return fn.apply(x, mesh, axis, dim % x.dim())


def split_to(x, mesh, axis: str = "model", dim: int = -1):
    if not _live(mesh, axis):
        return x
    return _Split.apply(x, mesh, axis, dim % x.dim())


def reduce_scatter(x, mesh, axis: str = "model", dim: int = -1):
    """This rank's slice on ``dim`` of ``x`` summed over the axis (an
    all-reduce, then the slice: gloo has no reduce-scatter); its
    backward all-gathers the slice's gradient."""
    if not _live(mesh, axis):
        return x
    return _ReduceScatter.apply(x, mesh, axis, dim % x.dim())


def all_to_all(x, mesh, axis: str = "model", split_dim: int = 0,
               concat_dim: int = 1):
    """The reference's ``lax.all_to_all(x, axis, split_dim, concat_dim,
    tiled=True)``: ``x`` cut into the axis size's chunks on
    ``split_dim``, chunk ``i`` sent to rank ``i``, the received chunks
    concatenated on ``concat_dim`` in rank order.  Its backward is the
    inverse exchange."""
    if not _live(mesh, axis):
        return x
    return _AllToAll.apply(x, mesh, axis, split_dim % x.dim(),
                           concat_dim % x.dim())


def all_gather_ints(x, mesh, axis: str = "data"):
    """``(n, *x.shape)``: the integer tensor ``x`` of every rank of the
    axis's group, in group rank order, outside autograd (``n`` the
    group's size: the dry run's 2x16x16 "data" group spans the pods);
    ``x[None]`` without a live axis."""
    x = x.detach()
    if not _live(mesh, axis):
        return x[None]
    group = mesh.group(axis)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def all_max(x, mesh, axis: str = "model"):
    """The elementwise max over the axis, outside autograd (a softmax's
    shift, which moves no gradient)."""
    x = x.detach()
    if not _live(mesh, axis):
        return x
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MAX)


def all_reduce_tree(tree_leaves, mesh, axis: str = "data"):
    """Sum each tensor of ``tree_leaves`` over the axis in place (the
    data group's gradients), one all-reduce of a flat f32 buffer."""
    leaves = [t for t in tree_leaves if t is not None]
    if not _live(mesh, axis) or not leaves:
        return
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in leaves])
    dist.all_reduce(flat, group=mesh.group(axis))
    o = 0
    for t in leaves:
        n = t.numel()
        t.copy_(flat[o:o + n].view(t.shape).to(t.dtype))
        o += n


def vocab_embed(table, ids, v0: int, mesh):
    """Rows ``ids`` of a vocab-parallel table (this rank holds rows
    ``[v0, v0 + table.shape[0])``): each rank looks up the ids it holds,
    zeros elsewhere, summed over the model group (one non-zero term per
    entry, so the sum is exact)."""
    local = ids.long() - v0
    mine = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(mine, local, torch.zeros_like(local))]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return reduce_from(rows, mesh)


def vocab_cross_entropy(logits, labels, vocab: int, v0: int, mesh):
    """``(sum of -log p(label), count)`` over the unmasked labels (!=
    -100) of vocab-parallel f32 logits: this rank's columns are global
    ``[v0, v0 + logits.shape[-1])``, those at or past ``vocab`` (the
    padded tail) out of the softmax.  The max and the sum of exponentials
    are reduced over the model group."""
    V = logits.shape[-1]
    col = torch.arange(v0, v0 + V, device=logits.device)
    logits = logits + torch.where(col >= vocab, -1e30, 0.0).to(logits.dtype)
    valid = labels != -100
    m = all_max(torch.amax(logits, dim=-1, keepdim=True), mesh)
    shifted = logits - m
    sumexp = reduce_from(torch.sum(torch.exp(shifted), dim=-1), mesh)
    local = labels.long() - v0
    mine = valid & (local >= 0) & (local < V)
    tgt = torch.gather(shifted, -1, torch.where(
        mine, local, torch.zeros_like(local))[..., None])[..., 0]
    tgt = reduce_from(torch.where(mine, tgt, torch.zeros_like(tgt)), mesh)
    ll = tgt - torch.log(sumexp)
    return -torch.sum(torch.where(valid, ll, torch.zeros_like(ll))), \
        torch.sum(valid)
