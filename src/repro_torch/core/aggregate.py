"""Fed-Server aggregation: FedAvg, partial participation and straggler
masks, masked FedAvg and seed-replay reconstruction, mirroring
:mod:`repro.core.aggregate`.

The masks draw from JAX's threefry stream (:mod:`repro_torch.core.prng`):
a key gives the reference's clients bit for bit.

Seed replay rebuilds the cohort's client update from the lean uplink
alone: per client a key (threefry stream) or an int32 seed (kernel
stream) and the (h, n_pairs) coefficients.  The (client, step, pair)
stream is flattened in the JAX package's order; an eager walk
regenerates one direction tree per entry and adds it into an f32
accumulator (kernel K1's accumulate mode on the kernel stream), applied
to the global params once.  The walk runs in one of two modes
(:func:`_replay_engine`):

* ``shard="none"`` walks the whole stream on every rank;
* ``shard=<axis>`` pads the stream to a multiple of the mesh axis's
  ranks and gives rank ``r`` the ``r``-th contiguous slab (padding is
  skipped: no launch); each rank walks its slab into a zeroed
  accumulator and the partials meet in one ``all_reduce(SUM)`` over the
  axis's group, so every rank applies the same sum.  This matches the
  flat walk up to f32 summation order, and with one rank bit for bit.

``chunk`` is taken for the reference's API and checked (``>= 1``), and
changes nothing: the reference's chunks bound the memory of a jitted
scan over the stream, while the eager walk already holds one direction
at a time, so every ``chunk`` gives the flat walk's (or the sharded
walk's) result bit for bit.

The mesh is a :class:`repro_torch.distributed.mesh.Mesh` over live
ranks; by default ``make_replay_mesh()`` over the running default
group.  The replay starts no group: with none running, ``shard=<axis>``
and no ``mesh`` raise.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import prng as R
from repro_torch.core import zo as Z
from repro_torch.kernels import ops as O
from repro_torch.distributed.mesh import make_replay_mesh
from repro_torch.tree import tree_leaves, tree_map


def fedavg(stacked_params):
    """Mean over the leading client axis (f32 sums, cast back)."""
    return tree_map(lambda p: torch.mean(p.to(torch.float32), dim=0)
                    .to(p.dtype), stacked_params)


def participation_mask(key, n_clients: int, fraction: float):
    """Exactly ``max(1, round(fraction * N))`` participants: the first of
    ``jax.random.permutation(key, N)``.  An (N,) f32 CPU mask."""
    k = max(1, int(round(fraction * n_clients)))
    perm = R.permutation(key, n_clients)
    mask = torch.zeros((n_clients,), dtype=torch.float32)
    mask[perm[:k]] = 1.0
    return mask


def straggler_mask(key, n_clients: int, fraction: float,
                   straggler_prob: float = 0.0):
    """The participation mask with each participant dropped where
    ``bernoulli(fold_in(key, 1), straggler_prob)``; if every participant
    would drop, the participation mask itself (the round never loses its
    whole cohort)."""
    base = participation_mask(key, n_clients, fraction)
    if straggler_prob <= 0:
        return base
    drop = R.bernoulli(R.fold_in(key, 1), straggler_prob, (n_clients,))
    survived = base * (1.0 - drop.to(torch.float32))
    return survived if float(torch.sum(survived)) > 0 else base


def fedavg_masked(stacked_params, mask):
    """FedAvg over the masked participants of a tree whose leaves carry a
    leading client axis."""
    tot = torch.clamp(torch.sum(mask), min=1.0)

    def avg(p):
        m = mask.reshape((-1,) + (1,) * (p.dim() - 1)).to(torch.float32)
        return (torch.sum(p.to(torch.float32) * m, dim=0) / tot).to(p.dtype)

    return tree_map(avg, stacked_params)


def replay_token_stream(client_keys, client_coeffs, lr: float, weights,
                        tot, kernel: bool = False):
    """Flatten a cohort's lean uplinks into ``(tokens, scales)``.

    ``client_keys``: (N, 2) keys (threefry stream) or (N,) int32 seeds
    (``kernel=True``); ``client_coeffs``: (N, h, n_pairs); ``weights``:
    (N,) f32 per-client multipliers (the participation mask); ``tot``:
    the normalizer.  Entry (i, m, p) has the token ``fold_in(fold_in(
    client_keys[i], m), p)`` (``fold_seed`` twice on the kernel stream)
    and the scale ``-lr * coeff * weights[i] / tot``.
    """
    n, h, n_pairs = client_coeffs.shape
    flat = np.arange(n * h * n_pairs)
    i_idx = flat // (h * n_pairs)
    m_idx = (flat // n_pairs) % h
    p_idx = flat % n_pairs
    if kernel:
        tokens = [int(s) for s in np.atleast_1d(O.fold_seed(O.fold_seed(
            np.asarray(client_keys, np.int64)[i_idx], m_idx), p_idx))]
    else:
        ck = torch.stack([R.as_key(k) for k in client_keys])
        tokens = R.fold_in_many(R.fold_in_many(
            ck[torch.as_tensor(i_idx)], m_idx), p_idx)
    i_t = torch.as_tensor(i_idx, device=client_coeffs.device)
    scales = (-lr * client_coeffs.reshape(-1) * weights[i_t] / tot
              ).to(torch.float32)
    return tokens, scales


# leaf offsets in the flat accumulator, in f32 entries: 512 bytes, the
# caching allocator's alignment, so a leaf view is aligned as a leaf of
# its own would be
_FLAT_ALIGN = 128


def _flat_zeros(global_params):
    """A zeroed f32 buffer and a tree of views into it shaped as
    ``global_params``' leaves: the accumulator, one buffer for one
    ``all_reduce``."""
    leaves = tree_leaves(global_params)
    offsets, n = [], 0
    for p in leaves:
        offsets.append(n)
        n += -(-p.numel() // _FLAT_ALIGN) * _FLAT_ALIGN
    dev = leaves[0].device if leaves else None
    buf = torch.zeros((n,), dtype=torch.float32, device=dev)
    views = iter([buf[o:o + p.numel()].view(p.shape)
                  for o, p in zip(offsets, leaves)])
    return buf, tree_map(lambda _: next(views), global_params)


def _walk(acc, tokens, scales, add_direction):
    """``scale * u(token)`` for each entry, into ``acc`` in place."""
    for t, s in zip(tokens, scales):
        add_direction(acc, t, s)


def _apply_acc(global_params, acc):
    return tree_map(lambda p, a: (p.to(torch.float32) + a).to(p.dtype),
                    global_params, acc)


def _resolve_replay_mesh(shard: str, mesh):
    """The mesh the stream is partitioned over: ``mesh`` if it has the
    axis ``shard``, else by default ``make_replay_mesh(axis=shard)`` over
    the running default group."""
    if mesh is not None:
        if shard not in mesh.shape:
            raise ValueError(f"replay shard axis {shard!r} not in mesh axes "
                             f"{tuple(mesh.shape)}")
        return mesh
    return make_replay_mesh(axis=shard)


def _replay_engine(global_params, tokens, scales, add_direction,
                   shard: str = "none", mesh=None, chunk=None):
    """Walk the ``(tokens, scales)`` stream into an f32 accumulator and
    apply it to ``global_params``, in the mode ``shard`` selects (the
    module's docstring).  ``add_direction(acc, token, scale)`` adds
    ``scale * u(token)`` into ``acc`` in place."""
    if chunk is not None and chunk < 1:
        raise ValueError(f"replay chunk {chunk} < 1")
    buf, acc = _flat_zeros(global_params)
    if shard == "none":
        _walk(acc, tokens, scales, add_direction)
        return _apply_acc(global_params, acc)
    mesh = _resolve_replay_mesh(shard, mesh)
    r = mesh.rank(shard)
    per = -(-len(scales) // mesh.shape[shard])   # the padded stream's slab
    _walk(acc, tokens[r * per:(r + 1) * per], scales[r * per:(r + 1) * per],
          add_direction)
    dist.all_reduce(buf, group=mesh.group(shard))
    return _apply_acc(global_params, acc)


def replay_apply(global_params, tokens, scales, *, kernel: bool = False,
                 zo: Z.ZOConfig | None = None, seed_pred=None,
                 shard: str = "none", mesh=None, chunk=None,
                 shardings=None):
    """Apply a flattened ``(tokens, scales)`` stream to ``global_params``:
    each token's direction (a K1 accumulate launch per token on the
    kernel stream, ``direction_like`` under ``zo`` on the threefry
    stream) times its scale into an f32 accumulator, in the mode
    ``shard`` / ``mesh`` / ``chunk`` select.  ``shardings`` (placements
    of ``global_params``' slabs) replays each direction's slabs."""
    if kernel:
        def add_direction(acc, sp, s):
            O.accumulate_direction_tree(
                acc, O.leaf_seed_tree(global_params, sp, seed_pred), s,
                shardings)
    else:
        def add_direction(acc, kp, s):
            Z.accumulate(acc, Z.direction_like(kp, global_params, zo,
                                               shardings), s)

    return _replay_engine(global_params, tokens, scales, add_direction,
                          shard=shard, mesh=mesh, chunk=chunk)


def _weights(client_coeffs, mask):
    if mask is None:
        mask = torch.ones((client_coeffs.shape[0],), dtype=torch.float32,
                          device=client_coeffs.device)
    mask = mask.to(client_coeffs.device)
    return mask, torch.clamp(torch.sum(mask), min=1.0)


def seed_replay_aggregate(global_params, client_keys, client_coeffs,
                          lr: float, zo: Z.ZOConfig, mask=None,
                          shard: str = "none", mesh=None, chunk=None):
    """Reconstruct the FedAvg'd client update from threefry (key, coeff)
    uplinks: entry (i, m, p) regenerates ``direction_like(fold_in(
    fold_in(client_keys[i], m), p))``, the direction client i's step m
    drew for pair p, and adds ``scale * u`` into the accumulator.
    Server memory: the accumulator and one direction.  ``shard`` /
    ``mesh`` / ``chunk``: the walk's mode."""
    mask, tot = _weights(client_coeffs, mask)
    keys, scales = replay_token_stream(client_keys, client_coeffs, lr,
                                       mask, tot)
    return replay_apply(global_params, keys, scales, zo=zo, shard=shard,
                        mesh=mesh, chunk=chunk)


def seed_replay_aggregate_kernel(global_params, client_seeds, client_coeffs,
                                 lr: float, mask=None, seed_pred=None,
                                 shard: str = "none", mesh=None, chunk=None):
    """The same walk on the kernel stream: each entry one K1 launch that
    adds ``s * U`` into the accumulator, no direction materialised; a
    rank launches K1 only for the entries of its own slab."""
    mask, tot = _weights(client_coeffs, mask)
    seeds, scales = replay_token_stream(client_seeds, client_coeffs, lr,
                                        mask, tot, kernel=True)
    return replay_apply(global_params, seeds, scales, kernel=True,
                        seed_pred=seed_pred, shard=shard, mesh=mesh,
                        chunk=chunk)
