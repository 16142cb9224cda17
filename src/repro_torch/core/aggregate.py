"""Fed-Server aggregation: FedAvg, partial participation and straggler
masks, masked FedAvg and seed-replay reconstruction of the kernel noise
stream, mirroring :mod:`repro.core.aggregate`.

The masks draw from a ``torch.Generator``; the reference draws them
from JAX's threefry stream, which the port does not reproduce yet, so
a seed gives the same count and semantics but not the same clients.
Parity tests pass JAX's mask in.

Seed replay rebuilds the cohort's client update from the lean uplink
alone: per client an int32 seed and the (h, n_pairs) coefficients.  The
(client, step, pair) stream is flattened in the JAX package's order,
each entry regenerates one direction tree and adds it into one f32
accumulator in the same pass (kernel K1's accumulate mode on the card),
applied to the global params once.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops as O
from repro_torch.tree import tree_map


def fedavg(stacked_params):
    """Mean over the leading client axis (f32 sums, cast back)."""
    return tree_map(lambda p: torch.mean(p.to(torch.float32), dim=0)
                    .to(p.dtype), stacked_params)


def participation_mask(gen: torch.Generator, n_clients: int,
                       fraction: float):
    """Exactly ``max(1, round(fraction * N))`` participants, uniformly
    at random: an (N,) f32 mask on ``gen``'s device."""
    k = max(1, int(round(fraction * n_clients)))
    perm = torch.randperm(n_clients, generator=gen, device=gen.device)
    mask = torch.zeros((n_clients,), dtype=torch.float32, device=gen.device)
    mask[perm[:k]] = 1.0
    return mask


def straggler_mask(gen: torch.Generator, n_clients: int, fraction: float,
                   straggler_prob: float = 0.0):
    """The participation mask with each participant dropped with
    probability ``straggler_prob``; if every participant would drop, the
    participation mask itself (the round never loses its whole
    cohort)."""
    base = participation_mask(gen, n_clients, fraction)
    if straggler_prob <= 0:
        return base
    drop = torch.rand((n_clients,), generator=gen,
                      device=gen.device) < straggler_prob
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


def replay_token_stream(client_seeds, client_coeffs, lr: float, weights,
                        tot):
    """Flatten a cohort's lean uplinks into ``(seeds, scales)``.

    ``client_seeds``: (N,) int32 seeds; ``client_coeffs``: (N, h,
    n_pairs); ``weights``: (N,) f32 per-client multipliers (the
    participation mask); ``tot``: the normalizer.  Entry (i, m, p) has
    seed ``fold_seed(fold_seed(client_seeds[i], m), p)`` and scale
    ``-lr * coeff * weights[i] / tot``.
    """
    n, h, n_pairs = client_coeffs.shape
    flat = np.arange(n * h * n_pairs)
    i_idx = flat // (h * n_pairs)
    m_idx = (flat // n_pairs) % h
    p_idx = flat % n_pairs
    seeds = O.fold_seed(O.fold_seed(
        np.asarray(client_seeds, np.int64)[i_idx], m_idx), p_idx)
    i_t = torch.as_tensor(i_idx, device=client_coeffs.device)
    scales = (-lr * client_coeffs.reshape(-1) * weights[i_t] / tot
              ).to(torch.float32)
    return [int(s) for s in np.atleast_1d(seeds)], scales


def seed_replay_aggregate_kernel(global_params, client_seeds, client_coeffs,
                                 lr: float, mask=None, seed_pred=None):
    """Reconstruct the FedAvg'd client update from (seed, coeff) uplinks.

    One walk over the flattened stream, each entry one K1 launch that
    adds ``s * U`` into one f32 accumulator: server memory is the
    accumulator, whatever the cohort's size, and no direction is
    materialised.  (The JAX package's ``chunk=`` bounds the memory of its
    vmapped direction batches; an eager walk has none to bound.)
    """
    n = client_coeffs.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.float32,
                          device=client_coeffs.device)
    tot = torch.clamp(torch.sum(mask), min=1.0)
    seeds, scales = replay_token_stream(client_seeds, client_coeffs, lr,
                                        mask, tot)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), global_params)
    for sp, s in zip(seeds, scales):
        O.accumulate_direction_tree(
            acc, O.leaf_seed_tree(global_params, sp, seed_pred), s)
    return tree_map(lambda p, a: (p.to(torch.float32) + a).to(p.dtype),
                    global_params, acc)
