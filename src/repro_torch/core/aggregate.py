"""Fed-Server aggregation: masked FedAvg and seed-replay reconstruction
of the kernel noise stream, mirroring :mod:`repro.core.aggregate`.

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
