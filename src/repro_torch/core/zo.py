"""The kernel-stream two-point ZO estimator, mirroring the kernel half of
:mod:`repro.core.zo`.

Each parameter leaf gets an int32 hash seed (``base + path_hash``, see
:func:`repro_torch.kernels.ops.leaf_seed_tree`) and the model's forward
generates the perturbation inside the matmul and attention kernels.
Both losses of a pair come out of ONE fused dual-probe pass.  The noise
is unit-variance uniform, iid per entry (the gaussian-type contract):
``coeff = (l_pert - l_clean) / mu / n_pairs``.

The base seed is an int32 the caller passes in; deriving it from a JAX
PRNG key (``repro.core.zo.seed_from_key``) stays on the JAX side.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops as O
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ZOConfig:
    mu: float = 1e-3
    n_pairs: int = 1            # number of two-point perturbation pairs


def add_scaled(params, direction, scale):
    return tree_map(
        lambda p, u: (p.to(torch.float32)
                      + scale * u.to(torch.float32)).to(p.dtype),
        params, direction)


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def pair_seeds(base_seed, n_pairs: int):
    """The per-pair seed stream: fold_seed(base, p) for p < n_pairs."""
    return [int(s) for s in O.fold_seed(base_seed, np.arange(n_pairs))]


def zo_gradient_kernel(dual_loss_fn, params, base_seed, zo: ZOConfig,
                       seed_pred=None):
    """Two-point ZO gradient with the fused kernel noise stream.

    ``dual_loss_fn(params, seeds_tree, mu) -> (l_clean, l_pert, aux)``
    evaluates both losses of a pair in one pass.  ``params`` may hold
    None placeholders (frozen leaves); their seeds are None and they are
    never perturbed.  Returns ``(grad_tree, info)``; ``info`` holds the
    last pair's clean loss and aux and the ``(n_pairs,)`` coefficients
    (the lean uplink).  Each pair adds ``coeff * U`` into the f32
    gradient in one K1 launch (accumulate mode).  With ``n_pairs == 0``
    the gradient is zero, and the loss and aux are the base seed's clean
    half, as in the reference.
    """
    g = tree_map(_zeros_f32, params)
    if zo.n_pairs == 0:
        seeds = O.leaf_seed_tree(params, base_seed, seed_pred)
        l0, _, aux = dual_loss_fn(params, seeds, zo.mu)
        dev = l0.device if isinstance(l0, torch.Tensor) else None
        return g, {"loss": l0, "aux": aux,
                   "coeffs": torch.zeros((0,), dtype=torch.float32,
                                         device=dev)}
    coeffs = []
    for sp in pair_seeds(base_seed, zo.n_pairs):
        seeds = O.leaf_seed_tree(params, sp, seed_pred)
        l0, lp, aux = dual_loss_fn(params, seeds, zo.mu)
        coeff = (lp - l0) / zo.mu / zo.n_pairs
        O.accumulate_direction_tree(g, seeds, coeff)
        coeffs.append(coeff)
    return g, {"loss": l0, "aux": aux, "coeffs": torch.stack(coeffs)}


def replay_gradient_kernel(params, base_seed, coeffs, seed_pred=None):
    """Regenerate the kernel-stream ZO gradient from its lean
    ``(base_seed, coeffs)`` form: the same accumulation as
    :func:`zo_gradient_kernel` minus the forward passes."""
    g = tree_map(_zeros_f32, params)
    for sp, coeff in zip(pair_seeds(base_seed, coeffs.shape[0]), coeffs):
        O.accumulate_direction_tree(
            g, O.leaf_seed_tree(params, sp, seed_pred), coeff)
    return g
