"""The two-point zeroth-order (ZO) estimators of :mod:`repro.core.zo`.

**The threefry stream** (the reference's default path,
``forward_impl="xla"``) is the paper's Eq. (2)::

    g_hat = (d / mu) * [l(theta + mu*u) - l(theta)] * u,  u ~ Unif(S^{d-1})

``u`` is drawn leaf by leaf from JAX's threefry stream
(:mod:`repro_torch.core.prng`, bit for bit up to the normals' few ulps),
so a client update travels as ``(key, coeffs)`` and the Fed-Server
regenerates it.  ``ZOConfig.scale`` picks the unit sphere with the
``d`` factor (``"sphere"``) or plain standard normals (``"gaussian"``).
The clean and the perturbed loss are two plain forwards: no kernel.
Under a mesh (``shardings``, a tree of placements matching the
parameters) each rank draws its slab of every leaf's global normals,
the sphere's norm is all-reduced over the model group (a replicated leaf
counted once), and ``d`` is the global tree size.

**The kernel stream** (``forward_impl="kernel"``): each parameter leaf
gets an int32 hash seed (``base + path_hash``, see
:func:`repro_torch.kernels.ops.leaf_seed_tree`) and the model's forward
generates the perturbation inside the matmul and attention kernels.
Both losses of a pair come out of ONE fused dual-probe pass.  The noise
is unit-variance uniform, iid per entry (the gaussian-type contract):
``coeff = (l_pert - l_clean) / mu / n_pairs``.  A round's int32 base
seed comes from its key through :func:`seed_from_key`.  Under a mesh a
rank's K1 launches add its slabs' part of the global field.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.core import prng as R
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.kernels import ops as O
from repro_torch.tree import (tree_leaves, tree_leaves_with_path, tree_map,
                              tree_map_with_path)


@dataclasses.dataclass(frozen=True)
class ZOConfig:
    mu: float = 1e-3
    n_pairs: int = 1            # number of two-point perturbation pairs
    scale: str = "sphere"       # sphere (Eq. 2, with d factor) | gaussian


def add_scaled(params, direction, scale):
    return tree_map(
        lambda p, u: (p.to(torch.float32)
                      + scale * u.to(torch.float32)).to(p.dtype),
        params, direction)


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


# ---------------------------------------------------------------------------
# the threefry stream
# ---------------------------------------------------------------------------

def _places(shardings):
    """A tree of placements as a dict path -> placement (None: {})."""
    return dict(tree_leaves_with_path(shardings)) if shardings else {}


def tree_size(tree, shardings=None) -> int:
    """The entries of ``tree``; with ``shardings``, of the global tree
    its slabs are part of."""
    pl = _places(shardings)
    return int(sum(math.prod(pl[p].shape) if p in pl else leaf.numel()
                   for p, leaf in tree_leaves_with_path(tree)))


def _jax_leaves(tree):
    """``[(path, leaf)]`` in JAX's flatten order (dict keys sorted)."""
    return tree_leaves_with_path(tree, sort_keys=True)


def normal_like(key, tree, shardings=None):
    """Per-leaf f32 standard normals: leaf ``i`` of JAX's flatten order
    gets key ``i`` of ``split(key, n_leaves)``.  The result has
    ``tree``'s structure, each leaf on its leaf's device; a leaf with a
    placement in ``shardings`` is this rank's slab of the global draw
    (the reference pins the draw to the parameter's sharding, so it is
    never made whole)."""
    paths = [p for p, _ in _jax_leaves(tree)]
    keys = dict(zip(paths, R.split(key, max(len(paths), 1))))
    pl = _places(shardings)

    def draw(path, leaf):
        p = pl.get(path)
        if p is None or not p.sharded:
            return R.normal(keys[path], leaf.shape, leaf.device)
        return R.normal(keys[path], p.shape, leaf.device, bounds=p.bounds)

    return tree_map_with_path(draw, tree)


def global_norm(tree, shardings=None):
    """``sqrt(sum of squares + 1e-30)`` in f32, summed leaf by leaf in
    JAX's flatten order.  With ``shardings`` the sharded leaves' sum is
    all-reduced over the mesh axes that split them and the replicated
    leaves' sum (the same on every rank) added once."""
    pl = _places(shardings)
    tot, part, axes, mesh = None, None, set(), None
    for path, leaf in _jax_leaves(tree):
        s = torch.sum(torch.square(leaf.to(torch.float32)))
        p = pl.get(path)
        if p is not None and p.sharded:
            part = s if part is None else part + s
            axes.update(a for d in range(len(p.shape)) for a in p.dim_axes(d))
            mesh = p.mesh
        else:
            tot = s if tot is None else tot + s
    if part is not None:
        for a in sorted(axes):
            part = TP.reduce_from(part, mesh, a)
        tot = part if tot is None else tot + part
    return torch.sqrt(tot + 1e-30)


def unit_sphere_like(key, tree, shardings=None):
    """u ~ Unif(S^{d-1}) over the flattened tree (||u||_2 = 1)."""
    z = normal_like(key, tree, shardings)
    nrm = global_norm(z, shardings)
    return tree_map(lambda leaf: leaf.div_(nrm), z)


def fold_in_range(key, n: int):
    """``(n, 2)`` keys ``fold_in(key, i)`` for ``i < n``."""
    return R.fold_in_many(key, np.arange(n))


def direction_like(key, tree, zo: ZOConfig, shardings=None):
    """The pair direction u for one folded key, per the configured
    scale (this rank's slabs under ``shardings``)."""
    if zo.scale == "sphere":
        return unit_sphere_like(key, tree, shardings)
    return normal_like(key, tree, shardings)


def accumulate(g, u, coeff):
    """``g + coeff * u`` leaf by leaf, in place into the f32 tree ``g``
    (the gradient or the replay accumulator)."""
    return tree_map(lambda gl, ul: gl.add_(coeff * ul), g, u)


def zo_gradient(loss_fn: Callable, params, key, zo: ZOConfig,
                shardings=None):
    """Two-point ZO gradient of ``loss_fn`` at ``params`` on the
    threefry stream.

    ``loss_fn(params) -> (loss, aux)``.  Pair ``p`` takes direction
    ``direction_like(fold_in(key, p))``; its coefficient is
    ``dim_factor * (l_pert - l_clean) / mu / n_pairs`` with
    ``dim_factor = d`` for the sphere and 1 for gaussian.  Returns
    ``(grad_tree, info)``: the f32 gradient and the clean loss, its aux
    and the ``(n_pairs,)`` coefficients.  Cost: ``1 + n_pairs`` forward
    passes.  ``shardings``: the placements of ``params``' slabs."""
    d = tree_size(params, shardings)
    l0, aux0 = loss_fn(params)
    dim_factor = float(d) if zo.scale == "sphere" else 1.0
    g = tree_map(_zeros_f32, params)
    coeffs = []
    for kp in fold_in_range(key, zo.n_pairs):
        u = direction_like(kp, params, zo, shardings)
        lp, _ = loss_fn(add_scaled(params, u, zo.mu))
        coeff = dim_factor * (lp - l0) / zo.mu / zo.n_pairs
        accumulate(g, u, coeff)
        coeffs.append(coeff)
        del u
    coeffs = (torch.stack(coeffs) if coeffs else
              torch.zeros((0,), dtype=torch.float32, device=l0.device))
    return g, {"loss": l0, "aux": aux0, "coeffs": coeffs}


def zo_projected_coeffs(loss_fn: Callable, params, key, zo: ZOConfig):
    """The lean uplink alone: ``(coeffs, loss)``."""
    _, info = zo_gradient(loss_fn, params, key, zo)
    return info["coeffs"], info["loss"]


def replay_gradient(params, key, coeffs, zo: ZOConfig, shardings=None):
    """Regenerate the threefry ZO gradient from ``(key, coeffs)``:
    ``sum_p coeff_p u_p``, the accumulation of :func:`zo_gradient` minus
    the forward passes."""
    g = tree_map(_zeros_f32, params)
    for kp, coeff in zip(fold_in_range(key, coeffs.shape[0]), coeffs):
        accumulate(g, direction_like(kp, params, zo, shardings), coeff)
    return g


def replay_update(params, key, coeffs, lr, zo: ZOConfig, shardings=None):
    """theta - lr * sum_p coeff_p u_p, rebuilt from ``(key, coeffs)``."""
    return add_scaled(params, replay_gradient(params, key, coeffs, zo,
                                              shardings), -lr)


# ---------------------------------------------------------------------------
# the kernel stream
# ---------------------------------------------------------------------------

def seed_from_key(key) -> int:
    """The int32 base seed of a key: its two words xor-ed."""
    k0, k1 = (int(w) for w in R.as_key(key))
    x = k0 ^ k1
    return x - (1 << 32) if x >= 1 << 31 else x


def pair_seeds(base_seed, n_pairs: int):
    """The per-pair seed stream: fold_seed(base, p) for p < n_pairs."""
    return [int(s) for s in O.fold_seed(base_seed, np.arange(n_pairs))]


def zo_gradient_kernel(dual_loss_fn, params, base_seed, zo: ZOConfig,
                       seed_pred=None, shardings=None):
    """Two-point ZO gradient with the fused kernel noise stream.

    ``dual_loss_fn(params, seeds_tree, mu) -> (l_clean, l_pert, aux)``
    evaluates both losses of a pair in one pass.  ``params`` may hold
    None placeholders (frozen leaves); their seeds are None and they are
    never perturbed.  Returns ``(grad_tree, info)``; ``info`` holds the
    last pair's clean loss and aux and the ``(n_pairs,)`` coefficients
    (the lean uplink).  Each pair adds ``coeff * U`` into the f32
    gradient in one K1 launch (accumulate mode).  With ``n_pairs == 0``
    the gradient is zero, and the loss and aux are the base seed's clean
    half, as in the reference.  ``shardings``: the placements of
    ``params``' slabs, whose part of each leaf's field K1 adds.
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
        O.accumulate_direction_tree(g, seeds, coeff, shardings)
        coeffs.append(coeff)
    return g, {"loss": l0, "aux": aux, "coeffs": torch.stack(coeffs)}


def replay_gradient_kernel(params, base_seed, coeffs, seed_pred=None,
                           shardings=None):
    """Regenerate the kernel-stream ZO gradient from its lean
    ``(base_seed, coeffs)`` form: the same accumulation as
    :func:`zo_gradient_kernel` minus the forward passes."""
    g = tree_map(_zeros_f32, params)
    for sp, coeff in zip(pair_seeds(base_seed, coeffs.shape[0]), coeffs):
        O.accumulate_direction_tree(
            g, O.leaf_seed_tree(params, sp, seed_pred), coeff, shardings)
    return g
