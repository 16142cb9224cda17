"""Load parameters of the JAX package into the port.

The JAX package's params reach the port as numpy arrays (for example
``jax.tree.map(np.asarray, params)``); this module imports neither JAX
nor ``repro``.  The tree keeps every key, index and stacked ``(reps,
...)`` leaf: the per-leaf seeds hash the paths and the noise rows of a
stacked leaf are offset by its rep, so both must survive unchanged.

Under the datacenter step's mesh a rank loads only its slabs: with
``shardings`` (placements, :func:`repro_torch.distributed.sharding.
tree_shardings`) :func:`from_jax` cuts each numpy leaf before it reaches
the device, and :func:`to_numpy` all-gathers the slabs back into the
full arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.tree import tree_map


def _to_tensor(a, device):
    a = np.array(a)                      # a writable, contiguous copy
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16, bit for bit
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_jax(params_numpy_tree, device="cuda", shardings=None):
    """Nested dicts / lists / tuples of numpy arrays -> the same tree of
    torch tensors on ``device``.  ``None`` placeholders stay ``None``.
    With ``shardings`` each leaf is this rank's slab of it."""
    dev = resolve_device(device)
    if shardings is not None:
        params_numpy_tree = SH.shard_tree(params_numpy_tree, shardings)

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return _to_tensor(node, dev)

    return walk(params_numpy_tree)


def to_numpy(tree, shardings=None):
    """The tree's leaves as numpy arrays, bf16 ones as f32 (numpy has no
    bf16); with ``shardings`` the full arrays, all-gathered from every
    rank's slabs (every rank calls it)."""
    def one(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(one, SH.gather_tree(tree, shardings))
