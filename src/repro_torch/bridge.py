"""Load parameters of the JAX package into the port.

The JAX package's params reach the port as numpy arrays (for example
``jax.tree.map(np.asarray, params)``); this module imports neither JAX
nor ``repro``.  The tree keeps every key, index and stacked ``(reps,
...)`` leaf: the per-leaf seeds hash the paths and the noise rows of a
stacked leaf are offset by its rep, so both must survive unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _to_tensor(a, device):
    a = np.array(a)                      # a writable, contiguous copy
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16, bit for bit
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_jax(params_numpy_tree, device="cuda"):
    """Nested dicts / lists / tuples of numpy arrays -> the same tree of
    torch tensors on ``device``.  ``None`` placeholders stay ``None``."""
    dev = resolve_device(device)

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return _to_tensor(node, dev)

    return walk(params_numpy_tree)
