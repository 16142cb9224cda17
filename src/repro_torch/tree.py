"""Nested dict / list / tuple parameter trees (the JAX pytrees of
:mod:`repro`, without JAX).

``None`` is an empty subtree, as in JAX: frozen placeholders from
:func:`repro_torch.core.split.partition` map to ``None`` and are skipped.
Paths are the ``/``-joined keys and indices that the seed scheme hashes
(:func:`repro_torch.kernels.ops.leaf_seed_tree`).
"""
from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching nodes of
    ``rest``; ``None`` in ``tree`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, path: str = ""):
    """``fn(path, leaf)`` over the leaves of ``tree``; ``None`` stays
    ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, _join(path, k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, _join(path, i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _join(path: str, k) -> str:
    return f"{path}/{k}" if path else str(k)


def tree_leaves_with_path(tree, path: str = "", sort_keys: bool = False):
    """``[(path, leaf), ...]`` in traversal order, ``None`` skipped.
    ``sort_keys`` walks dicts in sorted key order: JAX's flatten order,
    which the threefry stream gives its per-leaf keys in."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = sorted(tree.items()) if sort_keys else tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(path, tree)]
    out = []
    for k, v in items:
        out += tree_leaves_with_path(v, _join(path, k), sort_keys)
    return out


def tree_leaves(tree):
    return [leaf for _, leaf in tree_leaves_with_path(tree)]
