"""Path-based parameter partition and byte counts for SFL, mirroring
:mod:`repro.core.split`.  Paths are the '/'-joined keys and indices the
seed scheme hashes, so the same predicates apply to both."""
from __future__ import annotations

from typing import Callable

from repro_torch.tree import tree_leaves


def partition(tree, predicate: Callable[[str], bool]):
    """Split a tree into (selected, rest) by path predicate; structure is
    preserved with None placeholders (mergeable via :func:`combine`)."""
    def walk(node, path):
        if node is None:
            return None, None
        if isinstance(node, (dict, list, tuple)):
            items = (node.items() if isinstance(node, dict)
                     else enumerate(node))
            pairs = {k: walk(v, f"{path}/{k}" if path else str(k))
                     for k, v in items}
            if isinstance(node, dict):
                return ({k: s for k, (s, _) in pairs.items()},
                        {k: r for k, (_, r) in pairs.items()})
            return (type(node)(s for s, _ in pairs.values()),
                    type(node)(r for _, r in pairs.values()))
        return (node, None) if predicate(path) else (None, node)

    return walk(tree, "")


def combine(a, b):
    """Inverse of :func:`partition` (None-aware merge)."""
    if a is None:
        return b
    if isinstance(a, dict):
        return {k: combine(v, b[k]) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return type(a)(combine(v, b[i]) for i, v in enumerate(a))
    return a


def param_bytes(tree) -> int:
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)))
