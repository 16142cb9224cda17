"""Path-based parameter partition, byte counts, int8 smashed-data
quantization and the paper's Table I client costs for SFL, mirroring
:mod:`repro.core.split`.  Paths are the '/'-joined keys and indices the
seed scheme hashes, so the same predicates apply to both."""
from __future__ import annotations

from typing import Callable

import torch

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


def quantize_smashed(x):
    """Symmetric int8 quantization of cut activations, one scale per row
    of the last axis (channels for the CNN's NHWC maps): ``scale =
    max(amax, 1e-8) / 127`` and ``round(x / scale)`` (half to even)
    clipped to +-127.  Returns ``(q, scale)``."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_smashed(q, scale, dtype):
    return (q.to(torch.float32) * scale).to(dtype)


def client_costs(method: str, *, p_batch_bytes: int, q_smashed_bytes: int,
                 client_params: int, aux_params: int, f_c: float,
                 f_a: float, n_pairs: int = 1, bytes_per_param: int = 4):
    """Analytic per-local-update client costs (paper Table I):
    ``dict(comm_bytes, peak_mem_bytes, flops)``.  FO peak memory is the
    paper's O(|theta|) proxy for the trained stack's activations and
    gradients; HERON's is the params alone (inference level)."""
    pc, pa = client_params * bytes_per_param, aux_params * bytes_per_param
    pq = q_smashed_bytes
    if method in ("sflv1", "sflv2"):
        return {"comm_bytes": 2 * pq + 2 * pc,
                "peak_mem_bytes": 2 * pc,
                "flops": 3 * f_c}
    if method in ("cse_fsl", "fsl_sage", "splitlora"):
        return {"comm_bytes": pq + 2 * (pc + pa),
                "peak_mem_bytes": 2 * (pc + pa),
                "flops": 3 * (f_c + f_a)}
    if method == "heron":
        return {"comm_bytes": pq + 2 * (pc + pa),
                "peak_mem_bytes": pc + pa,
                "flops": (1 + n_pairs) * (f_c + f_a)}
    raise ValueError(method)
