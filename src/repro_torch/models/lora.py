"""LoRA: low-rank adapters in dense layers, as :mod:`repro.models.lora`.

:func:`add_lora` adds ``lora_a`` (d_in, r) and ``lora_b`` (r, d_out)
leaves to every dense-layer dict whose key is in ``targets``;
``layers.dense`` reads them on its clean and perturbed paths.
``lora_b`` starts at zero, so an adapted model computes what the base
model does until it trains.  The port draws ``lora_a`` from a
``torch.Generator``; the parity tests load the JAX package's adapters
through the bridge instead.  :func:`add_lora_axes` gives the adapters'
logical axes, for the datacenter step's mesh: ``lora_a`` takes W's input
axis, ``lora_b`` its output axis, so a column-parallel W's ``lora_b``
and a row-parallel W's ``lora_a`` are slabs like W.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import Logical

DEFAULT_TARGETS = ("wq", "wv", "wk", "wo", "up", "down", "gate")


def add_lora(gen: torch.Generator, params, rank: int = 8,
             alpha: float = 16.0, targets=DEFAULT_TARGETS):
    """A new tree with ``lora_a`` / ``lora_b`` on each dict that holds a
    2-D (or stacked 3-D) ``w`` under a key in ``targets``.  ``lora_a`` is
    normal times ``(alpha / rank) / sqrt(d_in)``, drawn on ``gen``'s
    device in f32 and stored in ``w``'s dtype and device."""
    def walk(node, name):
        if isinstance(node, dict):
            w = node.get("w")
            if (isinstance(w, torch.Tensor) and w.dim() in (2, 3)
                    and name in targets and "lora_a" not in node):
                *lead, d_in, d_out = w.shape
                a = torch.randn((*lead, d_in, rank), generator=gen,
                                dtype=torch.float32, device=gen.device) \
                    * (alpha / rank) / d_in ** 0.5
                new = dict(node)
                new["lora_a"] = a.to(device=w.device, dtype=w.dtype)
                new["lora_b"] = torch.zeros((*lead, rank, d_out),
                                            dtype=w.dtype, device=w.device)
                return new
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        return node

    return walk(params, "")


def lora_pred(path: str) -> bool:
    return "lora_a" in path or "lora_b" in path


def merge_lora(params):
    """Fold the adapters into the base weights, ``w + lora_a @ lora_b``
    in f32 (the serving path)."""
    def walk(node):
        if isinstance(node, dict):
            if "lora_a" in node:
                new = {k: v for k, v in node.items()
                       if k not in ("lora_a", "lora_b")}
                w = node["w"].to(torch.float32) \
                    + node["lora_a"].to(torch.float32) \
                    @ node["lora_b"].to(torch.float32)
                new["w"] = w.to(node["w"].dtype)
                return new
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def add_lora_axes(axes, targets=DEFAULT_TARGETS):
    """The logical axes of :func:`add_lora`'s tree from those of the
    params (``repro_torch.models.transformer.param_axes``): beside each
    targeted ``w`` of 2 or 3 dims, ``lora_a`` (its leading and input
    axes, then the rank's None) and ``lora_b`` (None, then its output
    axis)."""
    def walk(node, name):
        if isinstance(node, dict):
            w = node.get("w")
            if (isinstance(w, Logical) and len(w.names) in (2, 3)
                    and name in targets and "lora_a" not in node):
                *lead, a_in, a_out = w.names
                return {**node, "lora_a": Logical((*lead, a_in, None)),
                        "lora_b": Logical((*lead, None, a_out))}
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        return node

    return walk(axes, "")
