"""Optimizers on parameter trees (SGD, AdamW, ZO-SGD), formula for
formula as :mod:`repro.optim.optimizers`: f32 moments, bias correction
``b1t = 1 - b1**step``, and ``eps`` added outside the square root.  Not
``torch.optim``: its AdamW differs in where eps and the bias correction
enter, and the parity tests hold the port to the reference's numbers.

``update`` returns new tensors and never writes into its inputs, like
the JAX version.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (new_params, new_state)


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def sgd(lr, momentum: float = 0.0, weight_decay: float = 0.0):
    def init(params):
        if momentum == 0.0:
            return {"step": 0}
        return {"step": 0, "m": tree_map(_zeros_f32, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr(step) if callable(lr) else lr

        def upd(p, g, m=None):
            g = g.to(torch.float32)
            if weight_decay:
                g = g + weight_decay * p.to(torch.float32)
            if m is not None:
                m = momentum * m + g
                g = m
            return (p.to(torch.float32) - lr_t * g).to(p.dtype), m

        if momentum == 0.0:
            out = tree_map(lambda p, g: upd(p, g), params, grads)
            return tree_map(lambda p, o: o[0], params, out), {"step": step}
        out = tree_map(upd, params, grads, state["m"])
        return (tree_map(lambda p, o: o[0], params, out),
                {"step": step, "m": tree_map(lambda p, o: o[1], params, out)})

    return Optimizer(init, update)


def adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0):
    def init(params):
        return {"step": 0, "m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr(step) if callable(lr) else lr
        # f32 like the reference's b1 ** step.astype(f32)
        b1t = 1.0 - float(torch.tensor(b1, dtype=torch.float32) ** step)
        b2t = 1.0 - float(torch.tensor(b2, dtype=torch.float32) ** step)

        def upd(p, g, m, v):
            g = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            mh = m / b1t
            vh = v / b2t
            u = mh / (torch.sqrt(vh) + eps)
            if weight_decay:
                u = u + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr_t * u).to(p.dtype), m, v

        out = tree_map(upd, params, grads, state["m"], state["v"])
        pick = lambda i: tree_map(lambda p, o: o[i], params, out)  # noqa
        return pick(0), {"step": step, "m": pick(1), "v": pick(2)}

    return Optimizer(init, update)


def zo_sgd(lr):
    """Plain SGD for ZO gradient estimates (the paper's client
    optimizer)."""
    return sgd(lr, momentum=0.0)
