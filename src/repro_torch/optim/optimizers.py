"""Optimizers on parameter trees (SGD, AdamW, Adafactor, ZO-SGD),
formula for formula as :mod:`repro.optim.optimizers`: f32 moments, bias
correction ``b1t = 1 - b1**step``, and ``eps`` added outside the square
root.  Not
``torch.optim``: its AdamW differs in where eps and the bias correction
enter, and the parity tests hold the port to the reference's numbers.

``update(grads, state, params, places=None)`` returns new tensors and
never writes into its inputs, like the JAX version.  ``places`` (a tree
of :class:`repro_torch.distributed.sharding.Placement` matching
``params``, the datacenter step's mesh) says which leaves are slabs:
only Adafactor reads it, whose factored means and update RMS are the
whole leaf's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, tree_map


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

    def update(grads, state, params, places=None):
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

    def update(grads, state, params, places=None):
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


def _slab_sum(t, pl, dims):
    """``t`` (a sum over a slab's ``dims``) summed over the mesh axes
    that cut those dims of the leaf: the whole leaf's sum."""
    for d in dims:
        for a in pl.dim_axes(d):
            t = t.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(t, group=pl.mesh.group(a))
    return t


def adafactor(lr, decay=0.8, eps=1e-30, clip_threshold=1.0,
              weight_decay=0.0):
    """Factored second moments: O(rows+cols) state for a leaf of two or
    more dims (row and column means of ``g**2 + eps`` over the last two
    axes), a full second moment otherwise; the update is clipped on its
    RMS.  ``beta = 1 - (step + 1)**-decay`` in f32, as the reference.  On
    a slab leaf (``places``) each mean is the whole leaf's: summed over
    the mesh axes that cut its dims, then divided by the global count;
    the factors of a leaf cut on a leading dim (the experts) are its
    own, but its RMS is still the whole leaf's."""
    def _factored(shape):
        return len(shape) >= 2

    def init(params):
        def st(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": _zeros_f32(p)}

        return {"step": 0, "v": tree_map(st, params)}

    def update(grads, state, params, places=None):
        step = state["step"] + 1
        lr_t = lr(step) if callable(lr) else lr
        beta = 1.0 - torch.tensor(step + 1.0, dtype=torch.float32) ** (-decay)

        def upd(p, g, v, pl=None):
            if pl is not None and not pl.sharded:
                pl = None
            n = p.dim()
            shape = p.shape if pl is None else pl.shape

            def mean(t, d, of):
                """The leaf's mean over its dim ``of`` of ``t``'s dim
                ``d``."""
                if pl is None:
                    return torch.mean(t, dim=d)
                return _slab_sum(torch.sum(t, dim=d), pl, [of % n]) \
                    / shape[of]

            g = g.to(torch.float32)
            g2 = torch.square(g) + eps
            if _factored(p.shape):
                vr = beta * v["vr"] + (1 - beta) * mean(g2, -1, -1)
                vc = beta * v["vc"] + (1 - beta) * mean(g2, -2, -2)
                rms_r = vr / torch.clamp(mean(vr, -1, -2)[..., None],
                                         min=eps)
                u = g * torch.rsqrt(rms_r[..., None] + eps) \
                    * torch.rsqrt(vc[..., None, :] + eps) \
                    * torch.sqrt(torch.clamp(
                        mean(vc, -1, -1)[..., None, None], min=eps))
                nv = {"vr": vr, "vc": vc}
            else:
                nv = {"v": beta * v["v"] + (1 - beta) * g2}
                u = g * torch.rsqrt(nv["v"] + eps)
            if pl is None:
                ms = torch.mean(torch.square(u))
            else:
                ms = _slab_sum(torch.sum(torch.square(u)), pl,
                               range(n)) / math.prod(shape)
            rms_u = torch.sqrt(ms + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr_t * u).to(p.dtype), nv

        if places is None:
            out = tree_map(upd, params, grads, state["v"])
        else:
            out = tree_map(lambda p, g, pl, v: upd(p, g, v, pl), params,
                           grads, places, state["v"])
        pick = lambda i: tree_map(lambda p, o: o[i], params, out)  # noqa
        return pick(0), {"step": step, "v": pick(1)}

    return Optimizer(init, update)


def zo_sgd(lr):
    """Plain SGD for ZO gradient estimates (the paper's client
    optimizer)."""
    return sgd(lr, momentum=0.0)


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    return {"sgd": sgd, "sgdm": lambda l, **k: sgd(l, momentum=0.9, **k),
            "adamw": adamw, "adam": adamw, "adafactor": adafactor,
            "zo_sgd": zo_sgd}[name](lr, **kw)


def clip_by_global_norm(grads, max_norm: float):
    """``(grads * min(1, max_norm / |grads|), |grads|)``: the global L2
    norm in f32; the scaled leaves are f32 or wider, as the reference's
    type promotion makes them."""
    leaves = tree_leaves(grads)
    nrm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                         for g in leaves) + 1e-30)
    scale = torch.clamp(max_norm / nrm, max=1.0)
    return tree_map(lambda g: g.to(torch.promote_types(
        g.dtype, torch.float32)) * scale, grads), nrm
