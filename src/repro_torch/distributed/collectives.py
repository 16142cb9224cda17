"""Gradient compressors with error feedback, as
:mod:`repro.distributed.collectives`.

HERON's ZO uplink already compresses to (seed, scalars) (the seed
replay, :mod:`repro_torch.core.aggregate`).  For first-order payloads
these are the standard compressors applied before a reduction, with
error feedback so that compression noise does not accumulate:

* :func:`topk_sparsify`: keep the ``ceil(frac * n)`` largest-|.|
  entries of each leaf (ties at the threshold kept);
* :func:`quantize_int8` / :func:`dequantize_int8`: symmetric per-leaf
  int8 (``torch.round`` rounds half to even, as ``jnp.round`` does);
* :class:`ErrorFeedback`: the residual accumulator (Karimireddy et al.).

Trees are the port's nested dicts / lists of tensors
(:mod:`repro_torch.tree`).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import tree_map


def topk_sparsify(g, frac: float):
    """Zero all but the ``max(1, ceil(frac * n))`` largest-|.| entries of
    each leaf; every entry as large as the k-th is kept."""
    def one(x):
        n = x.numel()
        if n == 0:
            return x
        k = max(1, int(math.ceil(frac * n)))
        a = torch.abs(x)
        thresh = torch.topk(a.reshape(-1), k).values[-1]
        return torch.where(a >= thresh, x, torch.zeros_like(x))

    return tree_map(one, g)


def quantize_int8(g):
    """``(q, scales)``: per leaf the int8 codes ``round(x / scale)``
    clipped to +-127 and the scale ``max(max|x|, 1e-12) / 127``, the
    scales a list in the tree's leaf order (:func:`repro_torch.tree.
    tree_leaves`)."""
    scales = []

    def one(x):
        amax = torch.clamp(torch.max(torch.abs(x)), min=1e-12)
        scale = amax / 127.0
        scales.append(scale)
        return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)

    return tree_map(one, g), scales


def dequantize_int8(q, scales):
    it = iter(scales)
    return tree_map(lambda x: x.to(torch.float32) * next(it), q)


@dataclasses.dataclass(frozen=True)
class ErrorFeedback:
    """Residual-corrected compression: ``c = compress(g + e)``,
    ``e' = g + e - c``."""

    def init(self, g):
        return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), g)

    def compress(self, g, err, compressor):
        corrected = tree_map(lambda a, b: a.to(torch.float32) + b, g, err)
        c = compressor(corrected)
        new_err = tree_map(lambda a, b: a - b, corrected, c)
        return c, new_err
