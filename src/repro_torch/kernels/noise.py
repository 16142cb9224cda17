"""The counter-hash noise stream of :mod:`repro.kernels.zo_matmul`.

``U(seed)[r, c]`` is a murmur3-style mix of (seed, global row, global
column) turned into a uniform in (-sqrt3, sqrt3).  It is addressed by
global coordinates, so the same seed gives the same field whatever the
tiling, and one definition serves the JAX package, this plain PyTorch
version and the CUDA kernels (``csrc/hash.cuh``) bit for bit.

The plain version does the 32-bit arithmetic in int64 masked to
``0xFFFFFFFF``: PyTorch's CPU uint32 tensors lack ``>>`` and ``+``.  Each
32x32-bit product is split into 16-bit halves of the constant, so no
intermediate passes 2**49 and nothing overflows int64.  This module is
the plain version only; kernel K1 and its dispatch are
:func:`repro_torch.kernels.zo_matmul.zo_noise` and ``zo_noise_rows``.
"""
from __future__ import annotations

import torch

SQRT3 = 1.7320508075688772
_M32 = 0xFFFFFFFF


def _u32(v):
    """A seed or coordinate as its uint32 bit pattern (int or int64)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & _M32
    return int(v) & _M32


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for x in [0, 2**32), exact in int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix_bits(seed_u32, r_u32, c_u32):
    """murmur3-style finalizer over (seed, global row, global col)."""
    x = _mul32(r_u32, 0x9E3779B9) ^ _mul32(c_u32, 0x85EBCA6B)
    x = x ^ ((_mul32(seed_u32, 0x27D4EB2F) + 0x165667B1) & _M32)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _bits_to_uniform(bits):
    # int64 < 2**32 -> f32 rounds once, to nearest, like uint32 -> f32
    u01 = bits.to(torch.float32) * (1.0 / 4294967296.0)
    return (u01 * 2.0 - 1.0) * SQRT3


def uniform_noise(seed, shape, row_offset=0, col_offset=0, *, device):
    """U(seed) on a (rows, cols) window at a global offset, f32."""
    rows, cols = (int(s) for s in shape)
    dev = torch.device(device)
    r = (torch.arange(rows, dtype=torch.int64, device=dev)[:, None]
         + _u32(row_offset)) & _M32
    c = (torch.arange(cols, dtype=torch.int64, device=dev)[None, :]
         + _u32(col_offset)) & _M32
    return _bits_to_uniform(_mix_bits(_u32(seed), r, c))


def uniform_noise_at(seed, rows, cols):
    """Gathered entries U[rows, cols] for broadcasting integer tensors
    (the embedding-lookup form); plain PyTorch on any device."""
    return _bits_to_uniform(_mix_bits(_u32(seed), _u32(rows), _u32(cols)))

