"""JAX's threefry PRNG in plain PyTorch integer arithmetic: the subset of
``jax.random`` that the threefry ZO estimator, its seed replay, the
round's participation masks, the decode sampler and the synthetic
datasets call, bit for bit.

Only the partitionable layout (``jax_threefry_partitionable=True``, which
the JAX package sets on import) is reproduced.  In it every draw is the
Threefry-2x32 hash of the key and a 64-bit counter (its high and low
words): ``split(key, n)[i]`` is ``fold_in(key, i)``, and the 32-bit
``random_bits`` of a shape are the two output words of flat counter
``i`` xor-ed.

A key is a ``(2,)`` int64 tensor on the CPU holding the two uint32
words (torch's uint32 lacks shifts on some backends); every add and
shift is masked back to 32 bits.  Draws land on the device asked for,
in windows of ``WINDOW`` entries so the int64 temporaries stay bounded.
A draw may be of a slab of its shape (``bounds``, a ``[start, stop)`` per
dim): the slab's entries hash their global flat counters, so a rank of a
mesh draws its part of a leaf's field, bit for bit, and never the whole.

``normal`` needs XLA's f32 ``ErfInv``: the polynomial of M. Giles
(XLA's ``ErfInv32``), whose Horner steps XLA:CPU contracts into fused
multiply-adds.  PyTorch has no FMA op, so each step runs in f64 (the
product of two f32 is exact there) and rounds to f32 once: normals
agree with JAX's within a few f32 ulps, most of them exactly.
"""
from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
WINDOW = 1 << 24            # entries drawn at once (int64 temporaries)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# XLA's ErfInv32 coefficients (Giles), for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_F32 = np.float32


def _f32(v: float) -> float:
    """``v`` rounded to f32, as a Python float (f64) that holds it
    exactly."""
    return float(_F32(v))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of counters ``(x0, x1)`` under key
    ``(k0, k1)``.  Keys are ints or int64 tensors, counters int64
    tensors; all hold uint32 values.  Returns the two output words.
    The counters are consumed (updated in place)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0.add_(ks[0]).bitwise_and_(M32)
    x1 = x1.add_(ks[1]).bitwise_and_(M32)
    for i in range(5):
        for r in _ROT[i % 2]:
            x0.add_(x1).bitwise_and_(M32)
            hi = x1 << r
            x1.bitwise_right_shift_(32 - r).bitwise_or_(hi)
            x1.bitwise_and_(M32).bitwise_xor_(x0)
            del hi
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(M32)
    return x0, x1


def as_key(key) -> torch.Tensor:
    """A key as a ``(2,)`` int64 CPU tensor: from this module, from the
    JAX package's raw uint32 key data (as numpy), or any two words."""
    if isinstance(key, torch.Tensor):
        return (key.detach().to("cpu", torch.int64) & M32).reshape(2)
    return torch.tensor([int(w) & M32 for w in np.asarray(key).reshape(-1)],
                        dtype=torch.int64).reshape(2)


def _words(key):
    k = as_key(key)
    return int(k[0]), int(k[1])


def PRNGKey(seed: int) -> torch.Tensor:    # noqa: N802 (jax's name)
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the words are the
    seed's high 32 bits (0) and its low 32 bits."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} does not fit in 32 bits")
    return torch.tensor([0, seed & M32], dtype=torch.int64)


def fold_in_many(key, data) -> torch.Tensor:
    """``fold_in(key, d)`` for every ``d`` of ``data``: an ``(n, 2)`` key
    stack.  ``key`` is one key or an ``(n, 2)`` stack, one per entry of
    ``data``.  A tensor ``data`` keeps its device (the decode loop's
    per-slot keys never visit the host); other data is hashed on the
    CPU."""
    if isinstance(data, torch.Tensor):
        data = data.reshape(-1).to(torch.int64) & M32
    else:
        data = torch.as_tensor(np.asarray(data, np.int64).reshape(-1)) & M32
    if isinstance(key, torch.Tensor) and key.dim() == 2:
        k = key.to(data.device, torch.int64) & M32
        k0, k1 = k[:, 0], k[:, 1]
    else:
        k0, k1 = _words(key)
    o0, o1 = threefry2x32(k0, k1, torch.zeros_like(data), data.clone())
    return torch.stack([o0, o1], dim=-1)


def fold_in(key, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of counter ``(0, data)``."""
    return fold_in_many(key, [data])[0]


def split(key, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)`` (partitionable layout): ``(n, 2)``,
    row ``i`` equal to ``fold_in(key, i)``."""
    return fold_in_many(key, np.arange(n))


def _bits_at(k0, k1, idx: torch.Tensor) -> torch.Tensor:
    """32-bit random bits of the flat counters ``idx`` (an int64 tensor,
    consumed)."""
    hi = idx >> 32
    o0, o1 = threefry2x32(k0, k1, hi, idx.bitwise_and_(M32))
    return o0.bitwise_xor_(o1)


def _counters(shape, bounds, start: int, n: int, device) -> torch.Tensor:
    """The global flat counters of entries ``start .. start + n`` of the
    slab ``bounds`` of ``shape`` in the slab's own row-major order (all
    of ``shape`` without bounds)."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    if bounds is None:
        return idx
    out = torch.zeros_like(idx)
    stride = 1
    for dim, (a, b) in zip(reversed(shape), reversed(bounds)):
        out.add_((idx % (b - a) + a) * stride)
        idx = idx.div_(b - a, rounding_mode="floor")
        stride *= dim
    return out


def _draw(key, shape, device, dtype, fn, bounds=None) -> torch.Tensor:
    """``fn(bits)`` over the flat counters of ``shape`` (of its slab
    ``bounds``), a window at a time, into one ``dtype`` tensor on
    ``device``."""
    k0, k1 = _words(key)
    shape = tuple(int(d) for d in shape)
    local = shape if bounds is None else tuple(b - a for a, b in bounds)
    n = math.prod(local)
    out = torch.empty((n,), dtype=dtype, device=device)
    for s in range(0, n, WINDOW):
        m = min(WINDOW, n - s)
        out[s:s + m] = fn(_bits_at(k0, k1, _counters(shape, bounds, s, m,
                                                      device)))
    return out.reshape(local)


def random_bits(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: uint32 values in int64."""
    return _draw(key, shape, device, torch.int64, lambda bits: bits)


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """f32 in [0, 1) from the top 23 bits: ``bits >> 9 | 1.0``, minus 1."""
    fb = (bits >> 9).bitwise_or_(0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def _fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as XLA:CPU's contracted multiply
    and add (f64 holds the product of two f32 exactly)."""
    return (a.double() * b + c).float()


def _uniform_window(bits, minval: float, maxval: float):
    """``max(lo, floats * (hi - lo) + lo)``, the affine step fused."""
    lo = _f32(minval)
    u = _fma32(_unit_floats(bits), _f32(_f32(maxval) - lo), lo)
    return torch.clamp_min_(u, lo)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return _draw(key, shape, device, torch.float32,
                 lambda bits: _uniform_window(bits, minval, maxval))


def uniform_rows(keys, n: int, minval: float = 0.0, maxval: float = 1.0,
                 device="cpu") -> torch.Tensor:
    """``jax.vmap(lambda k: jax.random.uniform(k, (n,), float32, minval,
    maxval))(keys)``: a ``(B, n)`` block, row ``b`` drawn under
    ``keys[b]``, in one pass (not one draw per row)."""
    k = keys.to(device, torch.int64) & M32
    B = k.shape[0]
    x0 = torch.zeros((B, n), dtype=torch.int64, device=device)
    x1 = torch.arange(n, dtype=torch.int64, device=device).repeat(B, 1)
    o0, o1 = threefry2x32(k[:, :1], k[:, 1:], x0, x1)
    return _uniform_window(o0.bitwise_xor_(o1), minval, maxval)


_TINY = _f32(np.finfo(np.float32).tiny)


def _gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u))


def gumbel(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in jax's default "low"
    mode: ``-log(-log(uniform(key, shape, tiny, 1)))``.  The uniforms
    are JAX's bit for bit; the two logs are torch's, each within 1 f32
    ulp of XLA's (``tests/test_torch_sampler.py``)."""
    return _gumbel_from_uniform(uniform(key, shape, _TINY, 1.0, device))


def categorical(key, logits: torch.Tensor, shape=None) -> torch.Tensor:
    """``jax.random.categorical(key, logits, shape=shape)`` over the last
    axis: the argmax of ``logits`` plus Gumbel noise.  ``shape`` (the
    batch shape of the draws, ending in ``logits.shape[:-1]``) defaults
    to ``logits.shape[:-1]``; its extra leading axes broadcast the
    logits, so the noise has shape ``shape + logits.shape[-1:]``."""
    batch = tuple(logits.shape[:-1])
    shape = batch if shape is None else tuple(int(s) for s in shape)
    if shape[len(shape) - len(batch):] != batch:
        raise ValueError(f"shape {shape} does not end in the logits' batch "
                         f"shape {batch}")
    noise = gumbel(key, shape + tuple(logits.shape[-1:]), logits.device)
    return torch.argmax(noise + logits, dim=-1)


def categorical_rows(keys, logits: torch.Tensor) -> torch.Tensor:
    """``jax.vmap(jax.random.categorical)(keys, logits)`` for (B, V)
    logits and (B, 2) keys, the Gumbel noise of all rows drawn at once
    (:func:`uniform_rows`)."""
    u = uniform_rows(keys, logits.shape[-1], _TINY, 1.0, logits.device)
    return torch.argmax(_gumbel_from_uniform(u) + logits, dim=-1)


def randint(key, shape, minval: int, maxval: int,
            device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): two
    32-bit draws ``hi``, ``lo`` under ``split(key)``'s two keys, reduced
    as ``(hi % span * (2**32 % span) + lo % span) % span``, where
    ``2**32 % span`` is ``(2**16 % span)**2 % span`` and every product
    and sum wraps at 32 bits, as JAX's uint32 arithmetic does.  An int64
    tensor of values in ``[minval, maxval)``."""
    lo_v, hi_v = int(minval), int(maxval)
    if not all(-2 ** 31 <= v < 2 ** 31 for v in (lo_v, hi_v)):
        raise ValueError(f"randint bounds [{lo_v}, {hi_v}) outside int32")
    span = hi_v - lo_v if hi_v > lo_v else 1    # maxval <= minval: minval
    mult = (1 << 16) % span
    mult = ((mult * mult) & M32) % span
    k1, k2 = split(key, 2)
    hi = random_bits(k1, shape, device)
    lo = random_bits(k2, shape, device)
    off = (((hi % span) * mult) & M32) + lo % span
    return (off & M32) % span + lo_v


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``ErfInv`` (Giles' polynomial, FMA Horner steps)."""
    w = -torch.log1p((x * -x).double()).float()
    lt = w < 5.0
    # f32 sqrt correctly rounded through f64 (torch's vectorised f32 sqrt
    # on the CPU is not, and it is not the same on every element)
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    def coef(i):
        return torch.where(lt, torch.tensor(_f32(_ERFINV_LT5[i]),
                                            dtype=torch.float64,
                                            device=x.device),
                           torch.tensor(_f32(_ERFINV_GE5[i]),
                                        dtype=torch.float64, device=x.device))

    p = coef(0).float()
    w = w.double()
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma32(p, w, coef(i))
    out = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


_NORMAL_LO = _f32(np.nextafter(_F32(-1.0), _F32(0.0)))
_SQRT2 = _f32(math.sqrt(2.0))


def normal(key, shape, device="cpu", bounds=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) *
    erf_inv(uniform(key, shape, nextafter(-1, 0), 1))``; with ``bounds``
    only that slab of it."""
    return _draw(key, shape, device, torch.float32, lambda bits: erf_inv(
        _uniform_window(bits, _NORMAL_LO, 1.0)).mul_(_SQRT2), bounds)


def permutation(key, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``jax.random._shuffle`` of
    ``arange(n)``, ``ceil(3 ln n / ln(2^32 - 1))`` rounds of a split and
    a stable sort on 32-bit random keys."""
    x = torch.arange(n, dtype=torch.int64)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(M32)))
    for _ in range(rounds):
        key, sub = split(key, 2)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def bernoulli(key, p: float, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` in f32."""
    return uniform(key, shape, device=device) < _f32(p)
