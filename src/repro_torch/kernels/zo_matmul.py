"""Wrappers of kernels K1 (``csrc/zo_noise.cu``), K2
(``csrc/zo_dual_matmul.cu``) and K4 (``csrc/zo_matmul.cu``), the
counterparts of ``zo_noise``, ``zo_dual_matmul`` and ``zo_matmul`` in
:mod:`repro.kernels.zo_matmul`.

A wrapper launches its kernel for CUDA tensors, on PyTorch's current
stream, and raises if the launch fails.  It takes the plain PyTorch
version only for tensors on the CPU.  ``LAUNCHES`` counts kernel
launches (never plain-version calls), so a run can show that it went
through the kernels.

K2 and K4 have two routes on the card, chosen by
:func:`tensor_core_route`: bf16 operands whose shapes and pointers suit
TMA run on the tensor cores (``csrc/zo_wgmma_matmul.cuh``), everything
else on the CUDA-core tile loop (``csrc/zo_tile_matmul.cuh``).
``LAUNCHES["zo_dual_matmul"]`` / ``["zo_matmul"]`` count every launch;
the ``_tc`` keys count those that took the tensor cores.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import noise as N
from repro_torch.kernels import ref as R

LAUNCHES = {"zo_noise": 0, "zo_dual_matmul": 0, "zo_dual_matmul_tc": 0,
            "zo_matmul": 0, "zo_matmul_tc": 0}


def zo_noise(seed, shape, row_offset=0, col_offset=0, *, device):
    """K1, field mode: U(seed) on a (rows, cols) window at a global
    offset, f32."""
    dev = torch.device(device)
    rows, cols = (int(s) for s in shape)
    if dev.type == "cpu":
        return N.uniform_noise(seed, (rows, cols), row_offset, col_offset,
                               device=dev)
    out = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    build.require_cuda("zo_noise", out)
    if out.numel():
        err = build.library("zo_noise").zo_noise_field(
            out.data_ptr(), rows, cols, int(N._u32(seed)),
            int(N._u32(row_offset)), int(N._u32(col_offset)),
            build.stream(dev))
        build.check(err, "zo_noise")
        LAUNCHES["zo_noise"] += 1
    return out


def zo_noise_rows(seed, ids: torch.Tensor, n_cols: int):
    """K1, gathered mode: ``U[ids[..., None], arange(n_cols)]`` with
    shape ``ids.shape + (n_cols,)``, f32."""
    if ids.device.type == "cpu":
        cols = torch.arange(n_cols, dtype=torch.int64, device=ids.device)
        return N.uniform_noise_at(seed, ids[..., None], cols)
    flat = ids.reshape(-1).to(torch.int32).contiguous()
    out = torch.empty((flat.numel(), n_cols), dtype=torch.float32,
                      device=ids.device)
    dev = build.require_cuda("zo_noise_rows", flat, out)
    if out.numel():
        err = build.library("zo_noise").zo_noise_rows(
            out.data_ptr(), flat.data_ptr(), flat.numel(), n_cols,
            int(N._u32(seed)), build.stream(dev))
        build.check(err, "zo_noise_rows")
        LAUNCHES["zo_noise"] += 1
    return out.reshape(tuple(ids.shape) + (n_cols,))


def _check_matmul(what, w, *xs):
    """Device, contiguity, shapes and dtype of a K2 / K4 launch."""
    dev = build.require_cuda(what, *xs, w)
    x = xs[0]
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] \
            or any(t.shape != x.shape for t in xs):
        raise ValueError(f"{what}: shapes "
                         f"{[tuple(t.shape) for t in xs]} @ "
                         f"{tuple(w.shape)}")
    if any(t.dtype != w.dtype for t in xs) or w.dtype not in \
            build.DTYPE_CODES:
        raise ValueError(f"{what}: dtypes {[t.dtype for t in xs]}, "
                         f"{w.dtype}; expected one of f32 / bf16")
    return dev


def tensor_core_route(dtype, K: int, N: int, ptrs) -> bool:
    """Whether a K2 / K4 launch of (M, K) @ (K, N) runs on the tensor
    cores: bf16 operands, K and N positive multiples of 8 (TMA's row
    strides are multiples of 16 bytes) and every base pointer in ``ptrs``
    16-byte aligned (TMA's base addresses).  Anything else takes the
    CUDA-core loop.  A pure function of its arguments: it needs no card."""
    return (dtype == torch.bfloat16 and K > 0 and N > 0 and K % 8 == 0
            and N % 8 == 0 and all(int(p) % 16 == 0 for p in ptrs))


def zo_dual_matmul(xa, xb, w, seed, mu_a, mu_b, *, row_offset=0,
                   perturb_a: bool = False, perturb_b: bool = True):
    """K2: ``(xa @ (W + mu_a*U), xb @ (W + mu_b*U))`` for one read of W.

    xa, xb: (M, K); w: (K, N); one dtype, f32 or bf16; f32 accumulation,
    outputs in x's dtype.  ``perturb_a`` / ``perturb_b`` select the
    streams that see the noise (clean + perturbed by default;
    ``perturb_a=True, mu_b=-mu_a`` is the antithetic pair).
    """
    if xa.device.type == "cpu":
        u = None
        if perturb_a or perturb_b:
            u = N.uniform_noise(seed, w.shape, row_offset, device=w.device)
        return R.zo_dual_matmul_ref(xa, xb, w, u, mu_a, mu_b,
                                    perturb_a=perturb_a, perturb_b=perturb_b)
    dev = _check_matmul("zo_dual_matmul", w, xa, xb)
    M, K = xa.shape
    Nn = w.shape[1]
    ya = torch.empty((M, Nn), dtype=xa.dtype, device=dev)
    yb = torch.empty((M, Nn), dtype=xa.dtype, device=dev)
    if ya.numel():
        lib = build.library("zo_dual_matmul")
        ptrs = (xa.data_ptr(), xb.data_ptr(), w.data_ptr(), ya.data_ptr(),
                yb.data_ptr())
        rest = (int(perturb_a), int(perturb_b), int(N._u32(seed)),
                float(mu_a), float(mu_b), int(N._u32(row_offset)),
                build.stream(dev))
        tc = tensor_core_route(xa.dtype, K, Nn, ptrs)
        if tc:
            err = lib.zo_dual_matmul_tc(*ptrs, M, K, Nn, *rest)
        else:
            err = lib.zo_dual_matmul(*ptrs, M, K, Nn,
                                     build.DTYPE_CODES[xa.dtype], *rest)
        build.check(err, "zo_dual_matmul")
        LAUNCHES["zo_dual_matmul"] += 1
        LAUNCHES["zo_dual_matmul_tc"] += int(tc)
    return ya, yb


def zo_matmul(x, w, seed, mu, *, row_offset=0, perturb: bool = True):
    """K4: ``y = x @ (W + mu*U(seed))``, or ``x @ W`` with
    ``perturb=False`` (the clean pass of the two-pass baseline).

    x: (M, K); w: (K, N); one dtype, f32 or bf16; f32 accumulation,
    output in x's dtype.  Equals stream b of :func:`zo_dual_matmul` with
    the same (seed, mu, row_offset) bit for bit on the card when both take
    the same route.
    """
    if x.device.type == "cpu":
        if not perturb:
            return R.matmul_ref(x, w)
        u = N.uniform_noise(seed, w.shape, row_offset, device=w.device)
        return R.zo_matmul_ref(x, w, u, mu)
    dev = _check_matmul("zo_matmul", w, x)
    M, K = x.shape
    Nn = w.shape[1]
    y = torch.empty((M, Nn), dtype=x.dtype, device=dev)
    if y.numel():
        lib = build.library("zo_matmul")
        ptrs = (x.data_ptr(), w.data_ptr(), y.data_ptr())
        rest = (int(perturb), int(N._u32(seed)), float(mu),
                int(N._u32(row_offset)), build.stream(dev))
        tc = tensor_core_route(x.dtype, K, Nn, ptrs)
        if tc:
            err = lib.zo_matmul_tc(*ptrs, M, K, Nn, *rest)
        else:
            err = lib.zo_matmul(*ptrs, M, K, Nn, build.DTYPE_CODES[x.dtype],
                                *rest)
        build.check(err, "zo_matmul")
        LAUNCHES["zo_matmul"] += 1
        LAUNCHES["zo_matmul_tc"] += int(tc)
    return y
