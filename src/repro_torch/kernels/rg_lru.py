"""Wrapper of kernel K6 (``csrc/rg_lru_scan.cu``), the counterpart of
``rg_lru_scan`` in :mod:`repro.kernels.rg_lru`: the linear recurrence
``h_t = a_t h_{t-1} + b_t`` over (B, S, W) f32 from a zero state.

For CUDA tensors :func:`rg_lru_scan` runs :class:`RGLRUScan`, whose
forward is K6 and whose backward is K6 in reverse mode, so the server's
first-order step differentiates the recurrence through the kernel.  For
CPU tensors it runs the plain sequential version, which autograd
differentiates.  ``meta`` tensors take :class:`RGLRUScan` too, which
launches nothing there and records each launch's cost
(:mod:`repro_torch.kernels.records`).  ``LAUNCHES["rg_lru_scan"]``
counts K6 launches, forward and reverse; ``["rg_lru_scan_reverse"]`` the
reverse ones among them.
K6 takes any (B, S, W); the kernel chooses its loads (TMA where W % 4
== 0 and the pointers are 16-byte aligned, cp.async otherwise).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import records as REC
from repro_torch.kernels import ref as R

LAUNCHES = {"rg_lru_scan": 0, "rg_lru_scan_reverse": 0}


def _check(what, *ts):
    """Shapes and dtype of a K6 call: equal (B, S, W) f32 tensors."""
    shape = ts[0].shape
    if len(shape) != 3 or any(t.shape != shape for t in ts):
        raise ValueError(f"{what}: expected equal (B, S, W) shapes, got "
                         f"{[tuple(t.shape) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"{what}: expected float32, got "
                         f"{[t.dtype for t in ts]}")


def _launch(a, x, hs, out, da, reverse: bool):
    B, S, W = a.shape
    dev = build.require_cuda("rg_lru_scan", a, x, out,
                             *([hs, da] if reverse else []))
    if not out.numel():
        return
    if dev.type == "meta":
        REC.record("rg_lru_scan", 0, REC.scan_bytes(out.numel(), reverse))
        return
    err = build.library("rg_lru_scan").rg_lru_scan(
        a.data_ptr(), x.data_ptr(), hs.data_ptr() if reverse else None,
        out.data_ptr(), da.data_ptr() if reverse else None, B, S, W,
        int(reverse), build.stream(dev))
    build.check(err, "rg_lru_scan")
    LAUNCHES["rg_lru_scan"] += 1
    LAUNCHES["rg_lru_scan_reverse"] += int(reverse)
    REC.record("rg_lru_scan", 0, REC.scan_bytes(out.numel(), reverse))


def rg_lru_scan_reverse(a, g, h):
    """K6 in reverse mode: the gradient of the scan given ``g`` = dL/dh
    and the forward's ``h``.  Returns ``(da, db)``; see
    :func:`repro_torch.kernels.ref.rg_lru_scan_reverse_ref`."""
    _check("rg_lru_scan_reverse", a, g, h)
    if a.device.type == "cpu":
        return R.rg_lru_scan_reverse_ref(a, g, h)
    db = torch.empty_like(a)
    da = torch.empty_like(a)
    _launch(a, g, h, db, da, reverse=True)
    return da, db


class RGLRUScan(torch.autograd.Function):
    """K6 forward; K6 reverse mode as its backward."""

    @staticmethod
    def forward(ctx, a, b):
        h = torch.empty_like(a)
        _launch(a, b, None, h, None, reverse=False)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        return rg_lru_scan_reverse(a, g.contiguous(), h)


def rg_lru_scan(a, b):
    """K6: ``h_t = a_t h_{t-1} + b_t`` over the time axis of (B, S, W) f32
    ``a`` and ``b``, differentiable in both.  Equal bit for bit to the
    plain version on the card."""
    _check("rg_lru_scan", a, b)
    if a.device.type == "cpu":
        return R.rg_lru_scan_ref(a, b)
    return RGLRUScan.apply(a, b)
