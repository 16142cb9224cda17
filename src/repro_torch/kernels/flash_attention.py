"""Wrappers of kernels K3 (``csrc/zo_dual_flash_attention.cu``) and K5
(``csrc/flash_attention.cu``), the counterparts of
``zo_dual_flash_attention`` and ``flash_attention`` in
:mod:`repro.kernels.flash_attention`.

A kernel launches for CUDA tensors (or raises); CPU tensors take the
plain versions of :mod:`repro_torch.kernels.ref`, K3's with the score
field materialised from the same hash stream.  ``LAUNCHES`` counts
kernel launches only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import noise as N
from repro_torch.kernels import ref as R

LAUNCHES = {"zo_dual_flash_attention": 0, "flash_attention": 0}
HEAD_DIMS = (16, 32, 64)   # head widths the kernel is compiled for


def _check_attention(what, qs, ks):
    """Device, contiguity, shapes and dtype of a K3 / K5 launch: every
    tensor of ``qs`` is (B, Sq, H, D) like the first, every tensor of
    ``ks`` (B, Skv, Kv, D) like the first, with H a multiple of Kv."""
    q, k = qs[0], ks[0]
    dev = build.require_cuda(what, *qs, *ks)
    if q.dim() != 4 or k.dim() != 4 or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3] or k.shape[2] <= 0 \
            or q.shape[2] % k.shape[2] \
            or any(t.shape != q.shape for t in qs) \
            or any(t.shape != k.shape for t in ks):
        raise ValueError(
            f"{what}: q {[tuple(t.shape) for t in qs]}, k/v "
            f"{[tuple(t.shape) for t in ks]}: expected (B, S, H, D) and "
            "(B, S, Kv, D) with H a multiple of Kv")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {q.shape[3]} not in "
                         f"{HEAD_DIMS}")
    dtypes = {t.dtype for t in (*qs, *ks)}
    if len(dtypes) != 1 or q.dtype not in build.DTYPE_CODES:
        raise ValueError(f"{what}: dtypes {dtypes}")
    return dev


def zo_dual_flash_attention(qa, qb, k, v, kb=None, vb=None, seed=0,
                            mu_a=0.0, mu_b=0.0, row_offset=0, *,
                            causal=True, window=0, cap=0.0, scale=None,
                            perturb_a=False, perturb_b=True):
    """Fused dual-probe flash attention: (oa, ob) in one K/V sweep.

    qa, qb: (B, Sq, H, D); k, v: (B, Skv, Kv, D).  ``kb is None`` is the
    score-probe mode: both streams share k/v and a perturbed stream adds
    ``mu * U[row_offset + h*Sq + q, kv]`` to its scores after the
    soft-cap.  ``kb``/``vb`` given is the weight-probe mode: the b-stream
    attends its own K/V.
    """
    if (kb is None) != (vb is None):
        raise ValueError("kb and vb are given together or not at all")
    B, Sq, H, D = qa.shape
    Skv, Kv = k.shape[1], k.shape[2]
    cap = float(cap or 0.0)
    if qa.device.type == "cpu":
        u = None
        if perturb_a or perturb_b:
            u = N.uniform_noise(seed, (H * Sq, Skv), row_offset,
                                device=qa.device).reshape(H, Sq, Skv)
        return R.zo_dual_flash_attention_ref(
            qa, qb, k, v, kb=kb, vb=vb, u=u, mu_a=mu_a, mu_b=mu_b,
            perturb_a=perturb_a, perturb_b=perturb_b, causal=causal,
            window=window, cap=cap, scale=scale)
    shared = kb is None
    kb, vb = (k, v) if shared else (kb, vb)
    dev = _check_attention("zo_dual_flash_attention", (qa, qb),
                           (k, v, kb, vb))
    oa = torch.empty_like(qa)
    ob = torch.empty_like(qb)
    if oa.numel():
        sc = float(scale) if scale is not None else D ** -0.5
        err = build.library("zo_dual_flash_attention").zo_dual_flash_attention(
            qa.data_ptr(), qb.data_ptr(), k.data_ptr(), v.data_ptr(),
            kb.data_ptr(), vb.data_ptr(), oa.data_ptr(), ob.data_ptr(),
            B, Sq, Skv, H, Kv, D, build.DTYPE_CODES[qa.dtype], int(shared),
            int(perturb_a), int(perturb_b), int(causal), int(window or 0),
            cap, sc, int(N._u32(seed)), float(mu_a), float(mu_b),
            int(N._u32(row_offset)), build.stream(dev))
        build.check(err, "zo_dual_flash_attention")
        LAUNCHES["zo_dual_flash_attention"] += 1
    return oa, ob


def flash_attention(q, k, v, *, causal=True, window=0, cap=0.0,
                    scale=None):
    """K5: single-stream flash attention, q (B, Sq, H, D) against k, v
    (B, Skv, Kv, D), GQA, causal, local window and soft-cap.  Equals
    stream a of :func:`zo_dual_flash_attention` in the weights mode bit
    for bit on the card."""
    cap = float(cap or 0.0)
    if q.device.type == "cpu":
        return R.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     cap=cap, scale=scale)
    dev = _check_attention("flash_attention", (q,), (k, v))
    B, Sq, H, D = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    if o.numel():
        sc = float(scale) if scale is not None else D ** -0.5
        err = build.library("flash_attention").flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq,
            Skv, H, Kv, D, build.DTYPE_CODES[q.dtype], int(causal),
            int(window or 0), cap, sc, build.stream(dev))
        build.check(err, "flash_attention")
        LAUNCHES["flash_attention"] += 1
    return o
