"""Wrappers of kernels K3 (``csrc/zo_dual_flash_attention.cu``) and K5
(``csrc/flash_attention.cu``), the counterparts of
``zo_dual_flash_attention`` and ``flash_attention`` in
:mod:`repro.kernels.flash_attention`.

A kernel launches for CUDA tensors (or raises); CPU tensors take the
plain versions of :mod:`repro_torch.kernels.ref`, K3's with the score
field materialised from the same hash stream; ``meta`` tensors get empty
outputs and no launch.  ``LAUNCHES`` counts kernel launches only; each
launch, and each meta call in its place, records its cost
(:mod:`repro_torch.kernels.records`).

K3 and K5 have two routes on the card, chosen by :func:`route`: bf16
operands whose head width and pointers suit TMA run on the tensor cores
(``csrc/flash_wgmma.cuh``), everything else on the CUDA-core loop
(``csrc/flash_tile.cuh``).  Each route is compiled for the widths in
``HEAD_DIMS`` and runs a head width D at the smallest of them that holds
it (:func:`compiled_width`), the columns past D zero-filled as they load;
the scale stays ``1/sqrt(D)`` of the real width.  Only D past
``MAX_HEAD_DIM`` raises.  ``LAUNCHES["zo_dual_flash_attention"]``
/ ``["flash_attention"]`` count every launch; the ``_tc`` keys count
those that took the tensor cores.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import noise as N
from repro_torch.kernels import records as REC
from repro_torch.kernels import ref as R

LAUNCHES = {"zo_dual_flash_attention": 0, "zo_dual_flash_attention_tc": 0,
            "flash_attention": 0, "flash_attention_tc": 0}
# the widths each route is compiled for; the loop's tiles are 32 rows at
# 256, so its f32 Q, K, V and P fit 227 KB of shared memory
HEAD_DIMS = {"tensor cores": (16, 32, 64, 128, 256),
             "CUDA-core loop": (8, 16, 32, 64, 128, 256)}
MAX_HEAD_DIM = 256


def compiled_width(route_name: str, head_dim: int) -> int:
    """The compiled width a head width runs at on ``route_name``: the
    smallest of ``HEAD_DIMS[route_name]`` that holds it."""
    for dc in HEAD_DIMS[route_name]:
        if head_dim <= dc:
            return dc
    raise ValueError(f"head_dim {head_dim} > {MAX_HEAD_DIM}")


def tc_kv_tile(head_dim: int) -> int:
    """The kv tile width of the tensor-core route: 64 columns, 32 past
    head_dim 128 (so K3's weights mode fits shared memory)."""
    return 32 if head_dim > 128 else 64


def tensor_core_route(dtype, head_dim: int, seq_kv: int, ptrs) -> bool:
    """Whether a K3 / K5 launch runs on the tensor cores: bf16 operands, a
    head width that is a multiple of 8 up to ``MAX_HEAD_DIM`` (TMA's row
    strides are then multiples of 16 bytes), a non-empty K/V and every
    base pointer in ``ptrs`` 16-byte aligned (TMA's base addresses).
    Anything else takes the CUDA-core loop.  A pure function of its
    arguments: it needs no card."""
    return (dtype == torch.bfloat16 and 0 < head_dim <= MAX_HEAD_DIM
            and head_dim % 8 == 0 and seq_kv > 0
            and all(int(p) % 16 == 0 for p in ptrs))


def route(what: str, dtype, head_dim: int, seq_kv: int, ptrs) -> bool:
    """The route of a K3 / K5 launch on the card: True for the tensor
    cores (:func:`tensor_core_route`), False for the CUDA-core loop, which
    takes every head width up to ``MAX_HEAD_DIM`` in both dtypes.  Raises
    for a width past it, saying why.  A pure function of its arguments:
    it needs no card."""
    if not 0 < head_dim <= MAX_HEAD_DIM:
        raise ValueError(
            f"{what}: head_dim {head_dim} is outside 1..{MAX_HEAD_DIM}: "
            f"both routes are compiled for widths up to {MAX_HEAD_DIM} "
            f"(tensor cores {HEAD_DIMS['tensor cores']}, CUDA-core loop "
            f"{HEAD_DIMS['CUDA-core loop']}), and no config of the repo has "
            "a wider head")
    return tensor_core_route(dtype, head_dim, seq_kv, ptrs)


def _check_attention(what, qs, ks, outs):
    """Device, contiguity, shapes and dtype of a K3 / K5 launch: every
    tensor of ``qs`` is (B, Sq, H, D) like the first, every tensor of
    ``ks`` (B, Skv, Kv, D) like the first, with H a multiple of Kv.
    Returns the device and :func:`route`'s choice."""
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
    dtypes = {t.dtype for t in (*qs, *ks)}
    if len(dtypes) != 1 or q.dtype not in build.DTYPE_CODES:
        raise ValueError(f"{what}: dtypes {dtypes}")
    return dev, route(what, q.dtype, q.shape[3], k.shape[1],
                      [t.data_ptr() for t in (*qs, *ks, *outs)])


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
    oa = torch.empty_like(qa)
    ob = torch.empty_like(qb)
    dev, tc = _check_attention("zo_dual_flash_attention", (qa, qb),
                               (k, v, kb, vb), (oa, ob))
    cost = REC.attention_cost(B, Sq, Skv, H, Kv, D, qa.element_size(),
                              streams=2, kv_sets=1 if shared else 2)
    if oa.numel() and dev.type == "meta":
        REC.record("zo_dual_flash_attention", *cost)
    elif oa.numel():
        sc = float(scale) if scale is not None else D ** -0.5
        lib = build.library("zo_dual_flash_attention")
        ptrs = (qa.data_ptr(), qb.data_ptr(), k.data_ptr(), v.data_ptr(),
                kb.data_ptr(), vb.data_ptr(), oa.data_ptr(), ob.data_ptr())
        shape = (B, Sq, Skv, H, Kv, D)
        rest = (int(shared), int(perturb_a), int(perturb_b), int(causal),
                int(window or 0), cap, sc, int(N._u32(seed)), float(mu_a),
                float(mu_b), int(N._u32(row_offset)), build.stream(dev))
        if tc:
            err = lib.zo_dual_flash_attention_tc(*ptrs, *shape, *rest)
        else:
            err = lib.zo_dual_flash_attention(
                *ptrs, *shape, build.DTYPE_CODES[qa.dtype], *rest)
        build.check(err, "zo_dual_flash_attention")
        LAUNCHES["zo_dual_flash_attention"] += 1
        LAUNCHES["zo_dual_flash_attention_tc"] += int(tc)
        REC.record("zo_dual_flash_attention", *cost)
    return oa, ob


def flash_attention(q, k, v, *, causal=True, window=0, cap=0.0,
                    scale=None):
    """K5: single-stream flash attention, q (B, Sq, H, D) against k, v
    (B, Skv, Kv, D), GQA, causal, local window and soft-cap.  Equals
    stream a of :func:`zo_dual_flash_attention` in the weights mode bit
    for bit on the card when both take the same route."""
    cap = float(cap or 0.0)
    if q.device.type == "cpu":
        return R.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     cap=cap, scale=scale)
    o = torch.empty_like(q)
    dev, tc = _check_attention("flash_attention", (q,), (k, v), (o,))
    B, Sq, H, D = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    cost = REC.attention_cost(B, Sq, Skv, H, Kv, D, q.element_size())
    if o.numel() and dev.type == "meta":
        REC.record("flash_attention", *cost)
    elif o.numel():
        sc = float(scale) if scale is not None else D ** -0.5
        lib = build.library("flash_attention")
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
        rest = (int(causal), int(window or 0), cap, sc, build.stream(dev))
        if tc:
            err = lib.flash_attention_tc(*ptrs, B, Sq, Skv, H, Kv, D, *rest)
        else:
            err = lib.flash_attention(*ptrs, B, Sq, Skv, H, Kv, D,
                                      build.DTYPE_CODES[q.dtype], *rest)
        build.check(err, "flash_attention")
        LAUNCHES["flash_attention"] += 1
        LAUNCHES["flash_attention_tc"] += int(tc)
        REC.record("flash_attention", *cost)
    return o
