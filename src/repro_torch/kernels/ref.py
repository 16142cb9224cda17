"""Plain PyTorch versions of the kernels, mirroring
:mod:`repro.kernels.ref` op for op.  They are the CPU path of every
wrapper and the reference each CUDA kernel is held to on the card."""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


def zo_matmul_ref(x, w, u, mu):
    """y = x @ (W + mu*U) with U materialized explicitly."""
    wf = w.to(torch.float32) + float(mu) * u.to(torch.float32)
    return (x.to(torch.float32) @ wf).to(x.dtype)


def matmul_ref(x, w):
    return (x.to(torch.float32) @ w.to(torch.float32)).to(x.dtype)


def split_bf16(p):
    """The two bf16 terms of an f32 tensor: ``hi = bf16(p)`` and ``lo =
    bf16(p - hi)`` (``p - hi`` is exact in f32); ``hi + lo`` is within
    2^-16 of ``p``, relative."""
    hi = p.to(torch.bfloat16)
    return hi, (p - hi.to(torch.float32)).to(torch.bfloat16)


def zo_matmul_split_ref(x, w, u, mu, *, perturb=True, out_dtype=None):
    """The arithmetic of K2 / K4's tensor-core route for bf16 operands:
    ``p = w + mu*u`` in f32 (a multiply, then an add), split into
    :func:`split_bf16`'s two terms, ``y = x@hi + x@lo`` with every product
    exact and f32 sums; ``perturb=False`` gives ``x @ w`` on W's own bf16
    values.  Only tests and ``chip_smoke.py`` use it; the output is in
    ``out_dtype`` (x's by default)."""
    xf = x.to(torch.float32)
    if perturb:
        hi, lo = split_bf16(w.to(torch.float32) + float(mu) *
                            u.to(torch.float32))
        y = xf @ hi.to(torch.float32) + xf @ lo.to(torch.float32)
    else:
        y = xf @ w.to(torch.float32)
    return y.to(out_dtype or x.dtype)


def _tf32_rna(v):
    """f32 -> tf32 (the upper 19 bits), round to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits'
    range to the magnitude, then clear them.  f32 in, f32 out."""
    b = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = (b + 0x1000) & 0xFFFFE000
    return torch.where(b >= 1 << 31, b - (1 << 32), b).to(
        torch.int32).view(torch.float32)


def split_tf32(p):
    """The two tf32 terms of an f32 tensor: ``hi = tf32_rna(p)`` and ``lo =
    tf32_rna(p - hi)`` (``p - hi`` is exact in f32), both as f32 with the
    low 13 bits zero; ``hi + lo`` is within 2^-21 of ``p``, relative."""
    p = p.to(torch.float32)
    hi = _tf32_rna(p)
    return hi, _tf32_rna(p - hi)


def zo_matmul_tf32x3_ref(x, w, u, mu, *, perturb=True):
    """The arithmetic of K2 / K4's tensor-core route for f32 operands
    (``csrc/zo_tf32_matmul.cuh``): ``p = w + mu*u`` in f32 (a multiply,
    then an add; ``perturb=False`` gives ``p = w``), x and p split by
    :func:`split_tf32`, ``y = x_hi@p_hi + x_hi@p_lo + x_lo@p_hi`` in
    three f32 matmuls (every tf32 product is exact in f32).  Only tests
    and ``chip_smoke.py`` use it; the output is f32."""
    p = w.to(torch.float32)
    if perturb:
        p = p + float(mu) * u.to(torch.float32)
    xh, xl = split_tf32(x)
    ph, pl = split_tf32(p)
    return xh @ ph + xh @ pl + xl @ ph


def tf32x3_slack(x, w, u, mu, *, perturb=True):
    """How far the tensor cores' sums may stray from
    :func:`zo_matmul_tf32x3_ref`'s, elementwise: one f32 ulp (2^-23) of
    the sum of |products| for each of the three wgmmas of every k8 step
    (the tensor cores add in another order, and the emulation's own sums
    round too)."""
    p = w.to(torch.float32)
    if perturb:
        p = p + float(mu) * u.to(torch.float32)
    xh, xl = split_tf32(x)
    ph, pl = split_tf32(p)
    mag = xh.abs() @ (ph.abs() + pl.abs()) + xl.abs() @ ph.abs()
    return 3 * -(-x.shape[1] // 8) * 2 ** -23 * mag


def zo_dual_matmul_ref(xa, xb, w, u, mu_a, mu_b, *, perturb_a=False,
                       perturb_b=True):
    """Dual probe with U materialized: one branch per (x, mu) pair."""
    ya = zo_matmul_ref(xa, w, u, mu_a) if perturb_a else matmul_ref(xa, w)
    yb = zo_matmul_ref(xb, w, u, mu_b) if perturb_b else matmul_ref(xb, w)
    return ya, yb


def _attend(q, k, v, *, u=None, mu=0.0, causal=True, window=0, cap=0.0,
            scale=None):
    """Full-score attention of one stream; ``u`` (H, Sq, Skv) is added to
    the scores after the soft-cap and before the mask."""
    B, Sq, H, D = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    sc = scale if scale is not None else D ** -0.5
    qr = q.reshape(B, Sq, Kv, G, D).to(torch.float32)
    s = torch.einsum("bqkgd,bskd->bkgqs", qr, k.to(torch.float32)) * sc
    if cap and cap > 0:
        s = cap * torch.tanh(s / cap)
    if u is not None:
        s = s + float(mu) * u.reshape(Kv, G, Sq, Skv)[None]
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    kv_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= kv_pos
    if window and window > 0:
        mask &= (q_pos - kv_pos) < window
    s = torch.where(mask[None, None, None], s,
                    torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return o.reshape(B, Sq, H, D).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal=True, window=0, cap=0.0,
                        scale=None):
    """Naive full-score attention with GQA/local/softcap semantics."""
    return _attend(q, k, v, causal=causal, window=window, cap=cap,
                   scale=scale)


def flash_attention_tc_ref(q, k, v, *, bkv, u=None, mu=0.0, causal=True,
                           window=0, cap=0.0, scale=None, split_p=True):
    """The arithmetic of one stream of K3 / K5's tensor-core route for bf16
    operands (``csrc/flash_wgmma.cuh``): an online softmax over kv tiles
    of ``bkv`` columns; ``q . k`` with every bf16 product exact and f32
    sums; scale, soft-cap, ``mu * u`` (``u`` (H, Sq, Skv), as in
    :func:`_attend`) and the finite mask on the f32 scores; ``p = exp(s -
    m)`` in f32, fed to ``p @ v`` as :func:`split_bf16`'s two terms
    (``split_p``) or rounded once to bf16; ``acc / max(l, 1e-30)``.  Only
    tests and ``chip_smoke.py`` use it; the output is in q's dtype."""
    B, Sq, H, D = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    sc = scale if scale is not None else D ** -0.5
    qf = q.reshape(B, Sq, Kv, G, D).to(torch.float32)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    if u is not None:
        u = u.reshape(Kv, G, Sq, Skv)[None]
    dev = q.device
    m = torch.full((B, Kv, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Kv, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Kv, G, Sq, D), dtype=torch.float32, device=dev)
    q_pos = torch.arange(Sq, device=dev)[:, None]
    for kv0 in range(0, Skv, bkv):
        kv1 = min(kv0 + bkv, Skv)
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf[:, kv0:kv1]) * sc
        if cap and cap > 0:
            s = cap * torch.tanh(s / cap)
        if u is not None:
            s = s + float(mu) * u[..., kv0:kv1]
        kv_pos = torch.arange(kv0, kv1, device=dev)[None, :]
        mask = torch.ones((Sq, kv1 - kv0), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos >= kv_pos
        if window and window > 0:
            mask &= (q_pos - kv_pos) < window
        s = torch.where(mask, s, torch.tensor(NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        vt = vf[:, kv0:kv1]
        if split_p:
            hi, lo = split_bf16(p)
            pv = (torch.einsum("bkgqs,bskd->bkgqd", hi.to(torch.float32), vt)
                  + torch.einsum("bkgqs,bskd->bkgqd", lo.to(torch.float32),
                                 vt))
        else:
            pv = torch.einsum("bkgqs,bskd->bkgqd",
                              p.to(torch.bfloat16).to(torch.float32), vt)
        acc = acc * alpha[..., None] + pv
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def zo_dual_flash_attention_ref(qa, qb, k, v, *, kb=None, vb=None, u=None,
                                mu_a=0.0, mu_b=0.0, perturb_a=False,
                                perturb_b=True, causal=True, window=0,
                                cap=0.0, scale=None):
    """Dual-probe attention: both streams from one definition.  ``u`` is
    the (H, Sq, Skv) score-noise field; ``kb``/``vb`` give the b-stream
    its own K/V (weight-probe mode)."""
    kw = dict(causal=causal, window=window, cap=cap, scale=scale)
    oa = _attend(qa, k, v, u=u if perturb_a else None, mu=mu_a, **kw)
    ob = _attend(qb, kb if kb is not None else k,
                 vb if vb is not None else v,
                 u=u if perturb_b else None, mu=mu_b, **kw)
    return oa, ob


def rg_lru_scan_ref(a, b):
    """Sequential plain version of h_t = a_t h_{t-1} + b_t from a zero f32
    state over (B, S, W), each step a multiply then an add.  Autograd
    differentiates it on the CPU."""
    h = torch.zeros_like(a[:, 0], dtype=torch.float32)
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(a.dtype)


def rg_lru_scan_reverse_ref(a, g, h):
    """The gradient of :func:`rg_lru_scan_ref` given ``g`` = dL/dh and the
    forward's ``h``: ``G_t = g_t + a_{t+1} G_{t+1}`` (``G_S = 0``) run
    backwards over time, then ``db = G`` and ``da_t = G_t h_{t-1}``
    (``h_{-1} = 0``).  Returns ``(da, db)``."""
    G = torch.zeros_like(g[:, 0], dtype=torch.float32)
    a_next = torch.zeros_like(G)
    gs = [None] * g.shape[1]
    for t in reversed(range(g.shape[1])):
        G = g[:, t] + a_next * G
        gs[t] = G
        a_next = a[:, t]
    db = torch.stack(gs, dim=1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return db * h_prev, db
