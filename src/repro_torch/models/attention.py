"""GQA attention of the dense family, mirroring :mod:`repro.models.
attention` (training paths only; decode and KV caches are not ported).

The server's first-order step differentiates plain PyTorch attention
(:func:`naive_attention` / :func:`blocked_attention`, einsum, softmax,
einsum), as the JAX package differentiates XLA code.  The client's dual
probe runs both estimator streams through ONE fused pass,
:func:`repro_torch.kernels.ops.zo_dual_flash_attention` (kernel K3 on the
card); the single probe runs its one stream through
:func:`repro_torch.kernels.ops.flash_attention` (kernel K5).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as O
from repro_torch.kernels import ref as R
from repro_torch.kernels.ops import psub
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

NEG_INF = -2.0e38


def init_attention(gen, cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dt = cfg.torch_param_dtype()
    return {
        "wq": L.init_dense(gen, d, cfg.n_heads * hd, dt, cfg.qkv_bias),
        "wk": L.init_dense(gen, d, cfg.n_kv_heads * hd, dt, cfg.qkv_bias),
        "wv": L.init_dense(gen, d, cfg.n_kv_heads * hd, dt, cfg.qkv_bias),
        "wo": L.init_dense(gen, cfg.n_heads * hd, d, dt, False),
    }


def _split_heads(x, n, hd):
    return x.reshape(tuple(x.shape[:-1]) + (n, hd))


def _mask(q_pos, kv_pos, causal: bool, window: int):
    # q_pos: (Sq,), kv_pos: (Skv,) -> bool (Sq, Skv)
    d = q_pos[:, None] - kv_pos[None, :]
    m = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        m = m & (d >= 0)
    if window > 0:
        m = m & (d < window)
    return m


def _neg_inf_like(s):
    return torch.tensor(NEG_INF, dtype=s.dtype, device=s.device)


def naive_attention(q, k, v, *, causal=True, window=0, cap=None, scale=None):
    """q: (B,Sq,H,D)  k,v: (B,Skv,K,D).  Materializes the scores; the
    same function as the kernels' plain attention."""
    return R.flash_attention_ref(q, k, v, causal=causal, window=window,
                                 cap=cap or 0.0, scale=scale)


def blocked_attention(q, k, v, *, causal=True, window=0, cap=None,
                      scale=None, q_chunk=1024, kv_chunk=1024):
    """Online-softmax attention over (q_chunk x kv_chunk) tiles in plain
    PyTorch; never materializes the whole (Sq, Skv) score matrix."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    cq, ck = min(q_chunk, Sq), min(kv_chunk, Skv)
    outs = []
    for q0 in range(0, Sq, cq):
        q_blk = q[:, q0:q0 + cq]
        n_q = q_blk.shape[1]
        q_blk = q_blk.reshape(B, n_q, K, G, D).to(torch.float32)
        q_pos = torch.arange(q0, q0 + n_q, device=q.device)
        m = torch.full((B, K, G, n_q), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, K, G, n_q), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, n_q, K, G, D), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, Skv, ck):
            k_blk = k[:, k0:k0 + ck].to(torch.float32)
            v_blk = v[:, k0:k0 + ck].to(torch.float32)
            kv_pos = torch.arange(k0, k0 + k_blk.shape[1], device=q.device)
            s = torch.einsum("bqkgd,bskd->bkgqs", q_blk, k_blk) * scale
            s = L.softcap(s, cap)
            msk = _mask(q_pos, kv_pos, causal, window)
            s = torch.where(msk[None, None, None], s, _neg_inf_like(s))
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + torch.sum(p, dim=-1)
            pv = torch.einsum("bkgqs,bskd->bqkgd", p, v_blk)
            acc = acc * torch.movedim(alpha, 3, 1)[..., None] + pv
            m = m_new
        l = torch.movedim(l, 3, 1)[..., None]
        outs.append(acc / torch.clamp(l, min=1e-30))
    out = torch.cat(outs, dim=1).reshape(B, Sq, H, D)
    return out.to(q.dtype)


def _dual_probe_attention(q, k, v, cfg: ModelConfig, *, window: int,
                          perturb, score_probe: bool):
    """Both estimator streams through ONE fused flash pass.

    ``q`` stacks [clean; perturbed] on the leading batch axis.  In
    weight-probe mode k/v are stacked the same way and each stream
    attends its own K/V.  In score-probe mode k/v carry only the clean
    half, both streams share every K/V load, and the perturbed stream
    adds ``mu * U(seed)`` to its pre-softmax scores, with the scan repeat
    index row-offsetting the canonical (reps*H*Sq, Skv) field.
    """
    B2 = q.shape[0] // 2
    S = q.shape[1]
    common = dict(causal=True, window=window,
                  cap=cfg.attn_softcap or 0.0, scale=cfg.attn_scale)
    if score_probe:
        sseed = O.attn_score_seed(perturb.seeds)
        off = int(perturb.rep) * (cfg.n_heads * S)
        oa, ob = O.zo_dual_flash_attention(
            q[:B2], q[B2:], k, v, seed=0 if sseed is None else sseed,
            mu_a=0.0, mu_b=perturb.mu, row_offset=off, perturb_a=False,
            perturb_b=sseed is not None, **common)
    else:
        oa, ob = O.zo_dual_flash_attention(
            q[:B2], q[B2:], k[:B2], v[:B2], kb=k[B2:], vb=v[B2:],
            perturb_a=False, perturb_b=False, **common)
    return torch.cat([oa, ob], dim=0)


def attention_layer(params, x, cfg: ModelConfig, *, positions=None,
                    local: bool = False, perturb=None):
    """Self-attention for training: q/k/v projections, RoPE, attention,
    output projection.  ``perturb`` (the ZO probe) fuses weight noise into
    the projections; the dual probe runs the fused dual attention and the
    single probe the single-stream flash kernel."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    cdt = cfg.torch_compute_dtype()
    window = cfg.window if local else 0
    # score-probe mode: k/v come from the CLEAN half only and wk/wv are
    # never weight-perturbed (ops.attn_kv_seed_pred keeps the estimator
    # and replay seed streams consistent with this)
    score_probe = (perturb is not None and perturb.dual
                   and cfg.attn_probe == "scores")
    q = _split_heads(L.dense(params["wq"], x, cdt, psub(perturb, "wq")),
                     cfg.n_heads, hd)
    xkv = x[: x.shape[0] // 2] if score_probe else x
    pkv = None if score_probe else perturb
    k = _split_heads(L.dense(params["wk"], xkv, cdt, psub(pkv, "wk")),
                     cfg.n_kv_heads, hd)
    v = _split_heads(L.dense(params["wv"], xkv, cdt, psub(pkv, "wv")),
                     cfg.n_kv_heads, hd)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    kv_positions = positions
    if score_probe and positions.shape[0] == B:
        kv_positions = positions[: B // 2]      # k/v carry the clean half
    if cfg.rope_kind == "rope":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, kv_positions, cfg.rope_theta)
    elif cfg.rope_kind != "none":
        raise NotImplementedError(f"rope_kind={cfg.rope_kind!r}")
    if perturb is not None and perturb.dual:
        o = _dual_probe_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), cfg, window=window,
                                  perturb=perturb, score_probe=score_probe)
    elif perturb is not None:
        # the single probe's one stream through the flash kernel; the
        # unperturbed forward stays on the differentiable plain versions
        o = O.flash_attention(q.contiguous(), k.contiguous(),
                              v.contiguous(), causal=True, window=window,
                              cap=cfg.attn_softcap or 0.0,
                              scale=cfg.attn_scale)
    elif cfg.attn_impl == "naive":
        o = naive_attention(q, k, v, causal=True, window=window,
                            cap=cfg.attn_softcap, scale=cfg.attn_scale)
    else:
        o = blocked_attention(q, k, v, causal=True, window=window,
                              cap=cfg.attn_softcap, scale=cfg.attn_scale,
                              q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    o = o.reshape(B, S, cfg.n_heads * hd)
    return L.dense(params["wo"], o, cdt, psub(perturb, "wo"))
