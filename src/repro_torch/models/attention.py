"""GQA attention of the dense family, mirroring :mod:`repro.models.
attention`: the training paths, the serving prefill into a KV cache and
the one-token decode against it.

The server's first-order step differentiates plain PyTorch attention
(:func:`naive_attention` / :func:`blocked_attention`, einsum, softmax,
einsum), as the JAX package differentiates XLA code.  The client's dual
probe runs both estimator streams through ONE fused pass,
:func:`repro_torch.kernels.ops.zo_dual_flash_attention` (kernel K3 on the
card); the single probe runs its one stream through
:func:`repro_torch.kernels.ops.flash_attention` (kernel K5).

Positions rotate q and k by RoPE, or by qwen2-vl's M-RoPE on (3, B, S)
temporal / height / width ids (2-D ids broadcast to all three).  The
enc-dec decoder's cross-attention (``kv_x``, the encoder output) attends
k / v projected from it without RoPE or a causal mask, in plain PyTorch,
as the JAX package keeps it outside any kernel; under a model axis it
attends the rank's heads as self-attention does.

Serving takes no gradient, so a block prefill into a cache runs K5 on the
card too (the JAX package keeps it on ``blocked_attention`` only because
Pallas calls have no JVP rule); on the CPU it takes the config's plain
attention.  The decode step attends one query per slot over the whole
cache in plain PyTorch, as the JAX package does outside any kernel.
KV caches are ``{"k", "v": (B, size, Kv, D), "pos"}`` tensors that the
prefill and decode write in place; ``pos`` is a scalar, or a ``(B,)``
vector in the slot-paged layout where every slot decodes at its own
position.  A local layer's cache is a ring of ``min(seq, window)``
entries: absolute position ``p`` lives at slot ``p % size``.

Under a model axis (``rules``) serving runs on the rank's heads, as
training does: the prefill's K5 on its q heads and their kv heads, the
decode step on the same heads against a cache that holds only those kv
heads (:attr:`AttnTP.n_kv`), ``wo`` a row slab summed over "model".
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.kernels import ops as O
from repro_torch.kernels import ref as R
from repro_torch.kernels.ops import psub
from repro_torch.models import layers as L
from repro_torch.models.config import DTYPES, ModelConfig

NEG_INF = -2.0e38


Q_AXES, KV_AXES, O_AXES = (("d_model", "heads"), ("d_model", "kv_heads"),
                           ("heads", "d_model"))


def init_attention(gen, cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dt = cfg.torch_param_dtype()
    return {
        "wq": L.init_dense(gen, d, cfg.n_heads * hd, dt, cfg.qkv_bias,
                           axes=Q_AXES),
        "wk": L.init_dense(gen, d, cfg.n_kv_heads * hd, dt, cfg.qkv_bias,
                           axes=KV_AXES),
        "wv": L.init_dense(gen, d, cfg.n_kv_heads * hd, dt, cfg.qkv_bias,
                           axes=KV_AXES),
        "wo": L.init_dense(gen, cfg.n_heads * hd, d, dt, False, axes=O_AXES),
    }


def _split_heads(x, hd):
    """(..., n * hd) -> (..., n, hd): the heads a rank holds (all of them
    without a mesh)."""
    return x.reshape(tuple(x.shape[:-1]) + (x.shape[-1] // hd, hd))


class AttnTP:
    """The attention layer's tensor-parallel layout on this rank.  The
    projections are placed by the rules (the reference's logical axes):
    wq / wk / wv column slabs, wo a row slab, wherever the model axis
    divides their flat ``heads * head_dim`` dims.  A rank attends its own
    q heads ``[h0, h0 + n_local)`` when its wq slab holds whole heads;
    else q is gathered and every rank attends all heads (and cuts its wo
    slab's columns out of the output).  Its k / v heads are its own slab
    where that holds the kv heads of its q heads, else gathered (or, for
    a whole wk / wv, computed whole) and narrowed to its q heads' GQA
    groups: ``n_kv`` heads, what a serving cache holds on this rank."""

    def __init__(self, cfg: ModelConfig, rules):
        H, K, hd, d = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                       cfg.d_model)
        self.mesh = rules.mesh
        self.q = L.DenseTP.of(rules, (d, H * hd), Q_AXES)
        self.kv = L.DenseTP.of(rules, (d, K * hd), KV_AXES)
        self.o = L.DenseTP.of(rules, (H * hd, d), O_AXES)
        mp = self.mesh.shape.get("model", 1)
        self.q_local = self.q is not None and H % mp == 0
        self.kv_local = self.q_local and self.kv is not None and K % mp == 0
        self.h0, self.n_local = ((self.q.col0 // hd, H // mp)
                                 if self.q_local else (0, H))
        self.G = H // K
        # the narrowing of the k / v heads: None (the rank's q heads fill
        # their GQA groups in order), a slice of whole groups, or one kv
        # head per q head
        self.kv_sel, self.n_kv = None, self.n_local // self.G
        if not (self.kv_local or self.n_local == H):
            ids = (self.h0 + torch.arange(self.n_local)) // self.G
            lo, hi = int(ids[0]), int(ids[-1]) + 1
            nk = hi - lo
            if self.n_local % nk == 0 and torch.equal(
                    ids, lo + torch.arange(self.n_local)
                    // (self.n_local // nk)):
                self.kv_sel, self.n_kv = slice(lo, hi), nk
            else:
                self.kv_sel, self.n_kv = ids, self.n_local

    @classmethod
    def of(cls, cfg, rules):
        if rules is None or rules.mesh is None or \
                rules.mesh.shape.get("model", 1) == 1:
            return None
        return cls(cfg, rules)

    def kv_heads(self, t):
        """k or v (B, S, K, D) narrowed to this rank's q heads: a slice of
        whole GQA groups where the local heads fill them in order, else
        one kv head per q head."""
        if self.kv_sel is None:
            return t
        if isinstance(self.kv_sel, slice):
            return t[:, :, self.kv_sel]
        return t.index_select(2, self.kv_sel.to(t.device))


def _kv_proj(w, x, xin, cdt, hd, tp, perturb=None):
    """k or v, (B, S, heads, hd), from input ``x`` (``xin``: ``x`` through
    ``copy_to``, what a column slab of W reads): all heads without a
    mesh; under ``tp`` the rank's slab, gathered where the kv heads do
    not split by head, narrowed to the rank's q heads."""
    if tp is None:
        return _split_heads(L.dense(w, x, cdt, perturb), hd)
    if tp.kv is not None:
        t = L.dense(w, xin, cdt, perturb, tp.kv)
        if not tp.kv_local:
            t = TP.gather_from(t, tp.mesh, partial=tp.q_local)
    else:
        t = L.dense(w, x, cdt, perturb)
        if tp.q_local:      # a whole k / v read in part on each rank
            t = TP.copy_to(t, tp.mesh)
    return tp.kv_heads(_split_heads(t, hd))


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
                      scale=None, q_chunk=1024, kv_chunk=1024,
                      causal_skip=False, p_dtype=torch.float32):
    """Online-softmax attention over (q_chunk x kv_chunk) tiles in plain
    PyTorch; never materializes the whole (Sq, Skv) score matrix.

    With ``causal_skip`` each q block visits only the kv blocks that its
    causal and window masks leave open (the reference's static bounds:
    about half the products of a causal call, O(S * window) for a local
    one).  ``p`` and ``v`` enter ``p @ v`` in ``p_dtype``; the running
    max, sum and accumulator stay f32."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    cq, ck = min(q_chunk, Sq), min(kv_chunk, Skv)
    pos = torch.arange(max(Sq, Skv), device=q.device)
    neg_inf = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
    outs = []
    for q0 in range(0, Sq, cq):
        q_blk = q[:, q0:q0 + cq]
        n_q = q_blk.shape[1]
        q_blk = q_blk.reshape(B, n_q, K, G, D).to(torch.float32)
        q_pos = pos[q0:q0 + n_q]
        m = torch.full((B, K, G, n_q), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, K, G, n_q), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, n_q, K, G, D), dtype=torch.float32,
                          device=q.device)
        lo, hi = 0, Skv
        if causal_skip:
            hi = min(Skv, q0 + n_q) if causal else Skv
            lo = max(0, q0 - window + 1) if window > 0 else 0
        for k0 in range(0, Skv, ck):
            if k0 >= hi or k0 + ck <= lo:
                continue            # every (q, kv) pair of the tile masked
            k_blk = k[:, k0:k0 + ck].to(torch.float32)
            v_blk = v[:, k0:k0 + ck].to(p_dtype)
            n_k = k_blk.shape[1]
            s = torch.einsum("bqkgd,bskd->bkgqs", q_blk, k_blk) * scale
            s = L.softcap(s, cap)
            if (causal and k0 + n_k - 1 > q0) or (
                    window > 0 and q0 + n_q - 1 - k0 >= window):
                # some (q, kv) pair of the tile is masked
                msk = _mask(q_pos, pos[k0:k0 + n_k], causal, window)
                s = torch.where(msk[None, None, None], s, neg_inf)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + torch.sum(p, dim=-1)
            pv = torch.einsum("bkgqs,bskd->bqkgd", p.to(p_dtype),
                              v_blk).to(torch.float32)
            acc = acc * torch.movedim(alpha, 3, 1)[..., None] + pv
            m = m_new
        l = torch.movedim(l, 3, 1)[..., None]
        outs.append(acc / torch.clamp(l, min=1e-30))
    out = torch.cat(outs, dim=1).reshape(B, Sq, H, D)
    return out.to(q.dtype)


def _dual_probe_attention(q, k, v, cfg: ModelConfig, *, window: int,
                          perturb, score_probe: bool, h0: int = 0):
    """Both estimator streams through ONE fused flash pass.

    ``q`` stacks [clean; perturbed] on the leading batch axis.  In
    weight-probe mode k/v are stacked the same way and each stream
    attends its own K/V.  In score-probe mode k/v carry only the clean
    half, both streams share every K/V load, and the perturbed stream
    adds ``mu * U(seed)`` to its pre-softmax scores, with the scan repeat
    index row-offsetting the canonical (reps*H*Sq, Skv) field, and ``h0``
    (a rank's first q head under a mesh) the rows of its heads.
    """
    B2 = q.shape[0] // 2
    S = q.shape[1]
    common = dict(causal=True, window=window,
                  cap=cfg.attn_softcap or 0.0, scale=cfg.attn_scale)
    if score_probe:
        sseed = O.attn_score_seed(perturb.seeds)
        off = int(perturb.rep) * (cfg.n_heads * S) + int(h0) * S
        oa, ob = O.zo_dual_flash_attention(
            q[:B2], q[B2:], k, v, seed=0 if sseed is None else sseed,
            mu_a=0.0, mu_b=perturb.mu, row_offset=off, perturb_a=False,
            perturb_b=sseed is not None, **common)
    else:
        oa, ob = O.zo_dual_flash_attention(
            q[:B2], q[B2:], k[:B2], v[:B2], kb=k[B2:], vb=v[B2:],
            perturb_a=False, perturb_b=False, **common)
    return torch.cat([oa, ob], dim=0)


def decode_attention(q, k_cache, v_cache, valid_len, *, window=0, cap=None,
                     scale=None):
    """q: (B, 1, H, D); caches: (B, S, K, D); valid_len: a scalar or (B,)
    int tensor: cache entries ``< valid_len`` (and within ``window`` of
    it) are attended, in f32."""
    B, _, H, D = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    qr = q.reshape(B, K, G, D).to(torch.float32)
    s = torch.einsum("bkgd,bskd->bkgs", qr,
                     k_cache.to(torch.float32)) * scale
    s = L.softcap(s, cap)
    pos = torch.arange(S, device=q.device)
    vl = torch.as_tensor(valid_len, device=q.device).reshape(-1, 1)
    m = pos[None] < vl                                   # (B or 1, S)
    if window > 0:
        m = m & (pos[None] >= vl - window)
    s = torch.where(m[:, None, None, :], s, _neg_inf_like(s))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    return o.reshape(B, 1, H, D).to(q.dtype)


def _decode_write(cache, k, v, window: int, live):
    """Write one token's k/v, (B, 1, K, D), at each slot's position
    (``pos % size`` on a ring), in place.  Per-slot positions past the
    capacity keep their rows (the JAX package's scatter with
    ``mode="drop"``); a scalar position past the capacity writes the
    last row, as ``dynamic_update_slice`` clamps.  Every slot's row is
    written, a finished one's too, so its attention sees the token as the
    JAX package's does; the returned ``restore()`` puts back the rows of
    the slots whose ``live`` is False (the reference's frozen finished
    slots) once the attention has read them."""
    pos = cache["pos"]
    size = cache["k"].shape[1]
    B = k.shape[0]
    slot = (pos % size if window > 0 else pos).expand(B)
    drop = slot >= size if pos.dim() == 1 else None
    slot = slot.clamp(max=size - 1).long()
    b_ix = torch.arange(B, device=k.device)
    old = {name: cache[name][b_ix, slot].clone() for name in ("k", "v")}
    for name, new in (("k", k), ("v", v)):
        new = new[:, 0].to(cache[name].dtype)
        if drop is not None:
            new = torch.where(drop[:, None, None], old[name], new)
        cache[name][b_ix, slot] = new
    pos.add_(1 if live is None else live.to(pos.dtype))

    def restore():
        if live is None:
            return
        for name in ("k", "v"):
            c = cache[name]
            c[b_ix, slot] = torch.where(live[:, None, None], c[b_ix, slot],
                                        old[name])
    return restore


def _rope(cfg: ModelConfig, q, k, positions, kv_positions):
    """RoPE, or M-RoPE on (3, B, S) t / h / w ids (2-D ids broadcast to
    all three, which is RoPE), on q and k."""
    if cfg.rope_kind == "rope":
        return (L.apply_rope(q, positions, cfg.rope_theta),
                L.apply_rope(k, kv_positions, cfg.rope_theta))
    if cfg.rope_kind == "mrope":
        def three(p):
            return p if p.dim() == 3 else p.expand((3,) + tuple(p.shape))
        return (L.apply_mrope(q, three(positions), cfg.mrope_sections,
                              cfg.rope_theta),
                L.apply_mrope(k, three(kv_positions), cfg.mrope_sections,
                              cfg.rope_theta))
    if cfg.rope_kind != "none":
        raise ValueError(f"rope_kind={cfg.rope_kind!r}")
    return q, k


def attention_layer(params, x, cfg: ModelConfig, *, positions=None,
                    local: bool = False, cache=None, decode: bool = False,
                    live=None, kv_x=None, perturb=None, rules=None):
    """Self-attention: q/k/v projections, RoPE (or M-RoPE), attention,
    output projection.  Returns ``(out, cache)``.

    ``perturb`` (the training-time ZO probe) fuses weight noise into the
    projections; the dual probe runs the fused dual attention and the
    single probe the single-stream flash kernel.  ``cache`` without
    ``decode`` is a block prefill of a fresh cache (pos 0): the prompt's
    k/v are written so decode continues at ``pos = S``.  ``decode``
    takes one token per slot at the cache's positions, writes its k/v
    (kept only for ``live`` slots, when given) and attends the cache.
    ``kv_x``, the encoder output (B, S_enc, d_model) whole on every
    rank, makes it the enc-dec decoder's cross-attention: k / v projected
    from ``kv_x`` (under a model axis through ``copy_to`` into the wk /
    wv column slabs, so its gradient, a partial sum on each rank, is
    all-reduced over "model"), no RoPE, every query over every encoder
    position, in plain PyTorch (no kernel, as in the reference).
    ``rules`` with a model axis make it tensor-parallel
    (:class:`AttnTP`): training, and serving against a cache of the
    rank's kv heads (:func:`init_kv_cache` with the same rules)."""
    if perturb is not None and (cache is not None or decode
                                or kv_x is not None):
        raise ValueError("the ZO perturbed forward is a training-time path")
    tp = AttnTP.of(cfg, rules)
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    cdt = cfg.torch_compute_dtype()
    window = cfg.window if local else 0
    xin = x
    if tp is not None and (tp.q is not None or tp.kv is not None):
        xin = TP.copy_to(x, tp.mesh)
    if tp is None:
        q = L.dense(params["wq"], x, cdt, psub(perturb, "wq"))
    else:
        q = L.dense(params["wq"], xin if tp.q else x, cdt,
                    psub(perturb, "wq"), tp.q)
        if tp.q is not None and not tp.q_local:
            q = TP.gather_from(q, tp.mesh)
    q = _split_heads(q, hd)
    if rules is not None:
        q = SH.constrain(q, rules, ("batch", None, "heads", None),
                         (None, S, cfg.n_heads, hd))
    if kv_x is not None:
        kv_in = kv_x
        if tp is not None and tp.kv is not None:
            kv_in = TP.copy_to(kv_x, tp.mesh)
        k, v = (_kv_proj(params[w], kv_x, kv_in, cdt, hd, tp)
                for w in ("wk", "wv"))
        kw = dict(causal=False, cap=cfg.attn_softcap, scale=cfg.attn_scale)
        o = (naive_attention(q, k, v, **kw) if cfg.attn_impl == "naive"
             else blocked_attention(q, k, v, q_chunk=cfg.q_chunk,
                                    kv_chunk=cfg.kv_chunk, **kw))
        return _out_proj(params, o.reshape(B, S, q.shape[2] * hd), cdt,
                         tp), None
    # score-probe mode: k/v come from the CLEAN half only and wk/wv are
    # never weight-perturbed (ops.attn_kv_seed_pred keeps the estimator
    # and replay seed streams consistent with this)
    score_probe = (perturb is not None and perturb.dual
                   and cfg.attn_probe == "scores")
    half = x.shape[0] // 2
    xkv = x[:half] if score_probe else x
    pkv = None if score_probe else perturb

    xkv_in = xin[:half] if score_probe else xin
    k, v = (_kv_proj(params[w], xkv, xkv_in, cdt, hd, tp, psub(pkv, w))
            for w in ("wk", "wv"))
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        if decode:              # each slot (or the batch) at its position
            positions = cache["pos"].reshape(-1, 1) + positions
    kv_positions = positions
    if score_probe and positions.shape[-2] == B:
        # k/v carry the clean half: the batch axis of (B, S) or (3, B, S)
        kv_positions = positions.narrow(-2, 0, B // 2)
    q, k = _rope(cfg, q, k, positions, kv_positions)
    if decode:
        if S != 1:
            raise ValueError(f"decode takes one token per slot, got {S}")
        valid = cache["pos"] + 1         # a ring holds the last size
        if window > 0:
            valid = torch.clamp(valid, max=cache["k"].shape[1])
        restore = _decode_write(cache, k, v, window, live)
        o = decode_attention(q, cache["k"], cache["v"], valid,
                             cap=cfg.attn_softcap, scale=cfg.attn_scale)
        restore()
    elif perturb is not None and perturb.dual:
        o = _dual_probe_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), cfg, window=window,
                                  perturb=perturb, score_probe=score_probe,
                                  h0=0 if tp is None else tp.h0)
    elif perturb is not None or (cache is not None and x.is_cuda):
        # the single probe's one stream, and the serving prefill on the
        # card, through the flash kernel; the unperturbed forward stays on
        # the differentiable plain versions
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
                              q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                              causal_skip=cfg.causal_skip,
                              p_dtype=DTYPES[cfg.attn_p_dtype])
    if cache is not None and not decode:
        _prefill_cache(cache, k, v)
    return _out_proj(params, o.reshape(B, S, q.shape[2] * hd), cdt, tp,
                     psub(perturb, "wo")), cache


def _out_proj(params, o, cdt, tp, perturb=None):
    """wo on the attention output (B, S, heads * hd): under ``tp`` a row
    slab, fed the rank's columns of all heads' output where q was
    gathered."""
    if tp is not None and tp.o is not None and not tp.q_local:
        o = TP.split_to(o, tp.mesh)     # wo's row slab of all heads' output
    return L.dense(params["wo"], o, cdt, perturb,
                   None if tp is None else tp.o)


def _prefill_cache(cache, k, v):
    """Write a whole prompt's k/v into a fresh (possibly ring) KV cache,
    in place.  Entry at absolute position ``p`` lands at slot ``p %
    size``, the invariant the decode path's ring addressing continues
    from: for ``S >= size`` only the last ``size`` entries are kept,
    rolled by ``S % size``; for ``S < size`` it is a prefix write."""
    size = cache["k"].shape[1]
    S = k.shape[1]
    for name, new in (("k", k), ("v", v)):
        if S >= size:
            cache[name].copy_(torch.roll(new[:, -size:], S % size, dims=1))
        else:
            cache[name][:, :S] = new
    cache["pos"].add_(S)


def init_kv_cache(cfg: ModelConfig, batch: int, seq: int, *, local: bool,
                  per_slot: bool = False, device="cpu", rules=None):
    """``per_slot=True`` makes ``pos`` a (batch,) vector: the slot-paged
    layout the decode engine uses so requests of different lengths share
    one batch (see :mod:`repro_torch.core.decode`).

    ``rules`` with a model axis: the kv heads this rank's attention reads
    (:attr:`AttnTP.n_kv`): its ``n_kv_heads / n`` where the axis divides
    them and its q heads, else the heads its q heads' GQA groups narrow
    to, else all.  The reference lays the cache out as ``("batch",
    "seq_shard", "kv_heads", None)`` and keeps it whole where the model
    axis does not divide the kv heads; the port keeps only what the rank
    reads, so a decode step reads it without a gather."""
    size = min(seq, cfg.window) if local and cfg.window > 0 else seq
    hd = cfg.resolved_head_dim
    dt = cfg.torch_compute_dtype()
    tp = AttnTP.of(cfg, rules)
    shape = (batch, size, cfg.n_kv_heads if tp is None else tp.n_kv, hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.zeros((batch,) if per_slot else (),
                               dtype=torch.int32, device=device)}
