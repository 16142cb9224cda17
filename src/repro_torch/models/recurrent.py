"""The recurrent mixers, mirroring :mod:`repro.models.recurrent`: the
RG-LRU of RecurrentGemma and the mLSTM / sLSTM of xLSTM, each with its
sequence path (training and the serving prefill) and its one-token
decode step against a carried state.

The JAX package runs the RG-LRU's linear recurrence h_t = a_t*h_{t-1} +
b_t with ``jax.lax.associative_scan`` (log depth, TPU-friendly) and lets
``jax.grad`` differentiate it.  The port's path is kernel K6 instead
(:func:`repro_torch.kernels.ops.rg_lru_scan`): one sequential pass per
channel forward, and the same kernel in reverse mode as the backward, so
the server's first-order step does not fall back to a per-step loop.
On the CPU the scan is its plain sequential version; the sequential and
associative orders round differently, within f32 ulps.

The LSTM cells are plain torch, as the reference computes them outside
any Pallas kernel (``jax.lax.scan``): a Python loop over the tokens, or
for the mLSTM with ``cfg.mlstm_chunk > 0`` over chunks of that many
tokens (the chunkwise-parallel form, which keeps one matrix state per
chunk for the backward instead of one per token).

Under a mesh (``rules`` with a "model" axis: the datacenter step, and
serving, whose states hold what the rank's block reads) each block runs
on the rank's slabs of its leaves, which the reference's logical axes
place:

* the RG-LRU on the rank's ``W / n`` "lru" channels: ``in_x`` /
  ``in_gate`` column slabs, the conv's channel slab, ``w_r`` / ``w_i``
  row slabs whose partial products each rank reads only in its own
  columns (:func:`repro_torch.distributed.tensor_parallel.
  reduce_scatter`), their replicated biases read in part, K6 on the
  ``(B, S, W / n)`` slab, ``out`` a row slab; its state ``h`` and conv
  tail on the same channels;
* the mLSTM on the rank's heads: ``up``'s column slab gathered whole
  (it does not line up with the cell input / output gate halves), the
  conv on the rank's channels and gathered, ``wq`` / ``wk`` / ``wv``
  column slabs on "heads", the replicated ``w_if`` and norm scale read at
  the rank's heads, ``down`` a row slab; where the "heads" slab cuts
  below a head, q / k / v are gathered and every rank runs every head;
  its state: the cell's ``(C, n, m)`` of those heads and the conv tail of
  the rank's channels;
* the sLSTM whole on every rank (the reference keeps its ``h``
  replicated): the ``wx`` and ``r`` column slabs gathered once a call;
  its state whole.

Every rank reads a replicated input or a gathered tensor only in its own
part, so a replicated leaf read in part enters through ``copy_to`` (its
gradient summed over "model") and a gather's backward is a
reduce-scatter (``gather_from(partial=True)``); the sLSTM's gathered
gates feed a replicated cell instead, so its gathers are plain.  Where
the model axis does not divide a block's widths the rules leave its
leaves whole and it runs as on one device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as TP
from repro_torch.kernels import ops as O
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

_LRU_C = 8.0


def init_rg_lru(gen, cfg: ModelConfig):
    d, dt = cfg.d_model, cfg.torch_param_dtype()
    w = cfg.lru_width or d
    return {
        "in_x": L.init_dense(gen, d, w, dt, axes=("d_model", "lru")),
        "in_gate": L.init_dense(gen, d, w, dt, axes=("d_model", "lru")),
        "conv": L.init_conv1d(gen, w, dt, cfg.conv_width),
        "w_i": L.init_dense(gen, w, w, dt, bias=True, axes=("lru", None)),
        "w_r": L.init_dense(gen, w, w, dt, bias=True, axes=("lru", None)),
        "lam": L.init_param(gen, (w,), dt, "lru_lambda", axes=("lru",)),
        "out": L.init_dense(gen, w, d, dt, axes=("lru", "d_model")),
    }


def _store(state, new, live=None):
    """Write the tensors ``new`` into ``state``'s in place, cast to their
    dtypes; rows (the leading axis) where ``live`` is False keep theirs."""
    for dst, src in zip(state, new):
        src = src.to(dst.dtype)
        if live is not None:
            m = live.reshape((-1,) + (1,) * (src.dim() - 1))
            src = torch.where(m, src, dst)
        dst.copy_(src)


def _conv_tail(xb, cw: int):
    """The last ``cw-1`` rows of the zero-padded input: a conv state."""
    return F.pad(xb, (0, 0, cw - 1, 0))[:, xb.shape[1]:]


def _rg_lru_gate(p, xc, mesh, c0: int):
    """sigmoid of ``xc @ W + b`` in f32 for ``w_r`` / ``w_i`` (``p``) on
    the ``xc.shape[-1]`` channels from ``c0``: under a live axis W is a
    row slab whose partial products are summed and cut to those columns
    (``reduce_scatter``) and the replicated bias is read there."""
    part = L.dense({k: t for k, t in p.items() if k != "b"}, xc,
                   torch.float32)
    b = TP.copy_to(p["b"], mesh)[c0:c0 + xc.shape[-1]]
    return torch.sigmoid(TP.reduce_scatter(part, mesh)
                         + b.to(torch.float32))


def _rg_lru_coeffs(params, xc, mesh=None, c0: int = 0):
    """xc: (B, S, W) conved input (the channels from ``c0``) -> (a, b) of
    the linear recurrence, f32."""
    r = _rg_lru_gate(params["w_r"], xc, mesh, c0)
    i = _rg_lru_gate(params["w_i"], xc, mesh, c0)
    log_a = -_LRU_C * F.softplus(params["lam"].to(torch.float32)) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) input normalization (Griffin eq. 4)
    gate = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = gate * (i * xc.to(torch.float32))
    return a, b


def rg_lru_block(params, x, cfg: ModelConfig, state=None,
                 decode: bool = False, live=None, rules=None):
    """(B, S, d_model) -> ``(out, state)``: input and gate
    projections, the causal conv, the gated recurrence, the output
    projection.  ``state = {"h": (B, W), "conv": (B, cw-1, W)}``.

    The sequence path scans with K6 on the card; given a fresh ``state``
    (a block prefill) it writes the state it ends in there: ``h`` in the
    compute dtype, ``conv`` the last ``cw-1`` rows of the zero-padded
    input.  ``decode`` takes one token against ``state``: ``h = a*h + b``
    in f32, no scan.  Both write ``state``'s tensors in place and return
    it (None without a state); decode writes only the rows where ``live``
    is set (all rows when it is None).

    ``rules`` with a model axis dividing W: both paths on this rank's
    "lru" channels ``[c0, c0 + W / n)`` (``x`` enters the
    column-parallel ``in_x`` / ``in_gate`` through one ``copy_to``, K6
    scans the ``(B, S, W / n)`` slab, the decode step's ``w_r`` / ``w_i``
    row slabs are reduce-scattered to those channels, ``out`` is a row
    slab), the state those channels' (:func:`init_rg_lru_state` with the
    same rules)."""
    w = cfg.lru_width or cfg.d_model
    tp = L.DenseTP.of(rules, (cfg.d_model, w), ("d_model", "lru"))
    tp_out = L.DenseTP.of(rules, (w, cfg.d_model), ("lru", "d_model"))
    mesh, c0 = (None, 0) if tp is None else (tp.mesh, tp.col0)
    cdt = cfg.torch_compute_dtype()
    x = TP.copy_to(x, mesh)
    xb = L.dense(params["in_x"], x, cdt, tp=tp)
    gateb = L.dense(params["in_gate"], x, cdt, tp=tp)
    if decode:
        xc, conv = L.causal_conv1d(params["conv"], xb, state["conv"])
        a, b = _rg_lru_coeffs(params, xc, mesh, c0)
        h = a[:, 0] * state["h"].to(torch.float32) + b[:, 0]
        _store((state["h"], state["conv"]), (h, conv), live)
        y = h[:, None, :]
    else:
        xc = L.causal_conv1d(params["conv"], xb)
        a, b = _rg_lru_coeffs(params, xc, mesh, c0)
        y = O.rg_lru_scan(a, b)
        if state is not None:
            # a block prefill into a fresh state
            _store((state["h"], state["conv"]),
                   (y[:, -1], _conv_tail(xb, cfg.conv_width)))
    y = y.to(cdt) * F.gelu(gateb, approximate="tanh")
    return L.dense(params["out"], y, cdt, tp=tp_out), state


def init_rg_lru_state(cfg: ModelConfig, batch: int, device="cpu",
                      rules=None):
    """Zeroed ``h`` and conv tail; under ``rules`` on this rank's "lru"
    channels (all of them where the model axis does not divide W)."""
    w = cfg.lru_width or cfg.d_model
    tp = L.DenseTP.of(rules, (cfg.d_model, w), ("d_model", "lru"))
    if tp is not None:
        w //= tp.mesh.shape["model"]
    cdt = cfg.torch_compute_dtype()
    return {"h": torch.zeros((batch, w), dtype=cdt, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=cdt,
                                device=device)}


# ===========================================================================
# mLSTM block (xLSTM): matrix memory, exponential gating
# ===========================================================================

def init_mlstm(gen, cfg: ModelConfig):
    d, H, dt = cfg.d_model, cfg.n_heads, cfg.torch_param_dtype()
    return {
        "up": L.init_dense(gen, d, 2 * d, dt, axes=("d_model", "d_ff")),
        "conv": L.init_conv1d(gen, d, dt, cfg.conv_width),
        "wq": L.init_dense(gen, d, d, dt, axes=("d_model", "heads")),
        "wk": L.init_dense(gen, d, d, dt, axes=("d_model", "heads")),
        "wv": L.init_dense(gen, d, d, dt, axes=("d_model", "heads")),
        "w_if": L.init_dense(gen, d, 2 * H, dt, bias=True,
                             axes=("d_model", None)),
        "gn": init_groupnorm(gen, d, dt),
        "down": L.init_dense(gen, d, d, dt, axes=("d_ff", "d_model")),
    }


def init_groupnorm(gen, dim: int, dtype):
    return {"scale": L.init_param(gen, (dim,), dtype, "ones",
                                  axes=("d_model",))}


def groupnorm_heads(params, x, eps: float = 1e-6):
    """Per-head RMS normalization of (B, S, H, dh), flattened to (B, S,
    d), in f32."""
    B, S, H, dh = x.shape
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return y.reshape(B, S, H * dh) * params["scale"].to(torch.float32)


def _mlstm_state0(B, H, dh, device):
    return (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=device),
            torch.zeros((B, H, dh), dtype=torch.float32, device=device),
            torch.full((B, H), float("-inf"), dtype=torch.float32,
                       device=device))


def _mlstm_cell_scan(q, k, v, i_pre, f_pre, state=None):
    """q, k, v: (B, S, H, dh); i_pre, f_pre: (B, S, H) pre-activation
    gates.  Stabilized exponential gating (xLSTM eq. 19-26), one token a
    step.  Returns h (B, S, H, dh) f32 and the final state (C, n, m)."""
    B, S, H, dh = q.shape
    C, n, m = _mlstm_state0(B, H, dh, q.device) if state is None else state
    f32 = torch.float32
    q, k, v, ig = (t.to(f32) for t in (q, k, v, i_pre))
    log_f = F.logsigmoid(f_pre.to(f32))
    hs = []
    for t in range(S):
        qt, kt, vt, it, lf = q[:, t], k[:, t], v[:, t], ig[:, t], log_f[:, t]
        m_new = torch.maximum(lf + m, it)
        i_act = torch.exp(it - m_new)
        f_act = torch.exp(lf + m - m_new)
        C = f_act[..., None, None] * C + i_act[..., None, None] * (
            vt[..., :, None] * kt[..., None, :])          # (B, H, dv, dk)
        n = f_act[..., None] * n + i_act[..., None] * kt
        num = (C @ qt[..., None])[..., 0]
        den = torch.abs(torch.sum(n * qt, dim=-1))
        den = torch.maximum(den, torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1), (C, n, m)


def _mlstm_cell_chunked(q, k, v, i_pre, f_pre, state=None, chunk: int = 64):
    """The chunkwise-parallel mLSTM: the same function as
    :func:`_mlstm_cell_scan` (the reference's exact reformulation), the
    matrix state read and written once a chunk, with an O(L^2)
    attention-like term inside each chunk of L tokens.  A sequence that
    is not a multiple of the chunk is padded with state-identity steps
    (input gate -> 0, forget gate -> 1).

    The intra-chunk weights exp(a_s - M_t) are masked to s <= t before
    the exp (the reference masks after it): the same values, and no
    inf * 0 in the backward where a_s - M_t overflows for s > t."""
    B, S, H, dh = q.shape
    Lc = min(chunk, S)
    if S % Lc != 0:
        pad = Lc - S % Lc

        def zpad(x, val=0.0):
            return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad), value=val)

        h, st = _mlstm_cell_chunked(zpad(q), zpad(k), zpad(v),
                                    zpad(i_pre, -1e9), zpad(f_pre, 1e9),
                                    state, chunk)
        return h[:, :S], st
    n_chunks = S // Lc
    C, n, m_prev = (_mlstm_state0(B, H, dh, q.device) if state is None
                    else state)
    f32 = torch.float32

    def to_chunks(x):           # (B, S, H, ...) -> (n, B, H, L, ...)
        x = x.movedim(2, 1)
        x = x.reshape(x.shape[:2] + (n_chunks, Lc) + x.shape[3:])
        return x.movedim(2, 0)

    qc, kc, vc, lic = (to_chunks(t.to(f32)) for t in (q, k, v, i_pre))
    lfc = to_chunks(F.logsigmoid(f_pre.to(f32)))
    causal = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                   device=q.device))
    hs = []
    for c in range(n_chunks):
        qb, kb, vb, li, lf = qc[c], kc[c], vc[c], lic[c], lfc[c]
        b = torch.cumsum(lf, dim=-1)                      # (B, H, L)
        a = li - b
        Mt = torch.maximum(m_prev[..., None], torch.cummax(a, dim=-1).values)
        inter = torch.exp(m_prev[..., None] - Mt)
        # intra-chunk weights w[t, s] = exp(a_s - M_t), s <= t
        w = torch.exp(torch.where(causal, a[..., None, :] - Mt[..., :, None],
                                  float("-inf")))
        scores = torch.einsum("bhld,bhsd->bhls", qb, kb) * w
        num = (inter[..., None] * torch.einsum("bhld,bhvd->bhlv", qb, C)
               + torch.einsum("bhls,bhsv->bhlv", scores, vb))
        den = (inter * torch.einsum("bhld,bhd->bhl", qb, n)
               + torch.sum(scores, dim=-1))
        guard = torch.exp(-(b + Mt))
        hs.append(num / torch.maximum(torch.abs(den), guard)[..., None])
        # the carry at the chunk's end (t = L)
        M_L = Mt[..., -1]
        gain = torch.exp(a - M_L[..., None])              # (B, H, L)
        decay = torch.exp(m_prev - M_L)
        C = (decay[..., None, None] * C
             + torch.einsum("bhs,bhsv,bhsd->bhvd", gain, vb, kb))
        n = decay[..., None] * n + torch.einsum("bhs,bhsd->bhd", gain, kb)
        m_prev = b[..., -1] + M_L
    h = torch.stack(hs, dim=0).movedim(0, 2).reshape(B, H, S, dh)
    return h.movedim(1, 2), (C, n, m_prev)


def mlstm_block(params, x, cfg: ModelConfig, state=None,
                decode: bool = False, live=None, rules=None):
    """(B, S, d_model) -> ``(out, state)``: the up projection into the
    cell input and the output gate, the causal conv, the q / k / v and
    gate projections, the cell, the per-head norm and the down
    projection.  ``state = {"cell": (C, n, m), "conv": (B, cw-1, d)}``;
    the sequence path starts from it (a block prefill into a fresh state)
    and both paths write the state they end in there, in place, decode
    only the rows where ``live`` is set (all rows when it is None).

    ``rules`` with a model axis of n dividing d: the sequence path on
    this rank's channels ``[c0, c0 + d / n)`` and its heads where they
    are whole.  ``up``'s column slab (of the ``xm | z`` halves together)
    is gathered whole; the conv runs on the rank's channels of ``xm`` and
    is gathered for the column-parallel ``wq`` / ``wk``; ``wv`` reads the
    whole ``xm``.  The replicated ``w_if`` and norm scale enter through
    ``copy_to`` and are read at the rank's heads.  Where the slab cuts
    below a head q / k / v are gathered and every head runs on every
    rank; either way ``down``'s row slab reads the rank's channels of the
    gated output.  Every gathered tensor is read in part, so the gathers
    are ``partial``.  The state there is the cell's of the heads the rank
    runs and the conv tail of its channels (:func:`init_mlstm_state` with
    the same rules)."""
    cdt, f32 = cfg.torch_compute_dtype(), torch.float32
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H
    tp_up, tp_q, tp_down, mesh, c0, dn = _mlstm_layout(cfg, rules)
    x = TP.copy_to(x, mesh)
    up = TP.gather_from(L.dense(params["up"], x, cdt, tp=tp_up), mesh,
                        partial=True)
    xm, z = torch.chunk(up, 2, dim=-1)
    xr = xm[..., c0:c0 + dn]            # the rank's conv channels
    if decode:
        xc, conv = L.causal_conv1d(params["conv"], xr, state["conv"])
    else:
        xc = L.causal_conv1d(params["conv"], xr)
        conv = _conv_tail(xr, cfg.conv_width)
    xc = TP.gather_from(F.silu(xc), mesh, partial=True)
    q = L.dense(params["wq"], xc, cdt, tp=tp_q)
    k = L.dense(params["wk"], xc, cdt, tp=tp_q) * (dh ** -0.5)
    v = L.dense(params["wv"], xm, cdt, tp=tp_q)
    w_if = {n: TP.copy_to(t, mesh) for n, t in params["w_if"].items()}
    i_pre, f_pre = torch.chunk(L.dense(w_if, xc, f32), 2, dim=-1)
    scale = TP.copy_to(params["gn"]["scale"], mesh)
    local = dn % dh == 0        # the rank's whole heads [h0, h0 + hn)
    if local:
        h0, hn = c0 // dh, dn // dh
        i_pre, f_pre = i_pre[..., h0:h0 + hn], f_pre[..., h0:h0 + hn]
        scale, z = scale[c0:c0 + dn], z[..., c0:c0 + dn]
    else:
        q, k, v = (TP.gather_from(t, mesh, partial=True) for t in (q, k, v))
        hn = H
    q, k, v = (t.reshape(B, S, hn, dh) for t in (q, k, v))
    cell0 = None if state is None else state["cell"]
    if cfg.mlstm_chunk > 0 and not decode and S > 1:
        h, cell = _mlstm_cell_chunked(q, k, v, i_pre, f_pre, cell0,
                                      cfg.mlstm_chunk)
    else:
        h, cell = _mlstm_cell_scan(q, k, v, i_pre, f_pre, cell0)
    if state is not None:
        _store(state["cell"] + (state["conv"],), cell + (conv,),
               live if decode else None)
    y = groupnorm_heads({"scale": scale}, h).to(cdt) * F.silu(z)
    if not local:
        y = y[..., c0:c0 + dn]
    return L.dense(params["down"], y, cdt, tp=tp_down), state


def _mlstm_layout(cfg: ModelConfig, rules):
    """``(tp_up, tp_q, tp_down, mesh, c0, dn)``: the mLSTM's dense
    layouts under ``rules`` and the rank's channels ``[c0, c0 + dn)``
    (all ``d`` without a live model axis)."""
    d = cfg.d_model
    tp_up = L.DenseTP.of(rules, (d, 2 * d), ("d_model", "d_ff"))
    tp_q = L.DenseTP.of(rules, (d, d), ("d_model", "heads"))
    tp_down = L.DenseTP.of(rules, (d, d), ("d_ff", "d_model"))
    mesh = None if tp_up is None else tp_up.mesh
    if mesh is None:
        return tp_up, tp_q, tp_down, None, 0, d
    if tp_q is None or tp_down is None:
        raise NotImplementedError(f"mLSTM: a model axis of "
                                  f"{mesh.shape['model']} divides 2 "
                                  f"d_model but not d_model {d}")
    return (tp_up, tp_q, tp_down, mesh, tp_down.row0,
            d // mesh.shape["model"])


def init_mlstm_state(cfg: ModelConfig, batch: int, device="cpu",
                     rules=None):
    """Zeroed cell ``(C, n, m)`` and conv tail; under ``rules`` the cell
    of the heads the rank's block runs (its own where its channels hold
    whole heads, else all) and the tail of its channels."""
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    dn = _mlstm_layout(cfg, rules)[5]
    return {"cell": _mlstm_state0(batch, dn // dh if dn % dh == 0 else H,
                                  dh, device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, dn),
                                dtype=cfg.torch_compute_dtype(),
                                device=device)}


# ===========================================================================
# sLSTM block (xLSTM): scalar memory with recurrent gate connections
# ===========================================================================

def init_slstm(gen, cfg: ModelConfig):
    d, dt = cfg.d_model, cfg.torch_param_dtype()
    return {
        "wx": L.init_dense(gen, d, 4 * d, dt, bias=True,
                           axes=("d_model", "d_ff")),
        "r": L.init_param(gen, (d, 4 * d), dt, "normal", 0.02,
                          axes=("d_model", "d_ff")),
        "gn": init_groupnorm(gen, d, dt),
        "out": L.init_dense(gen, d, d, dt, axes=("d_model", "d_model")),
    }


def _slstm_state0(B, d, device):
    z = lambda: torch.zeros((B, d), dtype=torch.float32,  # noqa: E731
                            device=device)
    return (z(), torch.ones((B, d), dtype=torch.float32, device=device),
            z(), z())


def _slstm_cell_scan(gx, r_w, state=None):
    """gx: (B, S, 4d) input contributions to the (z, i, f, o) gates;
    ``r_w`` (d, 4d) the recurrent connections, cast to f32 once (the
    reference casts it every token: the same values).  Returns h (B, S,
    d) f32 and the final state (c, n, h, m)."""
    B, S, d4 = gx.shape
    c, n, h, m = (_slstm_state0(B, d4 // 4, gx.device) if state is None
                  else state)
    r = r_w.to(torch.float32)
    gx = gx.to(torch.float32)
    hs = []
    for t in range(S):
        g = gx[:, t] + h @ r
        z_pre, i_pre, f_pre, o_pre = torch.chunk(g, 4, dim=-1)
        z = torch.tanh(z_pre)
        o = torch.sigmoid(o_pre)
        log_f = F.logsigmoid(f_pre)
        m_new = torch.maximum(log_f + m, i_pre)
        i_act = torch.exp(i_pre - m_new)
        f_act = torch.exp(log_f + m - m_new)
        c = f_act * c + i_act * z
        n = f_act * n + i_act
        h = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, h, m)


def slstm_block(params, x, cfg: ModelConfig, state=None,
                decode: bool = False, live=None, rules=None):
    """(B, S, d_model) -> ``(out, state)``; ``state = {"cell": (c, n, h,
    m)}``, each (B, d) f32, read and written as :func:`mlstm_block`
    does.  ``rules`` with a model axis dividing 4d: ``wx`` and ``r`` are
    column slabs of the four gates, whose cell needs every gate of a
    channel and the whole ``h`` each token; so ``x @ wx`` (``x`` through
    ``copy_to``) and ``r`` are gathered once a call and the cell runs
    whole on every rank (plain gathers: it is replicated), and so does
    its state."""
    cdt = cfg.torch_compute_dtype()
    B, S, d = x.shape
    r = params["r"]
    tp = L.DenseTP.of(rules, (d, 4 * d), ("d_model", "d_ff"))
    if tp is not None:
        x = TP.copy_to(x, tp.mesh)
        r = TP.gather_from(r, tp.mesh)
    gx = L.dense(params["wx"], x, torch.float32)
    if tp is not None:
        gx = TP.gather_from(gx, tp.mesh)
    h, cell = _slstm_cell_scan(gx, r,
                               None if state is None else state["cell"])
    if state is not None:
        _store(state["cell"], cell, live if decode else None)
    h = groupnorm_heads(params["gn"], h.reshape(
        B, S, cfg.n_heads, d // cfg.n_heads)).to(cdt)
    return L.dense(params["out"], h, cdt), state


def init_slstm_state(cfg: ModelConfig, batch: int, device="cpu",
                     rules=None):
    """Zeroed ``(c, n, h, m)``, whole on every rank under ``rules``."""
    return {"cell": _slstm_state0(batch, cfg.d_model, device)}
