"""The RG-LRU mixer of RecurrentGemma, mirroring the RG-LRU half of
:mod:`repro.models.recurrent`: the sequence path (training and the
serving prefill) and the one-token decode step against a carried state.

The JAX package runs the linear recurrence h_t = a_t*h_{t-1} + b_t with
``jax.lax.associative_scan`` (log depth, TPU-friendly) and lets
``jax.grad`` differentiate it.  The port's path is kernel K6 instead
(:func:`repro_torch.kernels.ops.rg_lru_scan`): one sequential pass per
channel forward, and the same kernel in reverse mode as the backward, so
the server's first-order step does not fall back to a per-step loop.
On the CPU the scan is its plain sequential version; the sequential and
associative orders round differently, within f32 ulps.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as O
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

_LRU_C = 8.0


def init_rg_lru(gen, cfg: ModelConfig):
    d, dt = cfg.d_model, cfg.torch_param_dtype()
    w = cfg.lru_width or d
    return {
        "in_x": L.init_dense(gen, d, w, dt),
        "in_gate": L.init_dense(gen, d, w, dt),
        "conv": L.init_conv1d(gen, w, dt, cfg.conv_width),
        "w_i": L.init_dense(gen, w, w, dt, bias=True),
        "w_r": L.init_dense(gen, w, w, dt, bias=True),
        "lam": L.init_param(gen, (w,), dt, "lru_lambda"),
        "out": L.init_dense(gen, w, d, dt),
    }


def _rg_lru_coeffs(params, xc):
    """xc: (B, S, W) conved input -> (a, b) of the linear recurrence, f32."""
    r = torch.sigmoid(L.dense(params["w_r"], xc, torch.float32))
    i = torch.sigmoid(L.dense(params["w_i"], xc, torch.float32))
    log_a = -_LRU_C * F.softplus(params["lam"].to(torch.float32)) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) input normalization (Griffin eq. 4)
    gate = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = gate * (i * xc.to(torch.float32))
    return a, b


def rg_lru_block(params, x, cfg: ModelConfig, state=None,
                 decode: bool = False, live=None):
    """(B, S, d_model) -> ``(out, state)``: input and gate
    projections, the causal conv, the gated recurrence, the output
    projection.  ``state = {"h": (B, W), "conv": (B, cw-1, W)}``.

    The sequence path scans with K6 on the card; given a fresh ``state``
    (a block prefill) it writes the state it ends in there: ``h`` in the
    compute dtype, ``conv`` the last ``cw-1`` rows of the zero-padded
    input.  ``decode`` takes one token against ``state``: ``h = a*h + b``
    in f32, no scan.  Both write ``state``'s tensors in place and return
    it (None without a state); decode writes only the rows where ``live``
    is set (all rows when it is None)."""
    cdt = cfg.torch_compute_dtype()
    xb = L.dense(params["in_x"], x, cdt)
    gateb = L.dense(params["in_gate"], x, cdt)
    if decode:
        xc, conv = L.causal_conv1d(params["conv"], xb, state["conv"])
        a, b = _rg_lru_coeffs(params, xc)
        h = a[:, 0] * state["h"].to(torch.float32) + b[:, 0]
        for name, new in (("h", h), ("conv", conv)):
            new = new.to(state[name].dtype)
            if live is not None:
                m = live.reshape((-1,) + (1,) * (new.dim() - 1))
                new = torch.where(m, new, state[name])
            state[name].copy_(new)
        y = h[:, None, :]
    else:
        xc = L.causal_conv1d(params["conv"], xb)
        a, b = _rg_lru_coeffs(params, xc)
        y = O.rg_lru_scan(a, b)
        if state is not None:
            # a block prefill into a fresh state
            cw = cfg.conv_width
            state["h"].copy_(y[:, -1])
            state["conv"].copy_(F.pad(xb, (0, 0, cw - 1, 0))[:,
                                                            xb.shape[1]:])
    y = y.to(cdt) * F.gelu(gateb, approximate="tanh")
    return L.dense(params["out"], y, cdt), state


def init_rg_lru_state(cfg: ModelConfig, batch: int, device="cpu"):
    w = cfg.lru_width or cfg.d_model
    cdt = cfg.torch_compute_dtype()
    return {"h": torch.zeros((batch, w), dtype=cdt, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=cdt,
                                device=device)}
