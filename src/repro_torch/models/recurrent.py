"""The RG-LRU mixer of RecurrentGemma, mirroring the RG-LRU half of
:mod:`repro.models.recurrent` (training path only; the decode state is
serving, which is not ported).

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


def rg_lru_block(params, x, cfg: ModelConfig):
    """(B, S, d_model) -> (B, S, d_model): input and gate projections, the
    causal conv, the gated recurrence (K6 on the card), the output
    projection."""
    cdt = cfg.torch_compute_dtype()
    xb = L.dense(params["in_x"], x, cdt)
    gateb = L.dense(params["in_gate"], x, cdt)
    xc = L.causal_conv1d(params["conv"], xb)
    a, b = _rg_lru_coeffs(params, xc)
    y = O.rg_lru_scan(a, b)
    y = y.to(cdt) * F.gelu(gateb, approximate="tanh")
    return L.dense(params["out"], y, cdt)
