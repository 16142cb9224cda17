"""Mixture-of-Experts FFN, mirroring :mod:`repro.models.moe`.

Two execution paths share one routing function:

* :func:`moe_reference`: every expert on every token, combined with the
  top-k gates.  Exact (no token dropping): the tests' oracle.
* :func:`moe_xla`: the capacity dispatch on the global view, the path
  of every block here (training, the serving prefill and decode).

The reference's third path, ``moe_ep`` (``shard_map`` over a mesh with
all-to-all expert exchange), is ROADMAP queue 1 item 7.2: :func:`moe_ffn`
with a mesh raises.

Capacity semantics match GShard / Switch: per-expert capacity ``C =
ceil(T*k*cf / E)`` rounded up to a multiple of 4; an expert's tokens
past C are dropped (their residual stream passes through unchanged, plus
the shared-expert branch if any).  Which tokens an expert keeps is the
reference's: its stable sort by expert keeps the earliest flat (token,
choice) entries, and here each entry's place in its expert's queue is
counted directly, from an integer cumulative sum of the one-hot
assignments (exact, with no sort and no ``bincount``: shapes alone, so
it also runs on the ``meta`` device of the cut planner).  The combine adds each token's
contributions in ascending expert order starting from zero, the order
in which XLA:CPU applies the reference's serial scatter-add, so a bf16
combine rounds as the reference's does; it is a gather and a sum, with
no atomics, so it is deterministic on the card as well.  The expert
products are batched matmuls, as the reference's are ``einsum``s outside
any Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def init_moe(gen, cfg: ModelConfig):
    m, d, dt = cfg.moe, cfg.d_model, cfg.torch_param_dtype()
    p = {
        "router": L.init_param(gen, (d, m.n_experts), dt, "normal", 0.02,
                               axes=("d_model", "experts")),
        "up": L.init_param(gen, (m.n_experts, d, m.d_ff_expert), dt,
                           "normal", axes=("experts", "d_model",
                                           "expert_ff")),
        "gate": L.init_param(gen, (m.n_experts, d, m.d_ff_expert), dt,
                             "normal", axes=("experts", "d_model",
                                             "expert_ff")),
        "down": L.init_param(gen, (m.n_experts, m.d_ff_expert, d), dt,
                             "normal", axes=("experts", "expert_ff",
                                             "d_model")),
    }
    if m.n_shared_experts:
        p["shared"] = L.init_mlp(gen, d, m.n_shared_experts * m.d_ff_expert,
                                 dt, gated=True)
    return p


def route(router_w, x_flat, cfg: ModelConfig):
    """x_flat: (T, d) -> gates (T, k) f32, idx (T, k) int64: the top-k of
    the router's softmax, ties to the lower expert index (as
    ``lax.top_k``), the gates renormalised to sum to one."""
    logits = x_flat.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    gates, idx = srt.values[:, :k], srt.indices[:, :k]
    gates = gates / torch.clamp(torch.sum(gates, -1, keepdim=True), min=1e-9)
    return gates, idx


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(np.ceil(n_tokens * m.top_k * m.capacity_factor / m.n_experts))
    return max(4, -(-c // 4) * 4)


def _expert_ffn(buf, up, gate, down, cdt, activation="silu"):
    """buf: (E, C, d); expert weights (E, d, f) / (E, f, d)."""
    h_up = torch.bmm(buf.to(cdt), up.to(cdt))
    h_g = torch.bmm(buf.to(cdt), gate.to(cdt))
    return torch.bmm(L._act(h_g, activation) * h_up, down.to(cdt))


# ---------------------------------------------------------------------------
def moe_reference(params, x, cfg: ModelConfig):
    """All-experts dense combine; the exact no-drop oracle."""
    B, S, d = x.shape
    cdt = cfg.torch_compute_dtype()
    xf = x.reshape(-1, d)
    gates, idx = route(params["router"], xf, cfg)
    comb = torch.zeros((xf.shape[0], cfg.moe.n_experts), dtype=torch.float32,
                       device=x.device).scatter_add(1, idx, gates)
    up = torch.einsum("td,edf->tef", xf.to(cdt), params["up"].to(cdt))
    gt = torch.einsum("td,edf->tef", xf.to(cdt), params["gate"].to(cdt))
    h = L._act(gt, cfg.activation) * up
    y = torch.einsum("tef,efd->ted", h, params["down"].to(cdt))
    out = torch.einsum("te,ted->td", comb.to(cdt), y).reshape(B, S, d)
    if "shared" in params:
        out = out + L.mlp(params["shared"], x, cfg.activation, cdt)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
def _dispatch_compute_combine(xf, gates, idx, up, gate, down,
                              cfg: ModelConfig):
    """Capacity dispatch on a flat token buffer xf: (T, d) -> (T, d) in
    the compute dtype."""
    T, d = xf.shape
    m = cfg.moe
    cdt = cfg.torch_compute_dtype()
    k, E = m.top_k, m.n_experts
    C = _capacity(T, cfg)
    e_flat = idx.reshape(-1)                               # (T*k,)
    # each entry's place in its expert's queue: the earlier flat entries
    # with the same expert (the reference's stable-sort order)
    hot = (e_flat[:, None] == torch.arange(E, device=xf.device)).to(
        torch.int32)
    pos = torch.gather(torch.cumsum(hot, dim=0), 1, e_flat[:, None])[:, 0] - 1
    keep = pos < C
    slot = torch.where(keep, e_flat * C + pos, E * C)      # E*C: dropped
    tok = torch.arange(T * k, device=xf.device) // k
    buf = torch.zeros((E * C + 1, d), dtype=cdt, device=xf.device)
    buf = buf.index_put((slot,), xf[tok].to(cdt))[:E * C]
    y = _expert_ffn(buf.reshape(E, C, d), up, gate, down, cdt,
                    cfg.activation).reshape(E * C, d)
    contrib = y[torch.clamp(slot, max=E * C - 1)] * (
        gates.reshape(-1) * keep).to(cdt)[:, None]
    # each token's k contributions in ascending expert order, added to
    # zero one at a time
    contrib = contrib.reshape(T, k, d)
    order = torch.argsort(idx, dim=-1)
    contrib = torch.gather(contrib, 1, order[..., None].expand(T, k, d))
    out = torch.zeros((T, d), dtype=cdt, device=xf.device)
    for j in range(k):
        out = out + contrib[:, j]
    return out


def moe_xla(params, x, cfg: ModelConfig):
    """Global-view capacity MoE: (B, S, d) -> (B, S, d) in x's dtype."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    gates, idx = route(params["router"], xf, cfg)
    out = _dispatch_compute_combine(xf, gates, idx, params["up"],
                                    params["gate"], params["down"], cfg)
    out = out.reshape(B, S, d).to(x.dtype)
    if "shared" in params:
        out = out + L.mlp(params["shared"], x, cfg.activation,
                          cfg.torch_compute_dtype()).to(x.dtype)
    return out


def moe_ffn(params, x, cfg: ModelConfig, mesh=None):
    """The block's MoE FFN.  ``mesh`` is the reference's expert-parallel
    path (``moe_ep``), which the port does not have yet."""
    if mesh is not None:
        raise NotImplementedError("moe_ffn over a mesh (the reference's "
                                  "expert-parallel moe_ep) is ROADMAP "
                                  "queue 1 item 7.2")
    return moe_xla(params, x, cfg)
