"""Mixture-of-Experts FFN, mirroring :mod:`repro.models.moe`.

Three execution paths share one routing function:

* :func:`moe_reference`: every expert on every token, combined with the
  top-k gates.  Exact (no token dropping): the tests' oracle.
* :func:`moe_xla`: the capacity dispatch on the global view (one device,
  the serving prefill and decode).
* :func:`moe_ep`: the datacenter step's mesh (``rules`` with a
  :class:`repro_torch.distributed.mesh.Mesh`), the reference's
  ``shard_map`` path.  Each rank routes its own token slab (its rows of
  the batch, its ``S / n_model`` columns of the sequence) and dispatches
  it at the capacity of its own token count; the ``(E, C, d)`` buffer
  goes over the model axis with an all-to-all, the rank runs its
  ``E / n_model`` experts on ``(E / n_model, n_model * C, d)`` and the
  outputs come back by the inverse exchange.  So with drops the result
  is not :func:`moe_xla`'s: the capacity is each slab's.
  :func:`moe_ep_plain` is the same arithmetic in one process, slab by
  slab (the tests' and the card check's oracle).

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

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

# within recording_drops(): the dropped (token, choice) entries of each
# dispatch, in call order
_DROPS: list | None = None


@contextlib.contextmanager
def recording_drops():
    """Yields a list to which every dispatch inside the block appends
    how many of its (token, choice) entries the capacity dropped (a host
    sync each); the mesh path counts each rank's own entries."""
    global _DROPS
    saved, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = saved


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
def _queue_positions(e_flat, E: int):
    """Each entry's place in its expert's queue (the earlier flat entries
    with the same expert: the reference's stable-sort order) and each
    expert's entry count."""
    hot = (e_flat[:, None] == torch.arange(E, device=e_flat.device)).to(
        torch.int32)
    csum = torch.cumsum(hot, dim=0)
    return torch.gather(csum, 1, e_flat[:, None])[:, 0] - 1, csum[-1]


def _dispatch_compute_combine(xf, gates, idx, up, gate, down,
                              cfg: ModelConfig, *, data_mesh=None,
                              ep_mesh=None):
    """Capacity dispatch on a flat token buffer xf: (T, d) -> (T, d) in
    the compute dtype.

    ``data_mesh``: the global view over a split data axis (the reference's
    ``moe_xla`` on the whole batch): the capacity is the data group's
    token count, and an entry queues behind its expert's entries on the
    earlier data ranks (their counts all-gathered; tokens meet only
    through those positions, so none leaves its rank).  ``ep_mesh``: the
    expert exchange over its model axis (the weights are this rank's
    expert slab)."""
    T, d = xf.shape
    m = cfg.moe
    cdt = cfg.torch_compute_dtype()
    k, E = m.top_k, m.n_experts
    e_flat = idx.reshape(-1)                               # (T*k,)
    pos, counts = _queue_positions(e_flat, E)
    if data_mesh is None:
        C = _capacity(T, cfg)
    else:
        every = TP.all_gather_ints(counts, data_mesh, "data")
        before = dist.get_rank(data_mesh.group("data"))
        pos = pos + every[:before].sum(0)[e_flat]
        C = _capacity(T * every.shape[0], cfg)
    keep = pos < C
    if _DROPS is not None:
        _DROPS.append(int(T * k - keep.sum()))
    slot = torch.where(keep, e_flat * C + pos, E * C)      # E*C: dropped
    tok = torch.arange(T * k, device=xf.device) // k
    buf = torch.zeros((E * C + 1, d), dtype=cdt, device=xf.device)
    buf = buf.index_put((slot,), xf[tok].to(cdt))[:E * C].reshape(E, C, d)
    # (E/n, n*C, d) on the mesh: this rank's experts, every rank's slots
    buf = TP.all_to_all(buf, ep_mesh, "model", 0, 1)
    y = _expert_ffn(buf, up, gate, down, cdt, cfg.activation)
    y = TP.all_to_all(y, ep_mesh, "model", 1, 0).reshape(E * C, d)
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
        out = out + _shared(params, x, cfg)
    return out


def _shared(params, x, cfg: ModelConfig, rules=None):
    """The shared expert on every token (tensor-parallel over its d_ff
    under ``rules``), in x's dtype."""
    m = cfg.moe
    return L.mlp(params["shared"], x, cfg.activation,
                 cfg.torch_compute_dtype(), rules=rules,
                 d_ff=m.n_shared_experts * m.d_ff_expert).to(x.dtype)


def _whole(w, mesh, n_experts: int, dim: int, partial: bool = False):
    """An expert-indexed leaf whole on its experts dim: all-gathered over
    the model axis where this rank holds a slab of it (``partial``: the
    backward sums the gradient over the axis first, for a leaf each rank
    reads for its own tokens only)."""
    if w.shape[dim] == n_experts:
        return w
    return TP.gather_from(w, mesh, "model", dim, partial=partial)


def moe_ep(params, x, cfg: ModelConfig, rules):
    """Expert-parallel MoE over ``rules.mesh``: x (B, S, d) is this rank's
    rows of the batch, whole on the model axis (the residual stream's
    placement); returns the same slab in x's dtype.

    The expert slab (``"experts"`` over ``"model"``) is whole on
    ``d_model``: the reference stores it FSDP-sharded and all-gathers it
    inside its ``shard_map``, a storage round trip that changes no
    number, so there is nothing to gather here.  The router's column
    slab is gathered (its gradient summed over the model axis: each rank
    routes only its own tokens).

    Where the reference falls back to the global view (a model axis of
    1, a sequence that the model axis does not divide, or a batch that
    the data axis does not: ``rules.batch_split`` False), this is
    :func:`moe_xla` on the global batch: the expert slabs gathered, the
    capacity over the global token count, and on a split data axis each
    entry's queue position counting the earlier data ranks' entries."""
    mesh = rules.mesh
    B, S, d = x.shape
    E = cfg.moe.n_experts
    n_model, n_data = mesh.shape.get("model", 1), mesh.shape.get("data", 1)
    split = n_data > 1 and rules.batch_split
    if n_model == 1 or S % n_model or (n_data > 1 and not split):
        router = _whole(params["router"], mesh, E, -1)
        up, gate, down = (_whole(params[w], mesh, E, 0)
                          for w in ("up", "gate", "down"))
        xf = x.reshape(-1, d)
        gates, idx = route(router, xf, cfg)
        out = _dispatch_compute_combine(xf, gates, idx, up, gate, down, cfg,
                                        data_mesh=mesh if split else None)
        out = out.reshape(B, S, d).to(x.dtype)
    else:
        if params["up"].shape[0] * n_model != E:
            raise ValueError(f"moe_ep: {E} experts on a model axis of "
                             f"{n_model}: this rank holds "
                             f"{params['up'].shape[0]} (the expert "
                             "exchange needs the experts split evenly)")
        router = _whole(params["router"], mesh, E, -1, partial=True)
        xs = TP.split_to(x, mesh, "model", dim=1)           # (B, S/n, d)
        xf = xs.reshape(-1, d)
        gates, idx = route(router, xf, cfg)
        out = _dispatch_compute_combine(xf, gates, idx, params["up"],
                                        params["gate"], params["down"], cfg,
                                        ep_mesh=mesh)
        out = TP.gather_from(out.reshape(B, S // n_model, d), mesh, "model",
                             dim=1).to(x.dtype)
    if "shared" in params:
        out = out + _shared(params, x, cfg, rules)
    return out


def moe_ep_plain(params, x, cfg: ModelConfig, n_data: int, n_model: int):
    """What :func:`moe_ep` computes on an ``(n_data, n_model)`` mesh, in
    one process on the whole ``params`` and the global x (B, S, d): the
    capacity dispatch on each (data, model) token slab at that slab's
    capacity, or :func:`moe_xla` where ``moe_ep`` takes the global view.
    The single-process oracle of the tests and the card check; no model
    path calls it."""
    B, S, d = x.shape
    if n_model == 1 or S % n_model or B % n_data:
        return moe_xla(params, x, cfg)
    bl, sl = B // n_data, S // n_model
    rows = []
    for i in range(n_data):
        cols = []
        for j in range(n_model):
            xs = x[i * bl:(i + 1) * bl, j * sl:(j + 1) * sl]
            xf = xs.reshape(-1, d)
            gates, idx = route(params["router"], xf, cfg)
            cols.append(_dispatch_compute_combine(
                xf, gates, idx, params["up"], params["gate"], params["down"],
                cfg).reshape(bl, sl, d))
        rows.append(torch.cat(cols, dim=1))
    out = torch.cat(rows, dim=0).to(x.dtype)
    if "shared" in params:
        out = out + _shared(params, x, cfg)
    return out


def moe_ffn(params, x, cfg: ModelConfig, rules=None):
    """The block's MoE FFN: :func:`moe_ep` under ``rules`` with a mesh,
    else :func:`moe_xla`.  The reference sends one token a row (a decode
    step) to its ``moe_xla`` under the rules, the global view of the
    rank's expert slabs; here that is ``moe_ep``'s global-view branch
    (the model axis never divides ``S == 1``), which gathers the slabs,
    not :func:`moe_xla`, which would read the rank's slab as if it held
    every expert."""
    if rules is not None and rules.mesh is not None:
        return moe_ep(params, x, cfg, rules)
    return moe_xla(params, x, cfg)
