"""Profile-driven cut-layer selection (AdaptSFL, arXiv:2403.13101), as
:mod:`repro.fed.cutplan`.

At admission the controller knows a device's profile (sustained FLOP/s,
memory bandwidth, memory budget, round deadline) and picks the split
point.  The per-cut costs are counted, not modelled: the client loss
runs once at every candidate cut on the ``meta`` device (shapes alone:
nothing is allocated or launched, as the reference's ``eval_shape`` and
compile), under the port's cost counter
(:func:`repro_torch.launch.costs.total_costs`: ``FlopCounterMode``'s
FLOPs, the operand and result bytes of every non-view op).  The
reference reads both from the compiled HLO
(``launch/hlo_costs.total_costs``).  The FLOPs are the same products;
the bytes are eager PyTorch's, op by op and unfused, so they are not
held to XLA's fused count.

The plan picks the deepest cut that fits the device (client parameter
bytes within the memory budget, estimated round time within the
deadline); an infeasible device gets the shallowest cut with
``feasible=False``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.split import param_bytes
from repro_torch.launch.costs import total_costs


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """What the admission handshake reports about a device."""
    name: str
    peak_flops: float          # sustained FLOP/s on the client forward
    mem_bw: float              # bytes/s
    mem_bytes: float           # client parameter budget
    deadline_s: float = math.inf   # per-round completion deadline


# Representative fleet tiers for the phones+laptops+edge-TPUs scenario.
PROFILES = {
    "phone": DeviceProfile("phone", peak_flops=8e9, mem_bw=10e9,
                           mem_bytes=512e6, deadline_s=60.0),
    "laptop": DeviceProfile("laptop", peak_flops=200e9, mem_bw=50e9,
                            mem_bytes=8e9, deadline_s=60.0),
    "edge_tpu": DeviceProfile("edge_tpu", peak_flops=2e12, mem_bw=32e9,
                              mem_bytes=1e9, deadline_s=60.0),
}


@dataclasses.dataclass(frozen=True)
class CutCost:
    """The counted cost of one candidate cut's client loss."""
    cut: int
    flops: float               # one client forward (loss eval)
    bytes: float               # operand and result bytes of its ops
    param_bytes: int           # client-side parameter footprint


@dataclasses.dataclass(frozen=True)
class CutPlan:
    cut: int
    round_s: float             # estimated h·(2·n_pairs) forward evals
    feasible: bool


def _is_cnn(cfg) -> bool:
    return hasattr(cfg, "client_blocks")


def cut_candidates(cfg) -> list[int]:
    """Candidate split depths: every cut that leaves at least one block
    on each side."""
    if _is_cnn(cfg):
        total = len(cfg.widths) * cfg.blocks_per_stage
    else:
        total = cfg.n_layers
    return list(range(1, max(total, 2)))


def _loss_costs(loss_fn, *args) -> tuple[float, float]:
    """``(flops, bytes)`` of one call of ``loss_fn`` on meta tensors."""
    with torch.no_grad():
        c = total_costs(loss_fn, *args)
    return c["flops"], c["bytes"]


def candidate_costs(base_cfg, batch, cuts=None) -> list[CutCost]:
    """Count the client loss's FLOPs and bytes at every candidate cut.

    ``batch``: one client micro-batch; only its shapes and dtypes are
    read.  Params and batch live on the ``meta`` device, so a full-width
    model costs nothing to count."""
    from repro_torch.core import protocols as P

    cnn = _is_cnn(base_cfg)
    field = "client_blocks" if cnn else "cut_layers"
    mb = {k: torch.empty(tuple(v.shape), dtype=v.dtype, device="meta")
          for k, v in batch.items()}
    costs = []
    for cut in (cuts if cuts is not None else cut_candidates(base_cfg)):
        cfg = dataclasses.replace(base_cfg, **{field: cut})
        if cnn:
            from repro_torch.models import cnn as CNN
            api, params = P.cnn_api(cfg), CNN.init_cnn(cfg, device="meta")
        else:
            from repro_torch.models import transformer as T
            api, params = P.lm_api(cfg), T.init_lm(cfg, device="meta")
        cp = params["client"]
        flops, nbytes = _loss_costs(lambda p, b: api.client_loss(p, b)[0],
                                    cp, mb)
        costs.append(CutCost(cut=cut, flops=flops, bytes=nbytes,
                             param_bytes=param_bytes(cp)))
    return costs


def round_time_s(cost: CutCost, profile: DeviceProfile, h: int,
                 n_pairs: int) -> float:
    """Roofline estimate of one local round on the device: ``h`` local
    steps, each 2·n_pairs forward evals (two-point ZO probes), each
    bounded by the slower of compute and memory streaming."""
    fwd = max(cost.flops / profile.peak_flops,
              cost.bytes / profile.mem_bw)
    return h * 2 * n_pairs * fwd


def plan_cut(costs: list[CutCost], profile: DeviceProfile, h: int,
             n_pairs: int) -> CutPlan:
    """Deepest cut meeting the device's memory budget and deadline."""
    feasible = [c for c in costs
                if c.param_bytes <= profile.mem_bytes
                and round_time_s(c, profile, h, n_pairs)
                <= profile.deadline_s]
    if feasible:
        best = max(feasible, key=lambda c: c.cut)
        return CutPlan(best.cut, round_time_s(best, profile, h, n_pairs),
                       True)
    shallow = min(costs, key=lambda c: c.cut)
    return CutPlan(shallow.cut,
                   round_time_s(shallow, profile, h, n_pairs), False)


def plan_fleet(costs: list[CutCost], profiles, h: int,
               n_pairs: int) -> list[CutPlan]:
    """One :class:`CutPlan` per device, from one shared cost table."""
    return [plan_cut(costs, p, h, n_pairs) for p in profiles]
