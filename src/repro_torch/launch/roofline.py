"""Roofline terms of a counted call on the NVIDIA H100, the port's
counterpart of :mod:`repro.launch.roofline`.

Three terms, in seconds, of one rank's program (a counted call is one
rank's: nothing is divided by the chip count):

    compute    = FLOPs              / peak FLOP/s of the compute dtype
    memory     = bytes accessed     / HBM bandwidth
    collective = collective bytes   / link bandwidth (NVLink or network)

The constants are the published figures of the H100 SXM (NVIDIA's data
sheet: dense rates without sparsity, at the full 700 W power limit), not
measurements: 989 TFLOP/s bf16, 495 TFLOP/s TF32 and 67 TFLOP/s f32
outside the tensor cores, 3.35 TB/s of HBM3; NVLink 4 at 450 GB/s a
direction between the GPUs of one 8-GPU node, and 50 GB/s (400 Gb/s NDR
InfiniBand, one NIC a GPU) for a group that spans nodes.  A config in
f32 runs its products at the f32 rate: the port keeps TF32 off, apart
from K2 / K4's 3xTF32 route, whose records count its products as the
plain version's.  The costs come from :mod:`repro_torch.launch.costs`.
"""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BW = 3.35e12
NVLINK_BW = 450e9          # a direction, between the GPUs of one node
NETWORK_BW = 50e9          # a GPU's share of the network across nodes
LINK_BW = {"nvlink": NVLINK_BW, "network": NETWORK_BW}


def roofline_terms(costs: dict, cfg) -> dict:
    """The reference's keys from a :func:`repro_torch.launch.costs.
    total_costs` result: the three terms at the peaks of ``cfg``'s
    compute dtype, the bottleneck, the roofline step time (the largest
    term) and the compute term's share of it."""
    flops = float(costs["flops"])
    nbytes = float(costs["bytes"])
    links = costs.get("collective_links", {})
    terms = {
        "flops": flops,
        "bytes_accessed": nbytes,
        "collective_bytes": float(costs["collective_bytes"]),
        "collective_by_op": dict(costs["collectives"]),
        "compute_s": flops / PEAK_FLOPS[cfg.compute_dtype],
        "memory_s": nbytes / HBM_BW,
        "collective_s": sum(b / LINK_BW[k] for k, b in links.items()),
    }
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    terms["bottleneck"] = dom.replace("_s", "")
    step = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    terms["roofline_step_s"] = step
    terms["compute_fraction"] = terms["compute_s"] / step if step > 0 else 0.0
    return terms


def memory_summary(costs: dict) -> dict:
    """The reference's memory keys from counted costs: the arguments'
    and outputs' bytes, the temporaries (the high-water mark above
    both) and ``total_hbm_bytes``, the tracked peak."""
    arg, out = int(costs["argument_bytes"]), int(costs["output_bytes"])
    peak = int(costs["peak_bytes"])
    return {"argument_size_in_bytes": arg, "output_size_in_bytes": out,
            "temp_size_in_bytes": max(peak - arg - out, 0),
            "total_hbm_bytes": peak}


def model_flops(cfg, n_tokens: int, n_params_active: int) -> float:
    """6·N_active·D — the useful-compute yardstick."""
    return 6.0 * n_params_active * n_tokens


def bound_s(n_bytes: float, n_ops: float, dtype_name: str):
    """A kernel's least time on the card: the larger of its bytes over
    the HBM rate and its operations over the peak of ``dtype_name``.
    Returns ``(seconds, "bytes" or "operations")``."""
    t_bytes = n_bytes / HBM_BW
    t_ops = n_ops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
