"""The port's roofline (:mod:`repro_torch.launch.roofline`) and report
(:mod:`repro_torch.launch.report`) against the reference's.

* ``roofline_terms`` returns the reference's keys (less
  ``raw_cost_analysis``: XLA's own cost analysis has no eager
  counterpart), at the H100's published peaks by compute dtype;
* ``model_flops`` equals the reference's;
* ``report.table`` prints the reference's rows for the same records (the
  header names the H100's figures in place of the TPU's);
* the counted FLOPs of one unsharded HERON datacenter step on the
  threefry stream (gpt2-tiny and qwen2-1.5b's smoke config, 4 x 32
  tokens) equal ``hlo_costs.total_costs`` of the reference's jitted step
  with ``remat=False`` on both sides and ``scan_layers=False`` on the
  reference's (with a scan it counts a layer's body once a trip, which
  ``hlo_costs`` multiplies out); and with ``remat=True`` on both sides
  (gpt2-tiny), where both count the server stack's forward again in the
  backward: the port's non-reentrant checkpoint stops each rep's replay
  at its last saved tensor, the input of the MLP's down projection, and
  XLA drops that same dead product from ``jax.checkpoint``'s replay.
  The tolerance the count is held to is exact equality: both count the
  same products (``2 * M * K * N`` a dot or matmul, the blocked
  attention's two einsums a tile, the server's backward products), and
  nothing else enters either count.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.configs.gpt2 import gpt2_tiny as jax_gpt2_tiny
from repro.core import protocols as JP
from repro.core import zo as JZ
from repro.distributed.sharding import AxisRules
from repro.launch import report as JREPORT
from repro.launch import roofline as JRL
from repro.launch.hlo_costs import total_costs as hlo_total_costs
from repro.models import transformer as JT
from repro.optim import optimizers as JOPT
from torch_round_parity import one_torch_thread  # noqa: F401
from repro_torch.configs.gpt2 import gpt2_tiny
from repro_torch.configs.registry import get_config
from repro_torch.core import prng as R
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.launch import costs as C
from repro_torch.launch import report as REPORT
from repro_torch.launch import roofline as RL
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as OPT

B, S = 4, 32


def test_roofline_terms_keys_and_peaks():
    x = jnp.zeros((256, 256), jnp.float32)
    want = set(JRL.roofline_terms(jax.jit(lambda a: a @ a).lower(x)
                                  .compile())) - {"raw_cost_analysis"}
    costs = {"flops": 2 * 989e12, "bytes": 3.35e12, "collective_bytes": 5e9,
             "collectives": {"all-reduce": 5e9},
             "collective_links": {"network": 5e9}}
    for dtype, peak in (("bfloat16", 989e12), ("float32", 67e12)):
        terms = RL.roofline_terms(costs, gpt2_tiny().replace(
            compute_dtype=dtype))
        assert set(terms) == want
        assert terms["compute_s"] == pytest.approx(2 * 989e12 / peak)
        assert terms["memory_s"] == pytest.approx(1.0)
        assert terms["collective_s"] == pytest.approx(0.1)
        assert terms["bottleneck"] == "compute"
        assert terms["roofline_step_s"] == terms["compute_s"]
        assert terms["compute_fraction"] == 1.0
    nv = RL.roofline_terms({**costs, "collective_links": {"nvlink": 4.5e9}},
                           gpt2_tiny())
    assert nv["collective_s"] == pytest.approx(0.01)


def test_memory_summary_keys():
    m = RL.memory_summary({"argument_bytes": 10, "output_bytes": 4,
                           "peak_bytes": 30})
    assert m == {"argument_size_in_bytes": 10, "output_size_in_bytes": 4,
                 "temp_size_in_bytes": 16, "total_hbm_bytes": 30}


@pytest.mark.parametrize("tokens,active", [(1, 1), (1048576, 1310342144),
                                           (32, 28712341504)])
def test_model_flops_equal_reference(tokens, active):
    cfg = gpt2_tiny()
    assert RL.model_flops(cfg, tokens, active) == \
        JRL.model_flops(cfg, tokens, active)


RECORDS = [
    {"arch": "qwen2-1.5b", "shape": "train_4k", "mesh": "16x16",
     "status": "ok", "compute_s": 0.1762, "memory_s": 5.6, "collective_s":
     1.13, "bottleneck": "memory", "useful_flops_ratio": 0.1847,
     "memory": {"total_hbm_bytes": 1188690080032}},
    {"arch": "qwen2-1.5b", "shape": "long_500k", "mesh": "16x16",
     "status": "skipped", "reason": "pure full-attention arch: 524k KV "
     "decode is skipped per assignment (sub-quadratic only)"},
    {"arch": "kimi-k2-1t-a32b", "shape": "train_4k", "mesh": "16x16",
     "status": "error", "error": "boom"},
    {"arch": "gemma2-27b", "shape": "prefill_32k", "mesh": "2x16x16",
     "status": "ok", "compute_s": 3.1e-3, "memory_s": 2.0,
     "collective_s": 0.0, "bottleneck": "memory",
     "useful_flops_ratio": 0.5, "memory": {"total_hbm_bytes": 512}},
]


def _printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return [ln for ln in buf.getvalue().splitlines()
            if not ln.startswith("### Roofline")]


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_report_table_rows_equal_reference(mesh):
    assert _printed(REPORT.table, RECORDS, mesh) == \
        _printed(JREPORT.table, RECORDS, mesh)
    head = _printed(lambda: print(REPORT.header(mesh)))
    assert head == [""] * len(head)
    assert "H100" in REPORT.header(mesh)


def test_report_summary_equals_reference(tmp_path, monkeypatch):
    import json
    import sys
    path = tmp_path / "d.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in RECORDS))
    out = _printed(REPORT.main, ["--jsonl", str(path)])
    monkeypatch.setattr(sys, "argv", ["report", "--jsonl", str(path)])
    assert out == _printed(JREPORT.main)
    assert out[0] == "cells: 4 ok=2 skipped=1 error=1"


def _jax_step_flops(arch, remat):
    """``hlo_costs``' FLOPs of the reference's jitted HERON step."""
    jcfg = (jax_gpt2_tiny() if arch == "gpt2-tiny"
            else JREG.get_config(arch, smoke=True))
    jcfg = dataclasses.replace(jcfg, remat=remat, scan_layers=False)
    params = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    jcopt, jsopt = JOPT.zo_sgd(1e-3), JOPT.adamw(1e-3)
    jstate = JP.init_train_state(jax.random.PRNGKey(1), params, jcopt,
                                 jsopt)
    jstep = JP.make_train_step(JP.lm_api(jcfg, AxisRules(mesh=None)),
                               "heron", JZ.ZOConfig(mu=1e-3), jcopt, jsopt)
    toks = np.zeros((B, S), np.int32)
    text = jax.jit(jstep).lower(jstate, {"inputs": toks, "labels": toks}
                                ).compile().as_text()
    return hlo_total_costs(text)["flops"]


def _port_step_flops(arch, remat):
    """``launch/costs``' FLOPs of the port's HERON step on meta."""
    cfg = (gpt2_tiny() if arch == "gpt2-tiny"
           else get_config(arch, True)).replace(remat=remat)
    copt, sopt = OPT.zo_sgd(1e-3), OPT.adamw(1e-3)
    state = P.init_train_state(R.PRNGKey(1), T.init_lm(cfg, device="meta"),
                               copt, sopt)
    tok = torch.empty((B, S), dtype=torch.int32, device="meta")
    step = P.make_train_step(P.lm_api(cfg), "heron", Z.ZOConfig(mu=1e-3),
                             copt, sopt)
    return C.total_costs(step, state, {"inputs": tok, "labels": tok}
                         )["flops"]


@pytest.mark.parametrize("arch", ["gpt2-tiny", "qwen2-1.5b"])
def test_heron_step_flops_equal_reference_hlo(arch):
    want = _jax_step_flops(arch, remat=False)
    assert want > 0
    assert _port_step_flops(arch, remat=False) == want


def test_heron_step_flops_with_remat_equal_reference_hlo():
    want = _jax_step_flops("gpt2-tiny", remat=True)
    assert want > _port_step_flops("gpt2-tiny", remat=False)
    assert _port_step_flops("gpt2-tiny", remat=True) == want
