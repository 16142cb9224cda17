"""The port's dry run (:mod:`repro_torch.launch.dryrun`, ``sweep``,
``configs/base.py``) against the reference's.

* ``SHAPES``, ``supports_shape`` and the batch and token specs equal the
  reference's for every arch and shape (meta tensors against
  ``ShapeDtypeStruct``\\ s);
* ``param_counts`` equals the reference's for every arch (the reference
  in a subprocess: importing ``repro.launch.dryrun`` sets ``XLA_FLAGS``);
* ``count_train`` / ``count_prefill`` on a (2, 4) fake-backend mesh of 8
  ranks with the dense and MoE smoke configs, and ``count_decode`` on
  (8, 1), in a subprocess (the group is process-wide): one rank's
  program counts fewer FLOPs and a smaller peak than the unsharded
  program's, with the collectives its mesh implies;
* one 16x16 ``train_4k`` cell (qwen2-1.5b at full width) has status
  ``ok`` and the reference's record keys; a 16x16 ``decode_32k`` cell is
  counted: one rank's serve step on its slabs, fewer FLOPs than the
  unsharded step's, with the model axis's collectives;
* the sweep resumes from its jsonl: only cells without an ``ok`` or
  ``skipped`` record run.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.configs import base as JCB
from repro.configs import registry as JREG
from torch_round_parity import one_torch_thread  # noqa: F401
from repro_torch.configs import base as CB
from repro_torch.configs import registry as REG
from repro_torch.launch import dryrun as D

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
# the reference record's keys the port's carries (XLA's own cost
# analysis has no eager counterpart)
RECORD_KEYS = {"arch", "shape", "mesh", "method", "overrides", "status",
               "seconds_lower", "seconds_compile", "chips", "tokens_global",
               "params", "model_flops_per_chip", "useful_flops_ratio",
               "memory", "flops", "bytes_accessed", "collective_bytes",
               "collective_by_op", "compute_s", "memory_s", "collective_s",
               "bottleneck", "roofline_step_s", "compute_fraction"}


def _run(args, timeout=300):
    r = subprocess.run([sys.executable] + args, env=ENV, cwd=ROOT,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    return r.stdout


def _spec(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", JREG.ARCH_IDS)
def test_shapes_and_specs_equal_reference(arch):
    assert {k: vars(v) for k, v in CB.SHAPES.items()} == \
        {k: vars(v) for k, v in JCB.SHAPES.items()}
    cfg, jcfg = REG.get_config(arch), JREG.get_config(arch)
    for name in JCB.SHAPES:
        shape, jshape = CB.SHAPES[name], JCB.SHAPES[name]
        assert CB.supports_shape(cfg, shape) == \
            JCB.supports_shape(jcfg, jshape)
        got = {k: _spec(v) for k, v in CB.train_batch_specs(cfg, shape)
               .items()}
        want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
                JCB.train_batch_specs(jcfg, jshape).items()}
        assert got == want
        assert all(v.device.type == "meta" for v in
                   CB.train_batch_specs(cfg, shape).values())
        tok, jtok = (CB.decode_token_specs(cfg, shape),
                     JCB.decode_token_specs(jcfg, jshape))
        assert _spec(tok) == (tuple(jtok.shape), str(jtok.dtype))


JAX_COUNTS = r"""
import json
import repro.launch.dryrun as D
from repro.configs.registry import ARCH_IDS, get_config
from repro.models import transformer as T
print(json.dumps({a: D.param_counts(get_config(a), T.init_lm(
    None, get_config(a), mode="shape")) for a in ARCH_IDS}))
"""


def test_param_counts_equal_reference():
    want = json.loads(_run(["-c", JAX_COUNTS]).strip().splitlines()[-1])
    assert set(want) == set(D.SWEEP_ARCHS)
    for arch, counts in want.items():
        cfg = REG.get_config(arch)
        assert D.param_counts(cfg, CB.param_specs(cfg)) == counts, arch
    # the threshold the reference's FSDP switches at
    assert D.FSDP_THRESHOLD == 3e9


FAKE_MESH = r"""
import json
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import base as CB
from repro_torch.configs.registry import get_config
from repro_torch.distributed.mesh import Mesh, make_local_mesh
from repro_torch.launch import dryrun as D

dist.init_process_group("fake", store=FakeStore(), rank=5, world_size=8)
one = Mesh({"data": 1, "model": 1})
mesh = make_local_mesh(4)
out = {"mesh": [mesh.shape, mesh.rank("data"), mesh.rank("model")]}
train = CB.ShapeSpec("t", 32, 8, "train")
for arch in ("qwen2-1.5b", "qwen3-moe-30b-a3b"):
    cfg = get_config(arch, smoke=True)
    out[arch] = [D.count_train(cfg, train, m)[0] for m in (mesh, one)]
    out[arch + "|prefill"] = [D.count_prefill(cfg, train, m)[0]
                              for m in (mesh, one)]
dec = CB.ShapeSpec("d", 64, 8, "decode")
cfg = get_config("qwen2-1.5b", smoke=True)
out["decode"] = [D.count_decode(cfg, dec, m)[0]
                 for m in (make_local_mesh(1), one)]
dist.destroy_process_group()
rec = D.run_cell("qwen2-1.5b", "decode_32k", False)
out["cell"] = rec
out["group_left"] = dist.is_initialized()
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
out["cell_whole"] = D.count_decode(get_config("qwen2-1.5b"),
                                   CB.SHAPES["decode_32k"], one)[0]
dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_mesh():
    return json.loads(_run(["-c", FAKE_MESH]).strip().splitlines()[-1])


def test_fake_mesh_is_the_local_mesh(fake_mesh):
    assert fake_mesh["mesh"] == [{"data": 2, "model": 4}, 1, 1]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-30b-a3b"])
def test_count_train_on_a_2x4_fake_mesh(fake_mesh, arch):
    """A rank's step on (2, 4): fewer FLOPs, bytes and a smaller peak
    than the unsharded step's; the loss and gradients all-reduced, the
    model axis's all-gathers (and the MoE's expert all-to-all); every
    group within one 8-GPU node, so all over NVLink."""
    rank, whole = fake_mesh[arch]
    for key in ("flops", "bytes", "peak_bytes", "argument_bytes"):
        assert 0 < rank[key] < whole[key], key
    assert whole["n_collectives"] == 0 and whole["collectives"] == {}
    kinds = set(rank["collectives"])
    assert {"all-reduce", "all-gather"} <= kinds
    assert ("all-to-all" in kinds) == (arch == "qwen3-moe-30b-a3b")
    assert set(rank["collective_links"]) == {"nvlink"}
    assert sum(rank["collective_links"].values()) == \
        pytest.approx(rank["collective_bytes"])
    assert rank["kernel_records"] == whole["kernel_records"] == {}


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-30b-a3b"])
def test_count_prefill_on_a_2x4_fake_mesh(fake_mesh, arch):
    rank, whole = fake_mesh[arch + "|prefill"]
    assert 0 < rank["flops"] < whole["flops"]
    assert rank["output_bytes"] * 8 == whole["output_bytes"]
    assert rank["n_collectives"] > 0 == whole["n_collectives"]


def test_count_decode_on_the_data_axis(fake_mesh):
    """Decode on (8, 1): each rank decodes its slab of the batch, so an
    eighth of the unsharded step's work and no collective."""
    rank, whole = fake_mesh["decode"]
    assert rank["flops"] * 8 == whole["flops"] > 0
    assert rank["n_collectives"] == 0


def test_decode_cell_on_16x16_is_counted(fake_mesh):
    """qwen2-1.5b's decode_32k cell on 16x16: status ``ok``, the rank's
    serve step on its slabs (8 of the 128 rows, its heads and vocab
    slab) counts fewer FLOPs than the unsharded step, and the model
    axis's all-reduces and logits' gathers are there."""
    rec, whole = fake_mesh["cell"], fake_mesh["cell_whole"]
    assert rec["status"] == "ok", rec
    assert RECORD_KEYS <= set(rec)
    assert rec["mesh"] == "16x16" and rec["method"] == "decode"
    assert rec["tokens_global"] == 128
    assert 0 < rec["flops"] < whole["flops"]
    assert rec["collective_bytes"] > 0 == whole["collective_bytes"]
    assert rec["collective_by_op"]["all-reduce"] > 0
    assert not fake_mesh["group_left"]


def test_train_cell_on_16x16_is_ok(tmp_path):
    out = tmp_path / "cells.jsonl"
    line = _run(["-m", "repro_torch.launch.dryrun", "--arch", "qwen2-1.5b",
                 "--shape", "train_4k", "--out", str(out)])
    rec = json.loads(line.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == rec
    assert rec["status"] == "ok", rec
    assert RECORD_KEYS <= set(rec)
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["fsdp"] is False and rec["fsdp_reference"] is False
    assert rec["params"]["total"] == 1543912448
    assert rec["tokens_global"] == 256 * 4096
    assert rec["flops"] > rec["model_flops_per_chip"] > 0
    assert rec["collective_by_op"]["all-reduce"] > 0
    assert rec["memory"]["total_hbm_bytes"] > \
        rec["memory"]["argument_size_in_bytes"]


def test_sweep_resumes(tmp_path):
    """Every cell of the single-pod sweep but one has a done record
    (``ok``, ``skipped``); the one has an ``error`` record: the sweep
    runs that cell alone, and it ends ``ok``."""
    out = tmp_path / "sweep.jsonl"
    todo = ("qwen2-1.5b", "decode_32k")
    lines = []
    for i, arch in enumerate(D.SWEEP_ARCHS):
        for shape, spec in CB.SHAPES.items():
            method = "heron" if spec.kind == "train" else spec.kind
            status = (("error" if (arch, shape) == todo else
                       D.DONE[i % len(D.DONE)]))
            lines.append(json.dumps({"arch": arch, "shape": shape,
                                     "mesh": "16x16", "method": method,
                                     "status": status}))
    out.write_text("\n".join(lines) + "\n")
    log = _run(["-m", "repro_torch.launch.sweep", "--out", str(out),
                "--meshes", "single"])
    ran = [ln for ln in log.splitlines() if ln.startswith("[sweep ")
           and "done" not in ln]
    assert len(ran) == 1 and "qwen2-1.5b decode_32k 16x16" in ran[0], log
    last = json.loads(out.read_text().strip().splitlines()[-1])
    assert last["status"] == "ok"
    assert len(out.read_text().strip().splitlines()) == len(lines) + 1
    assert np.all([json.loads(ln)["mesh"] == "16x16"
                   for ln in out.read_text().splitlines()])
