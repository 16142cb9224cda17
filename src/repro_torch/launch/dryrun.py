"""The production dry run of the port, the counterpart of
:mod:`repro.launch.dryrun`: one (arch, shape, mesh) cell's per-rank
program, counted instead of compiled.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k [--multi-pod] [--method heron] [--rank R] \\
        [--set causal_skip=true] [--out experiments/torch_dryrun.jsonl]

The reference lowers the step against ``ShapeDtypeStruct`` stand-ins on
512 host devices and reads its costs from the compiled HLO.  Here one
process is one rank (``--rank``, default 0) of a fake-backend process
group of 256 (16x16) or 512 (2x16x16) ranks
(:func:`repro_torch.launch.mesh.make_dryrun_mesh`): it runs that rank's
program once on ``meta`` slabs (params cut by the rules' placements, the
batch by ``place_batch``) under :mod:`repro_torch.launch.costs`'
counters, whose collectives return at once.  Nothing is allocated on
any device and no card is needed.  The roofline terms are the H100's
(:mod:`repro_torch.launch.roofline`).

Each record carries the reference's keys (``seconds_lower`` is the time
to build the rank's state and batch, ``seconds_compile`` the counted
run's) and ``"fsdp": false``: the port's mesh step reads every leaf
whole over "data", where the reference shards storage over it above
3e9 params (``"fsdp_reference"``; ROADMAP 7.7).  A decode cell counts
one serve step of the rank's batch rows against its slab of the caches
(its kv heads, its recurrent channels or heads), as the reference shards
them.  The default output,
``experiments/torch_dryrun.jsonl``, is the port's own.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import base as CB
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core import prng as R
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.data.pipeline import place_batch
from repro_torch.distributed import sharding as SH
from repro_torch.launch import costs as C
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_dryrun_mesh
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.tree import tree_leaves_with_path

FSDP_THRESHOLD = 3e9  # params; the reference shards storage above this
OUT = os.path.join("experiments", "torch_dryrun.jsonl")
# the sweep's architectures: the reference's registry (the port's adds
# gpt2, the paper's LM split)
SWEEP_ARCHS = tuple(a for a in ARCH_IDS if a != "gpt2")
DONE = ("ok", "skipped")


def build_rules(cfg, mesh, n_params: float) -> SH.AxisRules:
    """The rules of a cell: the default logical axes on ``mesh``, with
    FSDP off (the reference's is on above :data:`FSDP_THRESHOLD`)."""
    return SH.AxisRules(mesh=mesh, enable_fsdp=False)


def param_counts(cfg, params) -> dict:
    """Total, expert, embedding and active non-embedding parameters, as
    the reference counts them over its tree's paths."""
    total = expert = embed = 0
    for path, t in tree_leaves_with_path(params):
        n = int(np.prod(tuple(t.shape)))
        total += n
        if "moe/up" in path or "moe/gate" in path or "moe/down" in path:
            expert += n
        if "embed" in path and "table" in path:
            embed += n
    active = total - embed
    if cfg.moe is not None and expert:
        active -= int(expert * (1.0 - cfg.moe.top_k / cfg.moe.n_experts))
    return {"total": total, "expert": expert, "embed": embed,
            "active_nonembed": active}


def _setup(cfg, mesh):
    """``(counts, rules, full meta params)`` of a cell."""
    params = CB.param_specs(cfg)
    counts = param_counts(cfg, params)
    return counts, build_rules(cfg, mesh, counts["total"]), params


def _batch(cfg, shape, rules):
    return place_batch(CB.train_batch_specs(cfg, shape), "meta", rules)


def count_train(cfg, shape, mesh, method="heron"):
    """``(costs, counts, seconds to build)`` of one rank's datacenter
    step (HERON's ZO-SGD client, or AdamW for the first-order methods;
    the config's server optimizer) on its meta slabs."""
    t0 = time.time()
    counts, rules, params = _setup(cfg, mesh)
    api = P.lm_api(cfg, rules)
    c_name = "zo_sgd" if method == "heron" else "adamw"
    copt = make_optimizer(c_name, 1e-3)
    sopt = make_optimizer(cfg.optimizer, 1e-3)
    state = P.init_train_state(R.PRNGKey(0), params, copt, sopt,
                               shardings=api.shardings)
    batch = _batch(cfg, shape, rules)
    step = P.make_train_step(api, method, Z.ZOConfig(mu=1e-3, n_pairs=1),
                             copt, sopt)
    built = time.time() - t0
    return C.total_costs(step, state, batch), counts, built


def count_prefill(cfg, shape, mesh):
    """The same for the whole model's forward (:func:`protocols.
    make_prefill_step` under the rules: the logits a vocab slab)."""
    t0 = time.time()
    counts, rules, params = _setup(cfg, mesh)
    params = SH.shard_tree(params, T.param_shardings(cfg, rules))
    batch = _batch(cfg, shape, rules)
    prefill = P.make_prefill_step(cfg, rules)
    built = time.time() - t0
    with torch.no_grad():
        return C.total_costs(prefill, params, batch), counts, built


def count_decode(cfg, shape, mesh):
    """The same for one decode step (:func:`protocols.make_serve_step`
    under the rules) of a rank's batch slab against its slab of the
    caches (``shape.seq_len`` tokens a row): the logits its vocab
    slab."""
    t0 = time.time()
    counts, rules, params = _setup(cfg, mesh)
    params = SH.shard_tree(params, T.param_shardings(cfg, rules))
    b = place_batch({"inputs": CB.decode_token_specs(cfg, shape)}, "meta",
                    rules)
    caches = P.init_serve_caches(cfg, shape.global_batch, shape.seq_len,
                                 device="meta", rules=rules)
    serve = P.make_serve_step(cfg, P._placed(rules, b))
    tok = b["inputs"]
    built = time.time() - t0
    with torch.no_grad():
        return C.total_costs(serve, params, caches, tok), counts, built


def _parse_overrides(pairs):
    out = {}
    for kv in pairs or []:
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
            continue
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             method: str = "heron", overrides=None, rank: int = 0) -> dict:
    """One cell's record, counted as ``rank`` of the production mesh."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = CB.SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
           "method": method if shape.kind == "train" else shape.kind,
           "overrides": overrides or {}, "rank": rank}
    ok, why = CB.supports_shape(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    mesh = make_dryrun_mesh(multi_pod=multi_pod, rank=rank)
    try:
        t0 = time.time()
        if shape.kind == "train":
            costs, counts, built = count_train(cfg, shape, mesh, method)
            tokens = shape.global_batch * shape.seq_len
        elif shape.kind == "prefill":
            costs, counts, built = count_prefill(cfg, shape, mesh)
            tokens = shape.global_batch * shape.seq_len
        else:
            costs, counts, built = count_decode(cfg, shape, mesh)
            tokens = shape.global_batch
        t_count = time.time() - t0 - built
    finally:
        dist.destroy_process_group()
    n_chips = int(np.prod(list(mesh.shape.values())))
    terms = RL.roofline_terms(costs, cfg)
    mf_global = RL.model_flops(cfg, tokens, counts["active_nonembed"])
    if shape.kind != "train":
        mf_global /= 3.0          # inference: 2ND
    mf_per_chip = mf_global / n_chips
    rec.update(
        status="ok",
        seconds_lower=round(built, 1),
        seconds_compile=round(t_count, 1),
        chips=n_chips,
        tokens_global=tokens,
        params=counts,
        fsdp=False,
        fsdp_reference=counts["total"] > FSDP_THRESHOLD,
        model_flops_per_chip=mf_per_chip,
        useful_flops_ratio=(mf_per_chip / terms["flops"]
                            if terms["flops"] else 0.0),
        memory=RL.memory_summary(costs),
        kernel_records=costs["kernel_records"],
        collective_links=costs["collective_links"],
        **terms,
    )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(CB.SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--method", default="heron")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--set", action="append", default=[],
                    help="config overrides key=value (repeatable)")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank whose program is counted")
    args = ap.parse_args(argv)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required")
    try:
        rec = run_cell(args.arch, args.shape, args.multi_pod, args.method,
                       _parse_overrides(args.set), args.rank)
    except Exception as e:  # noqa: BLE001 (a cell's failure is a record)
        rec = {"arch": args.arch, "shape": args.shape,
               "mesh": _mesh_name(args.multi_pod), "rank": args.rank,
               "status": "error", "error": repr(e),
               "trace": traceback.format_exc()[-2000:]}
    line = json.dumps(rec)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0 if rec.get("status") in DONE else 1


if __name__ == "__main__":
    sys.exit(main())
