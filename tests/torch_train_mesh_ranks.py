"""The ranks of ``tests/test_torch_train_mesh.py`` (not a test module;
imported by name in each spawned process, so it imports ``repro_torch``
and nothing of JAX or :mod:`repro`).

Each rank joins a gloo group on a ``FileStore``, reads the test's
inputs (``inputs.npz``: the rates and the batches), runs every case of
its world size in one process and writes ``rank<r>.npz``:

* ``<case>|fail``: each slab leaf of the mesh step's state that is not
  the port's unsharded step's slab at ``PARAM_TOL`` (both run here, from
  the same params, the reference's ``init_lm(PRNGKey(0))``), as text;
* ``<case>|rep|<path>``: the bytes of every replicated leaf, which the
  test holds equal across the ranks;
* ``<case>|full|<path>`` (rank 0, the cases the test holds to JAX): the
  params gathered from the slabs;
* ``rec|<case>|...``: a recurrent mixer (``rg_lru_block``,
  ``mlstm_block``, ``slstm_block``) on this rank's slabs against the
  unsharded block (each rank runs both), the widths its K6 scans took,
  and the reduce-scatter pair against a single-process sum;
* ``cross|<case>|fail``: seamless's cross sub-block on this rank's slabs
  against the whole sub-block;
* ``misc|...``: ``remesh``, the sphere's slabs, the bridge, the
  checkpoint and the driver cases;
* ``prefill|<case>|fail``: ``make_prefill_step(cfg, rules)`` on this
  rank's slabs, its logits against the slab (batch rows, vocab columns)
  of the unsharded prefill's (each rank runs both);
* ``moe|<case>|...`` (``torch_moe_ep_cases``): ``moe_ep`` on this rank's
  slabs, its output rows, the gradients of ``sum(out * w)`` (the params'
  summed over the data group where the batch is split, as the step
  does) with each slab's global bounds, and the dropped entries of the
  distinct token slabs beside :func:`repro_torch.models.moe.moe_ep_plain`'s;
* ``serve|...`` (``torch_serve_mesh_ranks``): serving on the rank's
  slabs (the engines, seamless's token loop, the (2, 2) serve step, the
  MoE at one token a row, the mixers' states and the KV caches) against
  the unsharded runs;
* ``remat|<case>|fail``: a mesh step with remat on (the configs'
  default) against the same step with remat off, every leaf of the
  state and every metric bit for bit (each rank's backward recomputes
  its checkpointed forward, collectives and all, in the same order).
"""
import dataclasses
import hashlib
import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_moe_ep_cases as MC
import torch_serve_mesh_ranks as SERVE
from repro_torch.bridge import from_jax, to_numpy
from repro_torch.checkpoint import checkpoint as CKPT
from repro_torch.configs.gpt2 import gpt2_tiny
from repro_torch.configs.registry import get_config
from repro_torch.core import prng as R
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.core.split import partition
from repro_torch.data.pipeline import place_batch
from repro_torch.distributed import fault as F
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.mesh import make_local_mesh
from repro_torch.models import layers as L
from repro_torch.models import lora as LORA
from repro_torch.models import moe as M
from repro_torch.models import recurrent as REC
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, MoECfg
from repro_torch.optim import optimizers as OPT
from repro_torch.tree import tree_leaves_with_path, tree_map

PARAM_TOL = dict(rtol=2e-5, atol=1e-6)
# (stream, method): HERON on the kernel stream (forward_impl "kernel"; in
# "scores" with attn_probe="scores", the probe on each rank's heads' rows
# of the score field) and the threefry stream (gaussian), and every
# first-order method
HERON = [("kernel", "heron"), ("threefry", "heron")]
STEPS = HERON + [("fo", m) for m in ("cse_fsl", "fsl_sage", "sflv1",
                                     "sflv2", "splitlora")]
# xlstm's f32 stack is ill-conditioned (ROADMAP queue 3): its steps run
# AdamW at eps 1e-3 and hold the optimizer moments, which carry the
# gradient itself, at 5e-4 x their leaf's max
# (tests/test_torch_family_rounds.py's XLSTM_EPS, XLSTM_MOMENT_ATOL)
XLSTM = {"eps": 1e-3, "moment_atol": 5e-4}
# world -> [(tag, config, model_parallel, steps, gathered for JAX[,
# options])]; qwen2-vl-2b (M-RoPE ids, vision-stub inputs; on (1, 4) its
# two kv heads split below a head and are gathered and narrowed) and
# seamless-m4t-medium (the decoder's cross sub-blocks on the rank's
# heads, dec_embed vocab-parallel; sflv2's backward runs through them)
# take the modality batches; options: "cf" the MoE capacity factor
# (n_experts / top_k:
# no slab drops, so the expert-parallel step is the unsharded one),
# "jax_step" the 4 x 16 batch of torch_moe_ep_cases, the step held to
# the reference's sharded step (per-slab drops and all) in place of the
# unsharded one, "adafactor" the server's optimizer, "eps" the AdamW eps
# and "moment_atol" the optimizer moments' tolerance (x their leaf's max)
MESHES = {4: [("gpt2_2x2", "gpt2-tiny", 2,
               STEPS + [("scores", "heron")], True),
              ("qwen_2x2", "qwen2-1.5b", 2, STEPS, False),
              ("qwen_1x4", "qwen2-1.5b", 4, STEPS, False),
              ("moe_2x2", "qwen3-moe-30b-a3b", 2, HERON[:1], True,
               {"jax_step": True}),
              ("kimi_2x2", "kimi-k2-1t-a32b", 2, HERON[:1], False,
               {"adafactor": True, "cf": 4.0}),
              ("rg_2x2", "recurrentgemma-9b", 2, HERON[:1], False),
              ("xlstm_1x4", "xlstm-1.3b", 4, HERON[:1], False, XLSTM),
              ("vlm_1x4", "qwen2-vl-2b", 4, HERON[:1], False),
              ("audio_2x2", "seamless-m4t-medium", 2, HERON[:1], False)],
          2: [("rg_2x1", "recurrentgemma-9b", 1, HERON[:1], False),
              ("gpt2_1x2", "gpt2-tiny", 2, HERON[:1], True),
              ("moe_1x2", "qwen3-moe-30b-a3b", 2, HERON[:1], False,
               {"cf": 4.0}),
              ("kimi_1x2", "kimi-k2-1t-a32b", 2, HERON[:1], False,
               {"adafactor": True, "cf": 4.0}),
              ("rg_1x2", "recurrentgemma-9b", 2, STEPS, True),
              ("xlstm_1x2", "xlstm-1.3b", 2, HERON + [("fo", "cse_fsl")],
               True, XLSTM),
              ("vlm_1x2", "qwen2-vl-2b", 2, HERON + [("scores", "heron")],
               True),
              ("audio_1x2", "seamless-m4t-medium", 2,
               HERON + [("fo", "sflv2")], True)]}
# the families whose batch is the frontend stub's: inputs.npz keys
# "<family>_<key>" (torch_round_parity.mesh_step_inputs)
STUB_FAMILIES = ("vlm", "audio")


def config(name, stream, opts=None):
    cfg = gpt2_tiny() if name == "gpt2-tiny" else get_config(name, True)
    if (opts or {}).get("cf"):
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=opts["cf"]))
    if stream == "scores":
        return cfg.replace(forward_impl="kernel", attn_probe="scores")
    return cfg.replace(forward_impl="kernel" if stream == "kernel"
                       else "xla")


def batch_of(inp, cfg, opts=None):
    if (opts or {}).get("jax_step"):
        return {k: torch.as_tensor(v).long()
                for k, v in MC.step_batch(cfg.vocab).items()}
    if cfg.family in STUB_FAMILIES:
        p = cfg.family + "_"
        return {k[len(p):]: torch.as_tensor(v) for k, v in inp.items()
                if k.startswith(p)}
    b = {k: torch.as_tensor(inp[f"batch_{k}"]) for k in ("inputs",
                                                          "labels")}
    return {k: v % cfg.vocab for k, v in b.items()}


def _digest(t):
    return np.frombuffer(hashlib.sha1(
        t.detach().contiguous().view(torch.uint8).numpy().tobytes()
    ).digest(), np.uint8)


def run_step(cfg, rules, method, stream, inp, batch, opts=None):
    """One datacenter step from the reference's params: ``(state,
    metrics, state placements)``."""
    rates = "kernel" if stream == "scores" else stream
    mu, lr = (float(x) for x in inp[f"{rates}_rates"]) if stream != "fo" \
        else (1e-3, 0.0)
    fo_lr, fo_slr, fo_eps = (float(x) for x in inp["fo_rates"])
    fo_eps = (opts or {}).get("eps", fo_eps)
    zo = Z.ZOConfig(mu=mu, scale="gaussian")
    copt = (OPT.zo_sgd(lr) if method == "heron"
            else OPT.adamw(fo_lr, eps=fo_eps))
    sopt = (OPT.adafactor(fo_slr) if (opts or {}).get("adafactor")
            else OPT.adamw(fo_slr, eps=fo_eps))
    api = P.lm_api(cfg, rules)
    params = T.init_lm(cfg, device="cpu", key=R.PRNGKey(0))
    shardings, tc_pred = api.shardings, None
    if method == "splitlora":
        gen = torch.Generator().manual_seed(5)
        params = {**params, "client": LORA.add_lora(gen, params["client"],
                                                    rank=4)}
        tc_pred = LORA.lora_pred
        if rules is not None:
            axes = T.param_axes(cfg)
            axes = {**axes, "client": LORA.add_lora_axes(axes["client"])}
            shardings = SH.tree_shardings(rules, axes, params)
    state = P.init_train_state(R.PRNGKey(1), params, copt, sopt, tc_pred,
                               shardings=shardings)
    cs = None
    if method == "splitlora" and shardings is not None:
        cs = partition(shardings["client"], tc_pred)[0]
    step = P.make_train_step(api, method, zo, copt, sopt, tc_pred,
                             client_shardings=cs)
    new, m = step(state, place_batch(batch, "cpu", rules))
    return new, m, P.train_state_shardings(new, shardings, tc_pred)


def step_cases(inp, out, world):
    refs = {}
    for tag, name, mp, steps, to_jax, *opts in MESHES[world]:
        opts = opts[0] if opts else {}
        mesh = make_local_mesh(mp)
        assert mesh.shape == {"data": world // mp, "model": mp}, mesh.shape
        rules = SH.AxisRules(mesh=mesh, enable_fsdp=False)
        for stream, method in steps:
            cfg = config(name, stream, opts)
            batch = batch_of(inp, cfg, opts)
            case = f"{tag}_{stream}_{method}"
            new, m, places = run_step(cfg, rules, method, stream, inp, batch,
                                      opts)
            # the unsharded step (rank 0's, sent to the others as numpy),
            # shared by the meshes of a config; None for a case held to
            # the reference's sharded step instead
            ref_key = (None if opts.get("jax_step") else
                       (tag if opts else name, stream, method))
            if ref_key is not None and ref_key not in refs:
                one = [None]
                if dist.get_rank() == 0:
                    st, ms, _ = run_step(cfg, None, method, stream, inp,
                                         batch, opts)
                    one = [(tree_map(lambda t: t.detach().numpy() if
                                     isinstance(t, torch.Tensor) else t, st),
                            {k: float(v) for k, v in ms.items()})]
                dist.broadcast_object_list(one, src=0)
                refs[ref_key] = one[0]
            ref, rm = refs.get(ref_key, (None, None))
            fails = []
            for k in ("loss", "client_loss") if rm else ():
                if not np.isclose(float(m[k]), float(rm[k]), rtol=2e-5,
                                  atol=0):
                    fails.append(f"{k} {float(m[k])} vs {float(rm[k])}")
            pl = dict(tree_leaves_with_path(places))
            for path, got in tree_leaves_with_path(new):
                if not isinstance(got, torch.Tensor):
                    continue
                if ref is not None:
                    full = torch.as_tensor(_leaf(ref, path))
                    want = SH.shard(full, pl.get(path))
                    tol = dict(PARAM_TOL)
                    if opts.get("moment_atol") and path.startswith("opt_") \
                            and full.is_floating_point():
                        tol["atol"] = opts["moment_atol"] * float(
                            full.abs().max())
                    if not torch.allclose(got.double(), want.double(),
                                          **tol):
                        err = (got.double() - want.double()).abs().max()
                        fails.append(f"{path}: max err {float(err):.3g}")
                if pl.get(path) is None or not pl[path].sharded:
                    out[f"{case}|rep|{path}"] = _digest(got)
            out[f"{case}|fail"] = np.array("\n".join(fails))
            if to_jax and method == "heron":
                full = SH.gather_tree(new["params"], places["params"])
                if dist.get_rank() == 0:
                    for path, t in tree_leaves_with_path(full):
                        out[f"{case}|full|{path}"] = t.numpy()
            dist.barrier()


# world -> the mesh steps run again with remat off: (tag, config,
# model_parallel, stream, method, options as MESHES'); on (1, 2) a dense
# FSL-SAGE step (client, aux head and server checkpointed under
# tensor-parallel collectives, the alignment's double backward through
# the aux block), on (2, 2) the MoE's HERON step (moe_ep's all_to_all and
# capacity offsets in the server's recompute)
REMAT = {2: [("gpt2_1x2", "gpt2-tiny", 2, "fo", "fsl_sage", {})],
         4: [("moe_2x2", "qwen3-moe-30b-a3b", 2, "kernel", "heron",
              {"jax_step": True})]}


def remat_cases(inp, out, world):
    for tag, name, mp, stream, method, opts in REMAT[world]:
        rules = SH.AxisRules(mesh=make_local_mesh(mp), enable_fsdp=False)
        cfg = config(name, stream, opts)
        assert cfg.remat
        batch = batch_of(inp, cfg, opts)
        runs = []
        for c in (cfg, cfg.replace(remat=False)):
            new, m, _ = run_step(c, rules, method, stream, inp, batch, opts)
            runs.append({"state": new, "metrics": m})
        want = dict(tree_leaves_with_path(runs[1]))
        fails = [f"{path}: max |d| {float((got - want[path]).abs().max())}"
                 for path, got in tree_leaves_with_path(runs[0])
                 if isinstance(got, torch.Tensor)
                 and not torch.equal(got, want[path])]
        out[f"remat|{tag}_{stream}_{method}|fail"] = np.array("\n".join(
            fails))


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def moe_config(cf, shared):
    """The one-layer MoE of a ``torch_moe_ep_cases`` case."""
    return ModelConfig(
        name="t", n_layers=1, d_model=MC.D_MODEL, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=64,
        moe=MoECfg(n_experts=MC.N_EXPERTS, top_k=MC.TOP_K,
                   d_ff_expert=MC.D_FF, capacity_factor=cf,
                   n_shared_experts=shared),
        param_dtype="float32", compute_dtype="float32")


def moe_case(case, out):
    """``moe_ep`` forward and backward on this rank's slabs of the
    case's params and batch."""
    (nd, nm), cf, shared, (B, S) = MC.CASES[case]
    mesh = make_local_mesh(nm)
    assert mesh.shape == {"data": nd, "model": nm}, mesh.shape
    rules = SH.AxisRules(mesh=mesh, enable_fsdp=False)
    cfg = moe_config(cf, shared)
    params, x, w = MC.inputs(case)
    places = tree_map(lambda r: rules.sharding_for(tuple(r.shape), r.axes),
                      M.init_moe(L.RULES, cfg))
    p = tree_map(lambda a, pl: SH.shard(torch.as_tensor(a), pl)
                 .requires_grad_(True), params, places)
    b = place_batch({"inputs": torch.as_tensor(x),
                     "labels": torch.as_tensor(w)}, "cpu", rules)
    split = b["batch_split"]
    xl = b["inputs"].requires_grad_(True)
    with M.recording_drops() as drops:
        y = M.moe_ep(p, xl, cfg, dataclasses.replace(rules,
                                                     batch_split=split))
    leaves = tree_leaves_with_path(p)
    grads = torch.autograd.grad(torch.sum(y * b["labels"]),
                                [xl] + [t for _, t in leaves])
    if split:
        TP.all_reduce_tree(grads[1:], mesh, "data")
    key = f"moe|{case}"
    rows = rules.sharding_for((B,), ("batch",)).bounds[0]
    out[f"{key}|rows"] = np.array(rows)
    out[f"{key}|out"] = y.detach().numpy()
    out[f"{key}|grad|x"] = grads[0].numpy()
    pl = dict(tree_leaves_with_path(places))
    for (path, _), g in zip(leaves, grads[1:]):
        out[f"{key}|grad|{path}"] = g.numpy()
        out[f"{key}|bounds|{path}"] = np.array(pl[path].bounds)
    # the drops of the distinct token slabs: every rank's on the exchange,
    # the data group's in the global view over a split batch, this
    # rank's where the batch is whole on every rank
    ep = nm > 1 and S % nm == 0 and (nd == 1 or split)
    n = torch.tensor(sum(drops))
    for a in (("data", "model") if ep else ("data",) if split else ()):
        n = TP.reduce_from(n, mesh, a)
    with M.recording_drops() as plain:
        M.moe_ep_plain(tree_map(torch.as_tensor, params), torch.as_tensor(x),
                       cfg, nd, nm)
    out[f"{key}|drops"] = np.array([int(n), sum(plain)])


_MIXERS = {"rg_lru": (REC.init_rg_lru, REC.rg_lru_block),
           "mlstm": (REC.init_mlstm, REC.mlstm_block),
           "slstm": (REC.init_slstm, REC.slstm_block)}
# world -> [(case, config, mixer, config changes)]: each recurrent mixer
# on (1, world); on (1, 4) also the edge layouts: the "heads" slab below
# a head (2 heads of 16 over 4 ranks) and an lru width the model axis
# does not divide (66: the rules leave the block whole)
REC_LAYERS = {2: [("rg_lru", "recurrentgemma-9b", "rg_lru", {}),
                  ("mlstm", "xlstm-1.3b", "mlstm", {}),
                  ("mlstm_chunked", "xlstm-1.3b", "mlstm",
                   {"mlstm_chunk": 4}),
                  ("slstm", "xlstm-1.3b", "slstm", {})],
              4: [("rg_lru", "recurrentgemma-9b", "rg_lru", {}),
                  ("rg_lru_w66", "recurrentgemma-9b", "rg_lru",
                   {"lru_width": 66}),
                  ("mlstm", "xlstm-1.3b", "mlstm", {}),
                  ("mlstm_2heads", "xlstm-1.3b", "mlstm",
                   {"n_heads": 2, "n_kv_heads": 2}),
                  ("slstm", "xlstm-1.3b", "slstm", {})]}
# a block on its slabs against the whole block: rtol 1e-5 and an
# absolute floor of 4e-6 x max|ref| (measured: 5e-7 x max)
LAYER_RTOL, LAYER_ATOL = 1e-5, 4e-6


def _close(got, want):
    return torch.allclose(got, want, rtol=LAYER_RTOL,
                          atol=LAYER_ATOL * float(want.abs().max()))


def rec_layer_cases(out, world):
    """Each case's block on this rank's slabs of seeded params (their
    1-D leaves moved off their init, so a bias read at the wrong columns
    shows) against the whole block on the same inputs: the output, the
    input's gradient and each slab's gradient of ``sum(out * w)``."""
    mesh = make_local_mesh(world)
    rules = SH.AxisRules(mesh=mesh, enable_fsdp=False)
    for case, name, mixer, changes in REC_LAYERS[world]:
        cfg = get_config(name, True).replace(**changes)
        init, block = _MIXERS[mixer]
        gen = torch.Generator().manual_seed(0)
        full = tree_map(lambda t: t + 0.1 * torch.randn(
            t.shape, generator=gen) if t.dim() == 1 else t, init(gen, cfg))
        places = tree_map(lambda r: rules.sharding_for(r.shape, r.axes),
                          init(L.RULES, cfg))
        rng = np.random.default_rng(7)
        x, w = (torch.as_tensor(rng.standard_normal(
            (2, 12, cfg.d_model)).astype(np.float32)) for _ in "xw")
        res = []
        for p, r in ((full, None), (tree_map(SH.shard, full, places),
                                    rules)):
            p = tree_map(lambda t: t.clone().requires_grad_(True), p)
            xr = x.clone().requires_grad_(True)
            widths, scan = [], REC.O.rg_lru_scan

            def counted(a, b):
                widths.append(a.shape[-1])
                return scan(a, b)
            REC.O.rg_lru_scan = counted
            try:
                y, _ = block(p, xr, cfg, rules=r)
            finally:
                REC.O.rg_lru_scan = scan
            leaves = tree_leaves_with_path(p)
            g = torch.autograd.grad(torch.sum(y * w),
                                    [xr] + [t for _, t in leaves])
            res.append((y.detach(), g[0], dict(zip(
                [q for q, _ in leaves], g[1:])), widths))
        (y0, gx0, gp0, _), (y1, gx1, gp1, widths) = res
        fails = [k for k, a, b in (("out", y1, y0), ("grad x", gx1, gx0))
                 if not _close(a, b)]
        pl = dict(tree_leaves_with_path(places))
        fails += [f"grad {path}" for path, g in gp1.items()
                  if not _close(g, SH.shard(gp0[path], pl[path]))]
        out[f"rec|{case}|fail"] = np.array("\n".join(fails))
        out[f"rec|{case}|scan_widths"] = np.array(widths, np.int64)
    # the reduce-scatter pair: each rank's (2, 3, 4 * world) input, the
    # slice of the sum and the gradient of sum(y * w_r), every rank's
    # inputs made here from their seeds
    def draw(seed, shape):
        return torch.as_tensor(
            np.random.default_rng(seed).standard_normal(shape))
    xs = [draw(r, (2, 3, 4 * world)) for r in range(world)]
    ws = [draw(100 + r, (2, 3, 4)) for r in range(world)]
    me = mesh.rank("model")
    xr = xs[me].clone().requires_grad_(True)
    y = TP.reduce_scatter(xr, mesh)
    g, = torch.autograd.grad(torch.sum(y * ws[me]), xr)
    out["rec|reduce_scatter"] = np.array([
        torch.allclose(y, sum(xs)[..., 4 * me:4 * me + 4]),
        torch.equal(g, torch.cat(ws, dim=-1))])


# seamless's cross sub-block on (1, 2): (case, config changes); with one
# kv head its wk / wv slabs are below a head (k / v gathered, each rank's
# q heads in its GQA group), with three q heads wq's too (q gathered,
# wo's row slab fed the rank's columns of every head's output)
CROSS_LAYERS = [("cross", {}), ("cross_kv1", {"n_kv_heads": 1}),
                ("cross_h3", {"n_heads": 3, "n_kv_heads": 1,
                              "head_dim": 16})]


def cross_layer_cases(out):
    """seamless-m4t-medium's smoke cross sub-block (``cross_norm``,
    ``cross``) on this rank's slabs of seeded params (the norm's leaves
    moved off their init) against the whole sub-block on the same x and
    encoder output: the output, the gradients of x and ``enc_out`` and
    each slab's gradient of ``sum(out * w)``."""
    from repro_torch.models import attention as A
    mesh = make_local_mesh(2)
    rules = SH.AxisRules(mesh=mesh, enable_fsdp=False)
    for case, changes in CROSS_LAYERS:
        cfg = get_config("seamless-m4t-medium", True).replace(**changes)

        def init(gen):
            return {"cross_norm": L.init_layernorm(gen, cfg.d_model,
                                                   torch.float32),
                    "cross": A.init_attention(gen, cfg)}
        gen = torch.Generator().manual_seed(0)
        full = tree_map(lambda t: t + 0.1 * torch.randn(
            t.shape, generator=gen) if t.dim() == 1 else t, init(gen))
        places = tree_map(lambda r: rules.sharding_for(r.shape, r.axes),
                          init(L.RULES))
        rng = np.random.default_rng(11)
        x, enc, w = (torch.as_tensor(rng.standard_normal(
            (2, s, cfg.d_model)).astype(np.float32)) for s in (12, 10, 12))
        res = []
        for p, r in ((full, None), (tree_map(SH.shard, full, places),
                                    rules)):
            p = tree_map(lambda t: t.clone().requires_grad_(True), p)
            xr, er = (t.clone().requires_grad_(True) for t in (x, enc))
            y = T._cross_attention(p, xr, cfg, er, r)
            leaves = tree_leaves_with_path(p)
            g = torch.autograd.grad(torch.sum(y * w),
                                    [xr, er] + [t for _, t in leaves])
            res.append((y.detach(), g[0], g[1], dict(zip(
                [q for q, _ in leaves], g[2:]))))
        (y0, gx0, ge0, gp0), (y1, gx1, ge1, gp1) = res
        fails = [k for k, a, b in (("out", y1, y0), ("grad x", gx1, gx0),
                                   ("grad enc_out", ge1, ge0))
                 if not _close(a, b)]
        pl = dict(tree_leaves_with_path(places))
        fails += [f"grad {path}" for path, g in gp1.items()
                  if not _close(g, SH.shard(gp0[path], pl[path]))]
        if not any(pl[f"cross/{k}/w"].sharded for k in ("wq", "wk", "wo")):
            fails.append("no sharded cross leaf")
        out[f"cross|{case}|fail"] = np.array("\n".join(fails))


def lora_dense_case(out, world):
    """A column- and a row-parallel dense layer with LoRA adapters (a
    non-zero ``lora_b``: a step from the adapters' init has ``lora_b``
    zero, so ``lora_a``'s gradient is zero and one step cannot tell) on
    this rank's slabs against the whole layer: the output and every
    slab's gradient of ``sum(out * w)``.  The column layer's replicated
    ``lora_a`` is read for the rank's columns alone; its gradient must
    be summed over "model"."""
    mesh = make_local_mesh(world)
    rules = SH.AxisRules(mesh=mesh, enable_fsdp=False)
    fails = []
    for mode, (d_in, d_out), axes in (("col", (16, 24), L.MLP_AXES),
                                      ("row", (24, 16), L.MLP_AXES[::-1])):
        gen = torch.Generator().manual_seed(3)
        full = {"w": torch.randn((d_in, d_out), generator=gen),
                "lora_a": torch.randn((d_in, 4), generator=gen),
                "lora_b": torch.randn((4, d_out), generator=gen)}
        places = {"w": rules.sharding_for((d_in, d_out), axes),
                  "lora_a": rules.sharding_for((d_in, 4), (axes[0], None)),
                  "lora_b": rules.sharding_for((4, d_out), (None, axes[1]))}
        tp = L.DenseTP.of(rules, (d_in, d_out), axes)
        x = torch.randn((2, 5, d_in), generator=gen)
        w = torch.randn((2, 5, d_out), generator=gen)
        res = []
        for p, xin, t in (
                (full, x, None),
                (tree_map(SH.shard, full, places),
                 TP.copy_to(x, mesh) if mode == "col"
                 else x[..., slice(*places["w"].bounds[0])], tp)):
            p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
            y = L.dense(p, xin, tp=t)
            ww = (w[..., slice(*places["w"].bounds[1])]
                  if t is not None and mode == "col" else w)
            res.append((y.detach(), dict(zip(p, torch.autograd.grad(
                torch.sum(y * ww), list(p.values()))))))
        (y0, g0), (y1, g1) = res
        if not _close(y1, SH.shard(y0, rules.sharding_for(
                tuple(y0.shape), (None, None, axes[1])))):
            fails.append(f"{mode} out")
        fails += [f"{mode} grad {k}" for k in g1
                  if not _close(g1[k], SH.shard(g0[k], places[k]))]
    out["lora|fail"] = np.array("\n".join(fails))


# world -> [(tag, config, model_parallel[, capacity factor])]: the whole
# model's forward under the rules (a MoE at n_experts / top_k, so no slab
# drops)
PREFILL = {4: [("gpt2_2x2", "gpt2-tiny", 2), ("qwen_1x4", "qwen2-1.5b", 4),
               ("moe_2x2", "qwen3-moe-30b-a3b", 2, 4.0),
               ("vlm_1x4", "qwen2-vl-2b", 4),
               ("audio_2x2", "seamless-m4t-medium", 2)],
           2: [("rg_1x2", "recurrentgemma-9b", 2),
               ("xlstm_1x2", "xlstm-1.3b", 2),
               ("kimi_1x2", "kimi-k2-1t-a32b", 2, 4.0)]}
PREFILL_TOL = dict(rtol=2e-5, atol=2e-5)
# xlstm's f32 stack is ill-conditioned (ROADMAP queue 3): its forwards
# are held at an absolute floor of 1e-4 x max|logits|, as in
# torch_serve_parity
XLSTM_FLOOR = 1e-4


def prefill_cases(inp, out, world):
    """The sharded prefill of each ``PREFILL`` case against the slab of
    the unsharded one's logits."""
    for tag, name, mp, *cf in PREFILL[world]:
        cfg = config(name, "xla", {"cf": cf[0]} if cf else None)
        xlstm = cfg.family == "ssm"
        rules = SH.AxisRules(mesh=make_local_mesh(mp), enable_fsdp=False)
        params = T.init_lm(cfg, seed=0, device="cpu")
        batch = batch_of(inp, cfg)
        with torch.no_grad():
            full = P.make_prefill_step(cfg)(params, batch)
            got = P.make_prefill_step(cfg, rules)(
                SH.shard_tree(params, T.param_shardings(cfg, rules)),
                place_batch(batch, "cpu", rules))
        want = SH.shard(full, rules.sharding_for(
            full.shape, ("batch", None, "vocab")))
        tol = dict(rtol=0.0, atol=XLSTM_FLOOR * float(full.abs().max())) \
            if xlstm else PREFILL_TOL
        fails = []
        if got.shape != want.shape:
            fails.append(f"logits {tuple(got.shape)}, the slab "
                         f"{tuple(want.shape)}")
        elif not torch.allclose(got, want, **tol):
            fails.append(f"max err {float((got - want).abs().max()):.3g}")
        out[f"prefill|{tag}|fail"] = np.array("\n".join(fails))
        out[f"prefill|{tag}|cut"] = np.array(tuple(got.shape) !=
                                            tuple(full.shape))


def remesh_case(out):
    """``fault.remesh`` over the four ranks: (2, 2), and (4, 1) where the
    model axis does not divide the world."""
    out["misc|remesh"] = np.array([list(F.remesh(m).shape.values())
                                   for m in (2, 3)])


def sphere_case(inp, out):
    """The threefry sphere on (1, 2) over qwen2-1.5b's smoke client: this
    rank's slabs and the norm all-reduced over the model group, beside
    the unsharded draw's slabs and norm; and the client through the
    bridge to this rank's slabs and gathered back."""
    rules = SH.AxisRules(mesh=make_local_mesh(2), enable_fsdp=False)
    cfg = config("qwen2-1.5b", "threefry")
    client = T.init_lm(cfg, device="cpu", key=R.PRNGKey(0))["client"]
    places = T.param_shardings(cfg, rules)["client"]
    key = R.PRNGKey(3)
    z = Z.normal_like(key, SH.shard_tree(client, places), places)
    out["misc|sphere_norm"] = np.array([
        float(Z.global_norm(z, places)),
        float(Z.global_norm(Z.normal_like(key, client)))])
    # the bridge: numpy leaves cut to the slabs and gathered back
    full_np = to_numpy(client)
    out["misc|bridge_roundtrip"] = np.array(all(
        np.array_equal(a, b) for (_, a), (_, b) in zip(
            tree_leaves_with_path(to_numpy(from_jax(full_np, "cpu", places),
                                           places)),
            tree_leaves_with_path(full_np))))
    u = Z.unit_sphere_like(key, SH.shard_tree(client, places), places)
    full = Z.unit_sphere_like(key, client)
    pl = dict(tree_leaves_with_path(places))
    for path, t in tree_leaves_with_path(u):
        out[f"misc|sphere|{path}"] = np.stack([
            t.numpy(), SH.shard(_leaf(full, path), pl[path]).numpy()])


def bridge_case(out):
    """seamless-m4t-medium's smoke tree (``dec_embed``, the decoder's
    cross sub-blocks) through the bridge to this rank's slabs on (1, 2):
    each leaf the slab of the numpy leaf, and the slabs gathered back
    bit for bit; how many leaves are cut."""
    rules = SH.AxisRules(mesh=make_local_mesh(2), enable_fsdp=False)
    cfg = config("seamless-m4t-medium", "kernel")
    full_np = to_numpy(T.init_lm(cfg, device="cpu", key=R.PRNGKey(0)))
    places = T.param_shardings(cfg, rules)
    slabs = from_jax(full_np, "cpu", places)
    pl = dict(tree_leaves_with_path(places))
    want = dict(tree_leaves_with_path(full_np))
    cut = [p for p, t in tree_leaves_with_path(slabs) if pl[p].sharded]
    out["misc|bridge_s2s"] = np.array([
        all(torch.equal(t, SH.shard(torch.as_tensor(want[p]), pl[p]))
            for p, t in tree_leaves_with_path(slabs)),
        all(np.array_equal(a, want[p]) for p, a in tree_leaves_with_path(
            to_numpy(slabs, places))),
        "server/dec_embed/table" in cut,
        any("/cross/" in p for p in cut)])


# the checkpoint cases: (config, its directory and keys' suffix)
CKPT_CASES = [("gpt2-tiny", ""), ("recurrentgemma-9b", "_rg"),
              ("seamless-m4t-medium", "_s2s")]


def checkpoint_case(inp, out, workdir, name="gpt2-tiny", tag=""):
    """A HERON step on (1, 2) saved (rank 0 writes the gathered state),
    then restored on one device (a template of full leaves) and on the
    mesh: the next step from either equals the mesh's next step."""
    mesh = make_local_mesh(2)
    rules = SH.AxisRules(mesh=mesh, enable_fsdp=False)
    cfg = config(name, "kernel")
    batch = batch_of(inp, cfg)
    new, _, places = run_step(cfg, rules, "heron", "kernel", inp, batch)
    ckpt = os.path.join(workdir, f"ckpt{tag}")
    CKPT.save(ckpt, 1, new, shardings=places)
    back, step = CKPT.restore(ckpt, new, shardings=places)
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_leaves_with_path(back), tree_leaves_with_path(new))
        if isinstance(a, torch.Tensor))
    out[f"misc|ckpt_mesh_roundtrip{tag}"] = np.array([same, step == 1])
    api = P.lm_api(cfg, rules)
    zo = Z.ZOConfig(mu=float(inp["kernel_rates"][0]), scale="gaussian")
    copt = OPT.zo_sgd(float(inp["kernel_rates"][1]))
    sopt = OPT.adamw(float(inp["fo_rates"][1]), eps=float(inp["fo_rates"][2]))
    nxt, _ = P.make_train_step(api, "heron", zo, copt, sopt)(
        back, place_batch(batch, "cpu", rules))
    full = SH.gather_tree(nxt["params"], places["params"])
    if dist.get_rank() == 0:
        for path, t in tree_leaves_with_path(full):
            out[f"misc|ckpt_next_mesh{tag}|{path}"] = t.numpy()
    dist.barrier()


DRIVER = ["--arch", "qwen2-1.5b", "--smoke", "--batch", "2", "--seq", "16",
          "--device", "cpu", "--steps", "2", "--zo-mu", "1e-2",
          "--lr-client", "1e-3", "--lr-server", "1e-4"]
# the driver on seamless-m4t-medium's smoke config: (key suffix, arch)
DRIVER_ARCHS = [("", "qwen2-1.5b"), ("_s2s", "seamless-m4t-medium")]


def driver_args(arch):
    return ["--arch", arch] + DRIVER[2:]


def driver_case(out, workdir, arch="qwen2-1.5b", tag=""):
    """``launch.train --arch ARCH --model-parallel 2`` on the two ranks
    (the group running, as torchrun's would be): its exit code and what
    each rank prints (rank 0 alone prints)."""
    import contextlib
    import io

    from repro_torch.launch import train as TRAIN
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = TRAIN.main(driver_args(arch) + [
            "--model-parallel", "2", "--ckpt-dir",
            os.path.join(workdir, f"driver_ckpt{tag}")])
    out[f"misc|driver_run{tag}"] = np.array([str(rc), buf.getvalue()])


def run_rank(rank, world, workdir):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
        out = {}
        for case in MC.world_cases(world):
            moe_case(case, out)
        step_cases(inp, out, world)
        remat_cases(inp, out, world)
        prefill_cases(inp, out, world)
        rec_layer_cases(out, world)
        lora_dense_case(out, world)
        if world == 4:
            remesh_case(out)
        else:
            cross_layer_cases(out)
            sphere_case(inp, out)
            bridge_case(out)
            for name, tag in CKPT_CASES:
                checkpoint_case(inp, out, workdir, name, tag)
            for tag, arch in DRIVER_ARCHS:
                driver_case(out, workdir, arch, tag)
        SERVE.run_cases(out, world)
        blocked = sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "repro"))
        assert not blocked, blocked
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def spawn(world, workdir, inputs, timeout_s):
    """Run :func:`run_rank` on ``world`` ranks (one process each) on
    ``inputs``; their results, rank by rank.  A spawn that outlives
    ``timeout_s`` is killed and fails the test."""
    np.savez(os.path.join(workdir, "inputs.npz"), **inputs)
    ctx = mp.start_processes(run_rank, args=(world, workdir), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"the {world}-rank spawn ran past {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
            for r in range(world)]
