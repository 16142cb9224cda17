#!/usr/bin/env python3
"""Drive the PyTorch port of HERON-SFL (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):
  1. card: name and power limit, torch and CUDA versions; build the CUDA
     kernels from src/repro_torch/kernels/csrc with nvcc;
  2. K1 zo_noise vs its plain version: bit equality;
  3. K2 zo_dual_matmul vs plain at gpt2-small's client shapes;
  4. K3 zo_dual_flash_attention vs plain, both probe modes, plus GQA,
     window, soft-cap and ragged lengths;
  5. one HERON-SFL round on gpt2-small at full width (N=2 clients, h=1,
     n_pairs=1, 4 x 256 tokens each, lean seed-replay uplink): losses,
     uplink bytes, wall time, peak memory and kernel launch counts; and a
     small round on the card held against the same round on the CPU;
  6. kernel times (CUDA events, median) beside the plain version, a
     PyTorch library yardstick and the card's bound.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # f32 off tensor cores
HASH_OPS = 21          # integer and float operations per K1 element
REPS = 30


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def fail(msg):
    raise RuntimeError(msg)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _spin_cycles_per_ms():
    import torch
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(10 ** 7)
    e.record()
    torch.cuda.synchronize()
    return 1e7 / s.elapsed_time(e)


def time_ms(fn, reps=REPS):
    """Median device time of one call of ``fn`` in ms.

    ``reps`` calls run back to back with a CUDA event between each two.
    A spin kernel holds the card first, long enough for the host to
    enqueue every call, so the events time the device's work and not the
    host's Python dispatch between launches."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(int(_spin_cycles_per_ms() * (2 * host_ms + 1)))
    evs[0].record()
    for i in range(reps):
        fn()
        evs[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(evs[i].elapsed_time(evs[i + 1])
                             for i in range(reps))


def bound_ms(n_bytes, n_ops, dtype_name):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# phases 2-4: each kernel against its plain version
# ---------------------------------------------------------------------------

def k1_fields(dev):
    """(seed, (rows, cols), row_offset) of the fields K1 draws on the
    gpt2-small round: each client leaf whole on its canonical 2-D view
    (the client direction and the server's replay; the tied table is the
    largest), and each leaf's last leading-axis slice at its row offset
    (a stacked leaf's last rep, as the per-rep norm perturbation reads
    it), plus a 1024x3072 window at row_offset 2*768."""
    from repro_torch.configs.gpt2 import gpt2_small
    from repro_torch.kernels import ops as O
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    client = T.init_lm(gpt2_small(), seed=0, device=dev)["client"]
    out = [(-123456789, (1024, 3072), 2 * 768)]
    for p, s in zip(tree_leaves(client), tree_leaves(
            O.leaf_seed_tree(client, -123456789))):
        shape = tuple(p.shape)
        rows = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        out.append((s, (rows, shape[-1]), 0))
        if len(shape) > 1:
            per = rows // shape[0]
            out.append((s, (per, shape[-1]), (shape[0] - 1) * per))
    return sorted(set(out), key=lambda f: -f[1][0] * f[1][1])


def check_k1(dev):
    import torch
    from repro_torch.kernels import noise as N
    from repro_torch.kernels import zo_matmul as ZM
    fields = k1_fields(dev)
    for seed, shape, off in fields:
        got = ZM.zo_noise(seed, shape, off, 0, device=dev)
        ref = N.uniform_noise(seed, shape, off, 0, device=dev)
        if not torch.equal(got, ref):
            fail(f"K1 field {shape} at row_offset {off} seed {seed} differs "
                 f"from plain: max |d| = {max_abs(got, ref)}")
        del got, ref
    rng = np.random.default_rng(1)
    ids = torch.as_tensor(np.append(rng.integers(0, 50432, 4 * 256 - 1),
                                    50431).reshape(4, 256), device=dev)
    got_r = ZM.zo_noise_rows(-7, ids, 768)
    cols = torch.arange(768, device=dev)
    ref_r = N.uniform_noise_at(-7, ids[..., None], cols)
    if not torch.equal(got_r, ref_r):
        fail(f"K1 rows differ from plain: max |d| = {max_abs(got_r, ref_r)}")
    log(2, f"K1 zo_noise == plain bit for bit: {len(fields)} fields (every "
        f"gpt2-small client leaf whole and its last leading slice at its "
        f"row offset, the largest {fields[0][1]}; (1024, 3072) at "
        f"row_offset 1536), seed -123456789 and the leaf seeds; rows (4, "
        f"256) ids <= 50431 x 768")
    return 0.0


def k2_inputs(dev, dtype, M, K, Nn, seed=0):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    xa = torch.randn((M, K), generator=g, device=dev).to(dtype)
    xb = torch.randn((M, K), generator=g, device=dev).to(dtype)
    w = (torch.randn((K, Nn), generator=g, device=dev) * K ** -0.5
         ).to(dtype)
    return xa, xb, w


K2_SHAPES = ((768, 768), (768, 3072), (3072, 768))
K2_FLAGS = ((False, True, 0.0, 1e-3), (True, True, 1e-3, -1e-3))


def k2_plain(xa, xb, w, seed, mu_a, mu_b, pa, pb, off):
    from repro_torch.kernels import noise as N
    from repro_torch.kernels import ref as R
    u = N.uniform_noise(seed, w.shape, off, device=w.device)
    return R.zo_dual_matmul_ref(xa, xb, w, u, mu_a, mu_b, perturb_a=pa,
                                perturb_b=pb)


def check_k2(dev):
    """Tolerance: f32 sums in another order differ by ~sqrt(K) f32 ulps,
    so |d| <= 1e-4 * max|ref|.  In bf16 the kernel and the plain version
    round the same f32 value to bf16; where their f32 sums straddle a
    rounding boundary they differ by one bf16 step, 2^-7 relative, so
    |d| <= 2^-7 |ref| + 1e-4 max|ref| elementwise.  A wrong noise, row
    offset or stream flag moves the outputs by ~mu*sqrt(K)*|x|, far
    above both."""
    import torch
    from repro_torch.kernels import zo_matmul as ZM
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for K, Nn in K2_SHAPES:
            xa, xb, w = k2_inputs(dev, dtype, 1024, K, Nn)
            for pa, pb, mu_a, mu_b in K2_FLAGS:
                # mu 1e-3 on the main path; 0.5 makes a wrong U visible
                for scale in (1.0, 500.0):
                    ma, mb = mu_a * scale, mu_b * scale
                    off = 2 * K
                    ya, yb = ZM.zo_dual_matmul(xa, xb, w, -99, ma, mb,
                                               row_offset=off, perturb_a=pa,
                                               perturb_b=pb)
                    ra, rb = k2_plain(xa, xb, w, -99, ma, mb, pa, pb, off)
                    for got, ref in ((ya, ra), (yb, rb)):
                        d = (got.float() - ref.float()).abs()
                        r = ref.float().abs()
                        if dtype == torch.float32:
                            ok = bool((d <= 1e-4 * r.max()).all())
                        else:
                            ok = bool((d <= 2 ** -7 * r + 1e-4 * r.max())
                                      .all())
                        if not ok:
                            fail(f"K2 {dtype} {K}x{Nn} flags {pa},{pb} mu "
                                 f"{ma},{mb}: max |d| {float(d.max())}")
                        key = (f"{str(dtype).split('.')[-1]} mu "
                               f"{'1e-3' if scale == 1.0 else '0.5'}")
                        worst[key] = max(worst.get(key, 0.0),
                                         float(d.max()))
    log(3, f"K2 zo_dual_matmul == plain within tolerance at M=1024, K x N "
        f"in {K2_SHAPES}, flags (F,T),(T,T): max |d| {worst}")
    return worst["bfloat16 mu 1e-3"]      # the main path's type and mu


def k3_inputs(dev, dtype, B, S, H, Kv, D, seed=0):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa
    return (mk(B, S, H, D), mk(B, S, H, D), mk(B, S, Kv, D),
            mk(B, S, Kv, D), mk(B, S, Kv, D), mk(B, S, Kv, D))


def k3_cases():
    # (name, B, S, H, Kv, kwargs); the main path's shape first
    return [("gpt2-small", 4, 256, 12, 12, dict()),
            ("gqa-window-cap-ragged", 2, 200, 8, 2,
             dict(window=64, cap=30.0))]


def check_k3(dev):
    """Tolerance: f32 |d| <= 1e-4 (outputs are convex combinations of v,
    |v| < 5; the online softmax sums in another order than the full
    softmax).  bf16: one bf16 rounding step of the output, 2^-7 |ref|,
    plus 1e-3."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import noise as N
    from repro_torch.kernels import ref as R
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, B, S, H, Kv, kw in k3_cases():
            qa, qb, k, v, kb, vb = k3_inputs(dev, dtype, B, S, H, Kv, 64)
            u = N.uniform_noise(77, (H * S, S), 5 * H * S,
                                device=dev).reshape(H, S, S)
            modes = [("weights", dict(kb=kb, vb=vb, perturb_a=False,
                                      perturb_b=False)),
                     ("scores", dict(perturb_a=False, perturb_b=True,
                                     mu_b=0.5)),
                     ("scores-antithetic", dict(perturb_a=True,
                                                perturb_b=True, mu_a=0.5,
                                                mu_b=-0.5))]
            for mode, mkw in modes:
                oa, ob = FA.zo_dual_flash_attention(
                    qa, qb, k, v, seed=77, row_offset=5 * H * S, **mkw, **kw)
                ra, rb = R.zo_dual_flash_attention_ref(
                    qa, qb, k, v, u=u, **mkw, **kw)
                for got, ref in ((oa, ra), (ob, rb)):
                    d = (got.float() - ref.float()).abs()
                    tol = (1e-4 if dtype == torch.float32
                           else 2 ** -7 * ref.float().abs() + 1e-3)
                    if not bool((d <= tol).all()):
                        fail(f"K3 {dtype} {name} {mode}: max |d| "
                             f"{float(d.max())}")
                    key = f"{str(dtype).split('.')[-1]} {name} {mode}"
                    worst[key] = max(worst.get(key, 0.0), float(d.max()))
    log(4, "K3 zo_dual_flash_attention == plain within tolerance: "
        "B4 S256 H12 D64 and B2 S200 H8 Kv2 window 64 cap 30; weights, "
        f"scores and antithetic scores modes: max |d| {worst}")
    return worst["bfloat16 gpt2-small weights"]   # the main path's case


# ---------------------------------------------------------------------------
# phase 5: the round
# ---------------------------------------------------------------------------

def _round_setup(cfg, dev, n_clients, h, batch, seq, mu, lr, server_lr,
                 seed=0):
    import torch
    from repro_torch.core import protocols as P
    from repro_torch.core import zo as Z
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import adamw, zo_sgd
    params = T.init_lm(cfg, seed=seed, device=dev)
    sopt = adamw(server_lr)
    state = {"client": params["client"], "server": params["server"],
             "opt_server": sopt.init(params["server"])}
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab,
                                        (n_clients, h, batch, seq + 1)),
                           device=dev)
    rb = {"inputs": toks[..., :-1], "labels": toks[..., 1:]}
    rnd = P.make_fed_round(P.lm_api(cfg), "heron",
                           Z.ZOConfig(mu=mu, n_pairs=1),
                           P.FedConfig(n_clients=n_clients, h=h),
                           zo_sgd(lr), sopt, uplink="seed_replay",
                           client_lr=lr)
    return state, rb, rnd


def launch_counts():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import zo_matmul as ZM
    return {**ZM.LAUNCHES, **FA.LAUNCHES}


def reset_counts():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import zo_matmul as ZM
    for d in (ZM.LAUNCHES, FA.LAUNCHES):
        for k in d:
            d[k] = 0


def run_round(dev):
    import torch
    from repro_torch.configs.gpt2 import gpt2_small
    from repro_torch.tree import tree_leaves
    cfg = gpt2_small()
    state, rb, rnd = _round_setup(cfg, dev, n_clients=2, h=1, batch=4,
                                  seq=256, mu=1e-3, lr=1e-4,
                                  server_lr=2e-4)
    rnd(state, rb, 20261016)                 # warm-up round
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    new_state, m = rnd(state, rb, 20261016)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    cl, sl = float(m["client_loss"]), float(m["server_loss"])
    if not (np.isfinite(cl) and np.isfinite(sl)):
        fail(f"round losses not finite: client {cl} server {sl}")
    for t in tree_leaves(new_state["client"]) + tree_leaves(
            new_state["server"]):
        if not bool(torch.isfinite(t.float()).all()):
            fail("round produced non-finite parameters")
    moved = any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(state["client"]), tree_leaves(new_state["client"])))
    if not moved:
        fail("the seed-replay aggregate left every client leaf unchanged")
    if counts["zo_dual_matmul"] != 48 or counts["zo_dual_flash_attention"] \
            != 8 or counts["zo_noise"] <= 0:
        fail(f"launch counts {counts}: expected 48 K2, 8 K3 and > 0 K1")
    log(5, f"gpt2-small round (N=2 h=1 n_pairs=1, 4x256 tokens per client, "
        f"seed_replay): client_loss {cl} server_loss {sl} uplink_bytes "
        f"{m['uplink_bytes']} uplink_bytes_dense {m['uplink_bytes_dense']} "
        f"wall_s {wall} max_memory_allocated {peak} launches {counts}")
    profile_round(rnd, state, rb, wall)
    return counts


def profile_round(rnd, state, rb, wall_s):
    """Device time of one more round by kernel (torch.profiler), and the
    card's idle share of the unprofiled round's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rnd(state, rb, 20261016)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        rows.append((us, ev.count, ev.key))
    busy_ms = sum(r[0] for r in rows) / 1e3
    if busy_ms <= 0:
        log(5, "profile: the profiler saw no device time (not measured)")
        return
    rows.sort(reverse=True)
    top = "; ".join(f"{k[:48]} x{n} {us / 1e3:.3f} ms" for us, n, k in
                    rows[:8])
    log(5, f"profile: device busy {busy_ms:.3f} ms of the round's "
        f"{1e3 * wall_s:.3f} ms wall (idle share "
        f"{1 - busy_ms / (1e3 * wall_s):.3f}); top kernels: {top}")


def check_small_round(dev):
    """The same small round on the card and on the CPU: the card runs
    the kernels, the CPU their plain versions.  Tolerance: losses rtol
    1e-4; params |d| <= 1e-5 + 1e-4 |p| (f32, other summation orders,
    amplified by 1/mu in the coefficient).  The server's lr is small
    because its first AdamW step, ~g/|g|, turns rounding in a near-zero
    gradient into an O(lr) change."""
    import torch
    from repro_torch.configs.gpt2 import gpt2_tiny
    from repro_torch.tree import tree_leaves
    cfg = gpt2_tiny()
    out = {}
    for d in (dev, torch.device("cpu")):
        state, rb, rnd = _round_setup(cfg, d, n_clients=2, h=2, batch=2,
                                      seq=32, mu=1e-2, lr=1e-3,
                                      server_lr=1e-4, seed=3)
        new, m = rnd(state, rb, 77)
        out[d.type] = (new, m)
    (gc, mc), (pc, mp) = out["cuda"], out["cpu"]
    for k in ("client_loss", "server_loss"):
        a, b = float(mc[k]), float(mp[k])
        if not abs(a - b) <= 1e-4 * abs(b):
            fail(f"small round {k}: card {a} vs cpu {b}")
    worst = 0.0
    for part in ("client", "server"):
        for a, b in zip(tree_leaves(gc[part]), tree_leaves(pc[part])):
            a, b = a.cpu().float(), b.float()
            d = (a - b).abs()
            if not bool((d <= 1e-5 + 1e-4 * b.abs()).all()):
                fail(f"small round {part} params: max |d| {float(d.max())}")
            worst = max(worst, float(d.max()))
    log(5, f"gpt2-tiny round (N=2 h=2) on the card == on the CPU: losses "
        f"{float(mc['client_loss'])} / {float(mc['server_loss'])}, max "
        f"param |d| {worst}")


# ---------------------------------------------------------------------------
# phase 6: times
# ---------------------------------------------------------------------------

def time_kernels(dev, counts, errs):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import noise as N
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import zo_matmul as ZM
    rows = []

    # K1: the tied-table field (the largest U a round draws), a weight
    # leaf's field, and the gathered embedding rows
    k1 = []
    for rr, cc in ((50432, 768), (768, 3072)):
        ms = time_ms(lambda: ZM.zo_noise(5, (rr, cc), device=dev))
        pl = time_ms(lambda: N.uniform_noise(5, (rr, cc), device=dev))
        b, by = bound_ms(4 * rr * cc, HASH_OPS * rr * cc, "float32")
        k1.append((f"field {rr}x{cc}", ms, pl, b, by))
    ids = torch.randint(0, 50257, (8, 256), device=dev)
    cols = torch.arange(768, device=dev)
    ms = time_ms(lambda: ZM.zo_noise_rows(5, ids, 768))
    pl = time_ms(lambda: N.uniform_noise_at(5, ids[..., None], cols))
    b, by = bound_ms(4 * ids.numel() * (768 + 1),
                     HASH_OPS * ids.numel() * 768, "float32")
    k1.append(("rows 2048x768", ms, pl, b, by))
    for name, ms, pl, b, by in k1:
        log(6, f"K1 {name}: kernel_ms {ms} plain_ms {pl} bound_ms {b} "
            f"({by})")
    _, ms, pl, b, by = k1[0]
    rows.append({"name": "zo_noise", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/zo_noise.cu",
                 "replaces": "src/repro/kernels/zo_matmul.py:274",
                 "launches": counts["zo_noise"], "max_abs_err": errs[0],
                 "ms": ms, "plain_ms": pl, "bound_ms": b, "bound_by": by,
                 "library_ms": None})

    # K2 at the client shapes, bf16 (the config's compute type)
    k2_rows = []
    for K, Nn in K2_SHAPES:
        xa, xb, w = k2_inputs(dev, torch.bfloat16, 1024, K, Nn)
        ms = time_ms(lambda: ZM.zo_dual_matmul(xa, xb, w, 3, 0.0, 1e-3))
        pl = time_ms(lambda: k2_plain(xa, xb, w, 3, 0.0, 1e-3, False, True,
                                      0))
        wa = w
        wb = (w.float() + 1e-3 * N.uniform_noise(
            3, w.shape, device=dev)).to(torch.bfloat16)
        lib = time_ms(lambda: (torch.matmul(xa, wa), torch.matmul(xb, wb)))
        n_bytes = 2 * (2 * 1024 * K + K * Nn + 2 * 1024 * Nn)
        b, by = bound_ms(n_bytes, 2 * 2 * 1024 * K * Nn, "bfloat16")
        log(6, f"K2 bf16 M=1024 {K}x{Nn}: kernel_ms {ms} plain_ms {pl} "
            f"library_ms {lib} (two bf16 torch.matmul on materialised W, "
            f"W+mu*U) bound_ms {b} ({by})")
        k2_rows.append((K, Nn, ms, pl, lib, b, by))
    _, _, ms, pl, lib, b, by = k2_rows[1]            # 768 x 3072 (up)
    rows.append({"name": "zo_dual_matmul", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/zo_dual_matmul.cu",
                 "replaces": "src/repro/kernels/zo_matmul.py:227",
                 "launches": counts["zo_dual_matmul"], "max_abs_err": errs[1],
                 "ms": ms, "plain_ms": pl, "bound_ms": b, "bound_by": by,
                 "library_ms": lib})

    # K3 at the main path's shape, bf16, both modes
    B, S, H, D = 4, 256, 12, 64
    qa, qb, k, v, kb, vb = k3_inputs(dev, torch.bfloat16, B, S, H, H, D)
    pairs = S * (S + 1) // 2                       # causal (q, kv) pairs
    n_ops = 2 * 4 * D * pairs * B * H              # QK + PV, two streams
    k3 = {}
    for mode, kw in (("weights", dict(kb=kb, vb=vb, perturb_b=False)),
                     ("scores", dict(mu_b=1e-3, seed=9))):
        ms = time_ms(lambda: FA.zo_dual_flash_attention(qa, qb, k, v, **kw))
        if mode == "weights":
            pl = time_ms(lambda: R.zo_dual_flash_attention_ref(
                qa, qb, k, v, kb=kb, vb=vb, perturb_b=False))
            n_in = 6
        else:
            pl = time_ms(lambda: R.zo_dual_flash_attention_ref(
                qa, qb, k, v, u=N.uniform_noise(
                    9, (H * S, S), device=dev).reshape(H, S, S), mu_b=1e-3))
            n_in = 4
        b, by = bound_ms(2 * (n_in + 2) * B * S * H * D, n_ops, "bfloat16")
        k3[mode] = (ms, pl, b, by)
    t = [x.transpose(1, 2).contiguous() for x in (qa, qb, k, v, kb, vb)]
    lib = time_ms(lambda: (
        F.scaled_dot_product_attention(t[0], t[2], t[3], is_causal=True),
        F.scaled_dot_product_attention(t[1], t[4], t[5], is_causal=True)))
    for mode, (ms, pl, b, by) in k3.items():
        log(6, f"K3 bf16 B{B} S{S} H{H} D{D} {mode}: kernel_ms {ms} "
            f"plain_ms {pl} bound_ms {b} ({by})"
            + (f" library_ms {lib} (two causal SDPA calls)"
               if mode == "weights" else ""))
    ms, pl, b, by = k3["weights"]
    rows.append({"name": "zo_dual_flash_attention", "route": "cuda",
                 "source":
                 "src/repro_torch/kernels/csrc/zo_dual_flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:296",
                 "launches": counts["zo_dual_flash_attention"],
                 "max_abs_err": errs[2], "ms": ms, "plain_ms": pl,
                 "bound_ms": b, "bound_by": by, "library_ms": lib})
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    log(1, f"card {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    secs = build.build_all()
    regs = []
    for name in build.SIGNATURES:
        for line in (build.BUILD_DIR / f"{name}.log").read_text(
                errors="replace").splitlines():
            if "registers" in line:
                regs.append(f"{name}: {line.split('ptxas info    :')[-1]}")
    log(1, f"built kernels in {secs:.1f} s")
    for r in regs:
        log(1, r.strip())

    errs = (check_k1(dev), check_k2(dev), check_k3(dev))
    counts = run_round(dev)
    check_small_round(dev)
    rows = time_kernels(dev, counts, errs)

    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
