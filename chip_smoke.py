#!/usr/bin/env python3
"""Drive the PyTorch port of HERON-SFL (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):
  1. card: name, power limit, SM count and top SM clock, torch and CUDA
     versions; build the CUDA kernels from src/repro_torch/kernels/csrc
     with nvcc;
  2. K1 zo_noise vs its plain version, bit for bit (torch.equal): every
     K1 call of a gpt2-small round (recorded, then run again: the theta +
     mu*U trees and the direction trees on fresh inputs, the noise rows on
     the round's token ids), and the field, accumulate and perturb modes
     over the gpt2-small and recurrentgemma-9b client trees (the plain
     version in row windows);
  3. K2 zo_dual_matmul and K4 zo_matmul vs plain at gpt2-small's client
     shapes, K2 also at qwen2-1.5b's, in bf16 and f32 (the tensor-core
     routes, also held to their arithmetic: ref.zo_matmul_split_ref for
     bf16, ref.zo_matmul_tf32x3_ref for f32), and K4 at ResNet-18's (f32:
     block 0's 576x64 convs on the tensor cores, the 27x64 stem and the
     64x10 aux fc on the CUDA-core loop); K4 == K2's streams bit for bit;
     the route counters;
  4. K3 zo_dual_flash_attention and K5 flash_attention vs plain, both
     probe modes, plus GQA, window, soft-cap and ragged lengths, at
     head_dim 8, 64, 112, 128 and 256, bf16 on the tensor-core route and
     on the CUDA-core loop and f32 on the loop; K5 == K3's streams bit for
     bit on both routes; the route counters; head_dim 264 refused;
  5. one HERON-SFL round on gpt2-small at full width (N=2 clients, h=1,
     n_pairs=1, 4 x 256 tokens each, lean seed-replay uplink): losses,
     uplink bytes, wall time, peak memory, device busy time and idle share,
     and kernel launch counts (all 48 K2 and all 8 K3 launches on the
     tensor-core route, K1 as phase 2 recorded); the same round with
     remat off (the server keeps every activation) and remat on,
     alternated, their walls and busy side by side, the launches equal;
     and a small round on the card held against the same round on the
     CPU;
  6. the same for ResNet-18 on 32x32x3 images (N=5 clients, 64 images
     each; 10 of the 20 K2 launches, block 0's convs, on the tensor
     cores), and its small config on the card against the CPU;
  7. the single-probe forwards (Perturb(dual=False): K4 and K5) of
     gpt2-small and ResNet-18, each held against the perturbed half of
     the dual forward on the same seeds; the gpt2-small dual losses
     through K2 against the same with K2 swapped for its plain version;
  8. kernel times (CUDA events, median) beside the plain version, a
     PyTorch library yardstick and the card's bound; K1 per leaf and per
     client tree in each mode beside the composition it replaced (a K1
     launch per leaf and the tensor code); K2 / K4 bf16 on both routes
     (tensor cores and the CUDA-core loop) and the host cost of a launch
     on each; K4 f32 at ResNet-18's block conv on both routes; K3 (both
     modes) and K5 bf16 on both routes at head_dim 64
     (gpt2-small), 128 and 256; the fused dual probe (K2, K3) against two
     single-probe passes (2 x K4, 2 x K5); K6 forward and reverse at the
     RG-LRU round's shapes; each kernel's registers, shared memory and
     spills from the compiler's report, the HGMMA count of the
     tensor-core kernels' SASS and K1's SASS opcode histogram;
  9. K6 rg_lru_scan vs its plain version: forward and reverse mode bit
     for bit at the round's shapes and ragged ones, its autograd backward
     against autograd through the plain loop;
 10. one HERON-SFL round on recurrentgemma-9b at full width, depth cut
     38 -> 8 layers (N=2 clients, h=1, 2 x 512 tokens each, lean
     seed-replay uplink): the RG-LRU client blocks through the whole-block
     fallback (K1 perturb trees, K6 scan), the server's RG-LRU blocks
     through K6 forward (twice: the backward recomputes each checkpointed
     rep, cfg.remat) and backward; and its smoke config on the card
     against the CPU.
 11. the paper's first-order baselines: one round each of CSE-FSL, SFLV1,
     SFLV2 and SplitLoRA (rank-8 adapters) on gpt2-small at phase 5's
     size and of CSE-FSL and SFLV2 on ResNet-18 at phase 6's: losses,
     wall, device busy and idle share, peak memory, uplink bytes, and no
     K1-K5 launch; one client's local step alone, HERON against CSE-FSL
     and SFLV2 (on gpt2-small each with remat on and off), on both
     models: device time and peak memory beside the paper's Table I
     (split.client_costs); a HERON gpt2-small round at
     h=2 with upload_every=2 and the int8 smashed uplink (the server steps
     twice); every method's small round on the card against the CPU,
     CSE-FSL on the recurrentgemma smoke config through K6 forward (and
     again in the backward's recompute) and reverse; K2 f32 at
     ResNet-18's im2col shape timed on the tensor cores (3xTF32) and on
     the CUDA-core loop.
 12. the threefry stream (forward_impl="xla", the reference's default):
     keys, fold_in, split, bits, uniforms, permutation and Bernoulli
     masks against JAX's golden table bit for bit, normals within 4
     ulps, and card vs CPU; HERON rounds on it at full width, gpt2-small
     (gaussian) and ResNet-18 (sphere), with no K1-K6 launch; the time,
     peak and byte bound of one direction draw over each client tree;
     the sphere probe on gpt2-small's bf16 client; gpt2-tiny threefry
     rounds (both scales, mask drawn) and each dense smoke config's
     kernel round on the card against the CPU; one HERON round on
     qwen2-1.5b at full width and depth on the kernel stream (28 K2, 4
     K3 on the tensor cores, 30 K1) with its draw time, every K1 and K2
     launch of that round recorded and run again against the plain
     versions, and K1's three modes over its client tree.
 13. serving (core/decode.DecodeEngine): every arch's smoke config
     (f32) greedy on the card == on the CPU == the eager per-token
     make_serve_step loop on the card, K5 / K6 once per attention /
     RG-LRU layer and admission, and one sampled run card == CPU;
     qwen2-1.5b at full width and depth (bf16, 8 slots, 24 requests of
     256 / 384 / 512 prompt tokens, 128 new) and recurrentgemma-9b at
     full width and depth (38 layers, 4 slots, 8 requests, 64 new): K5
     on the tensor cores once per attention layer and admission, K6 once
     per RG-LRU layer and admission, none in decode segments; prefill and
     decode tok/s, median ms per decode step beside its byte bound, peak
     memory, one segment's device busy time and idle share, the sampler's
     time, the eager loop's tok/s on the queue's shortest-prompt
     requests, and one admission's prefill logits against the plain K5 /
     K6.
 14. the training driver: three HERON datacenter steps
     (core/protocols.make_train_step, AdamW server) on qwen2-1.5b at
     full width and depth, 4 x 256 tokens, every K1 and K2 launch of
     the first recorded and run again against plain, the second's
     launches (14 K2, 2 K3, 14 K1), wall, idle share and peak; from one
     state the async round at buffer_k=0 == the sync seed-replay round
     bit for bit, then buffer_k=1 with durations from the cut planner
     (27 cuts counted on the meta device); gpt2-medium at full width
     (24 layers, cut 6, aux 3 blocks): one step (54 K2, 9 K3), its train
     state through the checkpoint and back bit for bit, a run_resilient
     drill with one injected fault == the uninterrupted steps; the
     launch driver (python -m repro_torch.launch.train, --smoke: the
     bigram table is vocab x vocab) as four processes: 6 checkpointed
     steps, 10 resuming from them, --fed and --fed-async --cutplan; and
     gpt2-tiny's datacenter steps (every method) and async rounds on the
     card against the CPU.
 15. the xLSTM and MoE families: one HERON round on xlstm-1.3b at full
     width and depth (48 layers, mlstm_chunk 64) and one on
     qwen3-moe-30b-a3b at full width cut to 4 layers (N=2, h=1, 4 x 256
     tokens each, the lean uplink): every client block through the
     whole-block fallback, 14 K1 launches and no K2-K6 a round, every K1
     launch of a warm-up round recorded and run again against plain; the
     xlstm-1.3b engine at full width and depth (4 slots, 8 requests, 64
     new; no kernel launch) and the qwen3-moe engine at 4 layers (8
     slots, 24 requests, 64 new; every K5 launch of its admissions held
     against plain); the three smoke configs' kernel and threefry rounds
     on the card against the CPU (their engines are phase 13's).
 16. the modality archs: one HERON round on qwen2-vl-2b at full width
     and depth (M-RoPE on a 16 x 16 patch grid's (3, B, S) ids, float
     patch embeddings: 28 K2, 4 K3 on the tensor cores, 28 K1) and one on
     seamless-m4t-medium (12 + 12 layers, cut 3, float frame embeddings,
     decoder tokens: 36 K2, 6 K3 on the tensor cores, 20 K1), N=2, h=1,
     4 x 256 each, the lean uplink, every K1 / K2 / K3 launch of a
     warm-up round recorded and held against plain; the qwen2-vl engine
     at full width and depth (8 slots, 8 requests of 256 / 384 / 512
     prompt tokens, 64 new; every K5 launch held against plain); the
     seamless enc-dec token loop (launch/serve.enc_dec_stream: batch 4,
     prompt 64, 64 new; no kernel launch) with prompt and decode tok/s
     beside a decode step's byte bound; both smoke configs' kernel and
     threefry rounds and the seamless token loop on the card against the
     CPU (the qwen2-vl smoke engine is phase 13's); the launch drivers
     as processes (train on both archs, serve on seamless).
 17. the cohort mesh (the Fed-Server's sharded and chunked seed replay):
     (a) the kernel-stream replay over qwen2-1.5b's client tree (f32,
     N=16 clients, h=2, n_pairs=1: 32 entries, 3 clients masked): the flat
     walk, chunk=5 and a one-rank NCCL group's shard="clients", each ==
     the flat walk bit for bit; then two ranks as processes on the card
     (gloo: NCCL takes one rank a device), shard and shard + chunk=5, each
     within rtol 1e-5 atol 1e-6 of the flat walk, the ranks' results
     equal bit for bit, shard + chunk equal to shard (the chunk changes
     nothing in the eager walk); K1 launches (a rank's slab), wall ms and peak
     memory per mode and rank; (b) the same for the threefry replay over
     gpt2-small's client tree (N=4, h=1, gaussian); (c) phase 5's
     gpt2-small round with replay_shard="clients", replay_chunk=4 on the
     one-rank NCCL group against the unsharded round (server state bit
     for bit, client within the same bar), and the launch driver with
     --replay-shard clients --replay-chunk 3 as a process.
 18. the datacenter step's ("data", "model") mesh: K2 / K4 on column
     slabs with col_offset, qwen2-1.5b (1, 2) and gpt2-small (2, 2) HERON
     steps as gloo ranks sharing the card against the unsharded step,
     and launch.train --model-parallel 2 under torch.distributed.run.
 19. the expert-parallel MoE (models/moe.moe_ep) on (1, 2) gloo ranks:
     (a) one qwen3-moe-30b-a3b MoE layer at full width in bf16 (its
     capacity factor 1.25, 2 x 256 tokens): each rank's output, dropped
     entries and gradients against moe_ep_plain on the card; (b) one
     HERON step (kernel stream, f32) at full width, 3 of 48 layers,
     capacity factor 16 (no slab drops) against the unsharded step; (c)
     the same in bf16 at capacity factor 1.25, 4 layers, timed, the drops
     of each rank and layer; (d) launch.train --arch qwen3-moe-30b-a3b
     --smoke --model-parallel 2 under torch.distributed.run.
 20. the recurrences on the mesh, (1, 2) gloo ranks: (a) one
     recurrentgemma-9b RG-LRU block at full width in bf16 (2 x 256
     tokens) on each rank's "lru" slab against the whole block on the
     card: output, input gradient and slab gradients, and every K6
     launch (forward and reverse on the (2, 256, 2048) slab) == plain;
     (b) recurrentgemma-9b's HERON step (kernel stream, f32, full width,
     4 of 38 layers) against the unsharded step, every K1 / K6 launch ==
     plain; (c) the same in bf16, timed over 3 steps after the first,
     every K1 / K6 launch of the first == plain; (d) xlstm-1.3b (8 of 48
     layers, the chunkwise mLSTM) likewise, f32 against the unsharded
     step and bf16 timed; (e) launch.train --model-parallel 2 under
     torch.distributed.run for both families' smoke configs.
 21. the vlm and enc-dec families on the mesh, (1, 2) gloo ranks, 2 x
     256 tokens: (a) qwen2-vl-2b's HERON step (kernel stream, f32, full
     width and depth, vision-stub embeddings and grid M-RoPE ids) against
     the unsharded step, launches per rank equal to its, every K1 / K2 /
     K3 launch == plain; (b) the same in the score probe
     (attn_probe="scores"), 4 of 28 layers; (c) seamless-m4t-medium's
     (12 + 12 layers, cut 3: the decoder's cross sub-blocks on the
     rank's heads, dec_embed vocab-parallel) likewise; (d) (a) and (c) in
     bf16, timed over 3 steps after the first, every K1 / K2 / K3 launch
     of the first == plain; (e) launch.train --model-parallel 2 under
     torch.distributed.run for both archs' smoke configs.
 22. the dry-run tooling: (a) one qwen2-1.5b HERON datacenter step (bf16,
     kernel stream, phase 14's 4 x 256 tokens) counted by
     launch/costs.py on meta tensors and on the card, the FLOPs and the
     kernel records equal, every K1-K3 launch of a recorded step ==
     plain, the timed step's wall and profiled busy beside the roofline
     step time (launch/roofline.py), the tracked peak beside
     max_memory_allocated above the bytes held; the same step with
     remat off: its wall, busy and both peaks beside remat on's, its
     updated params within the bf16 bar of remat on's; one launch each of K4,
     K5 and K6 recording the costs of the same call on meta, each ==
     plain; (b) the server's blocked attention at qwen2-1.5b's heads
     (bf16, B 1, S 4096, 1024-chunks) with causal_skip and with
     attn_p_dtype bf16 within the CPU tests' bars, the skip's counted
     FLOPs 10 / 16, the three timed; (c) launch/dryrun.py as processes
     on the host's cores, started after the build (beside phases 2-21;
     phase 22 waits for them): qwen2-1.5b and
     qwen3-moe-30b-a3b train_4k on 16x16, qwen2-1.5b train_4k on
     2x16x16, prefill_32k, and the decode cells (one rank's serve step
     on its slabs) qwen2-1.5b and qwen3-moe-30b-a3b decode_32k and
     recurrentgemma-9b long_500k on 16x16, xlstm-1.3b decode_32k on
     2x16x16, then launch/report.py over their records.
 23. serving over the model axis (core/decode.DecodeEngine(rules=)),
     (1, 2) gloo ranks on the card, each on its slabs: (a) qwen2-1.5b at
     full width and depth in f32 (8 slots, 24 requests of 256 / 384 /
     512 prompt tokens, 8 new): greedy streams == the unsharded
     engine's (run on rank 0) and every rank's, K5 28 an admission on
     the rank's q heads == the unsharded engine's, none in decode
     segments, every K5 launch of both engines recorded == plain; (b)
     recurrentgemma-9b cut 38 -> 4 layers, f32 (4 slots, 8 requests):
     the same, every K6 launch on the rank's lru slab == plain; (c)
     qwen2-1.5b in bf16, phase 13's queue at 16 new: a warm-up on every
     prompt length with every K5 launch recorded == plain, then timed:
     sustained tok/s, ms a decode step against the rank slab's byte
     bound, one segment's busy and idle share, peak, the streams' match
     with phase 13's.  Its decode dry-run cells run in phase 22 (c).
Phases 9-23 run before phase 8's timings.  The line before the last
is the kernel table as JSON; the last line is {"ok": true, "device":
{...}}.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.launch import roofline as RL  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit) are the
# dry run's, launch/roofline.py: f32 off the tensor cores; "tf32" for the
# 3xTF32 route, whose callers count its three tensor-core products (3 x
# 2MKN)
HBM_BYTES_PER_S = RL.HBM_BW
# K1's instructions per element of the field, by class, read from the
# SASS of csrc/zo_noise.cu (phase 8 prints each kernel's opcode
# histogram): the hash's LOP3 and SHF (integer), its two IMAD, one I2F
# (the u32 -> f32 conversion) and the f32 multiplies and add of
# zo_bits_to_uniform.  The epilogues' extra work is in k1_ops.
K1_SASS_PER_ELEMENT = {"integer": 7, "imad": 2, "conversion": 1, "fp32": 4}
# instructions per clock per SM by class (CUDA C++ Programming Guide,
# "Throughput of Native Arithmetic Instructions", compute capability 9.0);
# "issue": four schedulers, one warp instruction each per clock
PIPE_RATES = {"integer": 64, "imad": 64, "conversion": 16, "fp32": 128,
              "issue": 128}
CARD = {}              # SM count and top SM clock, read in main()
# the rounds' PRNG key, jax.random.PRNGKey(20261016)'s two words: on the
# kernel stream its base seed (the words xor-ed) is 20261016
ROUND_KEY = (0, 20261016)
REPS = 30
# substrings of the port's CUDA kernels' names (csrc/*.cu)
OUR_KERNELS = ("zo_noise", "zo_dual_matmul_kernel", "zo_matmul_kernel",
               "zo_wgmma_kernel", "zo_tf32_kernel", "zo_tf32_pt_kernel",
               "fa_kernel",
               "fa_wgmma_kernel",
               "rg_lru_scan_kernel")


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
    s, by = RL.bound_s(n_bytes, n_ops, dtype_name)
    return 1e3 * s, by


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# phases 2-4: each kernel against its plain version
# ---------------------------------------------------------------------------

# rows of U the plain version draws at once: its int64 temporaries for
# 2^25 entries take ~0.3 GB each
PLAIN_CHUNK = 1 << 25


def k1_plain(seg, r0, r1, dev):
    """The plain U (f32) of rows [r0, r1) of a K1 segment, on the card."""
    import torch
    from repro_torch.kernels import noise as N
    if seg.seed is None:
        return torch.zeros((r1 - r0, seg.cols), device=dev)
    return N.uniform_noise(seg.seed, (r1 - r0, seg.cols), seg.row_offset + r0,
                           seg.col_offset, device=dev)


def check_k1_tree(what, mode, segments, outs, ins=None, scale=None,
                  mu=0.0):
    """One K1 tree call against the plain tensor code of its mode on the
    same inputs, leaf by leaf in row windows of PLAIN_CHUNK entries, with
    ``torch.equal``; and one launch per segment table."""
    import torch
    from repro_torch.kernels import zo_matmul as ZM
    dev = outs[0].device
    before = [o.clone() for o in outs] if mode == "accumulate" else None
    n0 = ZM.LAUNCHES["zo_noise"]
    ZM.zo_noise_tree(mode, segments, outs, ins, scale, mu)
    want = len(ZM.plan_launches(segments))
    if ZM.LAUNCHES["zo_noise"] - n0 != want:
        fail(f"K1 {what} {mode}: {ZM.LAUNCHES['zo_noise'] - n0} launches, "
             f"expected {want}")
    for i, seg in enumerate(segments):
        o = outs[i].view(seg.rows, seg.cols)
        step = max(1, PLAIN_CHUNK // seg.cols)
        for r0 in range(0, seg.rows, step):
            r1 = min(seg.rows, r0 + step)
            u = k1_plain(seg, r0, r1, dev)
            if mode == "field":
                ref = u
            elif mode == "accumulate":
                ref = before[i].view(seg.rows, seg.cols)[r0:r1] + scale * u
            else:
                p = ins[i].view(seg.rows, seg.cols)[r0:r1]
                ref = (p.to(torch.float32) + float(mu) * u).to(p.dtype)
            if not torch.equal(o[r0:r1], ref):
                fail(f"K1 {what} {mode}: leaf {i} {seg} rows [{r0}, {r1}) "
                     f"differ from plain: max |d| {max_abs(o[r0:r1], ref)}")
            del u, ref
    return want


def record_k1_calls(fn):
    """Run ``fn`` with every K1 call recorded: ``([(mode, segments, out
    dtypes, in dtypes, mu)], [(seed, ids, n_cols)])``, the tree calls and
    the noise-rows calls (their token ids copied)."""
    from repro_torch.kernels import ops as O
    from repro_torch.kernels import zo_matmul as ZM
    calls, rows = [], []
    tree, gather = ZM.zo_noise_tree, O.zo_noise_rows

    def rec_tree(mode, segments, outs, ins=None, scale=None, mu=0.0):
        calls.append((mode, list(segments), [o.dtype for o in outs],
                      None if ins is None else [t.dtype for t in ins],
                      float(mu)))
        return tree(mode, segments, outs, ins, scale, mu)

    def rec_rows(seed, ids, n_cols):
        rows.append((seed, ids.clone(), n_cols))
        return gather(seed, ids, n_cols)

    ZM.zo_noise_tree, O.zo_noise_rows = rec_tree, rec_rows
    try:
        fn()
    finally:
        ZM.zo_noise_tree, O.zo_noise_rows = tree, gather
    return calls, rows


def check_k1_rows_recorded(what, rows):
    """Each recorded noise-rows call again on its own token ids, against
    the plain gathered U, bit for bit.  Returns the launches."""
    import torch
    from repro_torch.kernels import noise as N
    from repro_torch.kernels import zo_matmul as ZM
    n0 = ZM.LAUNCHES["zo_noise"]
    for k, (seed, ids, n_cols) in enumerate(rows):
        got = ZM.zo_noise_rows(seed, ids, n_cols)
        cols = torch.arange(n_cols, device=ids.device)
        ref = N.uniform_noise_at(seed, ids[..., None], cols)
        if not torch.equal(got, ref):
            fail(f"K1 {what} rows call {k} {tuple(ids.shape)} x {n_cols}: "
                 f"max |d| {max_abs(got, ref)}")
    if ZM.LAUNCHES["zo_noise"] - n0 != len(rows):
        fail(f"K1 {what} rows: {ZM.LAUNCHES['zo_noise'] - n0} launches for "
             f"{len(rows)} calls")
    return len(rows)


def k1_inputs(dev, mode, segments, dtypes, in_dtypes, seed):
    """Fresh seeded outputs / accumulators and inputs for a K1 call."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    outs, ins = [], None
    for seg, dt in zip(segments, dtypes):
        n = seg.rows * seg.cols
        outs.append(torch.randn(n, generator=gen, device=dev) if
                    mode == "accumulate" else
                    torch.empty(n, dtype=dt, device=dev))
    if mode == "perturb":
        ins = [torch.randn(seg.rows * seg.cols, generator=gen,
                           device=dev).to(dt)
               for seg, dt in zip(segments, in_dtypes)]
    return outs, ins


def check_k1_recorded(what, calls, dev):
    """Each recorded K1 call of a round again on fresh inputs, against
    the plain version: accumulate with a scale read from a 0-d view of a
    device vector, as the replay reads it."""
    import torch
    scales = torch.tensor([0.37, -1.25e-3], device=dev)
    n = 0
    for k, (mode, segs, dts, in_dts, mu) in enumerate(calls):
        outs, ins = k1_inputs(dev, mode, segs, dts, in_dts, seed=k)
        n += check_k1_tree(f"{what} call {k}", mode, segs, outs, ins,
                           scales[k % 2], mu)
        del outs, ins
    return n


def check_k1_model_tree(what, client, dev):
    """The three modes over a whole client tree with the round's seed
    scheme: the field, an accumulation into a seeded f32 tree (scale from
    a device vector), and theta + mu*U in the leaves' dtype."""
    import torch
    from repro_torch.kernels import ops as O
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(client)
    seeds = tree_leaves(O.leaf_seed_tree(client, -123456789))
    segs = [O.leaf_segment(s, p.shape) for p, s in zip(leaves, seeds)]
    outs = [torch.empty(p.numel(), device=dev) for p in leaves]
    check_k1_tree(what, "field", segs, outs)
    del outs
    outs, _ = k1_inputs(dev, "accumulate", segs, [torch.float32] * len(segs),
                        None, seed=5)
    check_k1_tree(what, "accumulate", segs, outs,
                  scale=torch.tensor([0.0, -3e-4], device=dev)[1])
    del outs
    outs = [torch.empty_like(p).reshape(-1) for p in leaves]
    check_k1_tree(what, "perturb", segs, outs,
                  [p.reshape(-1) for p in leaves], mu=1e-3)
    del outs
    return len(segs), sum(p.numel() for p in leaves)


def check_k1(dev, card):
    """K1 against the plain tensor code, bit for bit: every K1 call of a
    gpt2-small round (recorded, then run again on fresh inputs), the three
    modes over the gpt2-small and recurrentgemma-9b client trees (the
    256000 x 4096 table in row windows), a field at a row and column
    offset, and the gathered rows.  Returns the gpt2-small round's K1
    launches (phase 5 expects as many)."""
    import torch
    from repro_torch.configs.gpt2 import gpt2_small
    from repro_torch.kernels import noise as N
    from repro_torch.kernels import zo_matmul as ZM
    from repro_torch.models import transformer as T
    setup = _round_setup(gpt2_small(), dev, n_clients=2, h=1, batch=4,
                         seq=256, mu=1e-3, lr=1e-4, server_lr=2e-4)
    state, rb, rnd = setup
    calls, rows = record_k1_calls(lambda: rnd(state, rb, ROUND_KEY))
    n_tree = check_k1_recorded("gpt2-small round", calls, dev)
    n_rows = check_k1_rows_recorded("gpt2-small round", rows)
    modes = {m: sum(1 for c in calls if c[0] == m)
             for m in ("field", "accumulate", "perturb")}
    n_leaves, n_el = check_k1_model_tree("gpt2-small client tree",
                                         state["client"], dev)
    del state, rb, rnd, setup
    got = ZM.zo_noise(-5, (1024, 3072), 2 * 768, 3, device=dev)
    if not torch.equal(got, N.uniform_noise(-5, (1024, 3072), 2 * 768, 3,
                                            device=dev)):
        fail("K1 field (1024, 3072) at offsets (1536, 3) differs from plain")
    rng = np.random.default_rng(1)
    ids = torch.as_tensor(np.append(rng.integers(0, 50432, 4 * 256 - 1),
                                    50431).reshape(4, 256), device=dev)
    got_r = ZM.zo_noise_rows(-7, ids, 768)
    cols = torch.arange(768, device=dev)
    ref_r = N.uniform_noise_at(-7, ids[..., None], cols)
    if not torch.equal(got_r, ref_r):
        fail(f"K1 rows differ from plain: max |d| = {max_abs(got_r, ref_r)}")
    log(2, f"K1 zo_noise == plain bit for bit: the gpt2-small round's "
        f"{len(calls)} tree calls ({modes}; {n_tree} launches) on fresh "
        f"inputs and {n_rows} rows calls on their token ids; field, "
        f"accumulate and perturb over "
        f"the gpt2-small client tree ({n_leaves} leaves, {n_el} entries, one "
        f"launch each); a field at offsets (1536, 3); rows (4, 256) ids <= "
        f"50431 x 768")
    params = T.init_lm(rg_round_config(), seed=0, device=dev,
                       draw_on_device=True)
    n_leaves, n_el = check_k1_model_tree("recurrentgemma-9b client tree",
                                         params["client"], dev)
    del params
    torch.cuda.empty_cache()
    log(2, f"K1 == plain bit for bit in the three modes over the "
        f"recurrentgemma-9b client tree ({n_leaves} leaves, {n_el} entries, "
        f"one launch each; the plain version in windows of {PLAIN_CHUNK} "
        f"entries) on {card}")
    return n_tree + n_rows


def k2_inputs(dev, dtype, M, K, Nn, seed=0):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    xa = torch.randn((M, K), generator=g, device=dev).to(dtype)
    xb = torch.randn((M, K), generator=g, device=dev).to(dtype)
    w = (torch.randn((K, Nn), generator=g, device=dev) * K ** -0.5
         ).to(dtype)
    return xa, xb, w


K2_SHAPES = ((768, 768), (768, 3072), (3072, 768))
# qwen2-1.5b's client projections at d_model 1536 (phase 12): q and o,
# the two-head k and v, gate and up, down
QWEN_K2_SHAPES = ((1536, 1536), (1536, 256), (1536, 8960), (8960, 1536))
K2_FLAGS = ((False, True, 0.0, 1e-3), (True, True, 1e-3, -1e-3))


def k2_plain(xa, xb, w, seed, mu_a, mu_b, pa, pb, off, col=0):
    from repro_torch.kernels import noise as N
    from repro_torch.kernels import ref as R
    u = N.uniform_noise(seed, w.shape, off, col, device=w.device)
    return R.zo_dual_matmul_ref(xa, xb, w, u, mu_a, mu_b, perturb_a=pa,
                                perturb_b=pb)


def split_ok(got, x, w, u, mu, perturb):
    """The tensor-core route against its own arithmetic
    (ref.zo_matmul_split_ref, f32 sums): half a bf16 step of the output
    rounding (2^-8 relative) plus one f32 ulp of the sum of |products| per
    wgmma step (two per k16 step when perturbed: hi and lo), for the
    tensor cores' other accumulation order.  Returns (ok, max |d|)."""
    import torch
    from repro_torch.kernels import ref as R
    emu = R.zo_matmul_split_ref(x, w, u, mu, perturb=perturb,
                                out_dtype=torch.float32)
    if perturb:
        hi, lo = R.split_bf16(w.float() + float(mu) * u)
        mag = x.float().abs() @ (hi.float().abs() + lo.float().abs())
    else:
        mag = x.float().abs() @ w.float().abs()
    steps = (2 if perturb else 1) * -(-x.shape[1] // 16)
    d = (got.float() - emu).abs()
    ok = bool((d <= 2 ** -8 * emu.abs() + steps * 2 ** -23 * mag).all())
    return ok, float(d.max())


def tf32_ok(got, x, w, u, mu, perturb):
    """The f32 tensor-core route against its own arithmetic
    (ref.zo_matmul_tf32x3_ref, f32 sums): within ref.tf32x3_slack, one f32
    ulp of the sum of |products| for each of the three wgmmas of every k8
    step, for the tensor cores' other accumulation order.  Returns (ok,
    max |d|)."""
    from repro_torch.kernels import ref as R
    emu = R.zo_matmul_tf32x3_ref(x, w, u, mu, perturb=perturb)
    d = (got - emu).abs()
    ok = bool((d <= R.tf32x3_slack(x, w, u, mu, perturb=perturb)).all())
    return ok, float(d.max())


def route_check(what, got, x, w, u, mu, perturb, worst):
    """A tensor-core launch against its route's arithmetic: split_ok in
    bf16, tf32_ok in f32; ``worst`` keeps the largest |d| of each."""
    import torch
    bf16 = w.dtype == torch.bfloat16
    ok, dmax = (split_ok if bf16 else tf32_ok)(got, x, w, u, mu, perturb)
    name = "split" if bf16 else "tf32x3"
    if not ok:
        fail(f"{what} perturb {perturb} mu {mu}: off the {name} arithmetic, "
             f"max |d| {dmax}")
    key = f"{'bf16' if bf16 else 'f32'} vs {name}"
    worst[key] = max(worst.get(key, 0.0), dmax)


def check_k2_launch(what, xa, xb, w, seed, ma, mb, pa, pb, off, u, worst,
                    key, col=0):
    """One K2 launch against the plain version on the same inputs, with
    :func:`check_k2`'s tolerance; where K and N are multiples of 8 (the
    inputs are fresh, so aligned) also on the tensor-core route (the
    counter says so) and within its arithmetic (:func:`route_check`).
    ``u`` is U(seed) at (``off``, ``col``); ``worst[key]`` keeps the
    largest |d|."""
    import torch
    from repro_torch.kernels import zo_matmul as ZM
    K, Nn = w.shape
    tc0 = ZM.LAUNCHES["zo_dual_matmul_tc"]
    ya, yb = ZM.zo_dual_matmul(xa, xb, w, seed, ma, mb, row_offset=off,
                               col_offset=col, perturb_a=pa, perturb_b=pb)
    want_tc = int(K % 8 == 0 and Nn % 8 == 0)
    if ZM.LAUNCHES["zo_dual_matmul_tc"] - tc0 != want_tc:
        fail(f"K2 {what} {w.dtype} {K}x{Nn}: expected {want_tc} "
             f"tensor-core launch, counters {ZM.LAUNCHES}")
    ra, rb = k2_plain(xa, xb, w, seed, ma, mb, pa, pb, off, col)
    if want_tc:
        for got, x, m, p in ((ya, xa, ma, pa), (yb, xb, mb, pb)):
            route_check(f"K2 {what} {w.dtype} {K}x{Nn} flags {pa},{pb}",
                        got, x, w, u, m, p, worst)
    for got, ref in ((ya, ra), (yb, rb)):
        d = (got.float() - ref.float()).abs()
        r = ref.float().abs()
        if w.dtype == torch.float32:
            ok = bool((d <= 1e-4 * r.max()).all())
        else:
            ok = bool((d <= 2 ** -7 * r + 1e-4 * r.max()).all())
        if not ok:
            fail(f"K2 {what} {w.dtype} {K}x{Nn} flags {pa},{pb} mu {ma},"
                 f"{mb}: max |d| {float(d.max())}")
        worst[key] = max(worst.get(key, 0.0), float(d.max()))


def check_k2(dev):
    """Tolerance: f32 sums in another order differ by ~sqrt(K) f32 ulps,
    so |d| <= 1e-4 * max|ref|.  In bf16 the kernel and the plain version
    round the same f32 value to bf16; where their f32 sums straddle a
    rounding boundary they differ by one bf16 step, 2^-7 relative, so
    |d| <= 2^-7 |ref| + 1e-4 max|ref| elementwise.  A wrong noise, row
    offset or stream flag moves the outputs by ~mu*sqrt(K)*|x|, far
    above both.  Every launch here takes the tensor-core route (the
    counter says so) and is also held to the route's arithmetic: bf16 to
    its split (:func:`split_ok`), f32 to 3xTF32 (:func:`tf32_ok`).
    Shapes: gpt2-small's client projections and qwen2-1.5b's."""
    import torch
    from repro_torch.kernels import noise as N
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for K, Nn in K2_SHAPES + QWEN_K2_SHAPES:
            xa, xb, w = k2_inputs(dev, dtype, 1024, K, Nn)
            off = 2 * K
            u = N.uniform_noise(-99, w.shape, off, device=dev)
            for pa, pb, mu_a, mu_b in K2_FLAGS:
                # mu 1e-3 on the main path; 0.5 makes a wrong U visible
                for scale in (1.0, 500.0):
                    key = (f"{str(dtype).split('.')[-1]} mu "
                           f"{'1e-3' if scale == 1.0 else '0.5'}")
                    check_k2_launch("grid", xa, xb, w, -99, mu_a * scale,
                                    mu_b * scale, pa, pb, off, u, worst,
                                    key)
            del xa, xb, w, u
    log(3, f"K2 zo_dual_matmul == plain within tolerance at M=1024, K x N "
        f"in {K2_SHAPES + QWEN_K2_SHAPES}, flags (F,T),(T,T), bf16 and f32 "
        f"on the tensor-core route and within tolerance of its split / "
        f"3xTF32 arithmetic: max |d| {worst}")
    return worst["bfloat16 mu 1e-3"]      # the main path's type and mu


def record_k2_calls(fn):
    """Run ``fn`` with every K2 launch recorded: ``[(M, K, N, dtype,
    seed, mu_a, mu_b, perturb_a, perturb_b, row_offset, col_offset)]``."""
    from repro_torch.kernels import noise as N
    from repro_torch.kernels import ops as O
    calls, dual = [], O.zo_dual_matmul

    def rec(xa, xb, w, seed, mu_a, mu_b, *, row_offset=0, col_offset=0,
            perturb_a=False, perturb_b=True):
        calls.append((xa.shape[0], w.shape[0], w.shape[1], w.dtype,
                      int(N._u32(seed)), float(mu_a), float(mu_b),
                      perturb_a, perturb_b, int(N._u32(row_offset)),
                      int(N._u32(col_offset))))
        return dual(xa, xb, w, seed, mu_a, mu_b, row_offset=row_offset,
                    col_offset=col_offset, perturb_a=perturb_a,
                    perturb_b=perturb_b)

    O.zo_dual_matmul = rec
    try:
        fn()
    finally:
        O.zo_dual_matmul = dual
    return calls


def check_k2_recorded(what, calls, dev):
    """Each recorded K2 launch of a round again on fresh seeded inputs of
    its shape and type, with its seed, mus, stream flags and row and
    column offsets, against the plain version (:func:`check_k2_launch`).
    Returns the largest |d| by type."""
    from repro_torch.kernels import noise as N
    worst = {}
    for k, (M, K, Nn, dt, seed, ma, mb, pa, pb, off, col) in enumerate(
            calls):
        xa, xb, w = k2_inputs(dev, dt, M, K, Nn, seed=k)
        u = N.uniform_noise(seed, w.shape, off, col, device=dev)
        check_k2_launch(f"{what} call {k}", xa, xb, w, seed, ma, mb, pa, pb,
                        off, u, worst, str(dt).split(".")[-1], col)
        del xa, xb, w, u
    return worst


def k4_cases():
    import torch
    # (name, dtype, M, K, N): gpt2-small's client projections (bf16) and
    # ResNet-18's client convs over im2col patches and aux fc (f32,
    # 64 images of 32x32 per client)
    return [("gpt2 768x768", torch.bfloat16, 1024, 768, 768),
            ("gpt2 768x3072", torch.bfloat16, 1024, 768, 3072),
            ("gpt2 3072x768", torch.bfloat16, 1024, 3072, 768),
            ("resnet stem 27x64", torch.float32, 64 * 1024, 27, 64),
            ("resnet block0 576x64", torch.float32, 64 * 1024, 576, 64),
            ("resnet aux fc 64x10", torch.float32, 64, 64, 10)]


def k4_plain(x, w, seed, mu, perturb, off):
    from repro_torch.kernels import noise as N
    from repro_torch.kernels import ref as R
    if not perturb:
        return R.matmul_ref(x, w)
    return R.zo_matmul_ref(x, w, N.uniform_noise(seed, w.shape, off,
                                                 device=w.device), mu)


def check_k4(dev):
    """K4 against its plain version with K2's tolerance (see check_k2),
    perturbed and clean, at a nonzero row offset; and bit for bit against
    the matching stream of K2 (clean a, perturbed b), which runs the same
    route in the same order.  Shapes with K and N multiples of 8 take the
    tensor cores and are held to the route's arithmetic too; ResNet-18's
    stem (K = 27) and aux fc (N = 10) take the CUDA-core loop."""
    import torch
    from repro_torch.kernels import noise as N
    from repro_torch.kernels import zo_matmul as ZM
    worst = {}
    for name, dtype, M, K, Nn in k4_cases():
        xa, xb, w = k2_inputs(dev, dtype, M, K, Nn, seed=1)
        off = 2 * K
        for mu in (1e-3, 0.5):
            ya, yb = ZM.zo_dual_matmul(xa, xb, w, -99, 0.0, mu,
                                       row_offset=off)
            tc0 = ZM.LAUNCHES["zo_matmul_tc"]
            clean = ZM.zo_matmul(xa, w, -99, mu, row_offset=off,
                                 perturb=False)
            pert = ZM.zo_matmul(xb, w, -99, mu, row_offset=off)
            tc = K % 8 == 0 and Nn % 8 == 0
            if ZM.LAUNCHES["zo_matmul_tc"] - tc0 != 2 * int(tc):
                fail(f"K4 {name}: expected {2 * int(tc)} tensor-core "
                     f"launches, counters {ZM.LAUNCHES}")
            if not (torch.equal(clean, ya) and torch.equal(pert, yb)):
                fail(f"K4 {name} mu {mu} differs from K2's streams: max |d| "
                     f"{max_abs(clean, ya)}, {max_abs(pert, yb)}")
            if tc:
                u = N.uniform_noise(-99, w.shape, off, device=dev)
                for got, x, p in ((clean, xa, False), (pert, xb, True)):
                    route_check(f"K4 {name}", got, x, w, u, mu, p, worst)
            for got, ref in ((clean, k4_plain(xa, w, -99, mu, False, off)),
                             (pert, k4_plain(xb, w, -99, mu, True, off))):
                d = (got.float() - ref.float()).abs()
                r = ref.float().abs()
                tol = 1e-4 * r.max()
                if dtype == torch.bfloat16:
                    tol = 2 ** -7 * r + tol
                if not bool((d <= tol).all()):
                    fail(f"K4 {name} mu {mu}: max |d| {float(d.max())}")
                key = (f"{str(dtype).split('.')[-1]} mu "
                       f"{'1e-3' if mu == 1e-3 else '0.5'}")
                worst[key] = max(worst.get(key, 0.0), float(d.max()))
        del xa, xb, w
    log(3, f"K4 zo_matmul == plain within tolerance (perturbed and clean, "
        f"row_offset 2K) and == K2's a / b streams bit for bit at "
        f"{[c[0] + ' M=' + str(c[2]) for c in k4_cases()]} (K, N multiples "
        f"of 8 on the tensor-core route, the stem and aux fc on the "
        f"CUDA-core loop): max |d| {worst}")
    return worst["bfloat16 mu 1e-3"]


def k3_inputs(dev, dtype, B, S, H, Kv, D, seed=0):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa
    return (mk(B, S, H, D), mk(B, S, H, D), mk(B, S, Kv, D),
            mk(B, S, Kv, D), mk(B, S, Kv, D), mk(B, S, Kv, D))


def k3_cases():
    # (name, B, S, H, Kv, D, kwargs); the main path's shape first, then
    # qwen2-1.5b's heads (12 q, 2 kv, head_dim 128), recurrentgemma-9b's
    # (16 q, 1 kv, head_dim 256) with a window, the qwen2.5-32b smoke
    # config's (8 q, 2 kv, head_dim 8) with a soft-cap and kimi-k2's
    # head_dim 112 (GQA 8:1) with a window; phase 13's admissions (batch
    # 1) on qwen2-1.5b and recurrentgemma-9b; phase 14's train steps on
    # gpt2-medium and qwen2-1.5b (4 x 256 tokens, causal, no window)
    return [("gpt2-small", 4, 256, 12, 12, 64, dict()),
            ("gqa-window-cap-ragged", 2, 200, 8, 2, 64,
             dict(window=64, cap=30.0)),
            ("d128-qwen2-heads-window", 2, 300, 12, 2, 128,
             dict(window=100)),
            ("d256-recurrentgemma-heads-window", 1, 1024, 16, 1, 256,
             dict(window=512)),
            ("d8-qwen2.5-32b-smoke-heads-cap", 2, 130, 8, 2, 8,
             dict(cap=30.0)),
            ("d112-kimi-k2-heads-window", 1, 300, 16, 2, 112,
             dict(window=128)),
            ("serving-qwen2-1.5b-prefill", 1, 512, 12, 2, 128, dict()),
            ("serving-recurrentgemma-9b-prefill", 1, 384, 16, 1, 256,
             dict(window=2048)),
            ("train-gpt2-medium", 4, 256, 16, 16, 64, dict()),
            ("train-qwen2-1.5b", 4, 256, 12, 2, 128, dict())]


def k3_routes():
    """(name, dtype, tensor cores?): bf16 with aligned inputs takes the
    tensor cores; bf16 one element into a buffer (not 16-byte aligned)
    and f32 take the CUDA-core loop."""
    import torch
    return [("bf16 tensor cores", torch.bfloat16, True),
            ("bf16 loop", torch.bfloat16, False),
            ("f32 loop", torch.float32, False)]


def route_inputs(xs, tc):
    """The inputs as the route needs them: as they are for the tensor
    cores, misaligned copies (:func:`misaligned`) for the loop."""
    return list(xs) if tc else [misaligned(x) for x in xs]


def expect_fa_route(what, before, key, want):
    from repro_torch.kernels import flash_attention as FA
    if FA.LAUNCHES[key] - before[key] != want:
        fail(f"{what}: expected {want} launch(es) counted under {key}, "
             f"counters {FA.LAUNCHES}")


def check_loop_d256(dev):
    """The CUDA-core loop runs f32 head_dim 256 (32-row tiles): K3 and K5
    within the f32 tolerance of the plain version on a short ragged
    sequence; a head past 256 raises, naming the limit, and launches
    nothing."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref as R
    qa, qb, k, v, _, _ = k3_inputs(dev, torch.float32, 1, 100, 2, 1, 256)
    oa, ob = FA.zo_dual_flash_attention(qa, qb, k, v, perturb_b=False)
    o5 = FA.flash_attention(qa, k, v)
    ra, rb = R.zo_dual_flash_attention_ref(qa, qb, k, v, perturb_b=False)
    worst = max(max_abs(oa, ra), max_abs(ob, rb), max_abs(o5, ra))
    if worst > 1e-4 or not torch.equal(o5, oa):
        fail(f"f32 head_dim 256 on the loop: max |d| {worst}, K5 == K3's "
             f"stream a: {torch.equal(o5, oa)}")
    qa, qb, k, v, _, _ = k3_inputs(dev, torch.float32, 1, 64, 2, 1, 264)
    for what, fn in (("K3", lambda: FA.zo_dual_flash_attention(qa, qb, k,
                                                                v)),
                     ("K5", lambda: FA.flash_attention(qa, k, v))):
        before = dict(FA.LAUNCHES)
        try:
            fn()
        except ValueError as e:
            if "256" not in str(e):
                fail(f"{what} head_dim 264: unclear refusal: {e}")
        else:
            fail(f"{what} head_dim 264 ran; expected a refusal")
        if FA.LAUNCHES != before:
            fail(f"{what} head_dim 264 launched: {FA.LAUNCHES}")
    return worst


def check_k3(dev):
    """Tolerance: f32 |d| <= 1e-4 (outputs are convex combinations of v,
    |v| < 5; the online softmax sums in another order than the full
    softmax).  bf16: one bf16 rounding step of the output, 2^-7 |ref|,
    plus 1e-3.  Each case on each route that is compiled for its
    head_dim; the route counter shows where each call went."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import noise as N
    from repro_torch.kernels import ref as R
    import torch
    worst = {}
    for rname, dtype, tc in k3_routes():
        for name, B, S, H, Kv, D, kw in k3_cases():
            ins = k3_inputs(dev, dtype, B, S, H, Kv, D)
            qa, qb, k, v, kb, vb = route_inputs(ins, tc)
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
                before = dict(FA.LAUNCHES)
                oa, ob = FA.zo_dual_flash_attention(
                    qa, qb, k, v, seed=77, row_offset=5 * H * S, **mkw, **kw)
                expect_fa_route(f"K3 {rname} {name} {mode}", before,
                                "zo_dual_flash_attention_tc", int(tc))
                ra, rb = R.zo_dual_flash_attention_ref(
                    qa, qb, k, v, u=u, **mkw, **kw)
                for got, ref in ((oa, ra), (ob, rb)):
                    d = (got.float() - ref.float()).abs()
                    tol = (1e-4 if dtype == torch.float32
                           else 2 ** -7 * ref.float().abs() + 1e-3)
                    if not bool((d <= tol).all()):
                        fail(f"K3 {rname} {name} {mode}: max |d| "
                             f"{float(d.max())}")
                    key = f"{rname} {name} {mode}"
                    worst[key] = max(worst.get(key, 0.0), float(d.max()))
            del qa, qb, k, v, kb, vb, ins, u
    d256 = check_loop_d256(dev)
    log(4, "K3 zo_dual_flash_attention == plain within tolerance: "
        f"{[c[0] for c in k3_cases()]}; weights, scores and antithetic "
        "scores modes; every head_dim on every route (bf16 on the tensor "
        "cores and on the CUDA-core loop, f32 on the loop); f32 head_dim "
        f"256 again on a ragged S=100 (max |d| {d256}); head_dim 264 "
        f"refused, as it should be: max |d| {worst}")
    return worst["bf16 tensor cores gpt2-small weights"]   # the main path


def record_k3_calls(fn):
    """Run ``fn`` with every K3 call recorded: ``[(arguments, (oa,
    ob))]``, the call's arguments by name and its outputs, the tensors
    copied."""
    import inspect
    import torch
    from repro_torch.kernels import ops as O
    calls, dual = [], O.zo_dual_flash_attention
    sig = inspect.signature(dual)

    def rec(*args, **kw):
        out = dual(*args, **kw)
        bound = sig.bind(*args, **kw)
        bound.apply_defaults()
        calls.append(({k: v.clone() if torch.is_tensor(v) else v
                       for k, v in bound.arguments.items()},
                      tuple(o.clone() for o in out)))
        return out

    O.zo_dual_flash_attention = rec
    try:
        fn()
    finally:
        O.zo_dual_flash_attention = dual
    return calls


def check_k3_recorded(what, calls):
    """Each recorded K3 call's outputs against the plain version on the
    call's own inputs (its score noise drawn from its seed and row
    offset), at check_k3's tolerance.  Returns the largest |d|."""
    import torch
    from repro_torch.kernels import noise as N
    from repro_torch.kernels import ref as R
    worst = 0.0
    for k, (a, outs) in enumerate(calls):
        H, Sq, Skv = a["qa"].shape[2], a["qa"].shape[1], a["k"].shape[1]
        u = None
        if a["perturb_a"] or a["perturb_b"]:
            u = N.uniform_noise(a["seed"], (H * Sq, Skv), a["row_offset"],
                                device=a["qa"].device).reshape(H, Sq, Skv)
        refs = R.zo_dual_flash_attention_ref(
            a["qa"], a["qb"], a["k"], a["v"], kb=a["kb"], vb=a["vb"], u=u,
            mu_a=a["mu_a"], mu_b=a["mu_b"], perturb_a=a["perturb_a"],
            perturb_b=a["perturb_b"], causal=a["causal"],
            window=a["window"], cap=a["cap"], scale=a["scale"])
        for got, ref in zip(outs, refs):
            d = (got.float() - ref.float()).abs()
            tol = (1e-4 if got.dtype == torch.float32
                   else 2 ** -7 * ref.float().abs() + 1e-3)
            if not bool((d <= tol).all()):
                fail(f"K3 {what} call {k} {tuple(a['qa'].shape)}: max |d| "
                     f"{float(d.max())}")
            worst = max(worst, float(d.max()))
    return worst


def record_k5_calls(fn):
    """Run ``fn`` with every K5 call (``ops.flash_attention``, as the
    attention layer calls it) recorded: ``[(arguments, out)]``, the
    tensors copied."""
    import inspect
    import torch
    from repro_torch.kernels import ops as O
    calls, k5 = [], O.flash_attention
    sig = inspect.signature(k5)

    def rec(*args, **kw):
        out = k5(*args, **kw)
        bound = sig.bind(*args, **kw)
        bound.apply_defaults()
        calls.append(({k: v.clone() if torch.is_tensor(v) else v
                       for k, v in bound.arguments.items()}, out.clone()))
        return out

    O.flash_attention = rec
    try:
        fn()
    finally:
        O.flash_attention = k5
    return calls


def check_k5_recorded(what, calls):
    """Each recorded K5 call's output against the plain version on the
    call's own inputs, at check_k5's tolerance.  Returns the largest
    |d|."""
    import torch
    from repro_torch.kernels import ref as R
    worst = 0.0
    for k, (a, out) in enumerate(calls):
        ref = R.flash_attention_ref(a["q"], a["k"], a["v"], causal=a["causal"],
                                    window=a["window"], cap=a["cap"],
                                    scale=a["scale"])
        d = (out.float() - ref.float()).abs()
        tol = (1e-4 if out.dtype == torch.float32
               else 2 ** -7 * ref.float().abs() + 1e-3)
        if not bool((d <= tol).all()):
            fail(f"K5 {what} call {k} {tuple(a['q'].shape)}: max |d| "
                 f"{float(d.max())}")
        worst = max(worst, float(d.max()))
    return worst


def check_k5(dev):
    """K5 against its plain version over K3's cases with K3's tolerance
    (see check_k3); and bit for bit against each stream of K3 in the
    weights mode on the same route, which runs the same stream code."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref as R
    worst = {}
    for rname, dtype, tc in k3_routes():
        for name, B, S, H, Kv, D, kw in k3_cases():
            qa, qb, k, v, kb, vb = route_inputs(
                k3_inputs(dev, dtype, B, S, H, Kv, D, seed=2), tc)
            before = dict(FA.LAUNCHES)
            oa = FA.flash_attention(qa, k, v, **kw)
            ob = FA.flash_attention(qb, kb, vb, **kw)
            expect_fa_route(f"K5 {rname} {name}", before,
                            "flash_attention_tc", 2 * int(tc))
            fa, fb = FA.zo_dual_flash_attention(
                qa, qb, k, v, kb=kb, vb=vb, perturb_a=False,
                perturb_b=False, **kw)
            if not (torch.equal(oa, fa) and torch.equal(ob, fb)):
                fail(f"K5 {rname} {name} differs from K3's streams: max "
                     f"|d| {max_abs(oa, fa)}, {max_abs(ob, fb)}")
            ref = R.flash_attention_ref(qa, k, v, **kw)
            d = (oa.float() - ref.float()).abs()
            tol = (1e-4 if dtype == torch.float32
                   else 2 ** -7 * ref.float().abs() + 1e-3)
            if not bool((d <= tol).all()):
                fail(f"K5 {rname} {name}: max |d| {float(d.max())}")
            worst[f"{rname} {name}"] = float(d.max())
    log(4, "K5 flash_attention == plain within tolerance and == K3's a / b "
        "streams (weights mode) bit for bit on both routes: "
        f"{[c[0] for c in k3_cases()]}: max |d| {worst}")
    return worst["bf16 tensor cores gpt2-small"]


# ---------------------------------------------------------------------------
# phase 5: the round
# ---------------------------------------------------------------------------

def _make_round(api, params, rb, n_clients, h, mu, lr, server_lr,
                server_eps=1e-8, method="heron", fed_kw=None, scale="sphere",
                replay_kw=None):
    """HERON on the lean uplink (plain-SGD clients at ``lr``), or a
    first-order ``method`` on the dense uplink with AdamW clients at
    ``lr`` (``eps`` = ``server_eps``).  ``fed_kw``: more FedConfig
    knobs; ``scale``: the threefry direction's (unused by the kernel
    stream and the first-order methods); ``replay_kw``: HERON's
    ``replay_shard`` / ``replay_mesh`` / ``replay_chunk``."""
    from repro_torch.core import protocols as P
    from repro_torch.core import zo as Z
    from repro_torch.optim.optimizers import adamw, zo_sgd
    sopt = adamw(server_lr, eps=server_eps)
    state = {"client": params["client"], "server": params["server"],
             "opt_server": sopt.init(params["server"])}
    fed = P.FedConfig(n_clients=n_clients, h=h, **(fed_kw or {}))
    zo = Z.ZOConfig(mu=mu, n_pairs=1, scale=scale)
    if method == "heron":
        rnd = P.make_fed_round(api, "heron", zo, fed, zo_sgd(lr), sopt,
                               uplink="seed_replay", client_lr=lr,
                               **(replay_kw or {}))
    else:
        rnd = P.make_fed_round(api, method, zo, fed,
                               adamw(lr, eps=server_eps), sopt)
    return state, rb, rnd


def _with_lora(params, rank, seed):
    """Rank-``rank`` adapters on the client's wq wk wv wo up down gate,
    drawn on the CPU (the same values on every device)."""
    import torch
    from repro_torch.models.lora import add_lora
    if not rank:
        return params
    gen = torch.Generator().manual_seed(seed + 1)
    return {**params, "client": add_lora(gen, params["client"], rank)}


def _round_setup(cfg, dev, n_clients, h, batch, seq, mu, lr, server_lr,
                 seed=0, draw_on_device=False, server_eps=1e-8,
                 method="heron", fed_kw=None, lora_rank=0,
                 forward_impl="kernel", scale="sphere", replay_kw=None):
    """``forward_impl="kernel"``: HERON on the fused dual-probe kernels;
    ``"xla"``: on the threefry stream at ``scale``."""
    import torch
    from repro_torch.core import protocols as P
    from repro_torch.models import transformer as T
    cfg = cfg.replace(forward_impl=forward_impl)
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab,
                                        (n_clients, h, batch, seq + 1)),
                           device=dev)
    rb = {"inputs": toks[..., :-1], "labels": toks[..., 1:]}
    params = _with_lora(T.init_lm(cfg, seed=seed, device=dev,
                                  draw_on_device=draw_on_device),
                        lora_rank, seed)
    return _make_round(P.lm_api(cfg), params, rb, n_clients, h, mu, lr,
                       server_lr, server_eps, method, fed_kw, scale,
                       replay_kw)


def _cnn_round_setup(cfg, dev, n_clients, h, batch, hw, mu, lr, server_lr,
                     seed=0, server_eps=1e-8, method="heron",
                     forward_impl="kernel", scale="sphere", fed_kw=None):
    """Images and labels from a numpy seed (no dataset is downloaded)."""
    import torch
    from repro_torch.core import protocols as P
    from repro_torch.models import cnn as CNN
    cfg = dataclasses.replace(cfg, forward_impl=forward_impl)
    rng = np.random.default_rng(seed)
    rb = {"inputs": torch.as_tensor(rng.standard_normal(
              (n_clients, h, batch, hw, hw, 3), dtype=np.float32),
              device=dev),
          "labels": torch.as_tensor(rng.integers(
              0, cfg.classes, (n_clients, h, batch)), device=dev)}
    return _make_round(P.cnn_api(cfg), CNN.init_cnn(cfg, seed=seed,
                                                    device=dev),
                       rb, n_clients, h, mu, lr, server_lr, server_eps,
                       method, fed_kw, scale)


def launch_counts():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rg_lru as RG
    from repro_torch.kernels import zo_matmul as ZM
    return {**ZM.LAUNCHES, **FA.LAUNCHES, **RG.LAUNCHES}


def reset_counts():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rg_lru as RG
    from repro_torch.kernels import zo_matmul as ZM
    for d in (ZM.LAUNCHES, FA.LAUNCHES, RG.LAUNCHES):
        for k in d:
            d[k] = 0


def check_counts(what, counts, expect):
    """``expect``: kernel -> launches, or None for "more than zero"."""
    for k, want in expect.items():
        if (counts[k] <= 0) if want is None else (counts[k] != want):
            fail(f"{what}: launch counts {counts}, expected {expect} "
                 "(None: more than zero)")


def drive_round(phase, desc, setup, expect, round_key=None, warmup=None):
    """A warm-up round (``warmup()`` when given), then one timed round
    from the same state: finite losses and params, moved client params,
    the kernels' launch counts against ``expect``; then one more round
    under the profiler."""
    import torch
    from repro_torch.tree import tree_leaves
    state, rb, rnd = setup
    round_key = ROUND_KEY if round_key is None else round_key
    if warmup is None:
        rnd(state, rb, round_key)            # warm-up round
    else:
        warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    new_state, m = rnd(state, rb, round_key)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    cl, sl = float(m["client_loss"]), float(m["server_loss"])
    if not (np.isfinite(cl) and np.isfinite(sl)):
        fail(f"{desc}: losses not finite: client {cl} server {sl}")
    for t in tree_leaves(new_state["client"]) + tree_leaves(
            new_state["server"]):
        if not bool(torch.isfinite(t.float()).all()):
            fail(f"{desc}: non-finite parameters")
    moved = any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(state["client"]), tree_leaves(new_state["client"])))
    if not moved:
        fail(f"{desc}: the round left every client leaf unchanged")
    check_counts(desc, counts, expect)
    log(phase, f"{desc}: client_loss {cl} server_loss {sl} uplink_bytes "
        f"{m['uplink_bytes']} uplink_bytes_dense {m['uplink_bytes_dense']} "
        f"wall_s {wall} max_memory_allocated {peak} launches {counts}")
    del new_state               # the profiled round needs its memory
    profile_round(phase, rnd, state, rb, round_key, wall)
    return counts


def run_round(dev, k1_launches):
    """``k1_launches``: the K1 launches phase 2 recorded for this round
    (per client the embedding's noise rows, ten theta + mu*U trees (the
    norms, biases and the tied table) and the direction tree; the
    replay's two direction trees)."""
    from repro_torch.configs.gpt2 import gpt2_small
    cfg = gpt2_small()
    if not cfg.remat:
        fail("gpt2-small has remat off")
    rates = dict(mu=1e-3, lr=1e-4, server_lr=2e-4)
    setup = _round_setup(cfg, dev, n_clients=2, h=1, batch=4, seq=256,
                         **rates)
    counts = drive_round(
        5, "gpt2-small round (N=2 h=1 n_pairs=1, 4x256 tokens per client, "
        "seed_replay)", setup,
        {"zo_dual_matmul": 48, "zo_dual_matmul_tc": 48,
         "zo_dual_flash_attention": 8, "zo_dual_flash_attention_tc": 8,
         "zo_noise": k1_launches, "zo_matmul": 0, "flash_attention": 0,
         "rg_lru_scan": 0})
    remat_round_walls(cfg, setup, counts, rates)
    return counts


def remat_round_walls(cfg, setup, counts, rates, reps=3):
    """Phase 5's round from the same state with remat on (its server's
    backward recomputes each block's forward) and off, alternated
    ``reps`` times on the host's clock, then each once under the
    profiler; the remat-off round's launches == ``counts``."""
    import torch
    from repro_torch.core import protocols as P
    state, rb, rnd = setup
    _, _, rnd_off = _make_round(
        P.lm_api(cfg.replace(forward_impl="kernel", remat=False)),
        {"client": state["client"], "server": state["server"]}, rb, 2, 1,
        **rates)
    walls = {True: [], False: []}
    for _ in range(reps):
        for remat, fn in ((False, rnd_off), (True, rnd)):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            out = fn(state, rb, ROUND_KEY)
            torch.cuda.synchronize()
            walls[remat].append(time.perf_counter() - t0)
            del out
            if not remat:
                check_counts("gpt2-small round, remat off", launch_counts(),
                             counts)
    busy = {remat: sum(r[0] for r in device_rows(
        lambda: fn(state, rb, ROUND_KEY))) / 1e3
        for remat, fn in ((False, rnd_off), (True, rnd))}
    med = {k: float(np.median(v)) for k, v in walls.items()}
    log(5, f"gpt2-small round remat on / off, alternated {reps} times: "
        f"walls {walls[True]} / {walls[False]} s, medians {med[True]} / "
        f"{med[False]} s ({med[True] / med[False]:.4f}); busy {busy[True]} "
        f"/ {busy[False]} ms ({busy[True] / busy[False]:.4f}); the "
        f"remat-off round's launches == the round's")


def run_cnn_round(dev):
    """ResNet-18 at full width: per client the stem conv, block0's c1 and
    c2 (im2col) and the aux fc go through K2, 4 x 5 = 20 launches, of
    which block0's 10 (576 x 64) take the tensor cores and the stem (K =
    27) and aux fc (N = 10) the CUDA-core loop; K1 30:
    per client four theta + mu*U trees (the GroupNorm leaves, the aux fc's
    bias) and the direction tree, and the replay's five direction
    trees."""
    from repro_torch.configs.resnet18_cifar import full_config
    return drive_round(
        6, "resnet18 round (N=5 h=1 n_pairs=1, 64 images 32x32x3 per "
        "client, seed_replay)",
        _cnn_round_setup(full_config(), dev, n_clients=5, h=1, batch=64,
                         hw=32, mu=1e-3, lr=2e-2, server_lr=2e-3),
        {"zo_dual_matmul": 20, "zo_dual_matmul_tc": 10,
         "zo_dual_flash_attention": 0, "zo_dual_flash_attention_tc": 0,
         "zo_noise": 30, "zo_matmul": 0, "flash_attention": 0,
         "rg_lru_scan": 0})


def device_rows(fn):
    """``[(us, count, kernel name)]``: the device time of one call of
    ``fn`` by kernel: torch.profiler's CUDA activity, each kernel's (and
    copy's) duration summed by name from the raw events.  (The event
    list's Python post-processing behind ``key_averages()`` took minutes
    for a round of ~10^5 launches; it derives the same sums.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.profiler.kineto_results.events():
        if not str(ev.device_type()).endswith("CUDA"):
            continue
        us, n = by_name.get(ev.name(), (0.0, 0))
        by_name[ev.name()] = (us + ev.duration_ns() / 1e3, n + 1)
    return [(us, n, k) for k, (us, n) in by_name.items()]


def profile_round(phase, rnd, state, rb, round_key, wall_s):
    """Device time of one more round by kernel (torch.profiler), and the
    card's idle share of the unprofiled round's wall time."""
    rows = device_rows(lambda: rnd(state, rb, round_key))
    busy_ms = sum(r[0] for r in rows) / 1e3
    if busy_ms <= 0:
        log(phase, "profile: the profiler saw no device time (not measured)")
        return
    rows.sort(reverse=True)
    top = "; ".join(f"{k[:48]} x{n} {us / 1e3:.3f} ms" for us, n, k in
                    rows[:8])
    log(phase, f"profile: device busy {busy_ms:.3f} ms of the round's "
        f"{1e3 * wall_s:.3f} ms wall (idle share "
        f"{1 - busy_ms / (1e3 * wall_s):.3f}); top kernels: {top}")
    ours = "; ".join(f"{k[:64]} x{n} {us / 1e3:.3f} ms" for us, n, k in rows
                     if any(t in k for t in OUR_KERNELS))
    log(phase, f"profile: the port's kernels: {ours}")


def compare_card_cpu(desc, metrics, params, keys):
    """``metrics`` and ``params``: (the card's, the CPU's).  Tolerance:
    the metrics named in ``keys`` rtol 1e-4; params |d| <= 1e-5 + 1e-4
    |p| (f32, other summation orders, amplified by 1/mu in the
    coefficient).  Returns the largest param |d|."""
    from repro_torch.tree import tree_leaves
    (mc, mp), (gc, gp) = metrics, params
    for k in keys:
        if k not in mp:
            continue
        a, b = float(mc[k]), float(mp[k])
        if not abs(a - b) <= 1e-4 * abs(b):
            fail(f"{desc} {k}: card {a} vs cpu {b}")
    worst = 0.0
    la, lb = tree_leaves(gc), tree_leaves(gp)
    if len(la) != len(lb):
        fail(f"{desc} params: {len(la)} leaves on the card, {len(lb)} on "
             "the CPU")
    for a, b in zip(la, lb):
        a, b = a.cpu().float(), b.float()
        d = (a - b).abs()
        if not bool((d <= 1e-5 + 1e-4 * b.abs()).all()):
            fail(f"{desc} params: max |d| {float(d.max())}")
        worst = max(worst, float(d.max()))
    return worst


def check_small_round(phase, desc, setup_fn):
    """The same small round on the card and on the CPU: the card runs
    the kernels, the CPU their plain versions, at compare_card_cpu's
    tolerance (the losses).  The server's lr is small because its first
    AdamW step, ~g/|g|, turns rounding in a near-zero gradient into an
    O(lr) change."""
    import torch
    out = []
    for d in (torch.device("cuda", 0), torch.device("cpu")):
        state, rb, rnd = setup_fn(d)
        out.append(rnd(state, rb, (0, 77)))
    (gc, mc), (pc, mp) = out
    worst = compare_card_cpu(
        desc, (mc, mp), tuple({k: g[k] for k in ("client", "server")}
                              for g in (gc, pc)),
        ("client_loss", "server_loss"))
    log(phase, f"{desc} on the card == on the CPU: losses "
        f"{float(mc['client_loss'])} / {float(mc['server_loss'])}, max "
        f"param |d| {worst}")


def check_small_rounds():
    from repro_torch.configs.gpt2 import gpt2_tiny
    from repro_torch.configs.resnet18_cifar import smoke_config
    check_small_round(5, "gpt2-tiny round (N=2 h=2)", lambda d: _round_setup(
        gpt2_tiny(), d, n_clients=2, h=2, batch=2, seq=32, mu=1e-2, lr=1e-3,
        server_lr=1e-4, seed=3))
    check_small_round(6, "cnn smoke_config round (N=2 h=2, 4 images 8x8)",
                      lambda d: _cnn_round_setup(
                          smoke_config(), d, n_clients=2, h=2, batch=4,
                          hw=8, mu=1e-2, lr=1e-3, server_lr=1e-4, seed=3))


# ---------------------------------------------------------------------------
# phase 7: the single-probe forwards
# ---------------------------------------------------------------------------

def _timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def single_probe(desc, dual_loss, single_loss, expect, rtol):
    """One single-probe loss (launch counts against ``expect``) held
    against the perturbed half l_pert of the dual forward on the same
    seeds: the two evaluate one function of theta + mu*U."""
    (l0, lp, _), dual_s = _timed(dual_loss)
    single_loss()                            # warm-up
    reset_counts()
    ls, single_s = _timed(single_loss)
    counts = launch_counts()
    check_counts(desc, counts, expect)
    lp, ls = float(lp), float(ls)
    d = abs(ls - lp)
    if not (np.isfinite(ls) and d <= rtol * abs(lp)):
        fail(f"{desc}: single-probe loss {ls} vs dual l_pert {lp}")
    log(7, f"{desc}: loss {ls} vs dual l_pert {lp} (l_clean {float(l0)}): "
        f"|d| {d} <= {rtol} |l_pert|; wall_s single {single_s} dual "
        f"{dual_s}; launches {counts}")
    return counts


def plain_dual_matmul(xa, xb, w, seed, mu_a, mu_b, *, row_offset=0,
                      col_offset=0, perturb_a=False, perturb_b=True):
    """K2's plain version behind the wrapper's signature: phase 7 swaps it
    in for ``ops.zo_dual_matmul``, inside this script only."""
    return k2_plain(xa, xb, w, seed, mu_a, mu_b, perturb_a, perturb_b,
                    row_offset, col_offset)


def check_dual_vs_plain(desc, dual_loss, rtol):
    """The dual losses (l_clean, l_pert) through K2 against the same
    forward with ``ops.zo_dual_matmul`` swapped for its plain version (no
    K2 launch), each within ``rtol``: K2's bf16 outputs differ from the
    plain version's by at most one bf16 rounding step (2^-8 relative),
    which moves a mean cross-entropy by far less than 1e-3 of itself."""
    from repro_torch.kernels import ops as O
    from repro_torch.kernels import zo_matmul as ZM
    l0, lp, _ = dual_loss()
    n0 = ZM.LAUNCHES["zo_dual_matmul"]
    saved = O.zo_dual_matmul
    O.zo_dual_matmul = plain_dual_matmul
    try:
        r0, rp, _ = dual_loss()
    finally:
        O.zo_dual_matmul = saved
    if ZM.LAUNCHES["zo_dual_matmul"] != n0:
        fail(f"{desc}: the plain pass launched K2")
    pairs = [(float(l0), float(r0)), (float(lp), float(rp))]
    for a, b in pairs:
        if not (np.isfinite(a) and abs(a - b) <= rtol * abs(b)):
            fail(f"{desc}: kernels {a} vs plain {b}")
    log(7, f"{desc}: (l_clean, l_pert) through K2 {pairs[0][0]}, "
        f"{pairs[1][0]} vs with K2's plain version {pairs[0][1]}, "
        f"{pairs[1][1]}: |d| {abs(pairs[0][0] - pairs[0][1])}, "
        f"{abs(pairs[1][0] - pairs[1][1])} <= {rtol} |plain|")


def check_single_probe(dev):
    """Tolerance: gpt2-small rtol 1e-3 (bf16 activations: the single and
    dual forwards give bit-equal K4/K2 and K5/K3 outputs, but the library
    norms and logit GEMMs see other batch shapes, and one bf16 rounding
    step, 2^-8 relative, in the smashed data moves the loss by far less);
    ResNet-18 rtol 1e-5 (f32 throughout)."""
    import torch
    from repro_torch.configs.gpt2 import gpt2_small
    from repro_torch.configs.resnet18_cifar import full_config
    from repro_torch.core import protocols as P
    from repro_torch.kernels import ops as O
    from repro_torch.models import cnn as CNN
    from repro_torch.models import transformer as T
    rng = np.random.default_rng(11)
    mu = 1e-3
    with torch.no_grad():
        cfg = gpt2_small()
        cp = T.init_lm(cfg, seed=0, device=dev)["client"]
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 257)),
                               device=dev)
        batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
        seeds = O.leaf_seed_tree(cp, 4242)
        pz = O.Perturb(seeds=seeds, mu=mu, dual=False)

        def lm_single():
            s = T.client_forward(cp, cfg, batch["inputs"], perturb=pz)
            return T.lm_loss(T.aux_forward(cp, cfg, s, perturb=pz),
                             batch["labels"], cfg.vocab)

        lm_dual = lambda: P.lm_api(  # noqa: E731
            cfg.replace(forward_impl="kernel")).client_dual_loss(
            cp, batch, seeds, mu)
        counts = single_probe(
            "gpt2-small single-probe client+aux loss (4x256 tokens)",
            lm_dual, lm_single, {"zo_matmul": 24, "zo_matmul_tc": 24,
                                 "flash_attention": 4,
                                 "flash_attention_tc": 4,
                                 "zo_dual_matmul": 0,
                                 "zo_dual_flash_attention": 0}, 1e-3)
        check_dual_vs_plain("gpt2-small dual client+aux losses (4x256 "
                            "tokens)", lm_dual, 1e-3)
        del cp

        cfg = full_config()
        cp = CNN.init_cnn(cfg, seed=0, device=dev)["client"]
        batch = {"inputs": torch.as_tensor(rng.standard_normal(
                     (64, 32, 32, 3), dtype=np.float32), device=dev),
                 "labels": torch.as_tensor(rng.integers(0, 10, (64,)),
                                           device=dev)}
        seeds = O.leaf_seed_tree(cp, 4242)
        pz = O.Perturb(seeds=seeds, mu=mu, dual=False)

        def cnn_single():
            s = CNN.client_forward(cp, batch["inputs"], cfg, pz)
            return CNN.xent(CNN.aux_logits(cp, s, cfg, pz), batch["labels"])

        single_probe(
            "resnet18 single-probe client forward+aux loss (64 images)",
            lambda: P.cnn_api(dataclasses.replace(
                cfg, forward_impl="kernel")).client_dual_loss(
                    cp, batch, seeds, mu),
            cnn_single, {"zo_matmul": 4, "zo_matmul_tc": 2,
                         "flash_attention": 0, "flash_attention_tc": 0,
                         "zo_dual_matmul": 0}, 1e-5)
    return counts


# ---------------------------------------------------------------------------
# phases 9-10: K6 and the RG-LRU round
# ---------------------------------------------------------------------------

# (B, S, W) of K6 on the recurrentgemma round: every launch gets one half
# of a client's dual batch or one client's server batch, 2 x 512 tokens
# at lru_width 4096 (the whole-block fallback runs the clean and the
# perturbed half apart); (4, 512, 4096) is the stacked dual batch;
# (1, 512, 4096) a serving admission's prefill (phase 13)
K6_SHAPES = ((2, 512, 4096), (4, 512, 4096), (1, 512, 4096))
K6_RAGGED = ((1, 77, 1000), (1, 509, 4099), (3, 130, 129))
K6_GRAD_TOL = 1e-6


def k6_inputs(dev, B, S, W, seed=0):
    """a in (0.3, 0.999), the band RG-LRU's a = exp(-8 softplus(lam) r)
    lives in; b and the incoming gradient g standard normal."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = 0.3 + 0.699 * torch.rand((B, S, W), generator=gen, device=dev)
    b = torch.randn((B, S, W), generator=gen, device=dev)
    g = torch.randn((B, S, W), generator=gen, device=dev)
    return a, b, g


def check_k6(dev):
    """K6 forward and reverse mode against the plain loops with
    ``torch.equal``: both round each step as a multiply, then an add.  The
    autograd backward (K6 reverse) against autograd through the plain loop
    within K6_GRAD_TOL relative and absolute: the two form the same
    two-term sums and products, so they are equal in practice."""
    import torch
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import rg_lru as RG
    worst = 0.0
    for B, S, W in K6_SHAPES + K6_RAGGED:
        a, b, g = k6_inputs(dev, B, S, W, seed=B * S)
        h = RG.rg_lru_scan(a, b)
        ref = R.rg_lru_scan_ref(a, b)
        if not torch.equal(h, ref):
            fail(f"K6 forward ({B}, {S}, {W}) differs from plain: max |d| "
                 f"{max_abs(h, ref)}")
        da, db = RG.rg_lru_scan_reverse(a, g, h)
        rda, rdb = R.rg_lru_scan_reverse_ref(a, g, h)
        if not (torch.equal(da, rda) and torch.equal(db, rdb)):
            fail(f"K6 reverse ({B}, {S}, {W}) differs from plain: max |d| "
                 f"{max_abs(da, rda)}, {max_abs(db, rdb)}")
        ta, tb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        ka, kb = torch.autograd.grad(torch.sum(RG.rg_lru_scan(ta, tb) * g),
                                     (ta, tb))
        pa, pb = torch.autograd.grad(
            torch.sum(R.rg_lru_scan_ref(ta, tb) * g), (ta, tb))
        for got, want in ((ka, pa), (kb, pb)):
            d = (got - want).abs()
            if not bool((d <= K6_GRAD_TOL * (1 + want.abs())).all()):
                fail(f"K6 backward ({B}, {S}, {W}): max |d| "
                     f"{float(d.max())}")
            worst = max(worst, float(d.max()))
        del a, b, g, h, ref, da, db, rda, rdb, ta, tb, ka, kb, pa, pb
    log(9, f"K6 rg_lru_scan == plain bit for bit, forward and reverse mode, "
        f"at {K6_SHAPES + K6_RAGGED}; autograd backward vs autograd through "
        f"the plain loop: max |d| {worst} (tolerance {K6_GRAD_TOL} x (1 + "
        f"|ref|))")
    return 0.0


def rg_round_config():
    """recurrentgemma-9b at full width, depth cut 38 -> 8 layers: the
    port's AdamW keeps f32 m and v, 63 GB for the full 7.88 B-param
    server, which with its bf16 weights and gradients does not fit one
    80 GB card.  8 layers keep the client's two RG-LRU blocks
    (cut_layers=2) and give the server two repeats of (local_attn, rg_lru,
    rg_lru)."""
    from repro_torch.configs.recurrentgemma_9b import full_config
    return full_config().replace(n_layers=8)


def run_rg_round(dev, card):
    """Launches: K6 32 = 8 client (2 RG-LRU blocks x 2 halves of the dual
    batch x 2 clients) + 16 server forward (4 RG-LRU blocks x 2 clients,
    each again in the backward's recompute of its checkpointed rep,
    cfg.remat) + 8 server backward.  K1 14 = per client 6 (the
    embedding's noise rows; one theta + mu*U tree for each of the two client blocks' fallback, one
    for the aux norm and one for the tied table; the direction tree, all
    17 leaves in one launch) x 2, and the seed replay's two direction
    trees.  No K2-K5: the fallback's products are plain matmuls and the
    server's local attention the plain blocked version.
    The weights come from the card's generator (seeded): 2.83 B normals
    from the CPU generator would take tens of seconds."""
    from repro_torch.core.split import param_bytes
    from repro_torch.tree import tree_leaves
    cfg = rg_round_config()
    setup = _round_setup(cfg, dev, n_clients=2, h=1, batch=2, seq=512,
                         mu=1e-3, lr=1e-4, server_lr=2e-4,
                         draw_on_device=True)
    state = setup[0]
    n_c = sum(t.numel() for t in tree_leaves(state["client"]))
    n_s = sum(t.numel() for t in tree_leaves(state["server"]))
    log(10, f"recurrentgemma-9b at full width (d_model 4096, lru_width "
        f"4096, 16 heads, 1 KV head, head_dim 256, d_ff 12288, vocab "
        f"256000, bf16), n_layers cut 38 -> 8: client {n_c} params "
        f"({param_bytes(state['client'])} B), server {n_s} params")
    del state
    counts = drive_round(
        10, f"recurrentgemma-9b 8-layer round (N=2 h=1 n_pairs=1, 2x512 "
        f"tokens per client, seed_replay) on {card}", setup,
        {"rg_lru_scan": 32, "zo_noise": 14, "zo_dual_matmul": 0,
         "zo_dual_matmul_tc": 0, "zo_dual_flash_attention": 0,
         "zo_dual_flash_attention_tc": 0, "zo_matmul": 0, "zo_matmul_tc": 0,
         "flash_attention": 0, "flash_attention_tc": 0})
    del setup
    return counts


def check_rg_small_round():
    """The recurrentgemma smoke config (f32) on the card against the CPU.
    The server's AdamW eps is 1e-6: its first step is g/(|g| + eps), and
    a gradient entry that is rounding noise (~1e-9) moves a param by
    O(lr) at eps 1e-8; at 1e-6 by under lr/1000."""
    from repro_torch.configs.recurrentgemma_9b import smoke_config
    check_small_round(10, "recurrentgemma smoke_config round (N=2 h=2, "
                      "2x16 tokens)", lambda d: _round_setup(
                          smoke_config(), d, n_clients=2, h=2, batch=2,
                          seq=16, mu=1e-2, lr=1e-3, server_lr=1e-4, seed=3,
                          server_eps=1e-6))


# ---------------------------------------------------------------------------
# phase 11: the first-order baselines
# ---------------------------------------------------------------------------

# what a first-order round launches: none of the ZO kernels, and K6 only
# in RG-LRU blocks
NO_ZO_KERNELS = {k: 0 for k in (
    "zo_noise", "zo_dual_matmul", "zo_dual_matmul_tc",
    "zo_dual_flash_attention", "zo_dual_flash_attention_tc", "zo_matmul",
    "zo_matmul_tc", "flash_attention", "flash_attention_tc")}
FO_ROUND_METHODS = ("cse_fsl", "sflv1", "sflv2", "splitlora")


def run_fo_rounds(dev, card):
    """One round of each first-order baseline at phase 5's and phase 6's
    sizes (gpt2-small: N=2, h=1, 4 x 256 tokens, AdamW clients; SplitLoRA
    with rank-8 adapters on the client's projections; ResNet-18: N=5, 64
    images), through drive_round: no K1-K5 launch, no K6."""
    from repro_torch.configs.gpt2 import gpt2_small
    from repro_torch.configs.resnet18_cifar import full_config
    expect = dict(NO_ZO_KERNELS, rg_lru_scan=0)
    for method in FO_ROUND_METHODS:
        drive_round(11, f"gpt2-small {method} round (N=2 h=1, 4x256 tokens "
                    f"per client, dense uplink"
                    f"{', rank-8 LoRA' if method == 'splitlora' else ''}) "
                    f"on {card}",
                    _round_setup(gpt2_small(), dev, n_clients=2, h=1,
                                 batch=4, seq=256, mu=1e-3, lr=1e-4,
                                 server_lr=2e-4, method=method,
                                 lora_rank=8 if method == "splitlora"
                                 else 0),
                    expect)
    for method in ("cse_fsl", "sflv2"):
        drive_round(11, f"resnet18 {method} round (N=5 h=1, 64 images "
                    f"32x32x3 per client, dense uplink) on {card}",
                    _cnn_round_setup(full_config(), dev, n_clients=5, h=1,
                                     batch=64, hw=32, mu=1e-3, lr=2e-3,
                                     server_lr=2e-3, method=method),
                    expect)


# profiled client steps after the warm-up and the memory step; the
# device time is their median
STEP_REPS = 5


def step_device_time(fn):
    """Device busy time of ``STEP_REPS`` profiled calls of ``fn``:
    ``(median ms, min ms, max ms, kernels per call, the kernels whose
    launch count differed between calls as {name: [count per call]},
    the median call's rows)``."""
    reps = [device_rows(fn) for _ in range(STEP_REPS)]
    busy = [sum(r[0] for r in rows) / 1e3 for rows in reps]
    by_name = [{k: n for _, n, k in rows} for rows in reps]
    varied = {k[:56]: [d.get(k, 0) for d in by_name]
              for k in sorted(set().union(*by_name))
              if len({d.get(k, 0) for d in by_name}) > 1}
    mid = sorted(range(STEP_REPS), key=busy.__getitem__)[STEP_REPS // 2]
    return (busy[mid], min(busy), max(busy),
            [sum(r[1] for r in rows) for rows in reps], varied, reps[mid])


def client_step_costs(desc, api, params, batch, fwd, mu, lr, card,
                      api_remat_off=None):
    """One client's local step alone, HERON against the first-order
    clients: HERON's dual-probe step (K1-K3 or K1-K2, plain SGD on the
    lean uplink), CSE-FSL's (autograd through client and aux head, AdamW)
    and SFLV2's (autograd through client and server, both AdamW; its
    transient holds the server's activations and gradients too).  With
    ``api_remat_off`` (the same model with remat off) CSE-FSL's and
    SFLV2's steps run a second time on it: ``api``'s stacks recompute
    each rep's forward in the backward (cfg.remat, the reference's
    default), ``api_remat_off``'s keep every activation.

    Peak: ``reset_peak_memory_stats``, then ``max_memory_allocated`` less
    what was allocated before the step (params, optimizer states, batch):
    the step's transient.  The client's peak is its resident state (its
    params, its optimizer's state) plus that transient.  Beside each the
    paper's Table I value (``split.client_costs``, with the forward
    FLOPs ``f_c`` / ``f_a`` counted by ``FlopCounterMode`` and the
    smashed bytes from ``fwd``).  Device time: the step's kernels'
    summed time under torch.profiler, the median of ``STEP_REPS`` steps
    with its spread and the kernels whose launch count varied (CUDA
    events around a run of steps would time the host: an FO step
    enqueues thousands of elementwise launches, more than the launch
    queue holds).  Ratios are printed, not gated."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.core import protocols as P
    from repro_torch.core import split as S
    from repro_torch.core import zo as Z
    from repro_torch.optim.optimizers import adamw, zo_sgd
    from repro_torch.tree import tree_leaves
    cp, sp = params["client"], params["server"]
    state_bytes = lambda tree: S.param_bytes(     # noqa: E731
        [t for t in tree_leaves(tree) if torch.is_tensor(t)])
    zo = Z.ZOConfig(mu=mu, n_pairs=1)
    sgd, adam = zo_sgd(lr), adamw(lr)
    heron = P.make_local_update(api, "heron", zo, sgd, uplink="seed_replay",
                                client_lr=lr)
    cse = P.make_local_update(api, "cse_fsl", zo, adam)
    locked = P.make_locked_step(api, adam, adam)
    oc_h, oc_a, os_ = sgd.init(cp), adam.init(cp), adam.init(sp)
    # name -> (method, step, its optimizer state)
    steps = {"heron": ("heron", lambda: heron(cp, oc_h, batch, 1234), oc_h),
             "cse_fsl": ("cse_fsl", lambda: cse(cp, oc_a, batch, 0), oc_a),
             "sflv2": ("sflv2", lambda: locked(cp, oc_a, sp, os_, batch),
                       oc_a)}
    if api_remat_off is not None:
        cse_off = P.make_local_update(api_remat_off, "cse_fsl", zo, adam)
        locked_off = P.make_locked_step(api_remat_off, adam, adam)
        steps["cse_fsl remat off"] = (
            "cse_fsl", lambda: cse_off(cp, oc_a, batch, 0), oc_a)
        steps["sflv2 remat off"] = (
            "sflv2", lambda: locked_off(cp, oc_a, sp, os_, batch), oc_a)

    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        smashed = fwd["client"](cp, batch)
    f_c = fc.get_total_flops()
    with torch.no_grad(), FlopCounterMode(display=False) as fa:
        fwd["aux"](cp, smashed, batch)
    f_a = fa.get_total_flops()
    n_aux = sum(t.numel() for t in tree_leaves(cp["aux"]))
    n_client = sum(t.numel() for t in tree_leaves(cp)) - n_aux
    bpp = tree_leaves(cp)[0].element_size()
    costs_kw = dict(p_batch_bytes=batch["inputs"].numel()
                    * batch["inputs"].element_size(),
                    q_smashed_bytes=smashed.numel() * smashed.element_size(),
                    client_params=n_client, aux_params=n_aux, f_c=f_c,
                    f_a=f_a, n_pairs=1, bytes_per_param=bpp)
    del smashed
    resident_params = state_bytes(cp)
    out = {}
    for name, (method, fn, opt_state) in steps.items():
        fn()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        transient = torch.cuda.max_memory_allocated() - base
        del res
        busy_ms, lo, hi, n_kernels, varied, rows = step_device_time(fn)
        resident = resident_params + state_bytes(opt_state)
        table = S.client_costs(method, **costs_kw)
        out[name] = (resident + transient, transient, busy_ms)
        log(11, f"{desc} client step {name}: device busy median {busy_ms} "
            f"ms of {STEP_REPS} steps (min {lo}, max {hi}), kernels per "
            f"step {n_kernels}, launch counts that varied {varied}")
        if name == "heron":
            log(11, f"{desc} client step heron kernels (median step): "
                + "; ".join(f"{k[:56]} x{n} {us:.1f} us"
                            for us, n, k in sorted(rows, reverse=True)))
        log(11, f"{desc} client step {name}: wall {wall_ms} ms; step "
            f"transient {transient} B, client resident {resident} B "
            f"(params {resident_params} + optimizer "
            f"{resident - resident_params}), client peak "
            f"{resident + transient} B; Table I peak_mem_bytes "
            f"{table['peak_mem_bytes']} flops {table['flops']} comm_bytes "
            f"{table['comm_bytes']} on {card}")
    t_h = S.client_costs("heron", **costs_kw)
    for fo, (method, _, _) in steps.items():
        if method == "heron":
            continue
        t_f = S.client_costs(method, **costs_kw)
        log(11, f"{desc} HERON / {fo}: client peak "
            f"{out['heron'][0] / out[fo][0]:.4f} (Table I "
            f"{t_h['peak_mem_bytes'] / t_f['peak_mem_bytes']:.4f}), step "
            f"transient {out['heron'][1] / out[fo][1]:.4f}, median device "
            f"busy "
            f"{out['heron'][2] / out[fo][2]:.4f} (Table I flops "
            f"{t_h['flops'] / t_f['flops']:.4f}); f_c {f_c} f_a {f_a} "
            f"client params {n_client} aux params {n_aux}")
    for fo in ("cse_fsl", "sflv2"):
        if f"{fo} remat off" in out:
            on, off = out[fo], out[f"{fo} remat off"]
            log(11, f"{desc} {fo} remat on / off: client peak {on[0]} / "
                f"{off[0]} B ({on[0] / off[0]:.4f}), step transient {on[1]} "
                f"/ {off[1]} B, median device busy {on[2]} / {off[2]} ms "
                f"({on[2] / off[2]:.4f}); HERON {out['heron'][0]} B, "
                f"{out['heron'][2]} ms on {card}")
    return out


def run_client_steps(dev, card):
    import torch
    from repro_torch.configs.gpt2 import gpt2_small
    from repro_torch.configs.resnet18_cifar import full_config
    from repro_torch.core import protocols as P
    from repro_torch.models import cnn as CNN
    from repro_torch.models import transformer as T
    cfg = gpt2_small()
    if not cfg.remat:
        fail("gpt2-small has remat off")
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 257)), device=dev)
    client_step_costs(
        "gpt2-small (4x256 tokens)",
        P.lm_api(cfg.replace(forward_impl="kernel")),
        T.init_lm(cfg, seed=0, device=dev),
        {"inputs": toks[:, :-1], "labels": toks[:, 1:]},
        {"client": lambda cp, b: T.client_forward(cp, cfg, b["inputs"]),
         "aux": lambda cp, s, b: T.aux_forward(cp, cfg, s)},
        mu=1e-3, lr=1e-4, card=card,
        api_remat_off=P.lm_api(cfg.replace(forward_impl="kernel",
                                           remat=False)))
    ccfg = full_config()
    client_step_costs(
        "resnet18 (64 images 32x32x3)",
        P.cnn_api(dataclasses.replace(ccfg, forward_impl="kernel")),
        CNN.init_cnn(ccfg, seed=0, device=dev),
        {"inputs": torch.as_tensor(rng.standard_normal(
            (64, 32, 32, 3), dtype=np.float32), device=dev),
         "labels": torch.as_tensor(rng.integers(0, ccfg.classes, (64,)),
                                   device=dev)},
        {"client": lambda cp, b: CNN.client_forward(cp, b["inputs"], ccfg),
         "aux": lambda cp, s, b: CNN.aux_logits(cp, s, ccfg)},
        mu=1e-3, lr=2e-3, card=card)


def run_knob_round(dev, card):
    """HERON on gpt2-small at h=2 with a smashed upload every second step
    and the int8 uplink: the server steps N * ceil(h / k) = 2 times.
    Launches: K2 24 and K3 4 per client step; K1 12 per client step (the
    embedding's noise rows, ten theta + mu*U trees, the direction tree)
    and one replay direction tree per (client, step)."""
    from repro_torch.configs.gpt2 import gpt2_small
    n, h, k = 2, 2, 2
    setup = _round_setup(gpt2_small(), dev, n_clients=n, h=h, batch=4,
                         seq=256, mu=1e-3, lr=1e-4, server_lr=2e-4,
                         fed_kw=dict(upload_every=k, quantize_uplink=True))
    drive_round(11, f"gpt2-small HERON round (N={n} h={h} upload_every={k} "
                f"quantize_uplink, seed_replay) on {card}", setup,
                {"zo_dual_matmul": 24 * n * h, "zo_dual_matmul_tc": 24 * n * h,
                 "zo_dual_flash_attention": 4 * n * h,
                 "zo_dual_flash_attention_tc": 4 * n * h,
                 "zo_noise": 12 * n * h + n * h, "zo_matmul": 0,
                 "flash_attention": 0, "rg_lru_scan": 0})
    state, rb, rnd = setup
    new, _ = rnd(state, rb, ROUND_KEY)
    steps = int(new["opt_server"]["step"])
    want = n * -(-h // k)
    if steps != want:
        fail(f"knob round: the server stepped {steps} times, expected "
             f"N * ceil(h / k) = {want}")
    log(11, f"knob round: the server stepped {steps} times = N * ceil(h / "
        f"k) = {want}")


def check_fo_small_rounds():
    """Every method's small round on the card against the CPU (phase 5's
    check_small_round).  FO rounds: AdamW eps 1e-6 on both sides, as the
    recurrentgemma check (a gradient entry that is rounding noise moves
    a param by O(lr) at eps 1e-8).  The recurrentgemma CSE-FSL round runs
    the RG-LRU scan's forward and reverse on K6 (counted)."""
    from repro_torch.configs.gpt2 import gpt2_tiny
    from repro_torch.configs.recurrentgemma_9b import smoke_config as rgs
    from repro_torch.configs.resnet18_cifar import smoke_config
    from repro_torch.models import transformer as T
    lm = dict(n_clients=2, h=2, batch=2, seq=32, mu=1e-2, lr=1e-4,
              server_lr=1e-4, seed=3, server_eps=1e-6)
    for method in ("cse_fsl", "fsl_sage", "sflv1", "sflv2", "splitlora"):
        check_small_round(11, f"gpt2-tiny {method} round (N=2 h=2)",
                          lambda d, m=method: _round_setup(
                              gpt2_tiny(), d, method=m,
                              lora_rank=4 if m == "splitlora" else 0, **lm))
    for method in ("cse_fsl", "sflv1"):
        check_small_round(11, f"cnn smoke_config {method} round (N=2 h=2, "
                          "4 images 8x8)", lambda d, m=method:
                          _cnn_round_setup(smoke_config(), d, n_clients=2,
                                           h=2, batch=4, hw=8, mu=1e-2,
                                           lr=1e-4, server_lr=1e-4, seed=3,
                                           server_eps=1e-6, method=m))
    check_small_round(11, "gpt2-tiny HERON round (N=2 h=2 upload_every=2 "
                      "quantize_uplink)", lambda d: _round_setup(
                          gpt2_tiny(), d, n_clients=2, h=2, batch=2, seq=32,
                          mu=1e-2, lr=1e-3, server_lr=1e-4, seed=3,
                          fed_kw=dict(upload_every=2, quantize_uplink=True)))
    cfg = rgs()
    reset_counts()
    check_small_round(11, "recurrentgemma smoke_config cse_fsl round (N=2 "
                      "h=2, 2x16 tokens)", lambda d: _round_setup(
                          cfg, d, n_clients=2, h=2, batch=2, seq=16,
                          mu=1e-2, lr=1e-4, server_lr=1e-4, seed=3,
                          server_eps=1e-6, method="cse_fsl"))
    counts = launch_counts()
    # per (client, step): the client and aux RG-LRU blocks forward and
    # backward; per server step: its RG-LRU blocks forward and backward;
    # every forward twice, the second in the backward's recompute
    # (cfg.remat); rg_lru_scan counts the reverse launches too
    n_rg = sum(s.mixer == "rg_lru" for s in T.client_specs(cfg)
               + T.aux_specs(cfg) + T.server_specs(cfg))
    want = 2 * 2 * n_rg
    if not cfg.remat:
        fail("the recurrentgemma smoke config has remat off")
    check_counts("recurrentgemma cse_fsl round on the card", counts,
                 dict(NO_ZO_KERNELS, rg_lru_scan=3 * want,
                      rg_lru_scan_reverse=want))
    log(11, f"recurrentgemma cse_fsl round: K6 {2 * want} forward ({want} "
        f"of them the backward's recompute) and {want} reverse launches "
        f"(the FO client's and the server's backward through the scan), "
        f"no K1-K5")


def time_k2_f32(dev, cnn_k2_launches):
    """K2 f32 at ResNet-18's block-conv im2col shape (per half 65536 rows
    x 576 -> 64), as phase 8 times K4's f32 row: on the tensor cores
    (3xTF32) and on the CUDA-core loop (x one element into a buffer, so
    the wrapper takes the loop), beside the plain version, two f32
    torch.matmul on materialised W and W + mu*U, and the bound (bytes, or
    the three tf32 products at the TF32 rate); held to the plain version
    under check_k2's f32 tolerance and to the route's arithmetic.
    ``cnn_k2_launches``: the ResNet round's K2 counts (all and on the
    tensor cores)."""
    import torch
    from repro_torch.kernels import noise as N
    from repro_torch.kernels import zo_matmul as ZM
    M, K, Nn = 64 * 1024, 576, 64
    xa, xb, w = k2_inputs(dev, torch.float32, M, K, Nn)
    xm = misaligned(xa)
    tc = lambda: ZM.zo_dual_matmul(xa, xb, w, 3, 0.0, 1e-3)  # noqa: E731
    loop = lambda: ZM.zo_dual_matmul(xm, xb, w, 3, 0.0, 1e-3)  # noqa: E731
    expect_route("K2 f32", tc, "zo_dual_matmul_tc", 1)
    expect_route("K2 f32", loop, "zo_dual_matmul_tc", 0)
    ya, yb = tc()
    ra, rb = k2_plain(xa, xb, w, 3, 0.0, 1e-3, False, True, 0)
    err = max(max_abs(ya, ra), max_abs(yb, rb))
    rmax = float(torch.maximum(ra.abs().max(), rb.abs().max()))
    if not err <= 1e-4 * rmax:
        fail(f"K2 f32 {M} x {K}x{Nn}: max |d| {err} > {1e-4 * rmax}")
    u = N.uniform_noise(3, w.shape, device=dev)
    worst = {}
    for got, x, m, p in ((ya, xa, 0.0, False), (yb, xb, 1e-3, True)):
        route_check(f"K2 f32 {M} x {K}x{Nn}", got, x, w, u, m, p, worst)
    # both against the f64 product of the same f32 operands
    ex = xb.double() @ (w + 1e-3 * u).double()
    exact = {k: float((v.double() - ex).abs().max() / ex.abs().max())
             for k, v in (("kernel", yb), ("plain", rb))}
    del ex
    ms, loop_ms = time_ms(tc), time_ms(loop)
    pl = time_ms(lambda: k2_plain(xa, xb, w, 3, 0.0, 1e-3, False, True, 0))
    wb = w + 1e-3 * u
    lib = time_ms(lambda: (torch.matmul(xa, w), torch.matmul(xb, wb)))
    b, by = bound_ms(4 * (2 * M * K + K * Nn + 2 * M * Nn),
                     3 * 2 * 2 * M * K * Nn, "tf32")
    log(11, f"K2 f32 resnet block0 576x64 M={M} per half: kernel_ms {ms} "
        f"(tensor cores, 3xTF32) loop_ms {loop_ms} (CUDA-core loop) "
        f"plain_ms {pl} library_ms {lib} (two f32 torch.matmul on "
        f"materialised W, W+mu*U) bound_ms {b} ({by}) max_abs_err {err} "
        f"(max|ref| {rmax}; {worst}; max |d| / max|y| from the f64 product "
        f"{exact}) launches {cnn_k2_launches} / ResNet round")


def run_fo_phase(dev, card, cnn_k2_launches):
    import torch
    run_fo_rounds(dev, card)
    torch.cuda.empty_cache()
    run_client_steps(dev, card)
    torch.cuda.empty_cache()
    run_knob_round(dev, card)
    check_fo_small_rounds()
    time_k2_f32(dev, cnn_k2_launches)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: the threefry stream and the dense family
# ---------------------------------------------------------------------------

# jax.random (jax 0.9.0, jax_threefry_partitionable=True as the JAX
# package sets it) for PRNGKey(20261016) and k = fold_in(key, 777); f32
# values as their bit patterns.  tests/test_torch_prng.py holds the
# installed jax to this table.
THREEFRY_GOLDEN = {
    "seed": 20261016,
    "key": [0, 20261016],
    "fold_in_777": [3745423994, 608282859],
    "split_3": [[2024068154, 665741589], [2438922811, 59935751],
                [3969958351, 1598922753]],
    "bits_8": [1594539311, 2462944828, 3018678734, 617175692, 3871579886,
               2754361830, 4201628848, 1649930832],
    "bits_70001_last_4": [3261116903, 4161677597, 632392253, 3907967548],
    "uniform_8": [1052644728, 1058196878, 1060367712, 1041442152,
                  1063699358, 1059335224, 1064988612, 1053077476],
    "uniform_m3.3_7.1_8": [1057989333, 1076526295, 1082150448, 3219594284,
                           1086481587, 1079485994, 1088157617, 1060239622],
    "normal_16": [3198694493, 1044224801, 1057511357, 3213372510,
                  1067783388, 1052331922, 1073822447, 3197555760,
                  3193348693, 1058025142, 1068030987, 1071047626,
                  3192151183, 3214404717, 1070904231, 1060520876],
    "permutation_10": [6, 2, 9, 5, 7, 3, 0, 8, 4, 1],
    "bernoulli_0.3_16": [0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0],
}
NORMAL_ULPS = 4         # the port's normals against JAX's (XLA's ErfInv)


def f32_bits(t):
    return t.detach().cpu().float().numpy().view(np.uint32).tolist()


def ulps(a, b):
    """Distance in f32 ulps of two f32 arrays (ordered integer views)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def check_threefry(dev):
    """The port's threefry against the golden table: keys, fold_in,
    split and the permutation (CPU tensors, as the port keeps keys and
    masks) bit for bit; bits, uniforms and Bernoulli draws on the card
    bit for bit; normals on the card within NORMAL_ULPS of JAX's and of
    the CPU's over 4 Mi entries, bits and uniforms there bit for bit."""
    import torch
    from repro_torch.core import prng as R
    g = THREEFRY_GOLDEN

    def same(what, got, want):
        if list(got) != list(want):
            fail(f"threefry {what}: {list(got)} != JAX's {list(want)}")

    key = R.PRNGKey(g["seed"])
    k = R.fold_in(key, 777)
    same("PRNGKey", key.tolist(), g["key"])
    same("fold_in", k.tolist(), g["fold_in_777"])
    same("split", R.split(k, 3).tolist(), g["split_3"])
    same("permutation", R.permutation(k, 10).tolist(), g["permutation_10"])
    same("bits on the card", R.random_bits(k, (8,), dev).cpu().tolist(),
         g["bits_8"])
    same("bits (70001,) on the card, last 4",
         R.random_bits(k, (70001,), dev)[-4:].cpu().tolist(),
         g["bits_70001_last_4"])
    same("uniform on the card", f32_bits(R.uniform(k, (8,), device=dev)),
         g["uniform_8"])
    same("uniform(-3.3, 7.1) on the card",
         f32_bits(R.uniform(k, (8,), -3.3, 7.1, device=dev)),
         g["uniform_m3.3_7.1_8"])
    same("bernoulli on the card",
         R.bernoulli(k, 0.3, (16,), dev).int().cpu().tolist(),
         g["bernoulli_0.3_16"])
    nz = R.normal(k, (16,), dev)
    d_gold = ulps(np.array(g["normal_16"], np.uint32).view(np.float32),
                  nz.cpu().numpy())
    if d_gold.max() > NORMAL_ULPS:
        fail(f"threefry normal on the card: {d_gold.tolist()} ulps from "
             "JAX's")
    shape = (1024, 4096)
    for what, fn in (("bits", lambda d: R.random_bits(k, shape, d)),
                     ("uniform", lambda d: R.uniform(k, shape, device=d))):
        if not torch.equal(fn(dev).cpu(), fn("cpu")):
            fail(f"threefry {what} {shape}: card != CPU")
    d_cpu = ulps(R.normal(k, shape, dev).cpu().numpy(),
                 R.normal(k, shape).numpy())
    if d_cpu.max() > NORMAL_ULPS:
        fail(f"threefry normal {shape}: card vs CPU {d_cpu.max()} ulps")
    log(12, f"threefry == JAX's golden table: PRNGKey, fold_in, split, "
        f"permutation bit for bit; bits, uniform (also -3.3..7.1), "
        f"bernoulli on the card bit for bit; normal on the card "
        f"{d_gold.tolist()} ulps from JAX's; card vs CPU over {shape}: bits "
        f"and uniform bit for bit, normal max {int(d_cpu.max())} ulps, "
        f"{float((d_cpu == 0).mean())} of entries equal")


def time_draws(desc, tree, card):
    """One threefry direction draw over ``tree`` (every leaf, JAX's
    leaf order) in each scale: device time (CUDA events, median of 3),
    the draw's peak memory above what was allocated before it, and the
    bound, 4 B written per entry (the f32 direction) over the card's
    memory rate; the draw's integer and f64 operations are no bound."""
    import torch
    from repro_torch.core import prng as R
    from repro_torch.core import zo as Z
    n = Z.tree_size(tree)
    key = R.fold_in(ROUND_KEY, 5)
    for scale in ("gaussian", "sphere"):
        zo = Z.ZOConfig(scale=scale)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        Z.direction_like(key, tree, zo)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = time_ms(lambda: Z.direction_like(key, tree, zo), reps=3)
        b, _ = bound_ms(4 * n, 0, "float32")
        log(12, f"threefry direction draw ({scale}) over the {desc} ({n} "
            f"entries): {ms} ms, peak {peak} B above the params, bound "
            f"{b} ms (4 B written per entry; {ms / b:.1f}x) on {card}; "
            f"library none")


# the qwen2-1.5b round's K2 and K1 launches (see run_qwen_round)
QWEN_K2, QWEN_K1 = 28, 30


def run_qwen_round(dev, card):
    """qwen2-1.5b at full width and depth (28 layers, d_model 1536, GQA
    12:2 at head_dim 128, d_ff 8960, vocab 151936 tied, bf16, cut 2) on
    the kernel stream: N=2, h=1, 4 x 256 tokens per client, seed_replay.
    Launches: K2 28 = per client the two client blocks' q k v o gate up
    down (the aux head has no block: aux_layers=0), all on the tensor
    cores; K3 4 = two blocks x two clients; K1 30 = per client 14 (the
    embedding's noise rows; twelve theta + mu*U trees: the two blocks'
    two norms and three qkv biases, the aux norm, the tied table; the
    direction tree) and the replay's two direction trees.  The weights
    come from the card's generator (seeded)."""
    import torch
    from repro_torch.configs.qwen2_1_5b import full_config
    from repro_torch.core.split import param_bytes
    from repro_torch.tree import tree_leaves
    setup = _round_setup(full_config(), dev, n_clients=2, h=1, batch=4,
                         seq=256, mu=1e-3, lr=1e-4, server_lr=2e-4,
                         draw_on_device=True)
    state, rb, rnd = setup
    n_c = sum(t.numel() for t in tree_leaves(state["client"]))
    n_s = sum(t.numel() for t in tree_leaves(state["server"]))
    log(12, f"qwen2-1.5b at full width and depth (28 layers, d_model 1536, "
        f"12 heads, 2 KV heads, head_dim 128, d_ff 8960, vocab 151936 tied, "
        f"bf16, cut 2): client {n_c} params ({param_bytes(state['client'])} "
        f"B), server {n_s} params")
    # every K1 and K2 launch of one round, recorded and run again against
    # the plain versions (as phase 2 does for gpt2-small's K1)
    k2_calls = []
    k1_calls, k1_rows = record_k1_calls(lambda: k2_calls.extend(
        record_k2_calls(lambda: rnd(state, rb, ROUND_KEY))))
    n_k1 = (check_k1_recorded("qwen2-1.5b round", k1_calls, dev)
            + check_k1_rows_recorded("qwen2-1.5b round", k1_rows))
    k2_worst = check_k2_recorded("qwen2-1.5b round", k2_calls, dev)
    k2_shapes = sorted({(M, K, Nn) for M, K, Nn, *_ in k2_calls})
    if n_k1 != QWEN_K1 or len(k2_calls) != QWEN_K2:
        fail(f"qwen2-1.5b round recorded {n_k1} K1 launches and "
             f"{len(k2_calls)} K2, expected {QWEN_K1} and {QWEN_K2}")
    n_leaves, n_el = check_k1_model_tree("qwen2-1.5b client tree",
                                         state["client"], dev)
    torch.cuda.empty_cache()
    log(12, f"qwen2-1.5b round's kernels == plain: K1's {len(k1_calls)} "
        f"tree calls ({n_k1 - len(k1_rows)} launches) on fresh inputs and "
        f"{len(k1_rows)} rows calls on their token ids, bit for bit; K2's "
        f"{len(k2_calls)} launches (M, K, N in {k2_shapes}) on fresh inputs "
        f"with their seeds, mus and offsets, within check_k2's tolerance "
        f"(max |d| {k2_worst}); K1's three modes over the client tree "
        f"({n_leaves} leaves, {n_el} entries) bit for bit")
    drive_round(
        12, f"qwen2-1.5b round (N=2 h=1 n_pairs=1, 4x256 tokens per client, "
        f"seed_replay) on {card}", setup,
        {"zo_dual_matmul": QWEN_K2, "zo_dual_matmul_tc": QWEN_K2,
         "zo_dual_flash_attention": 4, "zo_dual_flash_attention_tc": 4,
         "zo_noise": QWEN_K1, "zo_matmul": 0, "flash_attention": 0,
         "rg_lru_scan": 0})
    time_draws("qwen2-1.5b client tree", state["client"], card)
    del state, rb, rnd, setup


def sphere_in_bf16(dev, card):
    """Eq. 2's sphere direction on gpt2-small's bf16 client: u has norm
    1 over d ~ 6.7e7 entries, so mu * u ~ 1e-3 / 8190 per entry, below
    half the bf16 spacing of almost every weight: theta + mu*u rounds
    back to theta but where theta is 0 (the biases).  Counts the entries
    the probe moves and the coefficients of 4 pairs (printed, not
    gated: a property of the reference's arithmetic, which the port
    shares)."""
    import torch
    from repro_torch.configs.gpt2 import gpt2_small
    from repro_torch.core import prng as R
    from repro_torch.core import protocols as P
    from repro_torch.core import zo as Z
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cfg = gpt2_small()
    cp = T.init_lm(cfg, seed=0, device=dev)["client"]
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 257)), device=dev)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    zo = Z.ZOConfig(mu=1e-3, n_pairs=4, scale="sphere")
    key = R.fold_in(ROUND_KEY, 9)
    u = Z.unit_sphere_like(key, cp)
    moved = sum(int((a != b).sum()) for a, b in zip(
        tree_leaves(Z.add_scaled(cp, u, zo.mu)), tree_leaves(cp)))
    del u
    api = P.lm_api(cfg)
    with torch.no_grad():
        _, info = Z.zo_gradient(lambda q: api.client_loss(q, batch), cp,
                                key, zo)
    loss = float(info["loss"])
    log(12, f"sphere in bf16 (gpt2-small client, d {Z.tree_size(cp)}, mu "
        f"{zo.mu}): theta + mu*u differs from theta in {moved} entries; "
        f"coefficients of 4 pairs {info['coeffs'].tolist()} (loss {loss}, "
        f"one f32 ulp of it {float(np.spacing(np.float32(loss)))}) on "
        f"{card}")
    del cp


def run_threefry_rounds(dev, card):
    """The reference's default path (forward_impl="xla") at full width:
    gpt2-small at phase 5's size with gaussian directions (bf16: see
    sphere_in_bf16) and ResNet-18 at phase 6's with the sphere (f32).
    The client's probes are plain forwards and the replay draws with
    threefry: no K1-K6 launch."""
    from repro_torch.configs.gpt2 import gpt2_small
    from repro_torch.configs.resnet18_cifar import full_config
    expect = dict(NO_ZO_KERNELS, rg_lru_scan=0)
    setup = _round_setup(gpt2_small(), dev, n_clients=2, h=1, batch=4,
                         seq=256, mu=1e-3, lr=1e-4, server_lr=2e-4,
                         forward_impl="xla", scale="gaussian")
    drive_round(12, f"gpt2-small threefry round (gaussian, N=2 h=1 "
                f"n_pairs=1, 4x256 tokens per client, seed_replay) on {card}",
                setup, expect)
    time_draws("gpt2-small client tree", setup[0]["client"], card)
    del setup
    drive_round(12, f"resnet18 threefry round (sphere, N=5 h=1 n_pairs=1, "
                f"64 images 32x32x3 per client, seed_replay) on {card}",
                _cnn_round_setup(full_config(), dev, n_clients=5, h=1,
                                 batch=64, hw=32, mu=1e-3, lr=2e-2,
                                 server_lr=2e-3, forward_impl="xla",
                                 scale="sphere"), expect)


def check_threefry_small_rounds():
    """Small rounds on the card against the CPU (check_small_round):
    gpt2-tiny on the threefry stream in both scales with the mask drawn
    from the round key (N=4, participation 0.5, straggler_prob 0.3; the
    sphere at mu 1e-1 and lr 1e-4, see tests/torch_round_parity.py's
    THREEFRY_RATES), and one kernel round on each dense smoke config."""
    from repro_torch.configs import registry as REG
    from repro_torch.configs.gpt2 import gpt2_tiny
    for scale, mu, lr in (("gaussian", 1e-2, 1e-3), ("sphere", 1e-1, 1e-4)):
        check_small_round(
            12, f"gpt2-tiny threefry {scale} round (N=4 h=1, participation "
            f"0.5, straggler_prob 0.3, mask drawn)",
            lambda d, s=scale, m=mu, r=lr: _round_setup(
                gpt2_tiny(), d, n_clients=4, h=1, batch=2, seq=32, mu=m,
                lr=r, server_lr=1e-4, seed=3, forward_impl="xla", scale=s,
                fed_kw=dict(participation=0.5, straggler_prob=0.3)))
    for name in ("qwen2-1.5b", "qwen2.5-32b", "command-r-35b",
                 "gemma2-27b"):
        check_small_round(
            12, f"{name} smoke_config kernel round (N=2 h=1, 2x16 tokens)",
            lambda d, a=name: _round_setup(
                REG.get_config(a, smoke=True), d, n_clients=2, h=1, batch=2,
                seq=16, mu=1e-2, lr=1e-3, server_lr=1e-4, seed=3,
                server_eps=1e-6))


def run_threefry_phase(dev, card):
    import torch
    check_threefry(dev)
    run_threefry_rounds(dev, card)
    torch.cuda.empty_cache()
    sphere_in_bf16(dev, card)
    check_threefry_small_rounds()
    torch.cuda.empty_cache()
    run_qwen_round(dev, card)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 13: serving
# ---------------------------------------------------------------------------

# the sampled configuration of phase 13 (a) and the sampler timing of (b)
SERVE_SAMPLED = dict(greedy=False, temperature=0.8, top_k=40, top_p=0.95)
# phase 13's greedy streams of its full-width engines, by config name
# bf16 tolerance of the last-position logits of an admission's prefill
# through K5 (and K6) against the same prefill on the plain versions:
# each K5 output is within one bf16 rounding step (2^-8 relative) of the
# plain one, and a random-init model carries that through its layers;
# 2^-4 of the logits' largest magnitude holds tens of such steps
SERVE_LOGIT_TOL = 2 ** -4


def serve_queue(vocab, n, prompt_len, seed=0):
    """``n`` prompts of the serving driver's mixed lengths (1/2, 3/4 and
    1 of ``prompt_len``, cycled) from a seed."""
    from repro_torch.launch.serve import prompt_lengths
    rng = np.random.default_rng(seed)
    lengths = prompt_lengths(prompt_len)
    return [rng.integers(0, vocab, size=lengths[i % len(lengths)])
            for i in range(n)]


def run_engine(eng, prompts, max_new):
    rids = [eng.submit(p, max_new) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


def eager_serve(params, cfg, dev, prompts, max_new, capacity):
    """The per-token loop the engine replaces: requests batched by equal
    prompt length (the only batching scalar-pos caches allow), every
    prompt token and every new token one ``make_serve_step`` call, the
    greedy token read by the host each step.  Returns the token streams."""
    import torch
    from repro_torch.core import protocols as P
    serve = P.make_serve_step(cfg)
    groups = {}
    for i, p in enumerate(prompts):
        groups.setdefault(len(p), []).append(i)
    out = {}
    with torch.inference_mode():
        for idx in groups.values():
            batch = torch.as_tensor(np.stack([prompts[i] for i in idx]),
                                    device=dev)
            caches = P.init_serve_caches(cfg, len(idx), capacity, device=dev)
            for t in range(batch.shape[1]):
                logits, caches = serve(params, caches, batch[:, t:t + 1])
            toks = []
            for _ in range(max_new):
                tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)
                toks.append(tok.cpu())
                logits, caches = serve(params, caches, tok[:, None])
            gen = torch.stack(toks, dim=1).numpy()
            for j, i in enumerate(idx):
                out[i] = gen[j].tolist()
    return [out[i] for i in range(len(prompts))]


def n_mixers(cfg):
    """(attention layers, RG-LRU layers) of a config: K5 and K6 launches
    per admission on the card (mLSTM / sLSTM layers launch neither)."""
    specs = cfg.layer_specs()
    n_rec = sum(s.mixer == "rg_lru" for s in specs)
    n_attn = sum(s.mixer in ("global_attn", "local_attn") for s in specs)
    return n_attn, n_rec


def check_serve_smoke(dev):
    """(a) Every decoder-only arch of the port's registry on its smoke
    config (f32):
    the engine's greedy streams on the card == the same engine on the CPU
    == the eager per-token loop on the card (2 slots, capacity 24,
    segments of 4, prompts of 5 and 9 tokens, 6 new); K5 and K6 launch
    once per attention / RG-LRU layer and admission (f32: the CUDA-core
    loop); one sampled run (temperature 0.8, top-k 40, top-p 0.95) card
    == CPU."""
    import torch
    from repro_torch.configs import registry as REG
    from repro_torch.core import decode as D
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    cpu = torch.device("cpu")
    for arch in REG.ARCH_IDS:
        cfg = REG.get_config(arch, smoke=True)
        if cfg.enc_dec:          # its token loop is phase 16's
            continue
        pc = T.init_lm(cfg, seed=0, device="cpu")
        pg = tree_map(lambda t: t.to(dev), pc)
        prompts = [np.random.default_rng(0).integers(0, cfg.vocab, size=n)
                   for n in (5, 9)]
        n_attn, n_rec = n_mixers(cfg)
        reset_counts()
        card_out = run_engine(D.DecodeEngine(
            pg, cfg, slots=2, capacity=24, segment_len=4, device=dev),
            prompts, 6)
        counts = launch_counts()
        check_counts(f"{arch} smoke engine", counts, {
            "flash_attention": 2 * n_attn, "flash_attention_tc": 0,
            "rg_lru_scan": 2 * n_rec, "zo_noise": 0, "zo_dual_matmul": 0,
            "zo_matmul": 0, "zo_dual_flash_attention": 0})
        cpu_out = run_engine(D.DecodeEngine(
            pc, cfg, slots=2, capacity=24, segment_len=4, device=cpu),
            prompts, 6)
        eager = eager_serve(pg, cfg, dev, prompts, 6, 24)
        if not card_out == cpu_out == eager:
            fail(f"{arch} smoke engine: card {card_out} cpu {cpu_out} "
                 f"eager on the card {eager}")
        log(13, f"{arch} smoke engine (2 slots, prompts 5 and 9, 6 new): "
            f"greedy streams card == cpu == eager loop on the card "
            f"{card_out}; K5 {counts['flash_attention']} K6 "
            f"{counts['rg_lru_scan']} launches (2 admissions)")
    cfg = REG.get_config("qwen2-1.5b", smoke=True)
    pc = T.init_lm(cfg, seed=0, device="cpu")
    pg = tree_map(lambda t: t.to(dev), pc)
    prompts = [np.random.default_rng(1).integers(0, cfg.vocab, size=n)
               for n in (5, 9, 7)]
    sampled = [run_engine(D.DecodeEngine(
        params, cfg, slots=2, capacity=24, segment_len=4, seed=3,
        sampler=D.SamplerConfig(**SERVE_SAMPLED), device=d), prompts, 7)
        for params, d in ((pg, dev), (pc, cpu))]
    if sampled[0] != sampled[1]:
        fail(f"qwen2-1.5b smoke sampled engine: card {sampled[0]} cpu "
             f"{sampled[1]}")
    log(13, f"qwen2-1.5b smoke engine sampled ({SERVE_SAMPLED}, 3 requests, "
        f"7 new): card == cpu {sampled[0]}")


def timed_engine(eng):
    """Wrap the engine's admission and segment (synchronised host clock)
    and record each call's K5 / K6 launches.  Returns the records."""
    import torch
    rec = {"admit": [], "segment": []}

    def wrap(name, fn):
        def call(*args):
            torch.cuda.synchronize()
            before = launch_counts()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            after = launch_counts()
            rec[name].append((time.perf_counter() - t0, {
                k: after[k] - before[k] for k in after}))
            return out
        return call

    eng._admit_one = wrap("admit", eng._admit_one)
    eng._decode_segment = wrap("segment", eng._decode_segment)
    return rec


def prefill_vs_plain(cfg, params, prompt, dev):
    """The last position's logits of one admission's prefill through K5
    (and K6) against the same prefill with ``ops.flash_attention`` and
    ``ops.rg_lru_scan`` swapped for their plain versions (inside this
    script only; no K5 / K6 launch).  Returns (max |d|, max |logits|,
    first token agrees, top-2 gap of the plain logits)."""
    import torch
    from repro_torch.core import protocols as P
    from repro_torch.kernels import ops as O
    from repro_torch.kernels import ref as R
    from repro_torch.models import transformer as T

    def last_logits():
        tmp = P.init_serve_caches(cfg, 1, len(prompt), per_slot=True,
                                  device=dev)
        x = P.decoder_hidden(params, cfg, tmp,
                             torch.as_tensor(prompt, device=dev)[None])
        return T.lm_head(params, cfg, x[:, -1:])[0, -1, :cfg.vocab]

    with torch.inference_mode():
        got = last_logits()
        saved = O.flash_attention, O.rg_lru_scan
        O.flash_attention, O.rg_lru_scan = (R.flash_attention_ref,
                                            R.rg_lru_scan_ref)
        reset_counts()
        try:
            ref = last_logits()
        finally:
            O.flash_attention, O.rg_lru_scan = saved
        if launch_counts()["flash_attention"] or \
                launch_counts()["rg_lru_scan"]:
            fail("the plain prefill launched K5 or K6")
    d = max_abs(got, ref)
    top2 = torch.topk(ref, 2).values
    return (d, float(ref.abs().max()), int(got.argmax()) == int(ref.argmax()),
            float(top2[0] - top2[1]))


def run_serve(dev, card, desc, cfg, slots, prompt_len, max_new, n_req,
              segment, phase=13, compare=True):
    """The engine at full width on a mixed queue (greedy), its launch
    counts held per admission (K5 on the tensor cores once per attention
    layer, K6 once per RG-LRU layer) and per segment (none); then one
    segment profiled and the sampler timed.  With ``compare`` (phase 13)
    the eager per-token loop then runs the queue's shortest-prompt
    requests and one admission's prefill is held against the plain
    kernels; without it
    (phase 15) every K5 launch of the run is recorded and held against
    its plain version on its own inputs.  A decode step's byte bound:
    every weight read once (bf16) and every slot's recurrent state read
    and written, over the card's memory rate.  Returns the run's launch
    counts and its greedy streams."""
    import torch
    from repro_torch.core import decode as D
    from repro_torch.core import protocols as P
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_leaves_with_path
    params = T.init_lm(cfg, seed=0, device=dev, draw_on_device=True)
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    prompts = serve_queue(cfg.vocab, n_req, prompt_len)
    capacity = prompt_len + max_new
    state_bytes = sum(
        t.numel() * t.element_size() for path, t in tree_leaves_with_path(
            P.init_serve_caches(cfg, slots, capacity, per_slot=True,
                                device="meta")) if "/rec/" in path)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves) \
        + 2 * state_bytes
    step_bound_ms, _ = bound_ms(n_bytes, 0, "bfloat16")
    n_attn, n_rec = n_mixers(cfg)
    eng = D.DecodeEngine(params, cfg, slots=slots, capacity=capacity,
                         segment_len=segment, device=dev)
    run_engine(eng, prompts[:slots], 2)            # warm-up
    eng = D.DecodeEngine(params, cfg, slots=slots, capacity=capacity,
                         segment_len=segment, device=dev)
    rec = timed_engine(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    if compare:
        streams = run_engine(eng, prompts, max_new)
    else:
        out = []
        k5_calls = record_k5_calls(lambda: out.append(
            run_engine(eng, prompts, max_new)))
        streams = out.pop()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_adm = len(rec["admit"])
    check_counts(desc, counts, {
        "flash_attention": n_attn * n_adm,
        "flash_attention_tc": n_attn * n_adm, "rg_lru_scan": n_rec * n_adm,
        "zo_noise": 0, "zo_dual_matmul": 0, "zo_matmul": 0,
        "zo_dual_flash_attention": 0})
    for s, c in rec["admit"]:
        if (c["flash_attention_tc"], c["rg_lru_scan"]) != (n_attn, n_rec):
            fail(f"{desc}: an admission launched {c}")
    for s, c in rec["segment"]:
        if any(c.values()):
            fail(f"{desc}: a decode segment launched {c}")
    total = sum(len(t) for t in streams)
    if total != n_req * max_new or n_adm != n_req:
        fail(f"{desc}: {total} tokens from {n_adm} admissions")
    if not all(0 <= t < cfg.vocab for s in streams for t in s):
        fail(f"{desc}: a token outside the vocab")
    adm_s = sum(s for s, _ in rec["admit"])
    seg_s = [s for s, _ in rec["segment"]]
    step_ms = statistics.median(1e3 * s / segment for s in seg_s)
    decoded = total - n_adm                # the first tokens: admissions
    log(phase, f"{desc} ({n_params} params, {n_attn} attention + {n_rec} "
        f"RG-LRU layers; {slots} slots, capacity {capacity}, segments of "
        f"{segment}; {n_req} requests, prompts {sorted(set(map(len, prompts)))}"
        f", {max_new} new each) on {card}: {total} tokens in wall_s {wall} "
        f"= sustained {total / wall} tok/s; {eng.segments} segments, "
        f"{eng.prefill_tokens} prefill tokens; prefill {n_adm} admissions "
        f"{adm_s} s = {eng.prefill_tokens / adm_s} prompt tok/s; decode "
        f"{sum(seg_s)} s = {decoded / sum(seg_s)} tok/s; median ms per "
        f"decode step {step_ms} vs byte bound {step_bound_ms} ms "
        f"({n_bytes} B: the weights, and {state_bytes} B of recurrent "
        f"state read and written) ({step_ms / step_bound_ms:.1f}x); "
        f"max_memory_allocated {peak}; launches {counts} (per admission K5 "
        f"{n_attn} on the tensor cores, K6 {n_rec}; per segment none)")
    if not compare and k5_calls:
        worst = check_k5_recorded(desc, k5_calls)
        if len(k5_calls) != counts["flash_attention"]:
            fail(f"{desc}: {len(k5_calls)} K5 calls recorded, "
                 f"{counts['flash_attention']} launched")
        log(phase, f"{desc}: every K5 launch of the run recorded "
            f"({len(k5_calls)}; q of "
            f"{sorted({tuple(a['q'].shape) for a, _ in k5_calls})}) == "
            f"plain within check_k5's tolerance on its own inputs: max |d| "
            f"{worst}")
        del k5_calls
    del eng._admit_one, eng._decode_segment
    # one segment: its wall unprofiled, then its device time profiled
    with torch.inference_mode():
        for p in prompts[:slots]:
            eng.submit(p, max_new)
        eng._admit()
        (_, wall_seg) = _timed(eng._decode_segment)
        rows = device_rows(eng._decode_segment)
    busy = sum(r[0] for r in rows) / 1e3
    rows.sort(reverse=True)
    top = "; ".join(f"{k[:40]} x{n} {us / 1e3:.3f} ms"
                    for us, n, k in rows[:6])
    log(phase, f"{desc}: one segment of {segment} steps, {slots} live slots: "
        f"wall {1e3 * wall_seg} ms, device busy {busy} ms (idle share "
        f"{1 - busy / (1e3 * wall_seg)}; profiled segment), "
        f"{sum(r[1] for r in rows) / segment:.0f} kernels a step; top "
        f"kernels: {top}")
    del eng
    # the sampler on a step's logits, beside greedy argmax
    logits = torch.randn((slots, cfg.vocab), device=dev)
    keys = torch.randint(0, 2 ** 32, (slots, 2), device=dev)
    s_cfg = D.SamplerConfig(**SERVE_SAMPLED)
    t_s = time_ms(lambda: D.sample_logits(logits, keys, s_cfg), reps=10)
    t_g = time_ms(lambda: D.sample_logits(logits, keys, D.SamplerConfig()),
                  reps=10)
    log(phase, f"{desc}: sampler on ({slots}, {cfg.vocab}) f32 logits: "
        f"{SERVE_SAMPLED} {t_s} ms (the threefry draw of all rows in one "
        f"pass) vs greedy argmax {t_g} ms (CUDA events)")
    if not compare:
        del params
        torch.cuda.empty_cache()
        return counts, streams
    # the eager per-token loop on the queue's shortest-prompt requests:
    # one batch (its time grows with the prompt tokens it feeds one by
    # one; it launches no kernel of the port)
    short = [i for i, p in enumerate(prompts)
             if len(p) == min(map(len, prompts))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = eager_serve(params, cfg, dev, [prompts[i] for i in short],
                        max_new, capacity)
    wall_e = time.perf_counter() - t0
    total_e = len(short) * max_new
    same = sum(a == streams[i] for a, i in zip(eager, short))
    first = sum(a[:8] == streams[i][:8] for a, i in zip(eager, short))
    log(phase, f"{desc}: eager per-token loop on the queue's {len(short)} "
        f"{len(prompts[short[0]])}-token-prompt requests (one batch, prompts "
        f"fed token by token, a host read per token): {total_e} tokens in "
        f"{wall_e} s = {total_e / wall_e} tok/s; engine / eager "
        f"{(total / wall) / (total_e / wall_e):.2f}x in tok/s; greedy "
        f"streams equal in {same} of {len(short)} requests, the first 8 "
        f"tokens in {first} (bf16: K5 prefill vs token-by-token decode "
        f"attention; not gated)")
    # one admission's prefill against the plain kernels
    d, mx, agree, gap = prefill_vs_plain(cfg, params, prompts[-1], dev)
    if not d <= SERVE_LOGIT_TOL * mx:
        fail(f"{desc}: prefill logits through the kernels vs plain: max "
             f"|d| {d} > {SERVE_LOGIT_TOL} x max |logits| {mx}")
    if gap > 2 * d and not agree:
        fail(f"{desc}: the first token differs from plain's though the "
             f"top-2 gap {gap} > 2 max |d| {d}")
    log(phase, f"{desc}: one {len(prompts[-1])}-token prefill's last logits "
        f"through K5{' / K6' if n_rec else ''} vs their plain versions: max "
        f"|d| {d} <= {SERVE_LOGIT_TOL} x max |logits| {mx}; first token "
        f"{'agrees' if agree else 'differs'} (plain top-2 gap {gap})")
    del params
    torch.cuda.empty_cache()
    return counts, streams


def run_serve_phase(dev, card):
    """Phase 13.  (b) qwen2-1.5b at full width and depth (bf16): per
    decode step the whole model's bf16 weights, 3.09 GB, are read at
    least once: 0.92 ms at 3.35 TB/s.  (c) recurrentgemma-9b at full
    width and depth, 38 layers (serving keeps no optimizer state, so
    phase 10's cut does not apply): 18.7 GB, 5.6 ms.  Returns the K5 and
    K6 launches of (b) and (c), and (b)'s greedy streams (phase 23 (c)
    holds its own beside them)."""
    import torch
    from repro_torch.configs import qwen2_1_5b, recurrentgemma_9b
    check_serve_smoke(dev)
    torch.cuda.empty_cache()
    counts, streams = {}, {}
    for desc, cfg, kw in (
            ("qwen2-1.5b engine (28 layers, bf16, greedy)",
             qwen2_1_5b.full_config(),
             dict(slots=8, prompt_len=512, max_new=128, n_req=24,
                  segment=16)),
            ("recurrentgemma-9b engine (38 layers, bf16, greedy)",
             recurrentgemma_9b.full_config(),
             dict(slots=4, prompt_len=512, max_new=64, n_req=8,
                  segment=16))):
        c, streams[cfg.name] = run_serve(dev, card, desc, cfg, **kw)
        for k in ("flash_attention", "rg_lru_scan"):
            counts[k] = counts.get(k, 0) + c[k]
    return counts, streams[qwen2_1_5b.full_config().name]


# ---------------------------------------------------------------------------
# phase 14: the training driver
# ---------------------------------------------------------------------------

# one HERON datacenter step on qwen2-1.5b (one client, one pair): K2 the
# two client blocks' q k v o gate up down (the aux head has no block),
# K3 one per client block, K1 the embedding's noise rows, twelve theta +
# mu*U trees (the two blocks' two norms and three qkv biases, the aux
# norm, the tied table) and the direction tree: phase 12's per-client
# counts, with no replay
QWEN_STEP = {"zo_dual_matmul": 14, "zo_dual_matmul_tc": 14,
             "zo_dual_flash_attention": 2, "zo_dual_flash_attention_tc": 2,
             "zo_noise": 14, "zo_matmul": 0, "flash_attention": 0,
             "rg_lru_scan": 0}
# gpt2-medium: the six client blocks and the aux head's three, six
# projections each (q k v o up down) and one attention each; K1 the
# noise rows, twenty theta + mu*U trees (the nine blocks' two norms, the
# aux norm, the tied table) and the direction tree
MEDIUM_STEP = {"zo_dual_matmul": 54, "zo_dual_matmul_tc": 54,
               "zo_dual_flash_attention": 9,
               "zo_dual_flash_attention_tc": 9, "zo_noise": 22,
               "zo_matmul": 0, "flash_attention": 0, "rg_lru_scan": 0}


def _lm_batch(vocab, batch, seq, dev, seed=0):
    import torch
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, vocab, (batch, seq + 1)),
                           device=dev)
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


def _train_step(cfg, lr, server_lr, mu, method="heron"):
    """``(client optimizer, server optimizer, step)``: HERON's datacenter
    step (ZO-SGD client at ``lr``, AdamW server), as the launch
    driver."""
    from repro_torch.core import protocols as P
    from repro_torch.core import zo as Z
    from repro_torch.optim.optimizers import adamw, zo_sgd
    copt = zo_sgd(lr) if method == "heron" else adamw(lr, eps=1e-6)
    sopt = adamw(server_lr, eps=1e-6)
    return copt, sopt, P.make_train_step(P.lm_api(cfg), method,
                                         Z.ZOConfig(mu=mu), copt, sopt)


def _train_parts(cfg, params, lr, server_lr, mu, method="heron"):
    """``(state, step)``: :func:`_train_step` from ``PRNGKey(1)``."""
    from repro_torch.core import prng as R
    from repro_torch.core import protocols as P
    copt, sopt, step = _train_step(cfg, lr, server_lr, mu, method)
    return P.init_train_state(R.PRNGKey(1), params, copt, sopt), step


def _state_finite(desc, state):
    import torch
    from repro_torch.tree import tree_leaves
    for t in tree_leaves(state["params"]):
        if not bool(torch.isfinite(t.float()).all()):
            fail(f"{desc}: non-finite parameters")


def _moved(a, b):
    import torch
    from repro_torch.tree import tree_leaves
    return any(not torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b)))


def _tree_equal(a, b):
    import torch
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        (torch.equal(x.cpu(), y.cpu()) if torch.is_tensor(x) else x == y)
        for x, y in zip(la, lb))


def timed_step(phase, desc, step, state, batch, expect, card):
    """One more step from ``state``, its launches counted from 0 (against
    ``expect``), its wall and peak memory; then one step under the
    profiler for the device's busy time.  Returns the new state and
    the timed step's launches."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    new, m = step(state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_counts(desc, counts, expect)
    loss, closs = float(m["loss"]), float(m["client_loss"])
    if not (np.isfinite(loss) and np.isfinite(closs)):
        fail(f"{desc}: losses not finite: {loss} / {closs}")
    _state_finite(desc, new)
    if not _moved(state["params"]["client"], new["params"]["client"]):
        fail(f"{desc}: the step left every client leaf unchanged")
    del state
    rows = device_rows(lambda: step(new, batch))
    busy = sum(r[0] for r in rows) / 1e3
    idle = (f"device busy {busy:.3f} ms, idle share "
            f"{1 - busy / (1e3 * wall):.3f}" if busy > 0 else
            "device busy not measured (the profiler saw no device time)")
    log(phase, f"{desc} on {card}: loss {loss} client_loss {closs} "
        f"zo_coeff_abs {float(m.get('zo_coeff_abs', float('nan')))}; "
        f"wall {1e3 * wall:.3f} ms, {idle}, max_memory_allocated {peak}; "
        f"launches per step {counts}")
    return new, counts


def recorded_step(desc, step, state, batch, expect, dev, card, phase=14):
    """One step with every K1, K2 and K3 launch recorded, each held
    against its plain version (K1 bit for bit and K2 on fresh inputs of
    the launch's shape, seed and flags; K3 on the call's own inputs), the
    recorded launches against ``expect``.  Returns the new state."""
    import torch
    out, k2_calls, k3_calls = [], [], []

    def run():
        k3_calls.extend(record_k3_calls(lambda: out.append(
            step(state, batch))))

    k1_calls, k1_rows = record_k1_calls(lambda: k2_calls.extend(
        record_k2_calls(run)))
    new = out.pop()[0]
    n_k1 = (check_k1_recorded(desc, k1_calls, dev)
            + check_k1_rows_recorded(desc, k1_rows))
    k2_worst = check_k2_recorded(desc, k2_calls, dev)
    k3_worst = check_k3_recorded(desc, k3_calls)
    got = (n_k1, len(k2_calls), len(k3_calls))
    want = (expect["zo_noise"], expect["zo_dual_matmul"],
            expect["zo_dual_flash_attention"])
    if got != want:
        fail(f"{desc} recorded {got} K1 / K2 / K3 launches, expected "
             f"{want}")
    shapes = sorted({tuple(a["qa"].shape) + (a["k"].shape[2],)
                     for a, _ in k3_calls})
    torch.cuda.empty_cache()
    log(phase, f"{desc}'s kernels == plain: K1's {len(k1_calls)} tree calls "
        f"and {len(k1_rows)} rows calls ({n_k1} launches) bit for bit, "
        f"K2's {len(k2_calls)} launches within check_k2's tolerance (max "
        f"|d| {k2_worst}), K3's {len(k3_calls)} launches (B, S, H, D, Kv "
        f"{shapes}) within check_k3's on their own inputs (max |d| "
        f"{k3_worst}) on {card}")
    return new


def run_qwen_train_step(dev, card, cfg, params):
    """14(a): three HERON datacenter steps on qwen2-1.5b at full width
    and depth, 4 x 256 tokens, AdamW on the server: the first with every
    K1, K2 and K3 launch recorded and held against plain, the second
    timed with its launches, the third profiled.  Returns the timed
    step's launches."""
    batch = _lm_batch(cfg.vocab, 4, 256, dev)
    state, step = _train_parts(cfg, params, lr=1e-4, server_lr=2e-4,
                               mu=1e-3)
    state = recorded_step("qwen2-1.5b step", step, state, batch, QWEN_STEP,
                          dev, card)
    state, counts = timed_step(
        14, "qwen2-1.5b HERON datacenter step (28 layers, d_model 1536, "
        "vocab 151936 tied, bf16, cut 2; 4x256 tokens, n_pairs 1, AdamW "
        "server)", step, state, batch, QWEN_STEP, card)
    del state
    return counts


def run_qwen_async(dev, card, cfg, params):
    """14(b): from one state, N=2 h=1, 4 x 256 tokens a client: the sync
    seed-replay round and the async round at buffer_k=0, alpha=0 bit for
    bit (client and server params); then buffer_k=1, alpha=0.5 with the
    durations of the port's cut planner over its PROFILES."""
    import torch
    from repro_torch.core import protocols as P
    from repro_torch.core import zo as Z
    from repro_torch.fed import cutplan as CP
    from repro_torch.optim.optimizers import adamw, zo_sgd
    from repro_torch.tree import tree_map
    lr, zo = 1e-4, Z.ZOConfig(mu=1e-3)
    api = P.lm_api(cfg)
    sopt = adamw(2e-4)
    fed = P.FedConfig(n_clients=2, h=1)
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 1, 4, 257)),
                           device=dev)
    rb = {"inputs": toks[..., :-1], "labels": toks[..., 1:]}
    state = {"client": params["client"], "server": params["server"],
             "opt_server": sopt.init(params["server"])}
    sync = P.make_fed_round(api, "heron", zo, fed, zo_sgd(lr), sopt,
                            uplink="seed_replay", client_lr=lr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, m_sync = sync(state, rb, ROUND_KEY)
    torch.cuda.synchronize()
    sync_wall = time.perf_counter() - t0
    host = tree_map(lambda t: t.cpu(), {"client": new["client"],
                                        "server": new["server"]})
    del new
    torch.cuda.empty_cache()

    def run(buffer_k, alpha, durations):
        rnd = P.make_async_round(api, "heron", zo, fed, zo_sgd(lr), sopt,
                                 client_lr=lr, staleness_alpha=alpha,
                                 buffer_k=buffer_k)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, m = rnd(state, rb, ROUND_KEY, durations=durations)
        torch.cuda.synchronize()
        return out, m, time.perf_counter() - t0, \
            torch.cuda.max_memory_allocated()

    new, m, wall, peak = run(0, 0.0, [2.0, 1.0])
    for part in ("client", "server"):
        if not _tree_equal(host[part], new[part]):
            fail(f"qwen2-1.5b async round at buffer_k=0 differs from the "
                 f"sync round in {part} params")
    del new, host
    torch.cuda.empty_cache()
    log(14, f"qwen2-1.5b async round (N=2 h=1, buffer_k=0, alpha=0, "
        f"durations [2, 1]) == sync seed-replay round bit for bit, client "
        f"and server params; client_loss {float(m['client_loss'])} "
        f"(sync {float(m_sync['client_loss'])}), flushes {m['flushes']}; "
        f"wall {wall:.3f} s (the sync round {sync_wall:.3f} s), "
        f"max_memory_allocated {peak} on {card}")
    t0 = time.perf_counter()
    costs = CP.candidate_costs(cfg, {k: v[0, 0] for k, v in rb.items()})
    cost_s = time.perf_counter() - t0
    profiles = [CP.PROFILES["phone"], CP.PROFILES["laptop"]]
    plans = CP.plan_fleet(costs, profiles, fed.h, zo.n_pairs)
    new, m, wall, peak = run(1, 0.5, [p.round_s for p in plans])
    _state_finite("qwen2-1.5b buffered async round", {"params": {
        "client": new["client"], "server": new["server"]}})
    if m["flushes"] != 2.0:
        fail(f"qwen2-1.5b async round at buffer_k=1: {m['flushes']} "
             "flushes, expected 2")
    del new
    plan_txt = "; ".join(f"{p.name} cut {pl.cut} est {pl.round_s:.4g} s "
                         f"feasible {pl.feasible}"
                         for p, pl in zip(profiles, plans))
    log(14, f"qwen2-1.5b cut planner: {len(costs)} cuts counted on the meta "
        f"device in {cost_s:.1f} s host time (cut 1: {costs[0].flops:.4g} "
        f"FLOPs, {costs[0].bytes:.4g} B; cut {costs[-1].cut}: "
        f"{costs[-1].flops:.4g} FLOPs, {costs[-1].bytes:.4g} B); plans "
        f"{plan_txt}; on {card}")
    log(14, f"qwen2-1.5b async round (buffer_k=1, alpha=0.5, planned "
        f"durations): flushes {m['flushes']}, mean_staleness "
        f"{m['mean_staleness']}, time_to_first_update_s "
        f"{m['time_to_first_update_s']:.4g}, updates_per_sim_s "
        f"{m['updates_per_sim_s']:.4g}, client_loss "
        f"{float(m['client_loss'])} server_loss {float(m['server_loss'])}; "
        f"wall {wall:.3f} s, max_memory_allocated {peak} on {card}")


def run_medium(dev, card, cfg):
    """14(c): gpt2-medium at full width and depth (24 layers, d_model
    1024, cut 6, aux 3 blocks, bf16): one HERON step with every K1, K2
    and K3 launch recorded and held against plain, one with its launches;
    its train state through the checkpoint and back bit for bit; a
    run_resilient drill with one injected fault ending where the
    uninterrupted steps end, bit for bit."""
    import tempfile
    import torch
    from repro_torch.checkpoint import checkpoint as CKPT
    from repro_torch.distributed import fault as F
    from repro_torch.models import transformer as T
    params = T.init_lm(cfg, seed=0, device=dev, draw_on_device=True)
    batches = [_lm_batch(cfg.vocab, 4, 256, dev, seed=s) for s in range(3)]
    state0, step = _train_parts(cfg, params, lr=1e-4, server_lr=2e-4,
                                mu=1e-3)
    recorded_step("gpt2-medium step", step, state0, batches[0],
                  MEDIUM_STEP, dev, card)               # also the warm-up
    state1, counts = timed_step(
        14, "gpt2-medium HERON datacenter step (24 layers, d_model 1024, "
        "cut 6, aux 3 blocks, bf16; 4x256 tokens)", step, state0,
        batches[0], MEDIUM_STEP, card)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = CKPT.save(d, 1, state1)
        t_save = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(path, "payload.npz"))
        t0 = time.perf_counter()
        back, at = CKPT.restore(d, state1)
        t_restore = time.perf_counter() - t0
        if at != 1 or not _tree_equal(back, state1):
            fail("gpt2-medium train state: checkpoint round trip differs")
        del back
    log(14, f"gpt2-medium train state through the checkpoint and back bit "
        f"for bit: payload {size} B, save {t_save:.2f} s, restore "
        f"{t_restore:.2f} s (host wall) on {card}")
    del state1
    clean = state0
    for b in batches:
        clean, _ = step(clean, b)
    with tempfile.TemporaryDirectory() as d:
        faulty, _, tel = F.run_resilient(
            step, state0, lambda s: batches[s], 3, d, ckpt_every=2,
            injector=F.FaultInjector(fail_at=(2,)), sleep=lambda s: None)
    if tel.restarts != 1 or tel.resumed_at != [2] or \
            tel.from_checkpoint != 1 or not _tree_equal(faulty, clean):
        fail(f"gpt2-medium run_resilient drill: {tel}, or its final state "
             "differs from the uninterrupted run")
    log(14, f"gpt2-medium run_resilient drill (3 steps, a checkpoint every "
        f"2, a fault at step 2): {tel}; final state == uninterrupted run "
        f"bit for bit on {card}")
    return counts


def run_cli(card):
    """14(d): the launch driver as a user runs it, one process each, on
    the smoke config (BigramLM's table is vocab x vocab): a checkpointed
    run of 6 steps and one of 10 that resumes from it, a --fed round and
    a --fed-async --cutplan round.  The three chains (the resume waits
    for its checkpoint) run side by side: each process spends most of
    its time starting up on the host."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen2-1.5b", "--smoke", "--device", "cuda", "--batch", "2",
            "--seq", "16"]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    with tempfile.TemporaryDirectory() as d:
        chains = [
            [("steps 6", ["--ckpt-dir", d, "--ckpt-every", "4", "--steps",
                          "6"], None),
             ("steps 10 (resume)", ["--ckpt-dir", d, "--ckpt-every", "4",
                                    "--steps", "10"],
              "[train] restored checkpoint at step 6")],
            [("--fed", ["--fed", "--clients", "4", "--local-steps", "2",
                        "--uplink", "seed_replay", "--steps", "2"],
              "[fed] round   1")],
            [("--fed-async --cutplan", [
                "--fed-async", "--clients", "4", "--local-steps", "2",
                "--steps", "2", "--staleness", "0.5", "--buffer-k", "2",
                "--cutplan"], "[cutplan] client 3")]]

        def run_chain(chain):
            done = []
            for desc, args, want in chain:
                t0 = time.perf_counter()
                out = subprocess.run(base + args, capture_output=True,
                                     text=True, cwd=ROOT, env=env,
                                     timeout=600)
                done.append((desc, want, out, time.perf_counter() - t0))
                if out.returncode != 0:
                    break
            return done

        with ThreadPoolExecutor(len(chains)) as pool:
            results = [r for rs in pool.map(run_chain, chains) for r in rs]
        for desc, want, out, wall in results:
            if out.returncode != 0:
                fail(f"launch.train {desc}: exit {out.returncode}: "
                     f"{out.stderr[-2000:]}")
            if want is not None and want not in out.stdout:
                fail(f"launch.train {desc}: no {want!r} in its output: "
                     f"{out.stdout[-2000:]}")
            last = out.stdout.strip().splitlines()[-1]
            log(14, f"launch.train {desc} on {card}: exit 0 in {wall:.1f} s "
                f"(beside the other chains); last line: {last}")


# the ZO kernels a HERON step or round on the kernel stream launches
ZO_KERNELS = {"zo_noise": None, "zo_dual_matmul": None,
              "zo_dual_flash_attention": None}


def check_train_small(dev, card):
    """14(e): gpt2-tiny (f32) on the card against the CPU: two datacenter
    steps of each method (HERON on the kernel stream) and the async round
    at buffer_k 0 and 2 (N=4 h=1), at compare_card_cpu's tolerances.
    The card's HERON steps and async rounds must have launched K1, K2
    and K3, so the card did not take the plain path."""
    import torch
    from repro_torch.configs.gpt2 import gpt2_tiny
    from repro_torch.core import protocols as P
    from repro_torch.core import zo as Z
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import adamw, zo_sgd
    cfg = gpt2_tiny().replace(forward_impl="kernel")
    keys = ("client_loss", "loss", "server_loss", "flushes",
            "mean_staleness")

    def on_both(desc, run, expect):
        """``run(device)`` -> (metrics, params) on the card, its launches
        counted from 0 (against ``expect``), then on the CPU."""
        reset_counts()
        card_out = run(dev)
        counts = launch_counts()
        if expect:
            check_counts(f"{desc} on the card", counts, expect)
        cpu_out = run(torch.device("cpu"))
        return compare_card_cpu(desc, (card_out[0], cpu_out[0]),
                                (card_out[1], cpu_out[1]), keys), counts

    def steps(method):
        def run(d):
            params = T.init_lm(cfg, seed=3, device=d)
            state, step = _train_parts(cfg, params, lr=1e-3, server_lr=1e-4,
                                       mu=1e-2, method=method)
            for s in range(2):
                state, m = step(state, _lm_batch(cfg.vocab, 2, 32, d, s))
            return m, state["params"]
        return run

    def async_round(buffer_k):
        def run(d):
            params = T.init_lm(cfg, seed=3, device=d)
            sopt = adamw(1e-4)
            rng = np.random.default_rng(3)
            toks = torch.as_tensor(rng.integers(0, cfg.vocab,
                                                (4, 1, 2, 33)), device=d)
            rb = {"inputs": toks[..., :-1], "labels": toks[..., 1:]}
            state = {"client": params["client"], "server": params["server"],
                     "opt_server": sopt.init(params["server"])}
            rnd = P.make_async_round(P.lm_api(cfg), "heron",
                                     Z.ZOConfig(mu=1e-2), P.FedConfig(
                                         n_clients=4, h=1), zo_sgd(1e-3),
                                     sopt, client_lr=1e-3,
                                     staleness_alpha=0.5, buffer_k=buffer_k)
            new, m = rnd(state, rb, (0, 77), durations=[1.0, 3.0, 2.0, 4.0])
            return m, {"client": new["client"], "server": new["server"]}
        return run

    worst, launched = {}, {}
    for method in P.METHODS:
        worst[method], counts = on_both(
            f"gpt2-tiny {method} datacenter steps", steps(method),
            ZO_KERNELS if method == "heron" else None)
        launched[method] = {k: counts[k] for k in ZO_KERNELS}
    for buffer_k in (0, 2):
        name = f"async buffer_k={buffer_k}"
        worst[name], counts = on_both(f"gpt2-tiny {name} round",
                                      async_round(buffer_k), ZO_KERNELS)
        launched[name] = {k: counts[k] for k in ZO_KERNELS}
    log(14, f"gpt2-tiny datacenter steps (every method) and async rounds "
        f"on the card ({card}) == on the CPU: max param |d| {worst}; the "
        f"card's K1 / K2 / K3 launches {launched}")


def run_train_phase(dev, card):
    """Phase 14.  Returns the launches of its two timed full-width steps
    (qwen2-1.5b and gpt2-medium) together."""
    import torch
    from repro_torch.configs.gpt2 import gpt2_medium
    from repro_torch.configs.qwen2_1_5b import full_config
    from repro_torch.models import transformer as T
    cfg = full_config().replace(forward_impl="kernel")
    params = T.init_lm(cfg, seed=0, device=dev, draw_on_device=True)
    counts = run_qwen_train_step(dev, card, cfg, params)
    torch.cuda.empty_cache()
    run_qwen_async(dev, card, cfg, params)
    del params
    torch.cuda.empty_cache()
    medium = run_medium(dev, card,
                        gpt2_medium().replace(forward_impl="kernel"))
    torch.cuda.empty_cache()
    run_cli(card)
    check_train_small(dev, card)
    return {k: counts[k] + medium[k] for k in counts}


# ---------------------------------------------------------------------------
# phase 15: the xLSTM and MoE families
# ---------------------------------------------------------------------------

# one HERON round (N=2, h=1) of a family whose client blocks all take the
# whole-block fallback: per client the embedding's noise rows, a theta +
# mu*U tree for each of the two client blocks, one for the aux norm and
# one for the tied table, and the direction tree (6 launches); the seed
# replay's two direction trees.  No K2-K6: the fallback runs the plain
# block (its attention the plain blocked version, as training's server
# does), and the mLSTM / sLSTM cells and the MoE dispatch are plain torch
# as the reference's are XLA.
FAMILY_ROUND = {"zo_noise": 14, "zo_dual_matmul": 0, "zo_dual_matmul_tc": 0,
                "zo_dual_flash_attention": 0,
                "zo_dual_flash_attention_tc": 0, "zo_matmul": 0,
                "zo_matmul_tc": 0, "flash_attention": 0,
                "flash_attention_tc": 0, "rg_lru_scan": 0}


def xlstm_round_config():
    """xlstm-1.3b at full width and depth (48 layers: 42 mLSTM, 6 sLSTM;
    d_model 2048, 4 heads of 512), with the reference's chunkwise mLSTM
    (``mlstm_chunk=64``): autograd through the sequential cell would
    keep a (B, 4, 512, 512) f32 state per token, 4 GiB a layer at 4 x
    256 tokens; the chunked cell keeps one per chunk."""
    from repro_torch.configs.xlstm_1_3b import full_config
    return full_config().replace(mlstm_chunk=64)


def moe_round_config():
    """qwen3-moe-30b-a3b at full width (d_model 2048, 32 heads / 4 KV
    heads of 128, 128 experts top-8 of d_ff 768, vocab 151936 untied),
    depth cut 48 -> 4 layers (2 client + 2 server).  A round holds three
    server states at once (the caller's, and the state before and after
    the second client's AdamW step), each 12 B a param (bf16 params, f32
    moments): 49.66 GB at qwen2-1.5b's 1.2 B server params (phase 12).
    At ~623 M params a layer, 6 layers' server (2.8 B params with the
    untied unembedding) would hold ~106 GB; 4 layers' (1.56 B) ~60 GB."""
    from repro_torch.configs.qwen3_moe_30b_a3b import full_config
    return full_config().replace(n_layers=4)


def recorded_k1_round(desc, setup, dev, expect):
    """One round with every K1 launch recorded, each run again on fresh
    inputs of its shape, seed and mode against the plain version bit for
    bit (phase 15's warm-up round)."""
    state, rb, rnd = setup
    calls, rows = record_k1_calls(lambda: rnd(state, rb, ROUND_KEY))
    n = (check_k1_recorded(desc, calls, dev)
         + check_k1_rows_recorded(desc, rows))
    if n != expect:
        fail(f"{desc}: {n} K1 launches recorded, expected {expect}")
    n_seg = sum(len(c[1]) for c in calls)
    n_el = sum(g.rows * g.cols for c in calls for g in c[1])
    log(15, f"{desc}: every K1 launch of one round recorded ({len(calls)} "
        f"tree calls over {n_seg} segments, {n_el} entries; {len(rows)} "
        f"rows calls) and run again == plain bit for bit")


def run_family_round(dev, card, name, cfg, desc):
    """A HERON round at full width (N=2, h=1, 4 x 256 tokens a client,
    n_pairs 1, the lean uplink, bf16): the warm-up round with every K1
    launch recorded and held against plain, then drive_round's timed and
    profiled rounds.  Returns the timed round's launches."""
    import torch
    from repro_torch.core.split import param_bytes
    from repro_torch.tree import tree_leaves
    setup = _round_setup(cfg, dev, n_clients=2, h=1, batch=4, seq=256,
                         mu=1e-3, lr=1e-4, server_lr=2e-4,
                         draw_on_device=True)
    state = setup[0]
    n_c = sum(t.numel() for t in tree_leaves(state["client"]))
    n_s = sum(t.numel() for t in tree_leaves(state["server"]))
    log(15, f"{name}: client {n_c} params ({param_bytes(state['client'])} "
        f"B), server {n_s} params ({param_bytes(state['server'])} B)")
    del state
    counts = drive_round(
        15, desc + f" on {card}", setup, FAMILY_ROUND,
        warmup=lambda: recorded_k1_round(name + " round", setup, dev,
                                         FAMILY_ROUND["zo_noise"]))
    del setup
    torch.cuda.empty_cache()
    return counts


def check_family_small_rounds():
    """15(e): each family's smoke config (f32), a kernel-path round and a
    threefry round (the reference's default) on the card against the
    CPU at compare_card_cpu's tolerance.  The server's AdamW eps is 1e-6
    (1e-3 for xlstm, whose f32 gradients are ill-conditioned: see
    tests/test_torch_family_rounds.py): a first step g / (|g| + eps)
    turns rounding in a near-eps gradient entry into an O(lr) change."""
    from repro_torch.configs import registry as REG
    for arch in ("xlstm-1.3b", "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"):
        eps = 1e-3 if arch == "xlstm-1.3b" else 1e-6
        for impl, scale in (("kernel", "sphere"), ("xla", "gaussian")):
            check_small_round(
                15, f"{arch} smoke_config {impl} round (N=2 h=2, 2x16 "
                "tokens)", lambda d, a=arch, i=impl, sc=scale, e=eps:
                _round_setup(REG.get_config(a, smoke=True), d, n_clients=2,
                             h=2, batch=2, seq=16, mu=1e-2, lr=1e-3,
                             server_lr=1e-4, seed=3, server_eps=e,
                             forward_impl=i, scale=sc))


def run_family_phase(dev, card):
    """Phase 15: (a) an xlstm-1.3b HERON round at full width and depth;
    (b) xlstm-1.3b serving at full width and depth; (c) a qwen3-moe-
    30b-a3b HERON round at full width, 4 layers; (d) its serving at the
    same depth, 8 slots, every K5 launch of the admissions held against
    plain; (e) the smoke configs' rounds card == CPU (their engines run in
    phase 13).  Logs each part's host seconds.  Returns the K1 launches
    of (a) and (c) and the K5 launches of (d)."""
    import torch
    from repro_torch.configs import xlstm_1_3b
    start = [time.perf_counter()]

    def took(part):
        now = time.perf_counter()
        log(15, f"({part} took {now - start[0]:.1f} s)")
        start[0] = now

    xl = run_family_round(
        dev, card, "xlstm-1.3b", xlstm_round_config(),
        "xlstm-1.3b round (48 layers: 42 mLSTM + 6 sLSTM, d_model 2048, "
        "vocab 50304 tied, bf16, mlstm_chunk 64, cut 2; N=2 h=1 n_pairs=1, "
        "4x256 tokens per client, seed_replay)")
    took("15a")
    run_serve(dev, card, "xlstm-1.3b engine (48 layers, bf16, greedy, "
              "mlstm_chunk 64 prefill)",
              xlstm_1_3b.full_config().replace(mlstm_chunk=64), slots=4,
              prompt_len=128, max_new=64, n_req=8, segment=16, phase=15,
              compare=False)
    log(15, "xlstm-1.3b engine: the path launches none of K1-K6 (its "
        "mLSTM / sLSTM cells are plain torch, as the reference's are "
        "lax.scan outside any Pallas kernel)")
    torch.cuda.empty_cache()
    took("15b")
    moe = run_family_round(
        dev, card, "qwen3-moe-30b-a3b", moe_round_config(),
        "qwen3-moe-30b-a3b round (4 of 48 layers, d_model 2048, 128 "
        "experts top-8, vocab 151936 untied, bf16, cut 2; N=2 h=1 "
        "n_pairs=1, 4x256 tokens per client, seed_replay)")
    took("15c")
    serve, _ = run_serve(dev, card, "qwen3-moe-30b-a3b engine (4 of 48 layers, "
                      "bf16, greedy)", moe_round_config(), slots=8,
                      prompt_len=256, max_new=64, n_req=24, segment=16,
                      phase=15, compare=False)
    torch.cuda.empty_cache()
    took("15d")
    check_family_small_rounds()
    took("15e")
    return {"zo_noise": xl["zo_noise"] + moe["zo_noise"],
            "flash_attention": serve["flash_attention"]}


# ---------------------------------------------------------------------------
# phase 16: the modality archs (qwen2-vl-2b's M-RoPE and vision stub,
# seamless-m4t-medium's enc-dec and audio stub)
# ---------------------------------------------------------------------------

# one HERON round (N=2, h=1) of qwen2-vl-2b on the kernel stream: K2 per
# client the two client blocks' q k v o gate up down, on the tensor
# cores; K3 one per client block; K1 per client twelve theta + mu*U trees
# (the two blocks' two norms and three qkv biases, the aux norm, the tied
# table) and the direction tree, and the replay's two direction trees:
# qwen2-1.5b's counts (phase 12) but its two noise-rows launches (the
# inputs are float patch embeddings, which read no table)
VLM_ROUND = {"zo_noise": 28, "zo_dual_matmul": 28, "zo_dual_matmul_tc": 28,
             "zo_dual_flash_attention": 4, "zo_dual_flash_attention_tc": 4,
             "zo_matmul": 0, "zo_matmul_tc": 0, "flash_attention": 0,
             "flash_attention_tc": 0, "rg_lru_scan": 0}
# seamless-m4t-medium (cut 3): K2 per client the three encoder blocks' q
# k v o up down; K3 one per block; K1 per client the six blocks'
# layernorm trees (scale and bias, one tree a norm), the aux norm's, the
# tied table's and the direction tree, and the replay's two
ENC_DEC_ROUND = {"zo_noise": 20, "zo_dual_matmul": 36,
                 "zo_dual_matmul_tc": 36, "zo_dual_flash_attention": 6,
                 "zo_dual_flash_attention_tc": 6, "zo_matmul": 0,
                 "zo_matmul_tc": 0, "flash_attention": 0,
                 "flash_attention_tc": 0, "rg_lru_scan": 0}


def patch_grid_ids(batch, seq, width):
    """(3, batch, seq) M-RoPE ids of one image of ``seq`` patches in rows
    of ``width``: t = 0, h = i // width, w = i % width."""
    i = np.arange(seq)
    ids = np.stack([np.zeros(seq, np.int64), i // width, i % width])
    return np.broadcast_to(ids[:, None, :], (3, batch, seq))


def modality_batch(cfg, lead, dev, seed=0):
    """The frontend stub's batch from a numpy seed, its leading axes
    ``lead`` ending in (B, S): float (*lead, d_model) embeddings and
    *lead labels; qwen2-vl adds the (..., 3, B, S) ids of a sqrt(S)-wide
    patch grid; seamless its decoder's tokens and the aux head's labels
    (seeded uniform tokens: BigramLM's vocab^2 table would be 525 GB at
    256,206)."""
    import torch
    rng = np.random.default_rng(seed)
    lead = tuple(lead)

    def put(a):
        return torch.as_tensor(a, device=dev)

    b = {"inputs": put(rng.standard_normal(lead + (cfg.d_model,),
                                           dtype=np.float32)),
         "labels": put(rng.integers(0, cfg.vocab, lead))}
    if cfg.enc_dec:
        b["dec_tokens"] = put(rng.integers(0, cfg.vocab, lead))
        b["aux_labels"] = put(rng.integers(0, cfg.vocab, lead))
    else:
        ids = patch_grid_ids(lead[-2], lead[-1], int(round(lead[-1] ** 0.5)))
        b["positions"] = put(np.broadcast_to(ids, lead[:-2] + ids.shape)
                             .copy())
    return b


def _modality_round_setup(cfg, dev, n_clients, h, batch, seq, mu, lr,
                          server_lr, seed=0, draw_on_device=False,
                          server_eps=1e-8, forward_impl="kernel",
                          scale="sphere"):
    """A round on the frontend stub's (N, h, B, S) batch from a numpy
    seed (:func:`modality_batch`)."""
    from repro_torch.core import protocols as P
    from repro_torch.models import transformer as T
    cfg = cfg.replace(forward_impl=forward_impl)
    rb = modality_batch(cfg, (n_clients, h, batch, seq), dev, seed)
    params = T.init_lm(cfg, seed=seed, device=dev,
                       draw_on_device=draw_on_device)
    return _make_round(P.lm_api(cfg), params, rb, n_clients, h, mu, lr,
                       server_lr, server_eps, scale=scale)


def recorded_round(desc, setup, dev, expect, card):
    """One round with every K1, K2 and K3 launch recorded, each held
    against its plain version as :func:`recorded_step` holds a step's,
    the recorded launches against ``expect``."""
    import torch
    state, rb, rnd = setup
    k2_calls, k3_calls = [], []

    def run():
        k3_calls.extend(record_k3_calls(lambda: rnd(state, rb, ROUND_KEY)))

    k1_calls, k1_rows = record_k1_calls(lambda: k2_calls.extend(
        record_k2_calls(run)))
    n_k1 = (check_k1_recorded(desc, k1_calls, dev)
            + check_k1_rows_recorded(desc, k1_rows))
    k2_worst = check_k2_recorded(desc, k2_calls, dev)
    k3_worst = check_k3_recorded(desc, k3_calls)
    got = (n_k1, len(k2_calls), len(k3_calls))
    want = (expect["zo_noise"], expect["zo_dual_matmul"],
            expect["zo_dual_flash_attention"])
    if got != want:
        fail(f"{desc} recorded {got} K1 / K2 / K3 launches, expected "
             f"{want}")
    k2_shapes = sorted({(M, K, Nn) for M, K, Nn, *_ in k2_calls})
    k3_shapes = sorted({tuple(a["qa"].shape) + (a["k"].shape[2],)
                        for a, _ in k3_calls})
    n_el = sum(g.rows * g.cols for c in k1_calls for g in c[1])
    del k3_calls
    torch.cuda.empty_cache()
    log(16, f"{desc}'s kernels == plain on {card}: K1's {len(k1_calls)} "
        f"tree calls ({n_el} entries) and {len(k1_rows)} rows calls "
        f"({n_k1} launches) bit for bit; K2's {got[1]} launches (M, K, N "
        f"in {k2_shapes}) within check_k2's tolerance (max |d| "
        f"{k2_worst}); K3's {got[2]} launches (B, S, H, D, Kv "
        f"{k3_shapes}) within check_k3's on their own inputs (max |d| "
        f"{k3_worst})")


def run_modality_round(dev, card, name, cfg, desc, expect):
    """A HERON round at full width (N=2, h=1, 4 x 256 a client, n_pairs 1,
    the lean uplink, bf16): the warm-up round recorded and held against
    plain, then drive_round's timed and profiled rounds.  Returns the
    timed round's launches."""
    import torch
    from repro_torch.core.split import param_bytes
    from repro_torch.tree import tree_leaves
    setup = _modality_round_setup(cfg, dev, n_clients=2, h=1, batch=4,
                                  seq=256, mu=1e-3, lr=1e-4,
                                  server_lr=2e-4, draw_on_device=True)
    state = setup[0]
    n_c = sum(t.numel() for t in tree_leaves(state["client"]))
    n_s = sum(t.numel() for t in tree_leaves(state["server"]))
    log(16, f"{name}: client {n_c} params ({param_bytes(state['client'])} "
        f"B), server {n_s} params ({param_bytes(state['server'])} B)")
    del state
    counts = drive_round(
        16, desc + f" on {card}", setup, expect,
        warmup=lambda: recorded_round(name + " round", setup, dev, expect,
                                      card))
    del setup
    torch.cuda.empty_cache()
    return counts


def run_enc_dec_serve(dev, card, cfg, batch=4, prompt_len=64, max_new=64):
    """16(d): the enc-dec token loop of launch/serve.py at full width and
    depth (``enc_dec_stream``, greedy): the prompt consumed one token a
    step, then ``max_new`` decoder tokens cross-attending the encoder
    output, none of K1-K6 launched.  A decode step's byte bound: the
    decoder stack's weights, the final norm and the tied table (the
    unembedding) read once, the step's token rows of ``dec_embed``, the
    self-attention caches' valid rows at the loop's mean position and
    ``enc_out`` read once (the cross k / v are recomputed from it each
    step, as in the reference), the f32 logits written."""
    import torch
    from repro_torch.core import decode as D
    from repro_torch.launch.serve import enc_dec_stream
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    params = T.init_lm(cfg, seed=0, device=dev, draw_on_device=True)
    greedy = D.SamplerConfig()
    enc_dec_stream(params, cfg, batch, 8, 4, greedy, device=dev)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    gen, t_pre, t_dec = enc_dec_stream(params, cfg, batch, prompt_len,
                                       max_new, greedy, device=dev)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if any(counts.values()):
        fail(f"seamless token loop launched {counts}")
    if tuple(gen.shape) != (batch, max_new) or not bool(
            ((gen >= 0) & (gen < cfg.vocab)).all()):
        fail(f"seamless token loop: tokens {tuple(gen.shape)} or outside "
             "the vocab")
    server = params["server"]
    wbytes = sum(t.numel() * t.element_size() for t in
                 tree_leaves(server["decoder"])
                 + tree_leaves(server["final_norm"])
                 + tree_leaves(params["client"]["embed"]))
    el = 2                                      # bf16 activations, caches
    n_dec = cfg.n_layers - cfg.n_enc_layers
    kv_row = 2 * cfg.n_kv_heads * cfg.resolved_head_dim * el
    mean_pos = prompt_len + (max_new - 1) / 2
    n_bytes = int(wbytes + batch * cfg.d_model * el
                  + n_dec * batch * kv_row * (mean_pos + 1)
                  + batch * (prompt_len + max_new) * cfg.d_model * el
                  + batch * cfg.vocab_padded * 4)
    step_bound, _ = bound_ms(n_bytes, 0, "bfloat16")
    step_ms = 1e3 * t_dec / (max_new - 1)
    log(16, f"seamless-m4t-medium token loop (12 + 12 layers, bf16, greedy; "
        f"batch {batch}, prompt {prompt_len} consumed token by token, "
        f"{max_new} new) on {card}: prompt consume {t_pre} s = "
        f"{batch * prompt_len / t_pre} prompt tok/s (the first token "
        f"included); decode {t_dec} s = {batch * (max_new - 1) / t_dec} "
        f"tok/s, {step_ms} ms a step (mean) vs byte bound {step_bound} ms "
        f"({n_bytes} B: {wbytes} B of decoder weights, final norm and tied "
        f"table; the KV caches at mean position {mean_pos}; enc_out) "
        f"({step_ms / step_bound:.1f}x); max_memory_allocated {peak}; "
        f"launches {counts} (none of K1-K6: the decode attention and the "
        f"cross-attention are plain torch, as in the reference)")
    del params
    torch.cuda.empty_cache()


def check_modality_small(dev):
    """16(e): both smoke configs' kernel round (sphere) and threefry round
    (gaussian, the reference's default) on the card against the CPU
    (check_small_round; qwen2-vl with grid ids on both streams); the
    seamless token loop on the card == on the CPU, greedy and sampled,
    from the same params."""
    from repro_torch.configs import registry as REG
    from repro_torch.core import decode as D
    from repro_torch.launch.serve import enc_dec_stream
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    for arch in ("qwen2-vl-2b", "seamless-m4t-medium"):
        for impl, scale in (("kernel", "sphere"), ("xla", "gaussian")):
            check_small_round(
                16, f"{arch} smoke_config {impl} round (N=2 h=2, 2x16 "
                "embeddings)", lambda d, a=arch, i=impl, sc=scale:
                _modality_round_setup(REG.get_config(a, smoke=True), d,
                                      n_clients=2, h=2, batch=2, seq=16,
                                      mu=1e-2, lr=1e-3, server_lr=1e-4,
                                      seed=3, server_eps=1e-6,
                                      forward_impl=i, scale=sc))
    cfg = REG.get_config("seamless-m4t-medium", smoke=True)
    pc = T.init_lm(cfg, seed=0, device="cpu")
    pg = tree_map(lambda t: t.to(dev), pc)
    for sampler in (D.SamplerConfig(), D.SamplerConfig(**SERVE_SAMPLED)):
        got, want = (enc_dec_stream(p, cfg, 2, 6, 8, sampler, seed=3,
                                    device=d)[0].cpu().tolist()
                     for p, d in ((pg, dev), (pc, "cpu")))
        if got != want:
            fail(f"seamless smoke token loop ({sampler}): card {got} cpu "
                 f"{want}")
        log(16, f"seamless smoke token loop ({sampler}; batch 2, prompt 6, "
            f"8 new): card == cpu {got}")


def run_modality_cli(card):
    """16(f): the launch drivers as processes on the smoke configs (the
    training driver's bigram table is vocab x vocab), started together
    (each spends most of its ~11 s starting up): two datacenter steps of
    each arch, and the seamless serving driver."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    runs = [(f"launch.train --arch {a}", [
        "repro_torch.launch.train", "--arch", a, "--smoke", "--device",
        "cuda", "--steps", "2", "--batch", "2", "--seq", "16"],
        "[train] step    1") for a in ("qwen2-vl-2b", "seamless-m4t-medium")]
    runs.append(("launch.serve --arch seamless-m4t-medium", [
        "repro_torch.launch.serve", "--arch", "seamless-m4t-medium",
        "--smoke", "--device", "cuda"], "[serve] enc-dec generated"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m"] + args, cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _, args, _ in runs]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    for (desc, _, want), p, (out, err) in zip(runs, procs, outs):
        if p.returncode != 0:
            fail(f"{desc}: exit {p.returncode}: {err[-2000:]}")
        if want not in out:
            fail(f"{desc}: no {want!r} in its output: {out[-2000:]}")
        lines = out.strip().splitlines()
        log(16, f"{desc} --smoke on {card}: exit 0; last lines: "
            f"{' | '.join(lines[-2:])}")
    log(16, f"the three driver processes, started together, done in "
        f"{wall:.1f} s")


def run_modality_phase(dev, card):
    """Phase 16: (a) a qwen2-vl-2b HERON round at full width and depth;
    (b) a seamless-m4t-medium round at full width and depth; (c) the
    qwen2-vl engine at full width and depth, every K5 launch of its
    admissions held against plain; (d) the seamless token loop; (e) the
    smoke configs card == CPU; (f) the launch drivers.  Logs each part's
    host seconds.  Returns the launches of (a), (b) and (c)."""
    import torch
    from repro_torch.configs import qwen2_vl_2b, seamless_m4t_medium
    start = [time.perf_counter()]

    def took(part):
        now = time.perf_counter()
        log(16, f"({part} took {now - start[0]:.1f} s)")
        start[0] = now

    vl = run_modality_round(
        dev, card, "qwen2-vl-2b", qwen2_vl_2b.full_config(),
        "qwen2-vl-2b round (28 layers, d_model 1536, 12 heads / 2 KV of "
        "128, M-RoPE (16, 24, 24) on 16x16 patch-grid ids, vocab 151936 "
        "tied, bf16, cut 2; N=2 h=1 n_pairs=1, 4x256 patch embeddings per "
        "client, seed_replay)", VLM_ROUND)
    took("16a")
    sm = run_modality_round(
        dev, card, "seamless-m4t-medium", seamless_m4t_medium.full_config(),
        "seamless-m4t-medium round (12 + 12 layers, d_model 1024, 16 heads "
        "of 64, layernorm, GELU, vocab 256206 tied, bf16, cut 3; N=2 h=1 "
        "n_pairs=1, 4x256 frame embeddings and decoder tokens per client, "
        "seed_replay)", ENC_DEC_ROUND)
    took("16b")
    serve, _ = run_serve(dev, card, "qwen2-vl-2b engine (28 layers, bf16, "
                      "greedy, M-RoPE from each slot's position)",
                      qwen2_vl_2b.full_config(), slots=8, prompt_len=512,
                      max_new=64, n_req=8, segment=16, phase=16,
                      compare=False)
    torch.cuda.empty_cache()
    took("16c")
    run_enc_dec_serve(dev, card, seamless_m4t_medium.full_config())
    took("16d")
    check_modality_small(dev)
    took("16e")
    run_modality_cli(card)
    took("16f")
    out = {k: vl[k] + sm[k] for k in ("zo_noise", "zo_dual_matmul",
                                      "zo_dual_flash_attention")}
    out["flash_attention"] = serve["flash_attention"]
    return out


# ---------------------------------------------------------------------------
# phase 17: the cohort mesh (the sharded and chunked seed replay)
# ---------------------------------------------------------------------------

# (a) the kernel stream over qwen2-1.5b's client tree: N=16 clients, h=2,
# n_pairs=1 (32 entries), three clients masked; (b) the threefry stream
# (gaussian) over gpt2-small's: N=4, h=1, one client masked
MESH_CASES = {"kernel": dict(n=16, h=2, drop=(3, 8, 13), chunk=5),
              "threefry": dict(n=4, h=1, drop=(2,), chunk=3)}
MESH_LR = 1e-2
# the reference's bar for the sharded replay against the flat one
MESH_TOL = dict(rtol=1e-5, atol=1e-6)
MESH_WORLD = 2
MESH_TIMEOUT_S = 300


def mesh_inputs(stream, dev):
    """``(client, seed_pred, keys, coeffs, mask)`` of 17(a) / (b), the
    same on every process (the card's seeded generator, numpy seeds).
    The client tree is the model's, cast to f32: the reference holds the
    sharded replay to the flat one at an f32 bar, which a bf16 cast of
    the result would round away."""
    import torch
    from repro_torch.configs.gpt2 import gpt2_small
    from repro_torch.configs.qwen2_1_5b import full_config
    from repro_torch.core import protocols as P
    from repro_torch.core import zo as Z
    from repro_torch.kernels import ops as O
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    case = MESH_CASES[stream]
    cfg = full_config() if stream == "kernel" else gpt2_small()
    client = tree_map(lambda t: t.float(), T.init_lm(
        cfg, seed=25, device=dev, draw_on_device=True)["client"])
    n = case["n"]
    coeffs = torch.as_tensor(np.random.default_rng(25).standard_normal(
        (n, case["h"], 1)).astype(np.float32), device=dev)
    mask = torch.ones((n,), device=dev)
    mask[list(case["drop"])] = 0.0
    keys = (O.fold_seed(20261016, np.arange(n)) if stream == "kernel"
            else Z.fold_in_range(ROUND_KEY, n))
    return client, P.lm_api(cfg).seed_pred, keys, coeffs, mask


def mesh_replay(stream, inputs, **kw):
    from repro_torch.core import aggregate as AG
    from repro_torch.core import zo as Z
    client, pred, keys, coeffs, mask = inputs
    if stream == "kernel":
        return AG.seed_replay_aggregate_kernel(client, keys, coeffs, MESH_LR,
                                               mask, seed_pred=pred, **kw)
    return AG.seed_replay_aggregate(
        client, keys, coeffs, MESH_LR,
        Z.ZOConfig(mu=1e-3, n_pairs=1, scale="gaussian"), mask, **kw)


def slab_entries(m, n, r):
    """The entries of an ``m``-entry stream that rank ``r`` of ``n``
    walks, padding excluded (``aggregate._replay_engine``'s slabs; the
    chunk changes nothing)."""
    per = -(-m // n)
    return max(0, min((r + 1) * per, m) - r * per)


def timed_replay(desc, stream, inputs, k1, **kw):
    """One replay in the mode ``kw``: its wall ms (to the card's sync;
    the sharded modes wait in their all-reduce), peak memory and
    launches, K1 ``k1`` on the kernel stream and none else."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = mesh_replay(stream, inputs, **kw)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts = launch_counts()
    check_counts(desc, counts, {**{k: 0 for k in counts},
                                "zo_noise": k1 if stream == "kernel" else 0})
    return out, ms, torch.cuda.max_memory_allocated(), counts["zo_noise"]


def trees_equal(a, b):
    import torch
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if torch.is_tensor(x) else x == y
        for x, y in zip(la, lb))


def trees_close(desc, a, b, rtol, atol):
    """Fails unless every leaf of ``a`` is within ``atol + rtol |b|`` of
    ``b``'s; returns the largest |d|."""
    from repro_torch.tree import tree_leaves
    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d = (x.float() - y.float()).abs()
        if not bool((d <= atol + rtol * y.float().abs()).all()):
            fail(f"{desc}: max |d| {float(d.max())} past rtol {rtol} atol "
                 f"{atol}")
        worst = max(worst, float(d.max()))
    return worst


def tree_digest(tree):
    """blake2b of every leaf's bytes, in leaf order: equal digests are
    equal trees bit for bit."""
    import hashlib
    from repro_torch.tree import tree_leaves
    h = hashlib.blake2b()
    for t in tree_leaves(tree):
        h.update(memoryview(t.detach().contiguous().cpu().numpy()))
    return h.hexdigest()


def first_all_reduce_ms(dev):
    """Wall ms of a one-entry all-reduce over the default group: the
    first sets the communicator up, outside the timed replays."""
    import torch
    import torch.distributed as dist
    x = torch.zeros((1,), device=dev)
    t0 = time.perf_counter()
    dist.all_reduce(x)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def mesh_rank(rank, world, workdir, device="cuda"):
    """One rank of 17(a) / (b)'s two-rank replay (``chip_smoke.py
    --mesh-rank RANK WORLD DIR``): a gloo group on a FileStore in DIR,
    both ranks on the card 0.  Per stream the flat walk (its digest),
    then ``shard="clients"`` and ``shard + chunk``: each held to the flat
    walk at MESH_TOL, its K1 launches the rank's slab.  Prints one
    ``MESH_RANK {json}`` line."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.mesh import make_replay_mesh
    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(workdir, "store"), world), rank=rank, world_size=world)
    try:
        mesh = make_replay_mesh()
        res = {"first all-reduce ms": first_all_reduce_ms(dev)}
        for stream, case in MESH_CASES.items():
            inputs = mesh_inputs(stream, dev)
            m = case["n"] * case["h"]
            flat = mesh_replay(stream, inputs)
            res[f"{stream} flat"] = {"digest": tree_digest(flat)}
            for mode, chunk in (("shard", None),
                                (f"shard+chunk={case['chunk']}",
                                 case["chunk"])):
                desc = f"rank {rank} {stream} {mode}"
                out, ms, peak, k1 = timed_replay(
                    desc, stream, inputs, slab_entries(m, world, rank),
                    shard="clients", mesh=mesh, chunk=chunk)
                res[f"{stream} {mode}"] = {
                    "k1": k1, "ms": ms, "peak": peak,
                    "max_abs": trees_close(desc, out, flat, **MESH_TOL),
                    "digest": tree_digest(out)}
                del out
            del flat, inputs
            torch.cuda.empty_cache()
        print("MESH_RANK " + json.dumps(res), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def run_mesh_ranks(card, flat_digests):
    """17(a) / (b) across two ranks: two processes of ``mesh_rank``
    started together on the card, gloo on a FileStore (NCCL takes one rank
    a device); every rank's modes within MESH_TOL of the flat walk, the
    ranks' results equal bit for bit (digests), ``shard + chunk`` equal
    to ``shard`` bit for bit (the chunk changes nothing), each rank's
    flat walk the parent's bit for bit."""
    import tempfile
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "GLOO_SOCKET_IFNAME": os.environ.get("GLOO_SOCKET_IFNAME", "lo")}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        logs = [(open(os.path.join(d, f"out{r}"), "w+"),
                 open(os.path.join(d, f"err{r}"), "w+"))
                for r in range(MESH_WORLD)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--mesh-rank", str(r), str(MESH_WORLD), d], cwd=ROOT, env=env,
            stdout=o, stderr=e, text=True) for r, (o, e) in enumerate(logs)]
        try:
            deadline = time.monotonic() + MESH_TIMEOUT_S
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs) or \
                        time.monotonic() > deadline:
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for r, (p, (o, e)) in enumerate(zip(procs, logs)):
            o.seek(0)
            e.seek(0)
            out, err = o.read(), e.read()
            o.close()
            e.close()
            if p.returncode != 0:
                fail(f"mesh rank {r}: exit {p.returncode} (killed after "
                     f"{MESH_TIMEOUT_S} s or when a rank failed): "
                     f"{err[-3000:]}")
            lines = [ln for ln in out.splitlines()
                     if ln.startswith("MESH_RANK ")]
            if len(lines) != 1:
                fail(f"mesh rank {r}: no MESH_RANK line: {out[-2000:]}")
            outs.append(json.loads(lines[0][len("MESH_RANK "):]))
    wall = time.perf_counter() - t0
    first = [o.pop("first all-reduce ms") for o in outs]
    for mode, res0 in outs[0].items():
        for r, res in enumerate(outs):
            if res[mode]["digest"] != res0["digest"]:
                fail(f"mesh {mode}: rank {r}'s result differs from rank 0's")
    for stream, case in MESH_CASES.items():
        chunked = outs[0][f"{stream} shard+chunk={case['chunk']}"]
        if chunked["digest"] != outs[0][f"{stream} shard"]["digest"]:
            fail(f"mesh {stream}: shard + chunk={case['chunk']} differs "
                 "from shard")
    for stream, digest in flat_digests.items():
        if outs[0][f"{stream} flat"]["digest"] != digest:
            fail(f"mesh {stream} flat walk: the ranks' differs from this "
                 "process's")
    for mode in outs[0]:
        if mode.endswith(" flat"):
            continue
        for r, res in enumerate(o[mode] for o in outs):
            log(17, f"{mode} over {MESH_WORLD} ranks (gloo, one card), rank "
                f"{r}: K1 launches {res['k1']}, wall_ms {res['ms']}, "
                f"max_memory_allocated {res['peak']}, max |d| vs the flat "
                f"walk {res['max_abs']} (within rtol 1e-5 atol 1e-6)")
    log(17, f"two ranks on {card}: every mode's results equal across the "
        f"ranks bit for bit (blake2b digests), shard + chunk equal to "
        f"shard, and each rank's flat walk equal to this process's; first "
        f"all-reduce (set-up) {first} ms; both processes done in "
        f"{wall:.1f} s")


def run_mesh_round(dev, card, mesh):
    """17(c): phase 5's gpt2-small round with ``replay_shard="clients"``,
    ``replay_chunk=4`` on the one-rank NCCL mesh, against phase 5's
    unsharded round from the same state on the same key: the launches
    equal, the server and client states bit for bit (one rank).
    Returns the sharded round's launches."""
    import torch
    from repro_torch.configs.gpt2 import gpt2_small
    from repro_torch.core import protocols as P
    cfg = gpt2_small()
    state, rb, rnd = _round_setup(cfg, dev, n_clients=2, h=1, batch=4,
                                  seq=256, mu=1e-3, lr=1e-4, server_lr=2e-4)
    _, _, srnd = _make_round(
        P.lm_api(cfg.replace(forward_impl="kernel")), state, rb, 2, 1, 1e-3,
        1e-4, 2e-4, replay_kw=dict(replay_shard="clients", replay_mesh=mesh,
                                   replay_chunk=4))
    reset_counts()
    ref, _ = rnd(state, rb, ROUND_KEY)
    ref_counts = launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    new, m = srnd(state, rb, ROUND_KEY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    check_counts("gpt2-small sharded round", counts, ref_counts)
    for part in ("server", "opt_server"):
        if not trees_equal(new[part], ref[part]):
            fail(f"gpt2-small sharded round: {part} differs from the "
                 "unsharded round's")
    if not trees_equal(new["client"], ref["client"]):
        fail("gpt2-small sharded round: the client differs from the "
             "unsharded round's (one rank: the same walk)")
    log(17, f"gpt2-small round (phase 5's size, kernel stream) with "
        f"replay_shard='clients' replay_chunk=4 on a one-rank "
        f"{torch.distributed.get_backend()} group on {card}: client_loss "
        f"{float(m['client_loss'])} wall_s {wall} "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()}; "
        f"launches {counts} == the unsharded round's; server and optimizer "
        f"state and client == the unsharded round's bit for bit")
    return counts


def run_mesh_cli(card):
    """17(c): the training driver with the sharded, chunked replay as a
    process (one rank: an NCCL group on an in-memory store)."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    args = [sys.executable, "-m", "repro_torch.launch.train", "--fed",
            "--uplink", "seed_replay", "--replay-shard", "clients",
            "--replay-chunk", "3", "--smoke", "--device", "cuda", "--batch",
            "2", "--seq", "16", "--clients", "4", "--local-steps", "2",
            "--steps", "2"]
    t0 = time.perf_counter()
    out = subprocess.run(args, capture_output=True, text=True, cwd=ROOT,
                         env=env, timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"launch.train --replay-shard clients --replay-chunk 3: exit "
             f"{out.returncode}: {out.stderr[-2000:]}")
    if "[fed] round   1" not in out.stdout:
        fail(f"launch.train --replay-shard: no second round in its output: "
             f"{out.stdout[-2000:]}")
    log(17, f"launch.train --fed --uplink seed_replay --replay-shard clients "
        f"--replay-chunk 3 --smoke on {card}: exit 0 in {wall:.1f} s; last "
        f"line: {out.stdout.strip().splitlines()[-1]}")


def run_mesh_phase(dev, card):
    """Phase 17: (a) the kernel-stream replay over qwen2-1.5b's client
    tree: the flat walk, ``chunk`` (== flat bit for bit) and a one-rank
    NCCL group's ``shard`` (== flat bit for bit) here, ``shard`` and
    ``shard + chunk`` over two ranks; (b) the threefry replay over
    gpt2-small's: flat, ``chunk`` here, the two ranks; (c) a sharded,
    chunked gpt2-small round and the driver.  Returns the launches of
    (a)'s one-rank shard walk and (c)'s round."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.mesh import init_distributed, \
        make_replay_mesh
    from repro_torch.tree import tree_leaves
    start = [time.perf_counter()]

    def took(part):
        now = time.perf_counter()
        log(17, f"({part} took {now - start[0]:.1f} s)")
        start[0] = now

    flat_digests = {}
    owned = init_distributed(dev)
    try:
        mesh = make_replay_mesh()
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dist.get_backend() != backend or mesh.shape != {"clients": 1}:
            fail(f"one-rank replay mesh {mesh.shape} on "
                 f"{dist.get_backend()}")
        log(17, f"one-rank {backend} group: first all-reduce (the "
            f"communicator's set-up) {first_all_reduce_ms(dev)} ms")
        for stream, case in MESH_CASES.items():
            inputs = mesh_inputs(stream, dev)
            mesh_replay(stream, inputs)               # warm-up
            n_params = sum(t.numel() for t in tree_leaves(inputs[0]))
            m = case["n"] * case["h"]
            desc = (f"{stream} replay over {n_params} f32 params, N="
                    f"{case['n']} h={case['h']} n_pairs=1 ({m} entries), "
                    f"clients {list(case['drop'])} masked")
            flat, ms, peak, k1 = timed_replay(desc, stream, inputs, m)
            log(17, f"{desc}, flat walk on {card}: K1 launches {k1}, wall_ms "
                f"{ms}, max_memory_allocated {peak}")
            modes = [(f"chunk={case['chunk']}", dict(chunk=case["chunk"]))]
            if stream == "kernel":
                modes.append((f"shard over a one-rank {backend} group",
                              dict(shard="clients", mesh=mesh)))
            for mode, kw in modes:
                out, ms, peak, k1 = timed_replay(f"{desc} {mode}", stream,
                                                 inputs, m, **kw)
                if not trees_equal(out, flat):
                    fail(f"{desc} {mode}: differs from the flat walk")
                log(17, f"{desc}, {mode}: == the flat walk bit for bit; K1 "
                    f"launches {k1}, wall_ms {ms}, max_memory_allocated "
                    f"{peak}")
                if "shard" in kw:
                    counts = launch_counts()
                del out
            flat_digests[stream] = tree_digest(flat)
            del flat, inputs
            torch.cuda.empty_cache()
        took("17a-b here")
        round_counts = run_mesh_round(dev, card, mesh)
        torch.cuda.empty_cache()
        took("17c round")
    finally:
        if owned:
            dist.destroy_process_group()
    run_mesh_ranks(card, flat_digests)
    took("17a-b two ranks")
    run_mesh_cli(card)
    took("17c driver")
    return {k: counts[k] + round_counts[k] for k in counts}


# ---------------------------------------------------------------------------
# phase 18: the datacenter step's ("data", "model") mesh
# ---------------------------------------------------------------------------

# 18(a): K2 / K4 on column slabs of W at qwen2-1.5b's client shapes (q / o
# and the two-head k / v), M rows per stream
COL_SHAPES = ((1536, 1536), (1536, 256))
COL_M = 256
# 18(b) / (c): (config, model axis, world, batch, seq).  f32 (the state
# cast as phase 17 cast its tree), so the slabs can be held to the
# unsharded step at an f32 bar
TRAIN_MESH_CASES = {"qwen": ("qwen2-1.5b", 2, 2, 2, 256),
                    "gpt2": ("gpt2-small", 2, 4, 4, 128)}
# each rank's slabs after one HERON step (kernel stream, mu 1e-2) against
# the unsharded step's on the card: the column-slab and row-parallel
# products and the vocab-parallel cross entropy sum in other orders than
# the whole-width ones, a few f32 ulps of each loss, which the
# coefficient divides by mu
TRAIN_MESH_TOL = dict(rtol=1e-4, atol=1e-5)
TRAIN_MESH_RATES = dict(lr=1e-3, server_lr=1e-4, mu=1e-2)
TRAIN_MESH_TIMEOUT_S = 400


def check_col_offset(dev):
    """18(a): K2 and K4 on each column slab of W (model axis 2 and 4),
    launched with the slab's ``col_offset``, equal the same columns of
    the full-width launch bit for bit: bf16 on the wgmma route, f32 on
    the 3xTF32 route, and bf16 and f32 on the CUDA-core loop (x one
    element into its buffer).  The slab launches check the kernels and
    count toward no main path (the counts are reset before each path)."""
    import torch
    from repro_torch.kernels import zo_matmul as ZM
    n_checked = 0
    for dtype in (torch.bfloat16, torch.float32):
        for K, Nn in COL_SHAPES:
            xa, xb, w = k2_inputs(dev, dtype, COL_M, K, Nn, seed=18)
            for route, xs in (("tensor cores", (xa, xb)),
                              ("CUDA-core loop", (misaligned(xa),
                                                  misaligned(xb)))):
                tc = route == "tensor cores"
                off = 2 * K
                before = ZM.LAUNCHES["zo_dual_matmul_tc"]
                fa, fb = ZM.zo_dual_matmul(*xs, w, 7, 0.0, 1e-3,
                                           row_offset=off)
                f4 = ZM.zo_matmul(xs[0], w, 7, 1e-3, row_offset=off)
                if ZM.LAUNCHES["zo_dual_matmul_tc"] - before != int(tc):
                    fail(f"18(a) K2 {dtype} {K}x{Nn}: not on the {route}")
                for mp in (2, 4):
                    n = Nn // mp
                    for m in range(mp):
                        cols = slice(m * n, (m + 1) * n)
                        ws = w[:, cols].contiguous()
                        before = ZM.LAUNCHES["zo_dual_matmul_tc"]
                        a, b = ZM.zo_dual_matmul(*xs, ws, 7, 0.0, 1e-3,
                                                 row_offset=off,
                                                 col_offset=m * n)
                        y4 = ZM.zo_matmul(xs[0], ws, 7, 1e-3,
                                          row_offset=off, col_offset=m * n)
                        if ZM.LAUNCHES["zo_dual_matmul_tc"] - before != \
                                int(tc):
                            fail(f"18(a) K2 {dtype} {K}x{n} slab: not on "
                                 f"the {route}")
                        for got, want in ((a, fa), (b, fb), (y4, f4)):
                            if not torch.equal(got, want[:, cols]):
                                d = (got.float() - want[:, cols].float()
                                     ).abs().max()
                                fail(f"18(a) {dtype} {K}x{Nn} {route} model "
                                     f"{mp} slab {m}: differs from the "
                                     f"full launch's columns, max |d| "
                                     f"{float(d)}")
                        n_checked += 3
            del xa, xb, w
    log(18, f"(a) K2 (both streams) and K4 on every column slab of W at K x "
        f"N {COL_SHAPES}, M={COL_M}, model axis 2 and 4, with the slab's "
        f"col_offset: == the full-width launch's columns bit for bit on "
        f"the bf16 wgmma route, the f32 3xTF32 route and the CUDA-core "
        f"loop (bf16 and f32): {n_checked} slab outputs")


def _mesh_config(name):
    from repro_torch.configs.gpt2 import gpt2_small
    from repro_torch.configs.qwen2_1_5b import full_config
    cfg = full_config() if name == "qwen2-1.5b" else gpt2_small()
    return cfg.replace(forward_impl="kernel", param_dtype="float32",
                       compute_dtype="float32")


def _slab_check(desc, got, want, places, tol=TRAIN_MESH_TOL):
    """Each leaf of ``got`` (a rank's state) against the slab of the
    unsharded ``want`` at ``tol``: ``(max |d|, the replicated leaves'
    digest)``."""
    import hashlib
    import torch
    from repro_torch.distributed import sharding as SH
    from repro_torch.tree import tree_leaves_with_path
    pl = dict(tree_leaves_with_path(places))
    want = dict(tree_leaves_with_path(want))
    worst, h = 0.0, hashlib.blake2b()
    for path, t in tree_leaves_with_path(got):
        if not torch.is_tensor(t):
            continue
        ref = want[path]
        if tuple(ref.shape) != tuple(t.shape):
            ref = SH.shard(ref, pl.get(path))
        d = (t.float() - ref.float()).abs()
        if not bool((d <= tol["atol"] + tol["rtol"]
                     * ref.float().abs()).all()):
            fail(f"{desc}: {path} max |d| {float(d.max())} past {tol}")
        worst = max(worst, float(d.max()))
        if pl.get(path) is None or not pl[path].sharded:
            h.update(memoryview(t.detach().contiguous().cpu().numpy()))
    return worst, h.hexdigest()


def train_mesh_rank(rank, world, workdir, case, device="cuda"):
    """One rank of 18(b) / (c) (``chip_smoke.py --train-mesh-rank RANK
    WORLD DIR CASE``): a gloo group on a FileStore in DIR, every rank on
    card 0, ``make_local_mesh(mp)``.  The unsharded HERON step first, one
    rank at a time (the card holds one whole state at a time), keeping
    its launches and this rank's slabs of its params; then the mesh
    step with every K1 / K2 / K3 launch recorded, each launch then held
    against its plain version, the slabs against the unsharded step's at
    TRAIN_MESH_TOL; then a second mesh step, its launches counted from 0
    (== the first's), its wall and peak memory; then a third under the
    profiler for the card's busy time.  Prints one ``TRAIN_MESH_RANK
    {json}`` line."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import prng as R
    from repro_torch.core import protocols as P
    from repro_torch.core import zo as Z
    from repro_torch.data.pipeline import place_batch
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.mesh import make_local_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import adamw, zo_sgd
    name, mp, _, batch_size, seq = TRAIN_MESH_CASES[case]
    cuda = device == "cuda"
    dev = torch.device(device, 0) if cuda else torch.device(device)
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def sync():
        if cuda:
            torch.cuda.synchronize()

    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(workdir, "store"), world), rank=rank, world_size=world)
    try:
        mesh = make_local_mesh(mp)
        rules = SH.AxisRules(mesh=mesh, enable_fsdp=False)
        cfg = _mesh_config(name)
        r8 = TRAIN_MESH_RATES
        copt, sopt = zo_sgd(r8["lr"]), adamw(r8["server_lr"], eps=1e-6)
        zo = Z.ZOConfig(mu=r8["mu"], scale="gaussian")
        batch = _lm_batch(cfg.vocab, batch_size, seq, dev, seed=18)

        def params():
            return T.init_lm(cfg, seed=18, device=dev, draw_on_device=True)

        api = P.lm_api(cfg, rules)
        ref = None
        for r in range(world):
            if r == rank or name == "gpt2-small":
                if ref is None:
                    st = P.init_train_state(R.PRNGKey(1), params(), copt,
                                            sopt)
                    reset_counts()
                    new, rm = P.make_train_step(P.lm_api(cfg), "heron", zo,
                                                copt, sopt)(st, batch)
                    sync()
                    ref = (SH.shard_tree(new["params"],
                                         api.shardings), launch_counts(),
                           float(rm["loss"]), float(rm["client_loss"]))
                    del st, new
                    if cuda:
                        torch.cuda.empty_cache()
            dist.barrier()
        state = P.init_train_state(R.PRNGKey(1), params(), copt, sopt,
                                   shardings=api.shardings)
        step = P.make_train_step(api, "heron", zo, copt, sopt)
        b = place_batch(batch, dev, rules)
        out, k2_calls, k3_calls = [], [], []

        def run():
            k3_calls.extend(record_k3_calls(lambda: out.append(
                step(state, b))))

        reset_counts()
        k1_calls, k1_rows = record_k1_calls(lambda: k2_calls.extend(
            record_k2_calls(run)))
        counts = launch_counts()
        new, m = out.pop()
        desc = f"rank {rank} {name} mesh step"
        n_k1 = (check_k1_recorded(desc, k1_calls, dev)
                + check_k1_rows_recorded(desc, k1_rows))
        k2_worst = check_k2_recorded(desc, k2_calls, dev)
        k3_worst = check_k3_recorded(desc, k3_calls)
        if (n_k1, len(k2_calls), len(k3_calls)) != (
                counts["zo_noise"], counts["zo_dual_matmul"],
                counts["zo_dual_flash_attention"]):
            fail(f"{desc}: recorded {n_k1} / {len(k2_calls)} / "
                 f"{len(k3_calls)} K1 / K2 / K3 launches, counted {counts}")
        for k in ("zo_noise", "zo_dual_matmul", "zo_dual_flash_attention"):
            if counts[k] <= 0 or counts[k] != ref[1][k]:
                fail(f"{desc}: {k} launched {counts[k]} times, the "
                     f"unsharded step {ref[1][k]}")
        loss, closs = float(m["loss"]), float(m["client_loss"])
        for got, want in ((loss, ref[2]), (closs, ref[3])):
            if not abs(got - want) <= 1e-5 * abs(want):
                fail(f"{desc}: loss {got} vs the unsharded step's {want}")
        worst, digest = _slab_check(desc, new["params"], ref[0],
                                    api.shardings)
        del k1_calls, k1_rows, k2_calls, k3_calls, ref, state
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        sync()
        reset_counts()
        t0 = time.perf_counter()
        new, _ = step(new, b)
        sync()
        wall = time.perf_counter() - t0
        if launch_counts() != counts:
            fail(f"{desc}: the second step launched {launch_counts()}, the "
                 f"first {counts}")
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        busy = 0.0
        if cuda:
            rows = device_rows(lambda: step(new, b))
            busy = sum(r_[0] for r_ in rows) / 1e3
        res = {"wall_ms": 1e3 * wall, "busy_ms": busy, "peak": peak,
               "counts": {k: counts[k] for k in (
                   "zo_noise", "zo_dual_matmul", "zo_dual_matmul_tc",
                   "zo_dual_flash_attention",
                   "zo_dual_flash_attention_tc")},
               "loss": loss, "client_loss": closs, "max_abs": worst,
               "k2_worst": k2_worst, "k3_worst": k3_worst,
               "digest": digest, "mesh": mesh.shape,
               "coords": {a: mesh.rank(a) for a in mesh.shape}}
        print("TRAIN_MESH_RANK " + json.dumps(res), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def run_rank_procs(flag, world, args, timeout_s, marker):
    """``chip_smoke.py FLAG RANK WORLD DIR *ARGS`` as ``world`` processes
    started together (a FileStore in a temporary DIR); their ``MARKER
    {json}`` lines, rank by rank, and the wall seconds.  Fails if a rank
    fails, prints no line or outlives ``timeout_s``."""
    import tempfile
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "GLOO_SOCKET_IFNAME": os.environ.get("GLOO_SOCKET_IFNAME", "lo")}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        logs = [(open(os.path.join(d, f"out{r}"), "w+"),
                 open(os.path.join(d, f"err{r}"), "w+"))
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"), flag,
             str(r), str(world), d, *args], cwd=ROOT, env=env, stdout=o,
            stderr=e, text=True) for r, (o, e) in enumerate(logs)]
        try:
            deadline = time.monotonic() + timeout_s
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs) or \
                        time.monotonic() > deadline:
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for r, (p, (o, e)) in enumerate(zip(procs, logs)):
            o.seek(0)
            e.seek(0)
            out, err = o.read(), e.read()
            o.close()
            e.close()
            if p.returncode != 0:
                fail(f"{flag} rank {r}: exit {p.returncode} (killed after "
                     f"{timeout_s} s or when a rank failed): "
                     f"{err[-3000:]}")
            lines = [ln for ln in out.splitlines()
                     if ln.startswith(marker + " ")]
            if len(lines) != 1:
                fail(f"{flag} rank {r}: no {marker} line: {out[-2000:]}")
            outs.append(json.loads(lines[0][len(marker) + 1:]))
    return outs, time.perf_counter() - t0


def run_train_mesh_ranks(card, case):
    """18(b) / (c): ``train_mesh_rank`` on every rank of the case's mesh;
    the replicated leaves equal across the ranks (digests).  Returns the
    K1 / K2 / K3 launches of the ranks' mesh steps, summed."""
    name, mp, world, batch_size, seq = TRAIN_MESH_CASES[case]
    outs, wall = run_rank_procs("--train-mesh-rank", world, [case],
                                TRAIN_MESH_TIMEOUT_S, "TRAIN_MESH_RANK")
    if len({o["digest"] for o in outs}) != 1:
        fail(f"18 {name}: the replicated leaves differ across the ranks")
    desc = (f"{name} (f32, full width and depth) HERON step, kernel stream, "
            f"mu {TRAIN_MESH_RATES['mu']}, {batch_size} x {seq} tokens, on "
            f"the ({world // mp}, {mp}) ('data', 'model') mesh as {world} "
            f"gloo ranks on one card")
    for r, o in enumerate(outs):
        busy = o["busy_ms"]
        idle = (f"busy {busy:.3f} ms, idle share "
                f"{1 - busy / o['wall_ms']:.3f}" if busy > 0 else
                "busy not measured (the profiler saw no device time)")
        log(18, f"{desc}, rank {r} at {o['coords']}: wall {o['wall_ms']:.3f} "
            f"ms (the second step), {idle} (a third, profiled), "
            f"max_memory_allocated {o['peak']}; launches {o['counts']} (== "
            f"the unsharded step's); every K1 launch == plain bit for bit, "
            f"K2 max |d| {o['k2_worst']}, K3 {o['k3_worst']}; loss "
            f"{o['loss']} client_loss {o['client_loss']} (== the unsharded "
            f"step's within 1e-5); its slabs within {TRAIN_MESH_TOL} of the "
            f"unsharded step's (max |d| {o['max_abs']})")
    log(18, f"{desc} on {card}: replicated leaves equal across the {world} "
        f"ranks (blake2b); all ranks done in {wall:.1f} s")
    return {k: sum(o["counts"][k] for o in outs)
            for k in outs[0]["counts"]}


def run_mesh_driver(card, arch="qwen2-1.5b", phase=18, part="d"):
    """18(d) / 19(d) / 20(e) / 21(e): ``torchrun --nproc-per-node=2 -m
    repro_torch.launch.train --arch ARCH --smoke --model-parallel 2
    --ckpt-dir D`` (torch.distributed.run on a local rendezvous; gloo,
    the two ranks sharing the card) exits 0, rank 0 alone prints, and its
    checkpoint (rank 0's write of the gathered state) restores into a
    one-device state."""
    import tempfile
    import torch
    from repro_torch.checkpoint import checkpoint as CKPT
    from repro_torch.configs.registry import get_config
    from repro_torch.core import prng as R
    from repro_torch.core import protocols as P
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.tree import tree_leaves
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "GLOO_SOCKET_IFNAME": os.environ.get("GLOO_SOCKET_IFNAME", "lo")}
    with tempfile.TemporaryDirectory() as d:
        args = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node=2", "-m", "repro_torch.launch.train",
                "--arch", arch, "--smoke", "--model-parallel", "2",
                "--ckpt-dir", d,
                "--steps", "2", "--batch", "2", "--seq", "16"]
        t0 = time.perf_counter()
        out = subprocess.run(args, capture_output=True, text=True, cwd=ROOT,
                             env=env, timeout=600)
        wall = time.perf_counter() - t0
        if out.returncode != 0:
            fail(f"torchrun launch.train --model-parallel 2: exit "
                 f"{out.returncode}: {out.stderr[-3000:]}")
        steps = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("[train] step")]
        if len(steps) != 2 or "final checkpoint" not in out.stdout:
            fail(f"torchrun launch.train --model-parallel 2: expected two "
                 f"step lines from rank 0 alone: {out.stdout[-2000:]}")
        cfg = get_config(arch, smoke=True)
        tmpl = P.init_train_state(
            R.PRNGKey(1), T.init_lm(cfg, device="cpu", key=R.PRNGKey(0)),
            make_optimizer("zo_sgd", 1e-3), make_optimizer("adamw", 1e-3))
        state, step = CKPT.restore(d, tmpl)
        finite = all(bool(torch.isfinite(t.float()).all()) for t in
                     tree_leaves(state["params"]))
        if step != 2 or not finite:
            fail(f"the mesh driver's checkpoint: step {step}, finite "
                 f"{finite}")
    log(phase, f"({part}) torchrun --nproc-per-node=2 -m "
        f"repro_torch.launch.train --arch {arch} --smoke --model-parallel "
        f"2 --ckpt-dir D on {card}: exit 0 in {wall:.1f} s, rank 0 alone "
        f"printed {steps}; its step-2 checkpoint restored into a one-device "
        f"state (finite)")


def run_mesh_drivers(card, archs, phase):
    """20(e) / 21(e): ``run_mesh_driver`` for each of ``archs``, side by
    side (each torchrun spends most of its time starting up on the
    host)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(archs)) as pool:
        for f in [pool.submit(run_mesh_driver, card, a, phase, "e")
                  for a in archs]:
            f.result()


def run_train_mesh_phase(dev, card):
    """Phase 18: (a) K2 / K4 on column slabs with ``col_offset`` == the
    full-width launch's columns; (b) qwen2-1.5b on (1, 2) as two gloo
    ranks; (c) gpt2-small on (2, 2) as four; (d) the driver under
    torchrun.  Returns the K1 / K2 / K3 launches of (b) and (c)'s mesh
    steps, summed over the ranks."""
    start = [time.perf_counter()]

    def took(part):
        now = time.perf_counter()
        log(18, f"({part} took {now - start[0]:.1f} s)")
        start[0] = now

    check_col_offset(dev)
    took("18a")
    counts = run_train_mesh_ranks(card, "qwen")
    took("18b")
    for k, v in run_train_mesh_ranks(card, "gpt2").items():
        counts[k] += v
    took("18c")
    run_mesh_driver(card)
    took("18d")
    return counts


# ---------------------------------------------------------------------------
# phase 19: the expert-parallel MoE (moe_ep) on the ("data", "model") mesh
# ---------------------------------------------------------------------------

# the model axis of phase 19's ranks, and 19(a)'s tokens (B, S)
MOE_EP_MP = 2
MOE_EP_TOKENS = (2, 256)
# 19(a): a rank's output against moe_ep_plain's on the card: the same
# slab dispatch, but the expert products run on (E/n, n*C, d) in place of
# (E, C, d) (other GEMM tilings) and the router's slab gradient is
# reduce-scattered; the bar is two bf16 ulps of the oracle's largest
# entry (2^-6 of it) for the output, four (2^-5) for the gradients
MOE_EP_OUT_BAR = 2.0 ** -6
MOE_EP_GRAD_BAR = 2.0 ** -5
# 19(b) / (c): (layers, capacity factor, dtype), 2 x 256 tokens.  (b)'s
# n_experts / top_k lets no slab drop, so each rank's slabs are the
# unsharded step's at TRAIN_MESH_TOL
MOE_STEP_CASES = {"b": (3, 16.0, "float32"), "c": (4, 1.25, "bfloat16")}
MOE_EP_TIMEOUT_S = 600


def _moe_config(case):
    """qwen3-moe-30b-a3b at full width: "a" one MoE layer in bf16 at its
    capacity factor, "b" / "c" the steps of MOE_STEP_CASES."""
    from repro_torch.configs.qwen3_moe_30b_a3b import full_config
    cfg = full_config()
    layers, cf, dtype = ((1, cfg.moe.capacity_factor, "bfloat16")
                         if case == "a" else MOE_STEP_CASES[case])
    return cfg.replace(n_layers=layers, forward_impl="kernel",
                       param_dtype=dtype, compute_dtype=dtype,
                       moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def check_moe_layer(rank, rules, dev):
    """19(a): ``moe_ep`` on this rank's slabs of one MoE layer and its
    token slab, forward and backward of ``sum(out * w)``, against
    ``moe_ep_plain`` (every token slab at its own capacity, in this
    process) on the same card: the output and x's gradient, the router's
    and the experts' slab gradients within the bars, the dropped entries
    of the two slabs equal and more than zero."""
    import torch
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.tree import tree_map
    cfg = _moe_config("a")
    gen = torch.Generator(dev).manual_seed(19)
    params = M.init_moe(gen, cfg)
    B, S = MOE_EP_TOKENS
    x, w = (torch.randn((B, S, cfg.d_model), generator=gen, device=dev
                        ).to(torch.bfloat16) for _ in range(2))
    keys = ("router", "up", "gate", "down")

    def run(fn, p, args):
        xg = x.clone().requires_grad_(True)
        p = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        with M.recording_drops() as drops:
            y = fn(p, xg, cfg, *args)
        g = torch.autograd.grad(torch.sum(y.float() * w.float()),
                                [xg] + [p[k] for k in keys])
        return y.detach(), g, drops

    yo, go, do = run(M.moe_ep_plain, params, (1, MOE_EP_MP))
    places = tree_map(lambda r: rules.sharding_for(tuple(r.shape), r.axes),
                      M.init_moe(L.RULES, cfg))
    slabs = {k: SH.shard(params[k], places[k]) for k in keys}
    yr, gr, dr = run(M.moe_ep, slabs, (rules,))
    n_drop = int(TP.reduce_from(torch.tensor(sum(dr)), rules.mesh))
    errs = {}
    for name, got, want, bar in (
            [("out", yr, yo, MOE_EP_OUT_BAR), ("grad x", gr[0], go[0],
                                                 MOE_EP_GRAD_BAR)]
            + [(f"grad {k}", g, SH.shard(o, places[k]), MOE_EP_GRAD_BAR)
               for k, g, o in zip(keys, gr[1:], go[1:])]):
        d = max_abs(got, want)
        top = float(want.float().abs().max())
        if not d <= bar * top:
            fail(f"19(a) rank {rank}: {name} max |d| {d} past {bar} x "
                 f"max |oracle| {top}")
        errs[name] = (d, top)
    if n_drop != sum(do) or n_drop <= 0:
        fail(f"19(a) rank {rank}: {n_drop} entries dropped on the mesh, "
             f"the oracle {sum(do)} (want equal and > 0)")
    return {"errs": errs, "drops": n_drop, "entries": B * S * cfg.moe.top_k}


def moe_mesh_step(case, rank, world, rules, dev, sync):
    """19(b) / (c) on this rank.  (b): the unsharded HERON step first, one
    rank at a time (the card holds one whole state at a time), keeping
    this rank's slabs of its params and its K1 launches; then the mesh
    step with every K1 launch recorded and held against plain, its
    slabs against the unsharded step's at TRAIN_MESH_TOL.  (c): the mesh
    step with the dropped entries of every dispatch recorded, a second
    timed (wall, peak memory, launches == the first's), a third under
    the profiler (busy)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import prng as R
    from repro_torch.core import protocols as P
    from repro_torch.core import zo as Z
    from repro_torch.data.pipeline import place_batch
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import adamw, zo_sgd
    cfg = _moe_config(case)
    r8 = TRAIN_MESH_RATES
    copt, sopt = zo_sgd(r8["lr"]), adamw(r8["server_lr"], eps=1e-6)
    zo = Z.ZOConfig(mu=r8["mu"], scale="gaussian")
    batch = _lm_batch(cfg.vocab, *MOE_EP_TOKENS, dev, seed=19)
    desc = f"19({case}) rank {rank}"

    def params():
        return T.init_lm(cfg, seed=19, device=dev, draw_on_device=True)

    api = P.lm_api(cfg, rules)
    ref = None
    for r in range(world if case == "b" else 0):
        if r == rank:
            st = P.init_train_state(R.PRNGKey(1), params(), copt, sopt)
            reset_counts()
            new, rm = P.make_train_step(P.lm_api(cfg), "heron", zo, copt,
                                        sopt)(st, batch)
            sync()
            ref = (SH.shard_tree(new["params"], api.shardings),
                   launch_counts()["zo_noise"], float(rm["loss"]),
                   float(rm["client_loss"]))
            del st, new
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    state = P.init_train_state(R.PRNGKey(1), params(), copt, sopt,
                               shardings=api.shardings)
    step = P.make_train_step(api, "heron", zo, copt, sopt)
    b = place_batch(batch, dev, rules)
    out = []
    reset_counts()
    with M.recording_drops() as drops:
        if case == "b":
            k1_calls, k1_rows = record_k1_calls(lambda: out.append(
                step(state, b)))
        else:
            out.append(step(state, b))
    sync()
    counts = launch_counts()
    new, m = out.pop()
    res = {"k1": counts["zo_noise"], "drops": drops,
           "entries": b["inputs"].numel() // MOE_EP_MP * cfg.moe.top_k,
           "loss": float(m["loss"]), "client_loss": float(m["client_loss"])}
    if case == "b":
        n_k1 = (check_k1_recorded(desc, k1_calls, dev)
                + check_k1_rows_recorded(desc, k1_rows))
        if n_k1 != counts["zo_noise"] or counts["zo_noise"] != ref[1] or \
                counts["zo_noise"] <= 0:
            fail(f"{desc}: {counts['zo_noise']} K1 launches ({n_k1} "
                 f"recorded), the unsharded step {ref[1]}")
        if sum(drops):
            fail(f"{desc}: {drops} entries dropped at capacity factor "
                 f"{cfg.moe.capacity_factor}")
        for got, want in ((res["loss"], ref[2]), (res["client_loss"],
                                                  ref[3])):
            if not abs(got - want) <= 1e-5 * abs(want):
                fail(f"{desc}: loss {got} vs the unsharded step's {want}")
        res["max_abs"], res["digest"] = _slab_check(
            desc, new["params"], ref[0], api.shardings, REC_STEP_TOL)
        return res
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    sync()
    reset_counts()
    t0 = time.perf_counter()
    new, _ = step(new, b)
    sync()
    res["wall_ms"] = 1e3 * (time.perf_counter() - t0)
    if launch_counts() != counts:
        fail(f"{desc}: the second step launched {launch_counts()}, the "
             f"first {counts}")
    res["peak"] = torch.cuda.max_memory_allocated() if dev.type == "cuda" \
        else 0
    res["busy_ms"] = (sum(r_[0] for r_ in device_rows(
        lambda: step(new, b))) / 1e3 if dev.type == "cuda" else 0.0)
    return res


def moe_ep_rank(rank, world, workdir, device="cuda"):
    """One rank of 19(a)-(c) (``chip_smoke.py --moe-ep-rank RANK WORLD
    DIR``): a gloo group on a FileStore in DIR, every rank on card 0,
    ``make_local_mesh(MOE_EP_MP)``.  Prints one ``MOE_EP_RANK {json}``
    line."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.mesh import make_local_mesh
    cuda = device == "cuda"
    dev = torch.device(device, 0) if cuda else torch.device(device)
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def sync():
        if cuda:
            torch.cuda.synchronize()

    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(workdir, "store"), world), rank=rank, world_size=world)
    try:
        mesh = make_local_mesh(MOE_EP_MP)
        rules = SH.AxisRules(mesh=mesh, enable_fsdp=False)
        res = {"a": check_moe_layer(rank, rules, dev)}
        for case in ("b", "c"):
            res[case] = moe_mesh_step(case, rank, world, rules, dev, sync)
            if cuda:
                torch.cuda.empty_cache()
        res["coords"] = {a: mesh.rank(a) for a in mesh.shape}
        print("MOE_EP_RANK " + json.dumps(res), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def run_moe_ep_phase(dev, card):
    """Phase 19: (a)-(c) as MOE_EP_MP gloo rank processes on the card, (d)
    the driver under torch.distributed.run.  Returns the K1 launches of
    the ranks' mesh steps in (b) and (c), summed."""
    t0 = time.perf_counter()
    outs, wall = run_rank_procs("--moe-ep-rank", MOE_EP_MP, [],
                                MOE_EP_TIMEOUT_S, "MOE_EP_RANK")
    if len({o["b"]["digest"] for o in outs}) != 1:
        fail("19(b): the replicated leaves differ across the ranks")
    for r, o in enumerate(outs):
        a, sb, sc = o["a"], o["b"], o["c"]
        if sc["k1"] != sb["k1"]:
            fail(f"19(c) rank {r}: {sc['k1']} K1 launches, (b) {sb['k1']} "
                 "(the same two client blocks)")
        log(19, f"(a) rank {r} at {o['coords']}: qwen3-moe-30b-a3b MoE layer "
            f"(d 2048, 128 experts, top-8, d_ff_expert 768, capacity factor "
            f"1.25, bf16), {MOE_EP_TOKENS[0]} x {MOE_EP_TOKENS[1]} tokens: "
            f"moe_ep == moe_ep_plain on the card within the bars (out "
            f"{MOE_EP_OUT_BAR}, gradients {MOE_EP_GRAD_BAR} x max |oracle|): "
            + ", ".join(f"{k} max |d| {d} of {t}" for k, (d, t) in
                        a["errs"].items())
            + f"; {a['drops']} of {a['entries']} (token, choice) entries "
            f"dropped on the two slabs (== the oracle's)")
        log(19, f"(b) rank {r}: HERON step, kernel stream, f32, full width, "
            f"3 of 48 layers, capacity factor 16: {sb['k1']} K1 launches "
            f"(== the unsharded step's, each == plain bit for bit), no "
            f"drops, loss {sb['loss']} client_loss {sb['client_loss']} (== "
            f"the unsharded step's within 1e-5), slabs within "
            f"{TRAIN_MESH_TOL} of the unsharded step's (max |d| "
            f"{sb['max_abs']})")
        idle = (f"busy {sc['busy_ms']:.3f} ms, idle share "
                f"{1 - sc['busy_ms'] / sc['wall_ms']:.3f}"
                if sc["busy_ms"] > 0 else
                "busy not measured (the profiler saw no device time)")
        log(19, f"(c) rank {r}: HERON step, bf16, 4 of 48 layers, capacity "
            f"factor 1.25, {MOE_EP_TOKENS[0]} x {MOE_EP_TOKENS[1]} tokens: "
            f"wall {sc['wall_ms']:.3f} ms (the second step), {idle} (a "
            f"third, profiled), max_memory_allocated {sc['peak']}; "
            f"{sc['k1']} K1 launches; dropped entries by dispatch (client "
            f"blocks 0-1 clean, perturbed; server blocks 2-3, then 3 and 2 "
            f"again in the backward's recompute) "
            f"{sc['drops']} of {sc['entries']} each; loss {sc['loss']} "
            f"client_loss {sc['client_loss']}")
    log(19, f"(a)-(c) on {card}: replicated leaves of (b) equal across the "
        f"{MOE_EP_MP} ranks (blake2b); the ranks done in {wall:.1f} s")
    run_mesh_driver(card, "qwen3-moe-30b-a3b", 19)
    log(19, f"(phase 19 took {time.perf_counter() - t0:.1f} s)")
    return {"zo_noise": sum(o["b"]["k1"] + o["c"]["k1"] for o in outs)}


# ---------------------------------------------------------------------------
# phases 20 and 21: HERON steps of the families on the ("data", "model") mesh
# ---------------------------------------------------------------------------

# the model axis of the ranks of phases 20 and 21, the tokens (B, S) of
# every case (seamless: S encoder frames and S decoder tokens a row) and a
# rank process's time limit
MESH_STEP_MP = 2
MESH_STEP_TOKENS = (2, 256)
MESH_STEP_TIMEOUT_S = 600
# a bf16 case's timed steps after the first: the median and the range
MESH_STEP_TIMED = 3
# the kernels a mesh step counts
MESH_STEP_KINDS = ("zo_noise", "zo_dual_matmul", "zo_dual_matmul_tc",
                   "zo_dual_flash_attention", "zo_dual_flash_attention_tc",
                   "rg_lru_scan", "rg_lru_scan_reverse")
# 20(a): a rank's bf16 block against the whole block on the card: the
# column and row slabs' products and the reduce-scatter's partial sums
# round in other orders; 19(a)'s bars, two bf16 ulps of the whole
# block's largest entry (2^-6 of it) for the output, four for gradients
REC_OUT_BAR = 2.0 ** -6
REC_GRAD_BAR = 2.0 ** -5
# A case: (arch, layers or None for all, dtype, attn_probe, the server
# AdamW's eps).  20(b)-(d): recurrentgemma at 4 layers is (rg_lru, rg_lru
# | local_attn, rg_lru): the server runs one RG-LRU block forward, again
# in the backward's recompute (cfg.remat), and in reverse; xlstm at 8 is
# 2 mLSTM | 5 mLSTM and the first sLSTM (block 7).
# xlstm's f32 stack is ill-conditioned (ROADMAP queue 3), so its server's
# AdamW runs at eps 1e-3, as the CPU tests hold it
REC_STEP_CASES = {"b": ("recurrentgemma-9b", 4, "float32", "weights", 1e-6),
                  "c": ("recurrentgemma-9b", 4, "bfloat16", "weights", 1e-6),
                  "d32": ("xlstm-1.3b", 8, "float32", "weights", 1e-3),
                  "d16": ("xlstm-1.3b", 8, "bfloat16", "weights", 1e-3)}
# 21(a)-(d): qwen2-vl at 4 layers keeps its two client blocks (cut 2): the
# score probe's K3 launches with each rank's head offset under M-RoPE ids
MOD_STEP_CASES = {
    "a": ("qwen2-vl-2b", None, "float32", "weights", 1e-6),
    "b": ("qwen2-vl-2b", 4, "float32", "scores", 1e-6),
    "c": ("seamless-m4t-medium", None, "float32", "weights", 1e-6),
    "d_vlm": ("qwen2-vl-2b", None, "bfloat16", "weights", 1e-6),
    "d_s2s": ("seamless-m4t-medium", None, "bfloat16", "weights", 1e-6)}
# phase -> (its cases, the kernels each of its steps must launch; xlstm
# has no RG-LRU block)
MESH_STEP_PHASES = {
    20: (REC_STEP_CASES, ("zo_noise",)),
    21: (MOD_STEP_CASES, ("zo_noise", "zo_dual_matmul",
                          "zo_dual_flash_attention"))}
# an f32 case's slabs against the unsharded step's, an absolute bar of
# 2.5e-6 on every entry (phase 18 measured 1.10e-6 and phase 19 2.45e-6
# on their f32 steps)
REC_STEP_TOL = dict(rtol=0.0, atol=2.5e-6)


def record_k6_calls(fn):
    """Run ``fn`` with every K6 launch held against its plain version on
    its own inputs as it returns (``torch.equal``: forward ``h``, reverse
    ``da`` and ``db``): ``[((B, S, W), reverse, equal)]``.  The plain
    loops launch no K6."""
    import torch
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import rg_lru as RG
    calls, launch = [], RG._launch

    def rec(a, x, hs, out, da, reverse):
        launch(a, x, hs, out, da, reverse)
        with torch.no_grad():
            if reverse:
                rda, rdb = R.rg_lru_scan_reverse_ref(a, x, hs)
                same = torch.equal(out, rdb) and torch.equal(da, rda)
            else:
                same = torch.equal(out, R.rg_lru_scan_ref(a, x))
        calls.append((tuple(a.shape), bool(reverse), bool(same)))

    RG._launch = rec
    try:
        fn()
    finally:
        RG._launch = launch
    return calls


def check_k6_recorded(desc, calls):
    bad = [c for c in calls if not c[2]]
    if bad:
        fail(f"{desc}: K6 launches differ from plain: {bad}")
    return [list(c[:2]) for c in calls]


def _step_config(arch, layers, dtype, probe="weights"):
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch).replace(forward_impl="kernel", attn_probe=probe,
                                   param_dtype=dtype, compute_dtype=dtype)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    return cfg.replace(mlstm_chunk=64) if arch == "xlstm-1.3b" else cfg


def check_rg_block(rank, rules, dev):
    """20(a): ``rg_lru_block`` on this rank's slabs of one recurrentgemma-9b
    RG-LRU block (bf16, lru 4096), forward and backward of ``sum(out *
    w)``, against the whole block on the same card: the output and x's
    gradient, each slab's gradient within the bars; every K6 launch of
    the slab block (forward and reverse on (B, S, 2048)) == plain."""
    import torch
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import layers as L
    from repro_torch.models import recurrent as REC
    from repro_torch.tree import tree_leaves_with_path, tree_map
    cfg = _step_config("recurrentgemma-9b", 1, "bfloat16")
    gen = torch.Generator(dev).manual_seed(20)
    params = REC.init_rg_lru(gen, cfg)
    B, S = MESH_STEP_TOKENS
    x, w = (torch.randn((B, S, cfg.d_model), generator=gen, device=dev
                        ).to(torch.bfloat16) for _ in range(2))
    places = tree_map(lambda r: rules.sharding_for(tuple(r.shape), r.axes),
                      REC.init_rg_lru(L.RULES, cfg))

    def run(p, r):
        xg = x.clone().requires_grad_(True)
        p = tree_map(lambda t: t.detach().requires_grad_(True), p)
        y, _ = REC.rg_lru_block(p, xg, cfg, rules=r)
        leaves = tree_leaves_with_path(p)
        g = torch.autograd.grad(torch.sum(y.float() * w.float()),
                                [xg] + [t for _, t in leaves])
        return y.detach(), g[0], dict(zip([q for q, _ in leaves], g[1:]))

    yo, gxo, gpo = run(params, None)
    out = []
    calls = record_k6_calls(lambda: out.append(run(tree_map(
        SH.shard, params, places), rules)))
    yr, gxr, gpr = out.pop()
    pl = dict(tree_leaves_with_path(places))
    errs = {}
    for name, got, want, bar in (
            [("out", yr, yo, REC_OUT_BAR), ("grad x", gxr, gxo,
                                            REC_GRAD_BAR)]
            + [(f"grad {k}", g, SH.shard(gpo[k], pl[k]), REC_GRAD_BAR)
               for k, g in gpr.items()]):
        d = max_abs(got, want)
        top = float(want.float().abs().max())
        if not d <= bar * top:
            fail(f"20(a) rank {rank}: {name} max |d| {d} past {bar} x "
                 f"max |whole block| {top}")
        errs[name] = (d, top)
    k6 = check_k6_recorded(f"20(a) rank {rank}", calls)
    want = [[(B, S, cfg.lru_width // MESH_STEP_MP), False],
            [(B, S, cfg.lru_width // MESH_STEP_MP), True]]
    if [[tuple(s), r] for s, r in k6] != want:
        fail(f"20(a) rank {rank}: K6 launches {k6}, expected {want}")
    return {"errs": errs, "k6": k6}


def record_step_calls(fn):
    """Run ``fn`` with every K1, K2, K3 and K6 launch recorded (each K6
    launch held against plain as it returns): ``{"k1": (tree calls, rows
    calls), "k2": ..., "k3": ..., "k6": ...}``."""
    rec = {}

    def k3():
        rec["k3"] = record_k3_calls(fn)

    def k2():
        rec["k2"] = record_k2_calls(k3)

    def k1():
        rec["k1"] = record_k1_calls(k2)

    rec["k6"] = record_k6_calls(k1)
    return rec


def check_step_recorded(desc, rec, counts, dev):
    """Each recorded launch of a mesh step against plain: K1 again on
    fresh inputs bit for bit, K2 and K3 on their own inputs within
    check_k2's / check_k3's tolerance, K6 bit for bit; the recorded
    launches equal the counted ones."""
    n_k1 = (check_k1_recorded(desc, rec["k1"][0], dev)
            + check_k1_rows_recorded(desc, rec["k1"][1]))
    got = {"zo_noise": n_k1, "zo_dual_matmul": len(rec["k2"]),
           "zo_dual_flash_attention": len(rec["k3"]),
           "rg_lru_scan": len(rec["k6"])}
    if got != {k: counts[k] for k in got}:
        fail(f"{desc}: recorded {got} launches, counted {counts}")
    k6 = check_k6_recorded(desc, rec["k6"])
    return {"k2_worst": check_k2_recorded(desc, rec["k2"], dev),
            "k3_worst": check_k3_recorded(desc, rec["k3"]),
            "k3_shapes": sorted({str(tuple(a["qa"].shape)) + (
                " scores row_offset " + str(a["row_offset"])
                if a["perturb_b"] and a["kb"] is None else "")
                for a, _ in rec["k3"]}),
            "k6_shapes": sorted({str(s) for s, _ in k6})}


def mesh_step(phase, case, rank, world, rules, dev, sync):
    """20(b)-(d) and 21(a)-(d) on this rank.  An f32 case: the unsharded
    HERON step first, one rank at a time (the card holds one whole state
    at a time), keeping this rank's slabs of its params and its
    launches; then the mesh step, its launches equal to the unsharded
    step's, its slabs within REC_STEP_TOL of the unsharded step's.  A
    bf16 case: the mesh step, MESH_STEP_TIMED more timed (wall, peak
    memory, launches == the first's), one under the profiler (busy).
    Every launch of the first mesh step is recorded and held against
    plain (:func:`check_step_recorded`)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import prng as R
    from repro_torch.core import protocols as P
    from repro_torch.core import zo as Z
    from repro_torch.data.pipeline import place_batch
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import adamw, zo_sgd
    cases, must = MESH_STEP_PHASES[phase]
    *spec, eps = cases[case]
    cfg = _step_config(*spec)
    r8 = TRAIN_MESH_RATES
    copt, sopt = zo_sgd(r8["lr"]), adamw(r8["server_lr"], eps=eps)
    zo = Z.ZOConfig(mu=r8["mu"], scale="gaussian")
    batch = (modality_batch(cfg, MESH_STEP_TOKENS, dev, seed=phase)
             if cfg.family in ("vlm", "audio") else
             _lm_batch(cfg.vocab, *MESH_STEP_TOKENS, dev, seed=phase))
    desc = f"{phase}({case}) rank {rank}"
    f32 = cfg.param_dtype == "float32"

    def params():
        return T.init_lm(cfg, seed=phase, device=dev, draw_on_device=True)

    def counted():
        return {k: launch_counts()[k] for k in MESH_STEP_KINDS}

    api = P.lm_api(cfg, rules)
    ref = None
    for r in range(world if f32 else 0):
        if r == rank:
            st = P.init_train_state(R.PRNGKey(1), params(), copt, sopt)
            reset_counts()
            new, rm = P.make_train_step(P.lm_api(cfg), "heron", zo, copt,
                                        sopt)(st, batch)
            sync()
            ref = (SH.shard_tree(new["params"], api.shardings), counted(),
                   float(rm["loss"]), float(rm["client_loss"]))
            del st, new
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    state = P.init_train_state(R.PRNGKey(1), params(), copt, sopt,
                               shardings=api.shardings)
    step = P.make_train_step(api, "heron", zo, copt, sopt)
    b = place_batch(batch, dev, rules)
    out = []
    reset_counts()
    rec = record_step_calls(lambda: out.append(step(state, b)))
    sync()
    counts = counted()
    new, m = out.pop()
    res = {"counts": counts, "loss": float(m["loss"]),
           "client_loss": float(m["client_loss"]),
           **check_step_recorded(desc, rec, counts, dev)}
    del rec
    if min(counts[k] for k in must) <= 0:
        fail(f"{desc}: launches {counts}, one of {must} never")
    if f32:
        if counts != ref[1]:
            fail(f"{desc}: launches {counts}, the unsharded step {ref[1]}")
        for got, want in ((res["loss"], ref[2]), (res["client_loss"],
                                                  ref[3])):
            if not abs(got - want) <= 1e-5 * abs(want):
                fail(f"{desc}: loss {got} vs the unsharded step's {want}")
        res["max_abs"], res["digest"] = _slab_check(
            desc, new["params"], ref[0], api.shardings, REC_STEP_TOL)
        return res
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(MESH_STEP_TIMED):
        sync()
        reset_counts()
        t0 = time.perf_counter()
        new, _ = step(new, b)
        sync()
        walls.append(1e3 * (time.perf_counter() - t0))
        if counted() != counts:
            fail(f"{desc}: a timed step launched {counted()}, the first "
                 f"{counts}")
    res["walls_ms"] = walls
    res["wall_ms"] = float(np.median(walls))
    res["peak"] = torch.cuda.max_memory_allocated() if dev.type == "cuda" \
        else 0
    res["busy_ms"] = (sum(r_[0] for r_ in device_rows(
        lambda: step(new, b))) / 1e3 if dev.type == "cuda" else 0.0)
    return res


def mesh_step_rank(rank, world, workdir, phase, device="cuda"):
    """One rank of phase 20's (a)-(d), phase 21's (a)-(d) or phase 23's
    (a)-(c) (``chip_smoke.py --mesh-step-rank RANK WORLD DIR PHASE``): a gloo
    group on a FileStore in DIR, every rank on card 0,
    ``make_local_mesh(MESH_STEP_MP)``.  Prints one ``MESH_STEP_RANK
    {json}`` line."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.mesh import make_local_mesh
    phase = int(phase)
    cuda = device == "cuda"
    dev = torch.device(device, 0) if cuda else torch.device(device)
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def sync():
        if cuda:
            torch.cuda.synchronize()

    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(workdir, "store"), world), rank=rank, world_size=world)
    try:
        mesh = make_local_mesh(MESH_STEP_MP)
        rules = SH.AxisRules(mesh=mesh, enable_fsdp=False)
        res = {"a": check_rg_block(rank, rules, dev)} if phase == 20 else {}
        cases, run = ((SERVE_MESH_CASES, serve_mesh_case)
                      if phase == SERVE_PHASE else
                      (MESH_STEP_PHASES[phase][0], mesh_step))
        for case in cases:
            t0 = time.perf_counter()
            res[case] = run(phase, case, rank, world, rules, dev, sync)
            res[case]["seconds"] = time.perf_counter() - t0
            if cuda:
                torch.cuda.empty_cache()
        res["coords"] = {a: mesh.rank(a) for a in mesh.shape}
        print("MESH_STEP_RANK " + json.dumps(res), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def run_mesh_steps(phase, card, what):
    """Phase ``phase``'s cases as MESH_STEP_MP gloo rank processes on the
    card, logged; the replicated leaves of each f32 case equal across the
    ranks.  ``what``: case -> its description.  Returns the ranks'
    outputs."""
    cases = MESH_STEP_PHASES[phase][0]
    outs, wall = run_rank_procs("--mesh-step-rank", MESH_STEP_MP,
                                [str(phase)], MESH_STEP_TIMEOUT_S,
                                "MESH_STEP_RANK")
    f32 = [c for c, v in cases.items() if v[2] == "float32"]
    for case in f32:
        if len({o[case]["digest"] for o in outs}) != 1:
            fail(f"{phase}({case}): the replicated leaves differ across "
                 "the ranks")
    B, S = MESH_STEP_TOKENS
    for r, o in enumerate(outs):
        if phase == 20:
            log(20, f"(a) rank {r} at {o['coords']}: recurrentgemma-9b "
                f"RG-LRU block (d 4096, lru 4096, bf16), {B} x {S} tokens, "
                f"on its lru slab == the whole block on the card within the "
                f"bars (out {REC_OUT_BAR}, gradients {REC_GRAD_BAR} x max "
                f"|whole|): " + ", ".join(
                    f"{k} max |d| {d} of {t}" for k, (d, t) in
                    o["a"]["errs"].items())
                + f"; K6 launches (shape, reverse) {o['a']['k6']}, each == "
                f"plain bit for bit")
        for case in cases:
            s = o[case]
            plain = (f"every K1 launch run again == plain bit for bit, K2 "
                     f"max |d| {s['k2_worst']}, K3 max |d| {s['k3_worst']} "
                     f"on {s['k3_shapes']}, every K6 launch on "
                     f"{s['k6_shapes']} == plain bit for bit")
            if case in f32:
                log(phase, f"({case}) rank {r} at {o['coords']}: "
                    f"{what[case]}, {B} x {S} tokens: launches "
                    f"{s['counts']} (== the unsharded step's; {plain}), loss "
                    f"{s['loss']} client_loss {s['client_loss']} (== the "
                    f"unsharded step's within 1e-5), slabs within "
                    f"{REC_STEP_TOL} of the unsharded step's (max |d| "
                    f"{s['max_abs']}); {s['seconds']:.1f} s")
                continue
            idle = (f"busy {s['busy_ms']:.3f} ms, idle share "
                    f"{1 - s['busy_ms'] / s['wall_ms']:.3f}"
                    if s["busy_ms"] > 0 else
                    "busy not measured (the profiler saw no device time)")
            log(phase, f"({case}) rank {r}: {what[case]}, {B} x {S} tokens: "
                f"wall median {s['wall_ms']:.3f} ms of the "
                f"{MESH_STEP_TIMED} steps after the first (each "
                f"{', '.join(f'{w:.3f}' for w in s['walls_ms'])} ms), "
                f"{idle} (one more, profiled), max_memory_allocated "
                f"{s['peak']}; launches {s['counts']} (the first step's: "
                f"{plain}); loss {s['loss']} client_loss "
                f"{s['client_loss']}; {s['seconds']:.1f} s")
    log(phase, f"on {card}: replicated leaves of {', '.join(f32)} equal "
        f"across the {MESH_STEP_MP} ranks (blake2b); the ranks done in "
        f"{wall:.1f} s")
    return outs


def step_counts(outs, phase, kinds):
    """The ranks' launches of ``kinds`` in phase ``phase``'s mesh steps,
    summed."""
    return {k: sum(o[c]["counts"][k] for o in outs
                   for c in MESH_STEP_PHASES[phase][0]) for k in kinds}


def run_rec_mesh_phase(dev, card):
    """Phase 20: (a)-(d) as MESH_STEP_MP gloo rank processes on the card,
    (e) the driver under torch.distributed.run for both families.
    Returns the K1 and K6 launches of the ranks' mesh steps in (b)-(d),
    summed."""
    t0 = time.perf_counter()
    outs = run_mesh_steps(20, card, {
        "b": "recurrentgemma-9b HERON step, kernel stream, f32, full width, "
        "4 of 38 layers",
        "c": "recurrentgemma-9b HERON step, bf16, 4 of 38 layers",
        "d32": "xlstm-1.3b HERON step, kernel stream, f32, full width, 8 "
        "of 48 layers (chunkwise mLSTM, 64)",
        "d16": "xlstm-1.3b HERON step, bf16, 8 of 48 layers"})
    run_mesh_drivers(card, ("recurrentgemma-9b", "xlstm-1.3b"), 20)
    log(20, f"(phase 20 took {time.perf_counter() - t0:.1f} s)")
    return step_counts(outs, 20, ("zo_noise", "rg_lru_scan"))


def run_mod_mesh_phase(dev, card):
    """Phase 21: (a)-(d) as MESH_STEP_MP gloo rank processes on the card,
    (e) the driver under torch.distributed.run for both archs.  Returns
    the K1 / K2 / K3 launches of the ranks' mesh steps in (a)-(d),
    summed."""
    t0 = time.perf_counter()
    outs = run_mesh_steps(21, card, {
        "a": "qwen2-vl-2b HERON step, kernel stream, f32, full width and "
        "depth (28 layers, cut 2), vision-stub embeddings and grid M-RoPE "
        "ids",
        "b": "qwen2-vl-2b HERON step, score probe, f32, full width, 4 of "
        "28 layers",
        "c": "seamless-m4t-medium HERON step, kernel stream, f32, full "
        "width and depth (12 + 12 layers, cut 3), frame embeddings and "
        "decoder tokens",
        "d_vlm": "qwen2-vl-2b HERON step, bf16, full width and depth",
        "d_s2s": "seamless-m4t-medium HERON step, bf16, full width and "
        "depth"})
    run_mesh_drivers(card, ("qwen2-vl-2b", "seamless-m4t-medium"), 21)
    log(21, f"(phase 21 took {time.perf_counter() - t0:.1f} s)")
    return step_counts(outs, 21, ("zo_noise", "zo_dual_matmul",
                                  "zo_dual_flash_attention"))


# ---------------------------------------------------------------------------
# phase 22: the dry-run tooling (launch/costs.py, roofline.py, dryrun.py)
# ---------------------------------------------------------------------------

# the bars of tests/test_torch_perf_knobs.py: causal_skip against no skip
# (absolute), attn_p_dtype "bfloat16" against an f32 p (x max|v|)
KNOB_SKIP_ATOL = 1e-6
KNOB_P_BF16_BAR = 2.0 ** -7
# (b): qwen2-1.5b's server attention (B, S, H, Kv, D) in 1024-chunks
KNOB_SHAPE = (1, 4096, 12, 2, 128)
KNOB_CHUNK = 1024
# (c): the dry-run cells, (arch, shape, flags); each must end "ok".  The
# last four are decode cells on the model axis (serving over the mesh)
DRYRUN_CELLS = (("qwen2-1.5b", "train_4k", ()),
                ("qwen3-moe-30b-a3b", "train_4k", ()),
                ("qwen2-1.5b", "train_4k", ("--multi-pod",)),
                ("qwen2-1.5b", "prefill_32k", ()),
                ("qwen2-1.5b", "decode_32k", ()),
                ("qwen3-moe-30b-a3b", "decode_32k", ()),
                ("recurrentgemma-9b", "long_500k", ()),
                ("xlstm-1.3b", "decode_32k", ("--multi-pod",)))
DRYRUN_TIMEOUT_S = 400


def start_dryruns():
    """(c): each DRYRUN_CELLS cell as its own ``python -m
    repro_torch.launch.dryrun`` process, all started together: they count
    on meta tensors on the host's cores (the card hidden from them)
    while the card runs other phases.  Returns ``(temporary directory,
    [(proc, out path, log)], start time)``; ``stop_dryruns`` ends any
    still running when the script exits."""
    import atexit
    import tempfile
    tmp = tempfile.TemporaryDirectory()
    workdir = tmp.name
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    procs = []
    for i, (arch, shape, flags) in enumerate(DRYRUN_CELLS):
        out = os.path.join(workdir, f"cell{i}.jsonl")
        log_f = open(os.path.join(workdir, f"cell{i}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, *flags, "--out", out], cwd=ROOT,
            env=env, stdout=log_f, stderr=subprocess.STDOUT), out, log_f))
    atexit.register(stop_dryruns, procs)
    return tmp, procs, time.perf_counter()


def stop_dryruns(procs):
    for proc, _, log_f in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log_f.close()


def finish_dryruns(procs, workdir, t_start):
    """Wait for (c)'s cells: each exits 0 and ends "ok"; their records,
    and ``launch/report.py`` over them."""
    deadline = t_start + DRYRUN_TIMEOUT_S
    recs = []
    for (proc, out, log_f), (arch, shape, flags) in zip(procs,
                                                         DRYRUN_CELLS):
        try:
            rc = proc.wait(timeout=max(deadline - time.perf_counter(), 1))
        except subprocess.TimeoutExpired:
            fail(f"dry run {arch} {shape} {flags} ran past "
                 f"{DRYRUN_TIMEOUT_S} s")
        log_f.close()
        text = open(log_f.name).read()
        if rc != 0:
            fail(f"dry run {arch} {shape} {flags} exited {rc}: {text[-2000:]}")
        rec = json.loads(open(out).read().strip().splitlines()[-1])
        if rec["status"] != "ok":
            fail(f"dry run {arch} {shape} {flags}: status {rec['status']}: "
                 f"{str(rec)[:2000]}")
        recs.append(rec)
        log(22, f"(c) dry run {arch} {shape} {rec['mesh']} rank 0: ok; "
            f"counted in {rec['seconds_compile']} s (built {rec['seconds_lower']}"
            f" s); flops {rec['flops']} bytes {rec['bytes_accessed']} "
            f"collective bytes {rec['collective_by_op']} over "
            f"{rec['collective_links']}; compute_s {rec['compute_s']} "
            f"memory_s {rec['memory_s']} collective_s {rec['collective_s']} "
            f"-> {rec['bottleneck']}, roofline_step_s "
            f"{rec['roofline_step_s']}; useful/counted flops "
            f"{rec['useful_flops_ratio']}; peak {rec['memory']['total_hbm_bytes']}"
            f" B; fsdp {rec['fsdp']} (reference: {rec['fsdp_reference']})")
    path = os.path.join(workdir, "cells.jsonl")
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in recs)
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.report", "--jsonl",
         path], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    if rep.returncode != 0:
        fail(f"launch/report.py exited {rep.returncode}: "
             f"{rep.stderr[-2000:]}")
    for line in rep.stdout.splitlines():
        if line.strip():
            log(22, f"(c) report: {line}")


def check_one_launches(dev, card):
    """(a): one launch each of K4, K5 and K6 at a shape of the kernel
    table (K4 bf16 1024 x 768x3072, K5 bf16 B4 S256 H12 D64 causal, K6
    forward f32 (2, 512, 4096)): each records the FLOPs and bytes of the
    same call on meta tensors, and equals plain (K4, K5 at check_k4 /
    check_k5's tolerance, K6 bit for bit).  Returns the launches."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import records as REC
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import rg_lru as RG
    from repro_torch.kernels import zo_matmul as ZM
    _, x, w = k2_inputs(dev, torch.bfloat16, 1024, 768, 3072)
    q, _, k, v, _, _ = k3_inputs(dev, torch.bfloat16, 4, 256, 12, 12, 64)
    a, b, _ = k6_inputs(dev, 2, 512, 4096)

    def bf16_tol(ref, floor):
        return 2 ** -7 * ref.float().abs() + floor

    cases = (
        ("K4 zo_matmul", lambda x, w: ZM.zo_matmul(x, w, 3, 1e-3), (x, w),
         lambda: k4_plain(x, w, 3, 1e-3, True, 0),
         lambda ref: bf16_tol(ref, 1e-4 * ref.float().abs().max())),
        ("K5 flash_attention", lambda q, k, v: FA.flash_attention(q, k, v),
         (q, k, v), lambda: R.flash_attention_ref(q, k, v),
         lambda ref: bf16_tol(ref, 1e-3)),
        ("K6 rg_lru_scan", RG.rg_lru_scan, (a, b),
         lambda: R.rg_lru_scan_ref(a, b), None))
    total = {}
    for name, fn, args, plain, tol in cases:
        reset_counts()
        with REC.recording() as recs:
            out = fn(*args)
        torch.cuda.synchronize()
        got = {kk: n for kk, n in launch_counts().items() if n}
        with REC.recording() as meta_recs:
            fn(*(torch.empty_like(t, device="meta") for t in args))
        if recs != meta_recs or len(recs) != 1:
            fail(f"{name}: records {recs} on the card, {meta_recs} on meta")
        ref = plain()
        if tol is None:
            if not torch.equal(out, ref):
                fail(f"{name}: max |d| {max_abs(out, ref)} from plain")
        elif not bool(((out.float() - ref.float()).abs()
                       <= tol(ref)).all()):
            fail(f"{name}: max |d| {max_abs(out, ref)} from plain")
        log(22, f"(a) {name} one launch {got} on {card}: record (flops, "
            f"bytes) {meta_recs[0][1:]} == the call on meta; max |d| from "
            f"plain "
            f"{max_abs(out, ref)}")
        for kk, n in got.items():
            total[kk] = total.get(kk, 0) + n
    return total


def _timed_step(desc, step, state, batch):
    """One qwen2-1.5b step from ``state`` on the host's clock, then one
    more under the profiler: ``(its updated params, wall s, busy ms,
    max_memory_allocated above the bytes held before it, those bytes,
    its launches)``, the launches checked against QWEN_STEP."""
    import torch
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    new, _ = step(state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    counts = launch_counts()
    check_counts(desc, counts, QWEN_STEP)
    params = new["params"]
    del new
    busy = sum(r[0] for r in device_rows(lambda: step(state, batch))) / 1e3
    return params, wall, busy, peak, held, counts


def run_costs_step(dev, card):
    """(a): one qwen2-1.5b HERON datacenter step (bf16, kernel stream, 4 x
    256 tokens, phase 14's) counted on meta tensors and on the card: the
    FLOPs and kernel records equal; the recorded step's K1-K3 launches
    each == plain; the timed step's wall and profiled busy beside the
    roofline step time, the tracked peak beside max_memory_allocated
    above the bytes held before the step.  Then the same step with remat
    off (every server activation kept) from the same state: its wall,
    busy, measured and tracked peaks beside remat on's, its updated
    params within KNOB_P_BF16_BAR x each leaf's max |entry| of remat on's.
    Returns the launches of the timed and the counted step."""
    import torch
    from repro_torch.configs.qwen2_1_5b import full_config
    from repro_torch.launch import costs as C
    from repro_torch.launch import roofline as RL
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cfg = full_config().replace(forward_impl="kernel")
    if not cfg.remat:
        fail("(a) qwen2-1.5b has remat off")
    cfg_off = cfg.replace(remat=False)
    rates = dict(lr=1e-4, server_lr=2e-4, mu=1e-3)
    batch = _lm_batch(cfg.vocab, 4, 256, dev)
    # the batch's views on meta, their strides and offsets the card's
    # (a copy of a strided view is an op with bytes of its own)
    mbatch = {kk: torch.empty(t.untyped_storage().nbytes() //
                              t.element_size(), dtype=t.dtype,
                              device="meta").as_strided(
        t.shape, t.stride(), t.storage_offset()) for kk, t in batch.items()}
    metas, t_metas = {}, {}
    for c in (cfg, cfg_off):
        mstate, mstep = _train_parts(c, T.init_lm(c, device="meta"),
                                     **rates)
        t0 = time.perf_counter()
        metas[c.remat] = C.total_costs(mstep, mstate, mbatch)
        t_metas[c.remat] = time.perf_counter() - t0
        del mstate
    meta, t_meta = metas[True], t_metas[True]
    state, step = _train_parts(cfg, T.init_lm(cfg, seed=0, device=dev,
                                              draw_on_device=True),
                               **rates)
    state = recorded_step("qwen2-1.5b step", step, state, batch, QWEN_STEP,
                          dev, card, phase=22)
    new_on, wall, busy, peak, held, counts = _timed_step(
        "qwen2-1.5b timed step", step, state, batch)
    reset_counts()
    t0 = time.perf_counter()
    on_card = C.total_costs(step, state, batch)
    t_card = time.perf_counter() - t0
    counted = launch_counts()
    check_counts("qwen2-1.5b counted step", counted, QWEN_STEP)
    # the same step with remat off, from the same state
    new_off, wall_off, busy_off, peak_off, _, _ = _timed_step(
        "qwen2-1.5b timed step, remat off", _train_step(cfg_off, **rates)[2],
        state, batch)
    worst, n_equal, n_leaves = 0.0, 0, 0
    for a, b in zip(tree_leaves(new_off), tree_leaves(new_on)):
        d = float((a.float() - b.float()).abs().max())
        bar = KNOB_P_BF16_BAR * float(b.float().abs().max())
        if not d <= bar:
            fail(f"(a) remat off: a leaf {tuple(a.shape)} max |d| {d} from "
                 f"remat on's (bar {bar})")
        worst, n_equal, n_leaves = (max(worst, d / max(bar, 1e-30)),
                                    n_equal + int(d == 0), n_leaves + 1)
    del new_off, new_on, state
    keys = ("flops", "kernel_records", "bytes", "collective_bytes")
    if any(on_card[kk] != meta[kk] for kk in keys):
        fail(f"(a) counted on the card: {[on_card[kk] for kk in keys]}; on "
             f"meta: {[meta[kk] for kk in keys]} ({keys})")
    recs = {kk: r["launches"] for kk, r in meta["kernel_records"].items()}
    if any(recs.get(kk, 0) != QWEN_STEP[kk] for kk in
           ("zo_noise", "zo_dual_matmul", "zo_dual_flash_attention")):
        fail(f"(a) records {recs} against the step's launches {QWEN_STEP}")
    terms = RL.roofline_terms(meta, cfg)
    step_s = terms["roofline_step_s"]
    tracked = meta["peak_bytes"] - meta["argument_bytes"]
    log(22, f"(a) qwen2-1.5b HERON step counted on meta in {t_meta:.1f} s "
        f"and on {card} in {t_card:.1f} s: flops {meta['flops']} == "
        f"{on_card['flops']}, kernel records {meta['kernel_records']}, "
        f"bytes {meta['bytes']} and collective bytes "
        f"{meta['collective_bytes']} equal")
    log(22, f"(a) roofline (H100 SXM published peaks, bf16): compute_s "
        f"{terms['compute_s']} memory_s {terms['memory_s']} -> "
        f"{terms['bottleneck']}, roofline_step_s {step_s}; measured wall "
        f"{wall} s, busy {busy / 1e3} s: roofline / busy {step_s / (busy / 1e3) if busy else float('nan')}, "
        f"roofline / wall {step_s / wall}")
    log(22, f"(a) peak: tracked on meta {tracked} B above the arguments "
        f"({meta['argument_bytes']} B); max_memory_allocated above the "
        f"{held} B held before the step {peak} B; tracked / measured "
        f"{tracked / peak}")
    tracked_off = metas[False]["peak_bytes"] - metas[False]["argument_bytes"]
    log(22, f"(a) remat on / off on {card}: max_memory_allocated above the "
        f"held state {peak} / {peak_off} B ({peak / peak_off:.4f}); tracked "
        f"on meta {tracked} / {tracked_off} B; busy {busy} / {busy_off} ms "
        f"({busy / busy_off if busy_off else float('nan'):.4f}); wall "
        f"{wall} / {wall_off} s; counted flops {meta['flops']} / "
        f"{metas[False]['flops']} (remat off counted in "
        f"{t_metas[False]:.1f} s); updated params: {n_equal} of {n_leaves} "
        f"leaves equal bit for bit, the worst leaf at {worst:.4f} of its "
        f"bar ({KNOB_P_BF16_BAR} x its max |entry|)")
    return {kk: counts[kk] + counted[kk] for kk in counts}


def run_knobs(dev, card):
    """(b): the server's blocked attention at qwen2-1.5b's heads, bf16, B
    1, S 4096 in 1024-chunks: causal_skip == no skip within
    KNOB_SKIP_ATOL, attn_p_dtype bf16 within KNOB_P_BF16_BAR x max|v| of
    the f32 p; the counted FLOPs of the skip 10 / 16 of no skip's; the
    three timed (plain torch: no kernel of the port)."""
    import torch
    from repro_torch.launch import costs as C
    from repro_torch.models import attention as A
    B, S, H, Kv, D = KNOB_SHAPE
    q, _, k, v, _, _ = k3_inputs(dev, torch.bfloat16, B, S, H, Kv, D, seed=5)
    kw = dict(q_chunk=KNOB_CHUNK, kv_chunk=KNOB_CHUNK)
    calls = {"no skip": dict(kw),
             "causal_skip": dict(kw, causal_skip=True),
             "p bf16": dict(kw, p_dtype=torch.bfloat16)}
    outs = {n: A.blocked_attention(q, k, v, **c) for n, c in calls.items()}
    d_skip = max_abs(outs["causal_skip"], outs["no skip"])
    d_p = max_abs(outs["p bf16"], outs["no skip"])
    bar = KNOB_P_BF16_BAR * float(v.float().abs().max())
    if d_skip > KNOB_SKIP_ATOL or d_p > bar:
        fail(f"(b) causal_skip max |d| {d_skip} (bar {KNOB_SKIP_ATOL}), "
             f"p bf16 {d_p} (bar {bar})")
    mq, mk, mv = (torch.empty_like(t, device="meta") for t in (q, k, v))
    flops = {n: C.total_costs(lambda: A.blocked_attention(
        mq, mk, mv, **c))["flops"] for n, c in calls.items()}
    if flops["causal_skip"] * 16 != flops["no skip"] * 10:
        fail(f"(b) counted flops {flops}: the skip is not 10 / 16")
    ms = {n: time_ms(lambda: A.blocked_attention(q, k, v, **c), reps=10)
          for n, c in calls.items()}
    log(22, f"(b) blocked_attention bf16 B{B} S{S} H{H} Kv{Kv} D{D}, "
        f"{KNOB_CHUNK}-chunks, on {card}: causal_skip max |d| {d_skip} "
        f"(bar {KNOB_SKIP_ATOL}), p bf16 max |d| {d_p} (bar {bar}); counted "
        f"flops {flops} (skip / no skip {flops['causal_skip'] / flops['no skip']}); "
        f"ms {ms}: skip / no skip {ms['causal_skip'] / ms['no skip']}, "
        f"p bf16 / no skip {ms['p bf16'] / ms['no skip']}")


def run_dryrun_phase(dev, card, dryruns=None):
    """Phase 22.  ``dryruns``: (c)'s processes (``start_dryruns``; main()
    starts them after the build, so they count beside phases 2-21), or
    None to start them here.  Returns its launches: the (a) step's timed
    and counted steps (K1-K3) and the one K4, K5, K6 launch."""
    import torch
    tmp, procs, t0 = dryruns or start_dryruns()
    try:
        counts = run_costs_step(dev, card)
        torch.cuda.empty_cache()
        for kk, n in check_one_launches(dev, card).items():
            counts[kk] = counts.get(kk, 0) + n
        run_knobs(dev, card)
        torch.cuda.empty_cache()
        finish_dryruns(procs, tmp.name, t0)
    finally:
        stop_dryruns(procs)
        tmp.cleanup()
    return counts


# ---------------------------------------------------------------------------
# phase 23: serving over the model axis
# ---------------------------------------------------------------------------

SERVE_PHASE = 23
# case -> (arch, layers or None for all, dtype, slots, requests, prompt
# length, new tokens, segment, params seed).  (a) / (b) f32, held to the
# unsharded engine; (c) bf16, timed, phase 13's qwen2-1.5b engine (its
# params, queue and slots) at 16 new tokens.  Two gloo ranks on one H100
# take ~0.19-0.28 s a bf16 decode step (~57 collectives a step through
# host memory), so the new tokens are few
SERVE_MESH_CASES = {
    "a": ("qwen2-1.5b", None, "float32", 8, 24, 512, 8, 8, 23),
    "b": ("recurrentgemma-9b", 4, "float32", 4, 8, 512, 16, 16, 23),
    "c": ("qwen2-1.5b", None, "bfloat16", 8, 24, 512, 16, 8, 0)}
SERVE_MESH_KERNELS = ("flash_attention", "rg_lru_scan")


def _serve_mesh_setup(case, dev):
    """``(cfg, prompts, engine keywords, [K5, K6] per admission)`` of a
    phase 23 case."""
    from repro_torch.configs.registry import get_config
    arch, layers, dtype, slots, n_req, plen, max_new, seg, _ = \
        SERVE_MESH_CASES[case]
    cfg = get_config(arch).replace(param_dtype=dtype, compute_dtype=dtype)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    kw = dict(slots=slots, capacity=plen + max_new, segment_len=seg,
              device=dev)
    return (cfg, serve_queue(cfg.vocab, n_req, plen), kw,
            list(n_mixers(cfg)))


def _serve_params(cfg, seed, dev, rules=None):
    """The seeded params, whole, or this rank's slabs under ``rules``."""
    import torch
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import transformer as T
    full = T.init_lm(cfg, seed=seed, device=dev, draw_on_device=True)
    if rules is None:
        return full
    slab = SH.shard_tree(full, T.param_shardings(cfg, rules))
    del full
    torch.cuda.empty_cache()
    return slab


def _per_call(rec):
    """The K5 / K6 launches of each recorded admission or segment."""
    return [[c[k] for k in SERVE_MESH_KERNELS] for _, c in rec]


def _counted():
    return {k: launch_counts()[k] for k in SERVE_MESH_KERNELS}


def _check_launch_pattern(desc, rec, n_mixer, n_req):
    """K5 / K6 ``n_mixer`` per admission, none in decode segments.
    Returns the admissions' launches."""
    admit = _per_call(rec["admit"])
    in_segments = sum(map(sum, _per_call(rec["segment"])))
    if admit != [n_mixer] * n_req or in_segments:
        fail(f"{desc}: K5 / K6 per admission {admit} (expected {n_mixer} "
             f"each), {in_segments} in decode segments")
    return admit


def checked_engine_run(desc, eng, prompts, max_new, n_mixer):
    """``prompts`` through ``eng`` (greedy) with every K5 launch recorded
    and held against plain at check_k5's tolerance, and every K6 launch
    held against plain bit for bit as it returns; ``n_mixer`` K5 / K6
    launches per admission, none in decode segments.  Returns the
    streams, the launches and what was checked."""
    rec = timed_engine(eng)
    reset_counts()
    out, k6 = [], []
    k5 = record_k5_calls(lambda: k6.extend(record_k6_calls(
        lambda: out.append(run_engine(eng, prompts, max_new)))))
    del eng._admit_one, eng._decode_segment          # the wrappers' cycle
    counts = _counted()
    streams = out.pop()
    admit = _check_launch_pattern(desc, rec, n_mixer, len(prompts))
    if sum(map(len, streams)) != len(prompts) * max_new:
        fail(f"{desc}: {sum(map(len, streams))} tokens")
    if len(k5) != counts["flash_attention"] or \
            len(k6) != counts["rg_lru_scan"]:
        fail(f"{desc}: recorded {len(k5)} K5 / {len(k6)} K6 calls, "
             f"counted {counts}")
    return {"streams": streams, "counts": counts, "admit": admit,
            "k5_worst": check_k5_recorded(desc, k5) if k5 else 0.0,
            "k5_shapes": sorted({str(tuple(a["q"].shape)) for a, _ in k5}),
            "k6_shapes": sorted({str(c) for c in check_k6_recorded(desc,
                                                                   k6)})}


def serve_mesh_case(phase, case, rank, world, rules, dev, sync):
    """23(a)-(c) on this rank: an f32 case held to the unsharded engine
    (``serve_mesh_check``), the bf16 case timed (``serve_mesh_timed``)."""
    run = (serve_mesh_check if SERVE_MESH_CASES[case][2] == "float32"
           else serve_mesh_timed)
    return run(case, rank, rules, dev, sync)


def serve_mesh_check(case, rank, rules, dev, sync):
    """23(a) / (b) on this rank.  The unsharded engine first, on rank 0
    alone (the others wait), through ``checked_engine_run``; its greedy
    streams and launches sent to every rank.  Then the engine on this
    rank's slabs (``DecodeEngine(rules=)``), checked the same way: its
    streams equal the unsharded engine's, and its launches too."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import decode as D
    from repro_torch.tree import tree_leaves
    cfg, prompts, kw, n_mixer = _serve_mesh_setup(case, dev)
    max_new, seed = SERVE_MESH_CASES[case][6], SERVE_MESH_CASES[case][8]
    desc = f"23({case}) rank {rank}"
    one = [None]
    if rank == 0:
        one = [checked_engine_run(
            f"{desc}, the unsharded engine",
            D.DecodeEngine(_serve_params(cfg, seed, dev), cfg, **kw),
            prompts, max_new, n_mixer)]
        torch.cuda.empty_cache()
    dist.broadcast_object_list(one, src=0)
    ref = one[0]
    slab = _serve_params(cfg, seed, dev, rules)
    res = checked_engine_run(
        desc, D.DecodeEngine(slab, cfg, rules=rules, **kw), prompts,
        max_new, n_mixer)
    res["slab_bytes"] = sum(t.numel() * t.element_size()
                            for t in tree_leaves(slab))
    res["unsharded"] = ref if rank == 0 else None
    if res["streams"] != ref["streams"]:
        bad = [i for i, (a, b) in enumerate(zip(res["streams"],
                                                ref["streams"])) if a != b]
        fail(f"{desc}: the mesh engine's greedy streams differ from the "
             f"unsharded engine's in requests {bad}")
    if res["admit"] != ref["admit"] or res["counts"] != ref["counts"]:
        fail(f"{desc}: launches {res['counts']}, the unsharded engine's "
             f"{ref['counts']}")
    return res


def serve_mesh_timed(case, rank, rules, dev, sync):
    """23(c) on this rank.  A warm-up over the queue's first ``slots``
    requests, which hold every prompt length of the queue and so every
    K5 shape of the timed run, through ``checked_engine_run``: every K5
    launch held against plain.  Then the engine timed per admission and
    segment (sustained tok/s, ms a decode step against the byte bound of
    the rank's slab), one segment profiled (busy, idle share), peak
    memory."""
    import torch
    from repro_torch.core import decode as D
    from repro_torch.tree import tree_leaves
    cfg, prompts, kw, n_mixer = _serve_mesh_setup(case, dev)
    max_new, seed = SERVE_MESH_CASES[case][6], SERVE_MESH_CASES[case][8]
    slots = kw["slots"]
    desc = f"23({case}) rank {rank}"
    if {len(p) for p in prompts[:slots]} != {len(p) for p in prompts}:
        fail(f"{desc}: the warm-up lacks a prompt length of the queue")
    slab = _serve_params(cfg, seed, dev, rules)
    warm = checked_engine_run(
        f"{desc} warm-up", D.DecodeEngine(slab, cfg, rules=rules, **kw),
        prompts[:slots], 2, n_mixer)
    eng = D.DecodeEngine(slab, cfg, rules=rules, **kw)
    rec = timed_engine(eng)
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    streams = run_engine(eng, prompts, max_new)
    wall = time.perf_counter() - t0
    res = {"counts": _counted(), "streams": streams, "wall_s": wall,
           "peak": torch.cuda.max_memory_allocated(),
           "admit": _check_launch_pattern(desc, rec, n_mixer, len(prompts)),
           "admit_s": sum(t for t, _ in rec["admit"]),
           "segment_s": [t for t, _ in rec["segment"]],
           "prefill_tokens": eng.prefill_tokens, "unsharded": None,
           "slab_bytes": sum(t.numel() * t.element_size()
                             for t in tree_leaves(slab)),
           "warm": {k: warm[k] for k in ("counts", "k5_worst", "k5_shapes")}}
    if sum(map(len, streams)) != len(prompts) * max_new:
        fail(f"{desc}: {sum(map(len, streams))} tokens")
    del eng._admit_one, eng._decode_segment
    with torch.inference_mode():          # one segment, profiled
        for p in prompts[:slots]:
            eng.submit(p, max_new)
        eng._admit()
        sync()
        t0 = time.perf_counter()
        eng._decode_segment()
        sync()
        res["segment_wall_ms"] = 1e3 * (time.perf_counter() - t0)
        res["busy_ms"] = sum(r[0] for r in device_rows(
            eng._decode_segment)) / 1e3
    return res


def run_serve_mesh_phase(dev, card, unsharded_streams):
    """Phase 23: (a)-(c) as MESH_STEP_MP gloo rank processes on the card
    (``chip_smoke.py --mesh-step-rank R W DIR 23``), every rank's streams
    equal; (c)'s beside ``unsharded_streams`` (phase 13's qwen2-1.5b
    engine).  Its decode dry-run cells count in phase 22 (c).  Returns
    the K5 / K6 launches of the ranks' engine runs (rank 0's unsharded
    ones of (a) / (b) included, (c)'s warm-up not), summed."""
    t0 = time.perf_counter()
    outs, wall = run_rank_procs("--mesh-step-rank", MESH_STEP_MP,
                                [str(SERVE_PHASE)], MESH_STEP_TIMEOUT_S,
                                "MESH_STEP_RANK")
    for case in SERVE_MESH_CASES:
        if len({json.dumps(o[case]["streams"]) for o in outs}) != 1:
            fail(f"23({case}): the ranks' streams differ")
    log_serve_mesh(outs, card, unsharded_streams)
    log(23, f"on {card}: the ranks done in {wall:.1f} s (phase 23 took "
        f"{time.perf_counter() - t0:.1f} s)")
    runs = [r for o in outs for c in SERVE_MESH_CASES
            for r in (o[c], o[c]["unsharded"]) if r]
    return {k: sum(r["counts"][k] for r in runs) for k in SERVE_MESH_KERNELS}


def log_serve_mesh(outs, card, unsharded_streams):
    """Phase 23's lines: (a) / (b) per rank, and rank 0's unsharded
    engine; (c) per rank beside phase 13's unsharded streams."""
    from repro_torch.launch.serve import prompt_lengths

    def checked(s):
        return (f"launches {s['counts']}, K5 / K6 per admission "
                f"{s['admit'][0]}, none in decode segments; every K5 launch "
                f"recorded == plain within check_k5's tolerance (max |d| "
                f"{s['k5_worst']}) on q {s['k5_shapes']}, every K6 launch on "
                f"{s['k6_shapes']} == plain bit for bit")

    what = {"a": "qwen2-1.5b engine, f32, full width and depth",
            "b": "recurrentgemma-9b engine, f32, full width, 4 of 38 layers",
            "c": "qwen2-1.5b engine, bf16, full width and depth"}
    for case, (arch, _, dtype, slots, n_req, plen, max_new, seg, _) in \
            SERVE_MESH_CASES.items():
        head = (f"({case}) {what[case]} on (1, {MESH_STEP_MP}); {slots} "
                f"slots, {n_req} requests, prompts "
                f"{prompt_lengths(plen)}, "
                f"{max_new} new, segments of {seg}")
        for r, o in enumerate(outs):
            s = o[case]
            if dtype == "float32":
                if s["unsharded"]:
                    log(23, f"{head}: the unsharded engine on rank {r}: "
                        f"{checked(s['unsharded'])}")
                log(23, f"{head}: rank {r} at {o['coords']}: greedy streams "
                    f"== the unsharded engine's ({sum(map(len, s['streams']))}"
                    f" tokens) and every rank's; {checked(s)}; launches == "
                    f"the unsharded engine's; rank slab {s['slab_bytes']} B; "
                    f"{s['seconds']:.1f} s")
                continue
            total = sum(map(len, s["streams"]))
            decoded = total - n_req
            step_ms = statistics.median(1e3 * t / seg
                                        for t in s["segment_s"])
            bound, by = bound_ms(s["slab_bytes"], 0, "bfloat16")
            busy = s["busy_ms"]
            idle = (f"busy {busy:.3f} ms, idle share "
                    f"{1 - busy / s['segment_wall_ms']:.3f}" if busy > 0
                    else "busy not measured (the profiler saw no device "
                    "time)")
            same = sum(a == b[:max_new]
                       for a, b in zip(s["streams"], unsharded_streams))
            same8 = sum(a[:8] == b[:8]
                        for a, b in zip(s["streams"], unsharded_streams))
            w = s["warm"]
            log(23, f"{head}: rank {r} on {card}: warm-up ({slots} requests, "
                f"2 new) launches {w['counts']}, every K5 launch recorded == "
                f"plain within check_k5's tolerance (max |d| {w['k5_worst']})"
                f" on q {w['k5_shapes']}, the timed run's shapes; timed: "
                f"{total} tokens in wall_s {s['wall_s']} = sustained "
                f"{total / s['wall_s']} tok/s; prefill {n_req} admissions "
                f"{s['admit_s']} s = {s['prefill_tokens'] / s['admit_s']} "
                f"prompt tok/s; decode {sum(s['segment_s'])} s = "
                f"{decoded / sum(s['segment_s'])} tok/s; median ms per "
                f"decode step {step_ms} vs the rank slab's byte bound {bound}"
                f" ms ({s['slab_bytes']} B, {by}) ({step_ms / bound:.1f}x); "
                f"one profiled segment of {seg} steps, {slots} live slots: "
                f"wall {s['segment_wall_ms']} ms, {idle}; "
                f"max_memory_allocated {s['peak']}; launches {s['counts']} "
                f"({s['admit'][0]} per admission); streams equal to phase "
                f"13's unsharded first {max_new} tokens in {same} of {n_req} "
                f"requests, the first 8 in {same8} (bf16; not gated); "
                f"{s['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# phase 8: times
# ---------------------------------------------------------------------------

def abba(fa, fb):
    """Times of ``fa`` and ``fb`` measured in turns a, b, b, a: the mean
    of each pair, so a drift of the card's clock during the measurement
    touches both alike."""
    ta1, tb1, tb2, ta2 = (time_ms(f) for f in (fa, fb, fb, fa))
    return (ta1 + ta2) / 2, (tb1 + tb2) / 2


def misaligned(x):
    """A copy of ``x`` one element into a buffer: contiguous, but not
    16-byte aligned, so K2 / K4 take the CUDA-core loop for it."""
    import torch
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    out = buf[1:1 + x.numel()].view(x.shape)
    out.copy_(x)
    return out


def expect_route(what, fn, key, want):
    """Run ``fn`` once and check that it added ``want`` to the route
    counter ``key``."""
    from repro_torch.kernels import zo_matmul as ZM
    n0 = ZM.LAUNCHES[key]
    fn()
    if ZM.LAUNCHES[key] - n0 != want:
        fail(f"{what}: expected {want} launch(es) counted under {key}, "
             f"counters {ZM.LAUNCHES}")


def host_us(fn, n=400):
    """Host time of one call of ``fn`` in us, enqueue only (no sync inside
    the loop): the median of three runs of ``n`` calls."""
    import torch
    out = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out.append(1e6 * (time.perf_counter() - t0) / n)
        torch.cuda.synchronize()
    return statistics.median(out)


def _demangle(names):
    import shutil
    if not names or shutil.which("c++filt") is None:
        return dict(zip(names, names))
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True, timeout=60)
    return dict(zip(names, out.stdout.splitlines()))


def compiler_report():
    """Registers, static shared memory and spills of every kernel, from
    the compiler's report in ``_build/<library>.log`` (``-Xptxas=-v``)."""
    import re
    from repro_torch.kernels import build
    rows, serialized = [], {}
    for lib in build.SIGNATURES:
        cur = None
        for line in (build.BUILD_DIR / f"{lib}.log").read_text(
                errors="replace").splitlines():
            m = re.search(r"(C75\d\d).*serialized.*function '([^']+)'",
                          line)
            if m:
                serialized[m.group(2)] = m.group(1)
                continue
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                cur = {"lib": lib, "fn": m.group(1)}
                rows.append(cur)
            elif cur is not None:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if m:
                    cur["spills"] = int(m.group(1)) + int(m.group(2))
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    cur["regs"] = int(m.group(1))
                    sm = re.search(r"(\d+) bytes smem", line)
                    cur["smem"] = int(sm.group(1)) if sm else 0
    names = _demangle([r["fn"] for r in rows])
    for r in rows:
        dyn = (" (+ the dynamic ring of zo_wgmma_matmul.cuh)"
               if "zo_wgmma" in r["fn"] else
               " (+ the dynamic ring of zo_tf32_matmul.cuh)"
               if "zo_tf32_kernel" in r["fn"] else
               " (+ the dynamic Q tiles and ring of flash_wgmma.cuh)"
               if "fa_wgmma" in r["fn"] else "")
        ser = (f"; ptxas serializes its wgmmas ({serialized[r['fn']]})"
               if r["fn"] in serialized else "")
        log(8, f"{r['lib']}: {names[r['fn']]}: {r.get('regs')} registers, "
            f"{r.get('smem')} bytes static shared memory{dyn}, "
            f"{r.get('spills')} bytes spilled (stores + loads){ser}")
    return rows


def check_hgmma():
    """The tensor-core kernels of K2, K4 (bf16 and f32), K3 and K5 hold
    HGMMA (wgmma) instructions in their SASS (cuobjdump -sass of the
    built library)."""
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log(8, "HGMMA: cuobjdump not found (not checked)")
        return
    for lib, tags in (("zo_dual_matmul", ("zo_wgmma_kernel",
                                          "zo_tf32_kernel")),
                      ("zo_matmul", ("zo_wgmma_kernel", "zo_tf32_kernel")),
                      ("zo_dual_flash_attention", ("fa_wgmma",)),
                      ("flash_attention", ("fa_wgmma",))):
        sass = subprocess.run([tool, "-sass", str(build._lib_path(lib))],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        per_fn, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[-1].strip()
                per_fn[fn] = 0
            elif fn is not None and "HGMMA" in line:
                per_fn[fn] += 1
        names = _demangle(list(per_fn))
        tc = {names[f]: n for f, n in per_fn.items()
              if any(t in f for t in tags)}
        if not tc or min(tc.values()) == 0:
            fail(f"{lib}: no HGMMA in the tensor-core kernels' SASS: {tc}")
        loop = sum(n for f, n in per_fn.items()
                   if not any(t in f for t in tags))
        log(8, f"{lib} SASS: HGMMA instructions per tensor-core kernel "
            f"{tc}; in the CUDA-core loop's kernels {loop}")


# (name, B, S, H, Kv, D, kwargs) of phase 8's attention times: the main
# path's shape, qwen2-1.5b's heads and recurrentgemma-9b's heads (its
# 2048-wide local window cut to 512 so the window bites at S = 1024), and
# phase 13's admissions of a 512-token prompt on each
TIME_ATTN = [("gpt2-small", 4, 256, 12, 12, 64, {}),
             ("qwen2-1.5b heads", 2, 512, 12, 2, 128, {}),
             ("recurrentgemma-9b heads window 512", 1, 1024, 16, 1, 256,
              dict(window=512)),
             ("qwen2-1.5b serving prefill", 1, 512, 12, 2, 128, {}),
             ("recurrentgemma-9b serving prefill window 2048", 1, 512, 16,
              1, 256, dict(window=2048))]


def attn_pairs(S, window=0):
    """The (q, kv) pairs a causal call over S positions scores, within
    ``window`` of the diagonal if it is set: the work this data needs."""
    q = np.arange(S)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(S, int)
    return int((q + 1 - lo).sum())


def time_attention(dev, counts, counts_sp, errs):
    """K3 (weights and scores mode) and K5 in bf16 at TIME_ATTN's shapes:
    the tensor-core route, the CUDA-core loop beside it (an input one
    element into a buffer), the plain version,
    PyTorch's SDPA and the bound.  Returns the kernel-table rows of K3 and
    K5 at the main path's shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import noise as N
    from repro_torch.kernels import ref as R
    out = {}
    for name, B, S, H, Kv, D, kw in TIME_ATTN:
        qa, qb, k, v, kb, vb = k3_inputs(dev, torch.bfloat16, B, S, H, Kv, D)
        qm = misaligned(qa)
        window = kw.get("window", 0)
        q_bytes, kv_bytes = 2 * B * S * H * D, 2 * B * S * Kv * D
        ops = 4 * D * attn_pairs(S, window) * B * H   # QK^T and PV, a stream
        pos = torch.arange(S, device=dev)
        allowed = pos[:, None] >= pos[None, :]
        if window:
            allowed &= (pos[:, None] - pos[None, :]) < window
        t = [x.transpose(1, 2).contiguous() for x in (qa, qb, k, v, kb, vb)]
        gqa = Kv != H

        def sdpa(q_, k_, v_, mask=None):
            if mask is None and not window:
                return F.scaled_dot_product_attention(q_, k_, v_,
                                                      is_causal=True,
                                                      enable_gqa=gqa)
            return F.scaled_dot_product_attention(
                q_, k_, v_, attn_mask=allowed if mask is None else mask,
                enable_gqa=gqa)

        u = N.uniform_noise(9, (H * S, S), device=dev).reshape(H, S, S)
        fmask = (1e-3 * u + torch.where(allowed, 0.0, float("-inf"))
                 ).to(torch.bfloat16)[None]
        cases = (
            ("K3 weights", "zo_dual_flash_attention_tc",
             lambda x: FA.zo_dual_flash_attention(x, qb, k, v, kb=kb, vb=vb,
                                                  perturb_b=False, **kw),
             lambda: R.zo_dual_flash_attention_ref(
                 qa, qb, k, v, kb=kb, vb=vb, perturb_b=False, **kw),
             lambda: (sdpa(t[0], t[2], t[3]), sdpa(t[1], t[4], t[5])),
             "two SDPA calls", 4 * q_bytes + 4 * kv_bytes, 2 * ops),
            ("K3 scores", "zo_dual_flash_attention_tc",
             lambda x: FA.zo_dual_flash_attention(x, qb, k, v, seed=9,
                                                  mu_b=1e-3, **kw),
             lambda: R.zo_dual_flash_attention_ref(
                 qa, qb, k, v, mu_b=1e-3, **kw, u=N.uniform_noise(
                     9, (H * S, S), device=dev).reshape(H, S, S)),
             lambda: (sdpa(t[0], t[2], t[3]), sdpa(t[1], t[2], t[3], fmask)),
             "two SDPA calls, the second with a float attn_mask mu*U + the "
             "mask's -inf, U materialised", 4 * q_bytes + 2 * kv_bytes,
             2 * ops),
            ("K5", "flash_attention_tc",
             lambda x: FA.flash_attention(x, k, v, **kw),
             lambda: R.flash_attention_ref(qa, k, v, **kw),
             lambda: sdpa(t[0], t[2], t[3]), "one SDPA call",
             2 * q_bytes + 2 * kv_bytes, ops))
        for what, key, fn, plain, lib, lib_desc, n_bytes, n_ops in cases:
            before = dict(FA.LAUNCHES)
            fn(qa)
            expect_fa_route(f"{what} {name}", before, key, 1)
            ms = time_ms(lambda: fn(qa))
            before = dict(FA.LAUNCHES)
            fn(qm)
            expect_fa_route(f"{what} {name} (loop)", before, key, 0)
            loop = time_ms(lambda: fn(qm))
            pl = time_ms(plain, reps=10)
            lb = time_ms(lib)
            b, by = bound_ms(n_bytes, n_ops, "bfloat16")
            log(8, f"{what} bf16 {name} (B{B} S{S} H{H} Kv{Kv} D{D}"
                f"{' window ' + str(window) if window else ''}): kernel_ms "
                f"{ms} (tensor cores) loop_ms {loop} (CUDA-core loop) "
                f"plain_ms {pl} library_ms {lb} ({lib_desc}) bound_ms {b} "
                f"({by})")
            out[(what, name)] = (ms, pl, lb, b, by)
        if name == TIME_ATTN[0][0]:
            fused, split = abba(
                lambda: FA.zo_dual_flash_attention(qa, qb, k, v, kb=kb,
                                                   vb=vb, perturb_b=False),
                lambda: (FA.flash_attention(qa, k, v),
                         FA.flash_attention(qb, kb, vb)))
            log(8, f"fused vs split, bf16 {name} weights mode (tensor "
                f"cores): K3 {fused} ms, 2 x K5 {split} ms: split / fused "
                f"{split / fused}")
            # how K5's time grows with the kv tiles of its longest block,
            # beside the card's floor for one launch
            by_len = []
            for s2 in (64, 256, 1024):
                q2, _, k2, v2, _, _ = k3_inputs(dev, torch.bfloat16, B, s2,
                                                H, Kv, D)
                t2 = time_ms(lambda: FA.flash_attention(q2, k2, v2))
                by_len.append(f"S={s2} {t2} ms")
            one = torch.zeros(1, device=dev)
            log(8, f"K5 bf16 B{B} H{H} D{D} causal by length (1, 4 and 16 kv "
                f"tiles in the longest block): {', '.join(by_len)}; one "
                f"1-element add_ (the launch floor) "
                f"{time_ms(lambda: one.add_(1.0))} ms")
        del qa, qb, k, v, kb, vb, qm, t, u, fmask
    main = TIME_ATTN[0][0]
    ms, pl, lb, b, by = out[("K3 weights", main)]
    k3 = {"name": "zo_dual_flash_attention", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/zo_dual_flash_attention.cu",
          "replaces": "src/repro/kernels/flash_attention.py:296",
          "launches": counts["zo_dual_flash_attention"],
          "max_abs_err": errs[2], "ms": ms, "plain_ms": pl, "bound_ms": b,
          "bound_by": by, "library_ms": lb}
    ms, pl, lb, b, by = out[("K5", main)]
    k5 = {"name": "flash_attention", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
          "replaces": "src/repro/kernels/flash_attention.py:115",
          "launches": counts_sp["flash_attention"], "max_abs_err": errs[4],
          "ms": ms, "plain_ms": pl, "bound_ms": b, "bound_by": by,
          "library_ms": lb}
    return k3, k5


def k1_ops(mode, bf16=False):
    """K1's instructions per element by class (the SASS counts of
    K1_SASS_PER_ELEMENT, plus the epilogue: accumulate and perturb a
    multiply and an add in f32; a bf16 perturb one integer op to widen p
    and half a conversion to pack two outputs)."""
    ops = dict(K1_SASS_PER_ELEMENT)
    if mode != "field":
        ops["fp32"] += 2
    if bf16:
        ops["integer"] += 1
        ops["conversion"] += 0.5
    ops["issue"] = sum(ops.values())
    return ops


def k1_bound(n_bytes, n_elems, mode, bf16=False):
    """K1's least time: the larger of the bytes over the memory rate and,
    for each instruction class, its instructions over its rate on every
    SM at the card's top SM clock.  Returns (ms, what bounds it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    ops = k1_ops(mode, bf16)
    sms, hz = CARD["sms"], CARD["sm_clock_hz"]
    t_ops, pipe = max((n_elems * ops[p] / (rate * sms * hz), p)
                      for p, rate in PIPE_RATES.items())
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, f"operations ({pipe})"


def time_k1_trees(dev):
    """K1 over whole client trees, one launch per tree, beside the
    composition it replaces (a K1 field launch per leaf, then the tensor
    code of the mode: ``s * u`` and ``a + .``; ``p.float()``, ``mu * u``,
    the add and ``.to(dtype)``), the plain version and the bound; and one
    leaf of each."""
    import torch
    from repro_torch.configs.gpt2 import gpt2_small
    from repro_torch.kernels import ops as O
    from repro_torch.kernels import zo_matmul as ZM
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves

    def old_field(segs):
        return [ZM.zo_noise(g.seed, (g.rows, g.cols), g.row_offset,
                            device=dev) for g in segs]

    def old_acc(acc, segs, sc):
        return [a + sc * u.reshape(-1) for a, u in zip(acc,
                                                       old_field(segs))]

    def old_perturb(leaves, segs, mu):
        return [(p.to(torch.float32) + float(mu) * u.view(p.shape)).to(
            p.dtype) for p, u in zip(leaves, old_field(segs))]

    def plain(mode, leaves, segs, acc, sc, mu):
        out = []
        for i, g in enumerate(segs):
            u = k1_plain(g, 0, g.rows, dev)
            out.append(u if mode == "field" else
                       acc[i] + sc * u.reshape(-1) if mode == "accumulate"
                       else (leaves[i].to(torch.float32) + float(mu) *
                             u.view(leaves[i].shape)).to(leaves[i].dtype))
        return out

    for tname, cfg_fn in (("gpt2-small", gpt2_small),
                          ("recurrentgemma-9b", rg_round_config)):
        client = T.init_lm(cfg_fn(), seed=0, device=dev,
                           draw_on_device=True)["client"]
        leaves = tree_leaves(client)
        seeds = tree_leaves(O.leaf_seed_tree(client, 7))
        segs = [O.leaf_segment(s, p.shape) for p, s in zip(leaves, seeds)]
        n = sum(p.numel() for p in leaves)
        bf16 = leaves[0].dtype == torch.bfloat16
        sc = torch.tensor([0.0, 1e-3], device=dev)[1]
        big = n > 1e9                 # plain's int64 temporaries: skip
        acc = [torch.zeros(p.numel(), device=dev) for p in leaves]
        outs = [torch.empty(p.numel(), device=dev) for p in leaves]
        pouts = [torch.empty_like(p).reshape(-1) for p in leaves]
        pins = [p.reshape(-1) for p in leaves]
        p_bytes = sum(2 * p.numel() * p.element_size() for p in leaves)
        modes = (
            ("field", lambda: ZM.zo_noise_tree("field", segs, outs),
             lambda: old_field(segs), 4 * n, False),
            ("accumulate",
             lambda: ZM.zo_noise_tree("accumulate", segs, acc, scale=sc),
             lambda: old_acc(acc, segs, sc), 8 * n, False),
            ("perturb",
             lambda: ZM.zo_noise_tree("perturb", segs, pouts, pins,
                                      mu=1e-3),
             lambda: old_perturb(leaves, segs, 1e-3), p_bytes, bf16))
        for mode, tree_fn, old_fn, nb, mb in modes:
            if big and mode != "accumulate":
                continue
            n0 = ZM.LAUNCHES["zo_noise"]
            tree_fn()
            launches = ZM.LAUNCHES["zo_noise"] - n0
            t_old, t_tree = abba(old_fn, tree_fn)
            pl = ("not timed (int64 temporaries of the whole tree)" if big
                  else time_ms(lambda: plain(mode, leaves, segs, acc, sc,
                                             1e-3), reps=5))
            b, by = k1_bound(nb, n, mode, mb)
            log(8, f"K1 {mode} over the {tname} client tree ({len(segs)} "
                f"leaves, {n} entries{', bf16' if mb else ''}): tree_ms "
                f"{t_tree} ({launches} launch) vs per-leaf composition "
                f"{t_old} ms ({len(segs)} K1 launches + the tensor code): "
                f"old / tree {t_old / t_tree}; plain_ms {pl} bound_ms {b} "
                f"({by})")
        if tname == "gpt2-small":
            # the largest leaf after the tied table: a stacked MLP weight
            i = sorted(range(len(segs)),
                       key=lambda k: segs[k].rows * segs[k].cols)[-2]
            g, a1 = segs[i], acc[i]
            t_old, t_leaf = abba(
                lambda: old_acc([a1], [g], sc),
                lambda: ZM.zo_noise_tree("accumulate", [g], [a1], scale=sc))
            b, by = k1_bound(8 * a1.numel(), a1.numel(), "accumulate")
            log(8, f"K1 accumulate over one {g.rows}x{g.cols} leaf: "
                f"leaf_ms {t_leaf} vs K1 field + s*u + a+. {t_old} ms: old "
                f"/ new {t_old / t_leaf}; bound_ms {b} ({by})")
        del client, leaves, acc, outs, pouts, pins
        torch.cuda.empty_cache()


def k1_sass():
    """The opcode histogram of each K1 kernel's SASS (cuobjdump -sass of
    the built library): the instruction classes K1_SASS_PER_ELEMENT is
    read from."""
    import collections
    import re
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log(8, "K1 SASS: cuobjdump not found (not read)")
        return
    sass = subprocess.run([tool, "-sass", str(build._lib_path("zo_noise"))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    per_fn, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[-1].strip()
            per_fn[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                     line)
        if fn is not None and m:
            per_fn[fn][m.group(1)] += 1
    names = _demangle(list(per_fn))
    for f, hist in per_fn.items():
        top = ", ".join(f"{k} {v}" for k, v in hist.most_common())
        log(8, f"K1 SASS {names[f]}: {sum(hist.values())} instructions: "
            f"{top}")


def time_kernels(dev, counts, counts_sp, counts_rg, errs, counts_serve,
                 counts_train, counts_family, counts_modality, counts_mesh,
                 counts_tools):
    """``counts``: launches of the gpt2-small round (K1-K3);
    ``counts_sp``: of the gpt2-small single-probe forward (K4, K5);
    ``counts_rg``: of the recurrentgemma round (K6); ``counts_serve``: of
    phase 13's two full-width engine runs (K5, K6), added to K5's and
    K6's (phase 23's engines on the mesh added to them);
    ``counts_train``: of phase 14's two full-width train steps
    (K1-K3), added to K1's, K2's and K3's; ``counts_family``: of phase
    15's two full-width rounds (K1) and its MoE engine run (K5), added
    to K1's and K5's; ``counts_modality``: of phase 16's two full-width
    rounds (K1-K3) and its qwen2-vl engine run (K5); ``counts_mesh``: of
    phase 17's one-rank sharded replay (K1) and sharded round (K1-K3),
    phase 18's mesh steps on every rank (K1-K3), phase 19's MoE mesh
    steps on every rank (K1), phase 20's recurrent mesh steps on every
    rank (K1, K6), added to K6's, and phase 21's vlm and enc-dec mesh
    steps on every rank (K1-K3); ``counts_tools``: of phase 22's timed
    and counted steps (K1-K3) and its one K4, K5 and K6 launch."""
    import torch
    from repro_torch.kernels import noise as N
    from repro_torch.kernels import ops as O
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import zo_matmul as ZM
    rows = []

    # K1: the tied-table field (the largest U a round draws), a weight
    # leaf's field, the gathered embedding rows, and whole trees
    k1 = []
    for rr, cc in ((50432, 768), (768, 3072)):
        ms = time_ms(lambda: ZM.zo_noise(5, (rr, cc), device=dev))
        pl = time_ms(lambda: N.uniform_noise(5, (rr, cc), device=dev))
        b, by = k1_bound(4 * rr * cc, rr * cc, "field")
        k1.append((f"field {rr}x{cc}", ms, pl, b, by))
    ids = torch.randint(0, 50257, (8, 256), device=dev)
    cols = torch.arange(768, device=dev)
    ms = time_ms(lambda: ZM.zo_noise_rows(5, ids, 768))
    pl = time_ms(lambda: N.uniform_noise_at(5, ids[..., None], cols))
    b, by = k1_bound(4 * ids.numel() * (768 + 1), ids.numel() * 768,
                     "field")
    k1.append(("rows 2048x768", ms, pl, b, by))
    for name, ms, pl, b, by in k1:
        log(8, f"K1 {name}: kernel_ms {ms} plain_ms {pl} bound_ms {b} "
            f"({by})")
    time_k1_trees(dev)
    _, ms, pl, b, by = k1[0]
    rows.append({"name": "zo_noise", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/zo_noise.cu",
                 "replaces": "src/repro/kernels/zo_matmul.py:274",
                 "launches": counts["zo_noise"] + counts_train["zo_noise"]
                 + counts_family["zo_noise"] + counts_modality["zo_noise"]
                 + counts_mesh["zo_noise"] + counts_tools.get("zo_noise", 0),
                 "max_abs_err": errs[0],
                 "ms": ms, "plain_ms": pl, "bound_ms": b,
                 "bound_by": by.split(" ")[0], "library_ms": None})

    # K2 at the client shapes, bf16 (the config's compute type), on the
    # tensor-core route and on the CUDA-core loop (x one element into a
    # buffer, not 16-byte aligned, so the wrapper takes the loop)
    k2_rows = []
    for K, Nn in K2_SHAPES:
        xa, xb, w = k2_inputs(dev, torch.bfloat16, 1024, K, Nn)
        xm = misaligned(xa)
        tc = lambda: ZM.zo_dual_matmul(xa, xb, w, 3, 0.0, 1e-3)  # noqa
        loop = lambda: ZM.zo_dual_matmul(xm, xb, w, 3, 0.0, 1e-3)  # noqa
        expect_route("K2", tc, "zo_dual_matmul_tc", 1)
        expect_route("K2", loop, "zo_dual_matmul_tc", 0)
        ms, loop_ms = time_ms(tc), time_ms(loop)
        pl = time_ms(lambda: k2_plain(xa, xb, w, 3, 0.0, 1e-3, False, True,
                                      0))
        wa = w
        wb = (w.float() + 1e-3 * N.uniform_noise(
            3, w.shape, device=dev)).to(torch.bfloat16)
        lib = time_ms(lambda: (torch.matmul(xa, wa), torch.matmul(xb, wb)))
        n_bytes = 2 * (2 * 1024 * K + K * Nn + 2 * 1024 * Nn)
        b, by = bound_ms(n_bytes, 2 * 2 * 1024 * K * Nn, "bfloat16")
        log(8, f"K2 bf16 M=1024 {K}x{Nn}: kernel_ms {ms} (tensor cores) "
            f"loop_ms {loop_ms} (CUDA-core loop) plain_ms {pl} library_ms "
            f"{lib} (two bf16 torch.matmul on materialised W, W+mu*U) "
            f"bound_ms {b} ({by})")
        k2_rows.append((K, Nn, ms, pl, lib, b, by))
        if (K, Nn) == K2_SHAPES[0]:
            # 16 rows, so the card keeps up with the host on both routes
            xs, xsm = xa[:16], misaligned(xa[:16])
            h_tc = host_us(lambda: ZM.zo_dual_matmul(xs, xs, w, 3, 0.0,
                                                     1e-3))
            h_loop = host_us(lambda: ZM.zo_dual_matmul(xsm, xs, w, 3, 0.0,
                                                       1e-3))
            log(8, f"K2 host time per launch (wrapper, no sync), bf16 M=16 "
                f"{K}x{Nn}: tensor-core route {h_tc} us (encodes 3 TMA maps) "
                f"vs CUDA-core loop {h_loop} us: difference {h_tc - h_loop} "
                f"us")
    _, _, ms, pl, lib, b, by = k2_rows[1]            # 768 x 3072 (up)
    rows.append({"name": "zo_dual_matmul", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/zo_dual_matmul.cu",
                 "replaces": "src/repro/kernels/zo_matmul.py:227",
                 "launches": counts["zo_dual_matmul"]
                 + counts_train["zo_dual_matmul"]
                 + counts_modality["zo_dual_matmul"]
                 + counts_mesh["zo_dual_matmul"]
                 + counts_tools.get("zo_dual_matmul", 0),
                 "max_abs_err": errs[1],
                 "ms": ms, "plain_ms": pl, "bound_ms": b, "bound_by": by,
                 "library_ms": lib})

    # K3 and K5 (phase 8's attention rows, the main path's first)
    k3_row, k5_row = time_attention(dev, counts, counts_sp, errs)
    k5_row["launches"] += (counts_serve["flash_attention"]
                           + counts_family["flash_attention"]
                           + counts_modality["flash_attention"]
                           + counts_tools.get("flash_attention", 0))
    k3_row["launches"] += (counts_train["zo_dual_flash_attention"]
                           + counts_modality["zo_dual_flash_attention"]
                           + counts_mesh["zo_dual_flash_attention"]
                           + counts_tools.get("zo_dual_flash_attention", 0))
    rows.append(k3_row)

    # K4: gpt2-small's three client shapes in bf16 (768x3072 is the main
    # path's row) and ResNet-18's block conv over im2col patches in f32
    # (3xTF32), each on the tensor-core route and on the CUDA-core loop
    k4 = []
    for name, dtype, M, K, Nn in k4_cases()[:3] + [k4_cases()[4]]:
        _, x, w = k2_inputs(dev, dtype, M, K, Nn)
        xm = misaligned(x)
        expect_route("K4", lambda: ZM.zo_matmul(x, w, 3, 1e-3),
                     "zo_matmul_tc", 1)
        expect_route("K4", lambda: ZM.zo_matmul(xm, w, 3, 1e-3),
                     "zo_matmul_tc", 0)
        ms = time_ms(lambda: ZM.zo_matmul(x, w, 3, 1e-3))
        loop = (f" (tensor cores) loop_ms "
                f"{time_ms(lambda: ZM.zo_matmul(xm, w, 3, 1e-3))} "
                f"(CUDA-core loop)")
        pl = time_ms(lambda: k4_plain(x, w, 3, 1e-3, True, 0))
        wp = (w.float() + 1e-3 * N.uniform_noise(3, w.shape, device=dev)
              ).to(dtype)
        lib = time_ms(lambda: torch.matmul(x, wp))
        dn = str(dtype).split(".")[-1]
        f32 = dtype == torch.float32        # three tf32 products
        b, by = bound_ms(x.element_size() * (M * K + K * Nn + M * Nn),
                         (3 if f32 else 1) * 2 * M * K * Nn,
                         "tf32" if f32 else dn)
        log(8, f"K4 {dn} {name} M={M}: kernel_ms {ms}{loop} plain_ms {pl} "
            f"library_ms {lib} (one {dn} torch.matmul on materialised "
            f"W+mu*U) bound_ms {b} ({by})")
        k4.append((ms, pl, lib, b, by))
    ms, pl, lib, b, by = k4[1]
    rows.append({"name": "zo_matmul", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/zo_matmul.cu",
                 "replaces": "src/repro/kernels/zo_matmul.py:145",
                 "launches": counts_sp["zo_matmul"]
                 + counts_tools.get("zo_matmul", 0), "max_abs_err": errs[3],
                 "ms": ms, "plain_ms": pl, "bound_ms": b, "bound_by": by,
                 "library_ms": lib})

    rows.append(k5_row)

    # K6 forward and reverse at the RG-LRU round's shapes; bytes: a, b
    # read and h written (12 B per element) forward, a, g, h read and da,
    # db written (20 B) reverse; 2 and 3 f32 operations per element
    from repro_torch.kernels import rg_lru as RG
    k6 = {}
    for shape in K6_SHAPES:
        a, b, g = k6_inputs(dev, *shape)
        h = RG.rg_lru_scan(a, b)
        n = int(np.prod(shape))
        for mode, fn, plain, nb, no in (
                ("forward", lambda: RG.rg_lru_scan(a, b),
                 lambda: R.rg_lru_scan_ref(a, b), 12, 2),
                ("reverse", lambda: RG.rg_lru_scan_reverse(a, g, h),
                 lambda: R.rg_lru_scan_reverse_ref(a, g, h), 20, 3)):
            ms = time_ms(fn)
            pl = time_ms(plain, reps=5)     # S small launches per call
            bd, by = bound_ms(nb * n, no * n, "float32")
            log(8, f"K6 {mode} f32 {shape}: kernel_ms {ms} plain_ms "
                f"{pl} bound_ms {bd} ({by}); library none")
            k6[(shape, mode)] = (ms, pl, bd, by)
        del a, b, g, h
    ms, pl, bd, by = k6[(K6_SHAPES[0], "forward")]
    rows.append({"name": "rg_lru_scan", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/rg_lru_scan.cu",
                 "replaces": "src/repro/kernels/rg_lru.py:50",
                 "launches": counts_rg["rg_lru_scan"]
                 + counts_serve["rg_lru_scan"]
                 + counts_mesh["rg_lru_scan"]
                 + counts_tools.get("rg_lru_scan", 0), "max_abs_err": errs[5],
                 "ms": ms, "plain_ms": pl, "bound_ms": bd, "bound_by": by,
                 "library_ms": None})

    # the fused dual probe against two single-probe passes
    _, x, w = k2_inputs(dev, torch.bfloat16, 1024, 768, 3072)
    fused, split = abba(lambda: O.zo_dual_forward(x, w, 3, 1e-3),
                        lambda: O.zo_dual_forward_split(x, w, 3, 1e-3))
    log(8, f"fused vs split, bf16 M=1024 768x3072: K2 zo_dual_forward "
        f"{fused} ms, zo_dual_forward_split (2 x K4) {split} ms: split / "
        f"fused {split / fused}")
    return rows


def main():
    import torch
    if sys.argv[1:2] == ["--mesh-rank"]:          # a rank of phase 17
        return mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if sys.argv[1:2] == ["--train-mesh-rank"]:    # a rank of phase 18
        return train_mesh_rank(int(sys.argv[2]), int(sys.argv[3]),
                               sys.argv[4], sys.argv[5])
    if sys.argv[1:2] == ["--moe-ep-rank"]:        # a rank of phase 19
        return moe_ep_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if sys.argv[1:2] == ["--mesh-step-rank"]:     # phase 20's, 21's or 23's
        return mesh_step_rank(int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4], sys.argv[5])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    CARD["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    CARD["sm_clock_hz"] = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    log(1, f"card {card}; {CARD['sms']} SMs, top SM clock "
        f"{CARD['sm_clock_hz'] / 1e6:.0f} MHz; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    secs = build.build_all()
    log(1, f"built kernels in {secs:.1f} s (registers, shared memory and "
        f"spills per kernel in phase 8)")
    dryruns = start_dryruns()         # phase 22 (c), on the host's cores

    start = [time.perf_counter()]

    def took(phases):
        now = time.perf_counter()
        log(1, f"(phases {phases} took {now - start[0]:.1f} s)")
        start[0] = now

    k1_round = check_k1(dev, card)
    errs = (0.0, check_k2(dev), check_k3(dev), check_k4(dev), check_k5(dev))
    took("2-4")
    counts = run_round(dev, k1_round)
    counts_cnn = run_cnn_round(dev)
    check_small_rounds()
    took("5-6")
    counts_sp = check_single_probe(dev)
    errs += (check_k6(dev),)
    took("7, 9")
    counts_rg = run_rg_round(dev, card)
    torch.cuda.empty_cache()
    check_rg_small_round()
    took("10")
    run_fo_phase(dev, card, {k: counts_cnn[k] for k in (
        "zo_dual_matmul", "zo_dual_matmul_tc")})
    took("11")
    run_threefry_phase(dev, card)
    took("12")
    counts_serve, qwen_streams = run_serve_phase(dev, card)
    torch.cuda.empty_cache()
    took("13")
    counts_train = run_train_phase(dev, card)
    torch.cuda.empty_cache()
    took("14")
    counts_family = run_family_phase(dev, card)
    torch.cuda.empty_cache()
    took("15")
    counts_modality = run_modality_phase(dev, card)
    torch.cuda.empty_cache()
    took("16")
    counts_mesh = run_mesh_phase(dev, card)
    torch.cuda.empty_cache()
    took("17")
    counts_train_mesh = run_train_mesh_phase(dev, card)
    torch.cuda.empty_cache()
    took("18")
    counts_moe_ep = run_moe_ep_phase(dev, card)
    torch.cuda.empty_cache()
    took("19")
    counts_rec_mesh = run_rec_mesh_phase(dev, card)
    torch.cuda.empty_cache()
    took("20")
    counts_mod_mesh = run_mod_mesh_phase(dev, card)
    torch.cuda.empty_cache()
    took("21")
    counts_tools = run_dryrun_phase(dev, card, dryruns)
    torch.cuda.empty_cache()
    took("22")
    counts_serve_mesh = run_serve_mesh_phase(dev, card, qwen_streams)
    counts_serve = {k: counts_serve[k] + counts_serve_mesh[k]
                    for k in counts_serve}
    took("23")
    mesh_phases = (counts_mesh, counts_train_mesh, counts_moe_ep,
                   counts_rec_mesh, counts_mod_mesh)
    rows = time_kernels(dev, counts, counts_sp, counts_rg, errs,
                        counts_serve, counts_train, counts_family,
                        counts_modality, {
                            k: sum(c.get(k, 0) for c in mesh_phases)
                            for k in set().union(*mesh_phases)},
                        counts_tools)
    compiler_report()
    check_hgmma()
    k1_sass()
    took("8")

    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
