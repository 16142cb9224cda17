"""Serving driver of the port: :class:`repro_torch.core.decode.DecodeEngine`
over a queue of mixed-length requests (prompts of 1/2, 3/4 and 1 times
``--prompt-len``), as :mod:`repro.launch.serve` drives the JAX engine.
Prints the sustained tok/s, the segment count and the prefill tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --device cuda --batch 8 --prompt-len 512 --max-new 128 \\
        --requests 24

``--smoke`` takes the arch's CPU-sized config; ``--device cpu`` runs the
kernels' plain versions.  The weights are random, from ``--seed``: on the
card drawn by the card's generator (seconds for billions of params), on
the CPU by the CPU's.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core import decode as D
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


def build_sampler(args) -> D.SamplerConfig:
    return D.SamplerConfig(greedy=not args.sample,
                           temperature=args.temperature,
                           top_k=args.top_k, top_p=args.top_p)


def prompt_lengths(prompt_len: int):
    """The queue's prompt lengths, cycled: 1/2, 3/4 and 1 of
    ``prompt_len``."""
    return [max(1, prompt_len * f // 4) for f in (2, 3, 4)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots (concurrent requests)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", "--gen", dest="max_new", type=int,
                    default=16, help="per-request token budget")
    ap.add_argument("--requests", type=int, default=0,
                    help="queue length (0 = one wave of --batch)")
    ap.add_argument("--segment", type=int, default=16,
                    help="decode steps per segment")
    ap.add_argument("--sample", action="store_true",
                    help="sample instead of greedy argmax")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="stop a request when it emits this token")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    params = T.init_lm(cfg, seed=args.seed, device=dev,
                       draw_on_device=dev.type == "cuda")
    n_req = args.requests or args.batch
    rng = np.random.default_rng(args.seed)
    lengths = prompt_lengths(args.prompt_len)
    engine = D.DecodeEngine(
        params, cfg, slots=args.batch,
        capacity=args.prompt_len + args.max_new, segment_len=args.segment,
        sampler=build_sampler(args), eos_id=args.eos_id, seed=args.seed,
        device=dev)
    prompts = {}
    for i in range(n_req):
        prompt = rng.integers(0, cfg.vocab, size=lengths[i % len(lengths)])
        prompts[engine.submit(prompt, args.max_new)] = prompt

    t0 = time.perf_counter()
    out = engine.run()
    wall = time.perf_counter() - t0      # run() ends reading the device
    total_new = sum(len(t) for t in out.values())
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"[serve] {cfg.name} on {where}: {len(out)} requests, "
          f"{total_new} tokens in {wall:.2f}s, sustained "
          f"{total_new / max(wall, 1e-9):.1f} tok/s ({engine.segments} "
          f"segments of {args.segment}, prefill {engine.prefill_tokens} "
          f"tok)")
    rid0 = min(out)
    print(f"request {rid0} ({len(prompts[rid0])}-tok prompt):",
          list(out[rid0])[:24])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
