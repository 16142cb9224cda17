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

The enc-dec (seamless-m4t-medium) keeps the reference's cross-attended
token loop (:func:`enc_dec_stream`): the prompt consumed token by token,
then one decoder token a step through the shared sampler, with the
reference's params (``init_lm(PRNGKey(0))``), encoder output
(``normal(PRNGKey(3))``) and prompt (``randint(PRNGKey(1))``), so its
printed stream is the reference's.  It prints prefill and decode tok/s.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core import decode as D
from repro_torch.core import prng as R
from repro_torch.core import protocols as P
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


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def enc_dec_stream(params, cfg, batch: int, prompt_len: int, max_new: int,
                   sampler: D.SamplerConfig, seed: int = 0, device="cuda",
                   rules=None):
    """The reference's enc-dec serving loop (``repro.launch.serve.
    _serve_enc_dec``): caches for ``prompt_len + max_new`` tokens whose
    ``enc_out`` is ``normal(PRNGKey(3))``, a ``randint(PRNGKey(1))``
    prompt consumed token by token (:func:`repro_torch.core.decode.
    make_prompt_consume`), then ``max_new`` tokens, each sampled under
    ``fold_in(fold_in(PRNGKey(seed), row), step)`` and fed back through
    the decoder step.  Returns ``(tokens (batch, max_new), prefill_s,
    decode_s)``, the seconds on the host clock to the device's end.

    ``rules`` with a mesh: ``params`` this rank's slabs, the caches its
    slab (:func:`repro_torch.core.protocols.init_serve_caches`), the
    encoder output, prompt and keys its rows of the global ones, the
    logits gathered over "model" before the sampler; the tokens are its
    rows."""
    dev = resolve_device(device)
    serve = P.make_serve_step(cfg, rules)
    consume = D.make_prompt_consume(cfg, rules)
    caches = P.init_serve_caches(cfg, batch, prompt_len + max_new,
                                 device=dev, rules=rules)
    rows = (slice(None) if P._mesh_rules(rules) is None else
            slice(*rules.sharding_for((batch,), ("batch",)).bounds[0]))
    caches["enc_out"].copy_(R.normal(R.PRNGKey(3), (
        batch, prompt_len + max_new, cfg.d_model), device=dev)[rows])
    prompt = R.randint(R.PRNGKey(1), (batch, prompt_len), 0, cfg.vocab,
                       device=dev)[rows]
    keys = R.fold_in_many(R.PRNGKey(seed),
                          torch.arange(batch, device=dev))[rows]
    batch = prompt.shape[0]

    def pick(logits, step):
        sk = (R.fold_in_many(keys, torch.full((batch,), step, device=dev))
              if sampler.draws else None)
        return D.sample_logits(logits[:, -1, :cfg.vocab].to(torch.float32),
                               sk, sampler)[:, None]

    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = consume(params, caches, prompt)
        toks = [pick(logits, 0)]
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        for step in range(1, max_new):
            logits, caches = serve(params, caches, toks[-1])
            toks.append(pick(P.vocab_logits(logits, cfg, rules), step))
        _sync(dev)
        t_decode = time.perf_counter() - t0
    return torch.cat(toks, dim=1), t_prefill, t_decode


def _serve_enc_dec(cfg, args, sampler, dev):
    params = T.init_lm(cfg, device=dev, key=R.PRNGKey(0))
    gen, t_prefill, t_decode = enc_dec_stream(
        params, cfg, args.batch, args.prompt_len, args.max_new, sampler,
        args.seed, dev)
    pre_tps = args.batch * args.prompt_len / max(t_prefill, 1e-9)
    dec_tps = args.batch * (gen.shape[1] - 1) / max(t_decode, 1e-9)
    print(f"[serve] enc-dec generated {tuple(gen.shape)}: prefill "
          f"{t_prefill:.2f}s ({pre_tps:.1f} tok/s), decode "
          f"{t_decode:.2f}s ({dec_tps:.1f} tok/s)")
    print(gen[0].tolist())
    return 0


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
    sampler = build_sampler(args)
    if cfg.enc_dec or cfg.frontend is not None:
        print("[serve] modality archs: serving the text decoder only")
    if cfg.enc_dec:
        return _serve_enc_dec(cfg, args, sampler, dev)
    params = T.init_lm(cfg, seed=args.seed, device=dev,
                       draw_on_device=dev.type == "cuda")
    n_req = args.requests or args.batch
    rng = np.random.default_rng(args.seed)
    lengths = prompt_lengths(args.prompt_len)
    engine = D.DecodeEngine(
        params, cfg, slots=args.batch,
        capacity=args.prompt_len + args.max_new, segment_len=args.segment,
        sampler=sampler, eos_id=args.eos_id, seed=args.seed,
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
