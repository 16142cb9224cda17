"""Training driver of the port, as :mod:`repro.launch.train`: the hybrid
datacenter step (HERON or any baseline) with checkpoint/restart, or the
federated rounds (``--fed``, ``--fed-async``), on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --smoke --steps 20 --batch 8 --seq 64 --ckpt-dir ckpt

Federated simulation with the lean seed-replay uplink:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --smoke --fed --clients 4 --local-steps 2 --uplink seed_replay \\
        --steps 5

``--fed-async --staleness 0.5 --buffer-k 2 --cutplan`` runs the
buffered-async round with per-client cuts planned from device
profiles.  ``--replay-shard clients`` partitions either round's seed
replay over the ranks (``torchrun --nproc-per-node=N -m
repro_torch.launch.train ...``; without torchrun one rank); every rank
runs the cohort and the server replicated, and rank 0 alone prints.
``--replay-chunk C`` is the reference's flag and changes nothing in the
port's eager replay walk.  The driver starts the group (NCCL on the
cards, gloo on the CPU and for ranks that share a card) and destroys it
at the end.  ``--device`` is the card by default (``cpu`` runs the
kernels' plain versions).  The keys are the reference's: the params
``init_lm(PRNGKey(0))`` (drawn on JAX's key stream, so a run starts
from the reference's params), the train state's ``PRNGKey(1)``, the
cut planner's batch ``PRNGKey(2)``, the round batches ``fold_in(
PRNGKey(5), r)``, the step batches ``fold_in(PRNGKey(7), step)`` and
the round keys ``fold_in(PRNGKey(9), r)``.

The datacenter step's mesh mode runs under torchrun (or any running
group): ``torchrun --nproc-per-node=N -m repro_torch.launch.train ...
--model-parallel M`` lays the N ranks out as the reference's
``make_local_mesh(M)``, ("data" N / M, "model" M) (M not dividing N
falls back to 1), with ``AxisRules(mesh, enable_fsdp=False)``: each rank
holds its slabs of the state and of each batch (``place_batch``), and a
checkpoint is rank 0's write of the gathered state, restored onto any
mesh width.  Both axes take every family: on the model axis the dense
family is tensor-parallel, MoE expert-parallel (e.g. ``--arch
qwen3-moe-30b-a3b --smoke --model-parallel 2``), the recurrent families
run their mixers on the rank's slabs (``--arch recurrentgemma-9b
--smoke --model-parallel 2``: the RG-LRU on its "lru" channels;
``--arch xlstm-1.3b``: the mLSTM on its heads, the sLSTM's gates
gathered), qwen2-vl-2b its M-RoPE attention on the rank's heads and
seamless-m4t-medium its decoder's cross sub-blocks on the rank's heads
and ``dec_embed`` vocab-parallel (``--arch qwen2-vl-2b`` or ``--arch
seamless-m4t-medium --smoke --model-parallel 2``).

The data is ``BigramLM``, whose table is ``vocab x vocab``: at a full
config's vocab (151,936 for qwen2-1.5b) that is 185 GB, so the driver
runs such archs with ``--smoke``.  The modality archs (qwen2-vl-2b, seamless-m4t-medium) train with the
datacenter step on the reference's stub batches (``build_batch``);
``--fed`` refuses them, as the reference's driver does.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpoint as CKPT
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core import prng as R
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.data.pipeline import place_batch, round_batches
from repro_torch.data.synthetic import BigramLM
from repro_torch.device import resolve_device
from repro_torch.distributed.mesh import (init_distributed, local_device,
                                          make_local_mesh, make_replay_mesh)
from repro_torch.distributed.sharding import AxisRules
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.optim.schedules import warmup_cosine


def build_batch(cfg, ds, key, batch, seq):
    """A batch of ``ds`` under ``key``, as the reference builds it: text
    for a text arch; for a modality arch the frontend stub's embeddings
    ``normal(key, (batch, seq - 1, d_model))`` in the compute dtype as
    the inputs (with (3, B, S) M-RoPE ids of the text positions for
    vision), and for the enc-dec the text as the decoder's tokens and
    both heads' labels."""
    b = ds.batch(key, batch)
    if not (cfg.enc_dec or cfg.frontend):
        return b
    emb = R.normal(key, (batch, seq - 1, cfg.d_model)).to(
        cfg.torch_compute_dtype())
    if cfg.enc_dec:
        return {"inputs": emb, "aux_labels": b["labels"],
                "dec_tokens": b["inputs"], "labels": b["labels"]}
    if cfg.frontend == "vision":
        pos = torch.arange(seq - 1, dtype=torch.int32).expand(
            3, batch, seq - 1)
        return {"inputs": emb, "positions": pos, "labels": b["labels"]}
    return {"inputs": emb, "labels": b["labels"]}


def _is_rank0():
    return not dist.is_initialized() or dist.get_rank() == 0


def run_fed(args, cfg, api, dev):
    """N-client federated rounds (``make_fed_round`` or, with
    ``--fed-async``, ``make_async_round``); prints each round's losses
    and uplink bytes."""
    if cfg.enc_dec or cfg.frontend is not None:
        raise SystemExit("--fed supports decoder-only text archs")
    copt = make_optimizer("zo_sgd" if args.method == "heron" else "adamw",
                          args.lr_client)
    sopt = make_optimizer("adamw", args.lr_server)
    fed = P.FedConfig(n_clients=args.clients, h=args.local_steps,
                      participation=args.participation)
    replay_mesh = (make_replay_mesh(axis=args.replay_shard)
                   if args.replay_shard != "none" else None)
    replay = dict(replay_shard=args.replay_shard, replay_mesh=replay_mesh,
                  replay_chunk=args.replay_chunk)
    zo_cfg = Z.ZOConfig(mu=args.zo_mu, n_pairs=args.zo_pairs)
    ds = BigramLM(vocab=cfg.vocab, seq_len=args.seq, seed=0)
    durations = None
    if args.fed_async:
        if args.method != "heron":
            raise SystemExit("--fed-async rides the seed-replay uplink "
                             "and requires --method heron")
        round_fn = P.make_async_round(
            api, args.method, zo_cfg, fed, copt, sopt,
            client_lr=args.lr_client, staleness_alpha=args.staleness,
            buffer_k=args.buffer_k, **replay)
        if args.cutplan:
            from repro_torch.fed import cutplan as CP
            costs = CP.candidate_costs(cfg, ds.batch(R.PRNGKey(2),
                                                     args.batch))
            tiers = list(CP.PROFILES.values())
            profiles = [tiers[i % len(tiers)] for i in range(args.clients)]
            plans = CP.plan_fleet(costs, profiles, fed.h, zo_cfg.n_pairs)
            durations = [p.round_s for p in plans]
            for i, (prof, plan) in enumerate(zip(profiles, plans)):
                if _is_rank0():
                    print(f"[cutplan] client {i}: {prof.name:8s} "
                          f"cut={plan.cut} est_round={plan.round_s:.3g}s "
                          f"feasible={plan.feasible}")
    else:
        round_fn = P.make_fed_round(
            api, args.method, zo_cfg, fed, copt, sopt, uplink=args.uplink,
            client_lr=args.lr_client, **replay)
    params = T.init_lm(cfg, device=dev, key=R.PRNGKey(0))
    state = {"client": params["client"], "server": params["server"],
             "opt_server": sopt.init(params["server"])}
    t0 = time.time()
    for r in range(args.steps):
        rb = place_batch(round_batches(
            ds, R.fold_in(R.PRNGKey(5), r), args.clients, args.local_steps,
            args.batch), dev)
        key_r = R.fold_in(R.PRNGKey(9), r)
        if args.fed_async:
            state, m = round_fn(state, rb, key_r, durations=durations)
            extra = (f"flushes={int(m['flushes'])} "
                     f"staleness={m['mean_staleness']:.2f} "
                     f"upd/s={m['updates_per_sim_s']:.3g} ")
        else:
            state, m = round_fn(state, rb, key_r)
            extra = ""
        if not _is_rank0():
            continue
        print(f"[fed] round {r:3d} "
              f"client_loss={float(m['client_loss']):.4f} "
              f"server_loss={float(m['server_loss']):.4f} "
              f"uplink={'seed_replay' if args.fed_async else args.uplink} "
              f"bytes/round={float(m['uplink_bytes']):.3g} "
              f"(dense={float(m['uplink_bytes_dense']):.3g}) {extra}"
              f"({time.time()-t0:.1f}s)", flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--method", default="heron", choices=list(P.METHODS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr-client", type=float, default=1e-3)
    ap.add_argument("--lr-server", type=float, default=1e-3)
    ap.add_argument("--zo-mu", type=float, default=1e-3)
    ap.add_argument("--zo-pairs", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--fed", action="store_true",
                    help="paper-faithful N-client federated simulation "
                         "(--steps counts rounds)")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--uplink", default="dense", choices=list(P.UPLINKS),
                    help="client->Fed-Server weight channel "
                         "(seed_replay = lean (seed, coeff) uplink)")
    ap.add_argument("--replay-shard", default="none",
                    choices=["none", "clients"],
                    help="partition the seed replay over a 1-D cohort "
                         "mesh of the ranks (torchrun's, else one)")
    ap.add_argument("--replay-chunk", type=int, default=None,
                    help="the reference's replay chunk: checked, and "
                         "changes nothing in the eager replay walk")
    ap.add_argument("--fed-async", action="store_true",
                    help="buffered-async round engine: seed-replay "
                         "arrivals are applied as they land, weighted by "
                         "staleness (implies --fed, requires heron)")
    ap.add_argument("--staleness", type=float, default=0.0,
                    help="staleness-decay exponent alpha in "
                         "w(tau) = (1+tau)^-alpha (0 = no decay)")
    ap.add_argument("--buffer-k", type=int, default=0,
                    help="snapshot a new global every K async arrivals "
                         "(0 = one flush per full cohort)")
    ap.add_argument("--cutplan", action="store_true",
                    help="pick per-client cut layers from device "
                         "profiles (counted FLOPs and bytes + roofline) "
                         "and use the estimated round times as async "
                         "arrival order")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(local_device(args.device))
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.fed or args.fed_async:
        if args.model_parallel > 1:
            raise SystemExit("--model-parallel is the datacenter step's "
                             "mesh; the rounds shard their replay "
                             "(--replay-shard)")
        owned = args.replay_shard != "none" and init_distributed(dev)
        try:
            return run_fed(args, cfg, P.lm_api(cfg), dev)
        finally:
            if owned:
                dist.destroy_process_group()
    if args.uplink != "dense":
        raise SystemExit("--uplink seed_replay requires --fed (the lean "
                         "uplink is a federated-round mechanism)")
    meshed = (args.model_parallel > 1 or dist.is_initialized()
              or int(os.environ.get("WORLD_SIZE", 1)) > 1)
    owned = meshed and init_distributed(dev)
    try:
        return run_step(args, cfg, dev, meshed)
    finally:
        if owned:
            dist.destroy_process_group()


def run_step(args, cfg, dev, meshed):
    """The datacenter step with checkpoint / restart: on one device, or
    (``meshed``) on ``make_local_mesh(--model-parallel)`` over the running
    group's ranks."""
    rules = None
    if meshed:
        rules = AxisRules(mesh=make_local_mesh(args.model_parallel),
                          enable_fsdp=False)
    api = P.lm_api(cfg, rules)
    c_name = "zo_sgd" if args.method == "heron" else "adamw"
    copt = make_optimizer(
        c_name, warmup_cosine(args.lr_client, 5, args.steps))
    # the config's server optimizer; kimi-k2's Adafactor only at full
    # width, as the reference's driver chooses
    sopt = make_optimizer(
        cfg.optimizer if cfg.optimizer != "adafactor" or not args.smoke
        else "adamw",
        warmup_cosine(args.lr_server, 5, args.steps))

    params = T.init_lm(cfg, device=dev, key=R.PRNGKey(0))
    state = P.init_train_state(R.PRNGKey(1), params, copt, sopt,
                               shardings=api.shardings)
    del params
    places = P.train_state_shardings(state, api.shardings)
    start = 0
    if args.ckpt_dir and CKPT.latest_step(args.ckpt_dir) is not None:
        state, start = CKPT.restore(args.ckpt_dir, state, shardings=places)
        if _is_rank0():
            print(f"[train] restored checkpoint at step {start}")
    step_fn = P.make_train_step(
        api, args.method, Z.ZOConfig(mu=args.zo_mu, n_pairs=args.zo_pairs),
        copt, sopt)

    ds = BigramLM(vocab=cfg.vocab, seq_len=args.seq, seed=0)
    key = R.PRNGKey(7)
    t0 = time.time()
    for step in range(start, args.steps):
        batch = place_batch(build_batch(cfg, ds, R.fold_in(key, step),
                                        args.batch, args.seq), dev, rules)
        state, metrics = step_fn(state, batch)
        if _is_rank0() and (step % 5 == 0 or step == args.steps - 1):
            m = {k: float(v) for k, v in metrics.items()}
            print(f"[train] step {step:4d} loss={m.get('loss', 0):.4f} "
                  f"client_loss={m.get('client_loss', 0):.4f} "
                  f"({time.time()-t0:.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            CKPT.save(args.ckpt_dir, step + 1, state, shardings=places)
    if args.ckpt_dir:
        CKPT.save(args.ckpt_dir, args.steps, state, shardings=places)
        if _is_rank0():
            print(f"[train] final checkpoint at {args.ckpt_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
