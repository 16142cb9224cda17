"""The HERON-SFL federated round, mirroring the ``"heron"`` method of
:mod:`repro.core.protocols` on the kernel noise stream.

One round: each of N clients takes h local steps of the forward-only ZO
estimator (the fused dual-probe forward: kernels K1-K3 on the card, K2
through im2col for the CNN's convs); the server takes sequential
first-order AdamW steps on the clients' smashed data
(``torch.autograd`` over plain PyTorch ops); the Fed-Server
aggregates either the clients' full params (``uplink="dense"``) or
rebuilds them from ``(seed, coeffs)`` alone (``uplink="seed_replay"``).
Clients run in a Python loop where the JAX package uses ``vmap``.

The participation mask is an input: the JAX package draws it from
``jax.random``; with full participation and no stragglers it is all
ones, which is the default here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import aggregate as AG
from repro_torch.core import zo as Z
from repro_torch.core.split import param_bytes
from repro_torch.kernels import ops as O
from repro_torch.models import cnn as CNN
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    """Adapter between the model and the round."""
    # (server_params, client_const, smashed, batch) -> loss
    server_loss: Callable
    # (client_params, batch, seeds_tree, mu) -> (l_clean, l_pert, smashed):
    # both ZO losses of one pair from a single dual-batch forward
    client_dual_loss: Callable
    # leaf-seed predicate the estimator AND the server replay share
    seed_pred: Callable | None = None


def lm_api(cfg: ModelConfig) -> ModelAPI:
    def server_loss(sp, cp_const, smashed, batch):
        logits = T.server_forward({"client": cp_const, "server": sp}, cfg,
                                  smashed, positions=batch.get("positions"))
        return T.lm_loss(logits, batch["labels"], cfg.vocab)

    def client_dual_loss(cp, batch, seeds, mu):
        pz = O.Perturb(seeds=seeds, mu=mu, dual=True)
        pos = batch.get("positions")
        s2 = T.client_forward(cp, cfg, batch["inputs"], pos, perturb=pz)
        pos2 = None if pos is None else torch.cat([pos, pos], dim=0)
        logits2 = T.aux_forward(cp, cfg, s2, pos2, perturb=pz)
        lbl = batch.get("aux_labels", batch["labels"])
        B = batch["inputs"].shape[0]
        l0 = T.lm_loss(logits2[:B], lbl, cfg.vocab)
        lp = T.lm_loss(logits2[B:], lbl, cfg.vocab)
        return l0, lp, s2[:B]

    seed_pred = O.attn_kv_seed_pred if cfg.attn_probe == "scores" else None
    return ModelAPI(server_loss, client_dual_loss, seed_pred)


def cnn_api(cfg: CNN.CNNConfig) -> ModelAPI:
    def server_loss(sp, cp_const, smashed, batch):
        return CNN.xent(CNN.server_logits(sp, smashed, cfg),
                        batch["labels"])

    def client_dual_loss(cp, batch, seeds, mu):
        pz = O.Perturb(seeds=seeds, mu=mu, dual=True)
        s2 = CNN.client_forward(cp, batch["inputs"], cfg, pz)
        logits2 = CNN.aux_logits(cp, s2, cfg, pz)
        B = batch["inputs"].shape[0]
        l0 = CNN.xent(logits2[:B], batch["labels"])
        lp = CNN.xent(logits2[B:], batch["labels"])
        return l0, lp, s2[:B]

    return ModelAPI(server_loss, client_dual_loss)


@dataclasses.dataclass(frozen=True)
class FedConfig:
    n_clients: int = 5
    h: int = 4                    # local steps per round


UPLINKS = ("dense", "seed_replay")


def seed_replay_uplink_bytes(n_clients: int, h: int, n_pairs: int) -> int:
    """Bytes on the wire for the lean uplink: per client one 64-bit seed
    word plus h·n_pairs fp32 projected-gradient coefficients."""
    return n_clients * (h * n_pairs * 4 + 8)


def _value_and_grad(loss_fn, params):
    """``loss_fn(params)`` and its gradient tree (autograd over the plain
    ops; the params are not modified)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    loss = loss_fn(tree_map(lambda _: next(it), params))
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def _slice_batch(batch, i, m):
    return {k: v[i, m] for k, v in batch.items()}


def make_fed_round(api: ModelAPI, method: str, zo_cfg: Z.ZOConfig,
                   fed: FedConfig, client_opt: Optimizer,
                   server_opt: Optimizer, uplink: str = "dense",
                   client_lr: float | None = None):
    """Returns ``round(state, round_batch, base_seed, mask=None) ->
    (state, metrics)``.

    ``state = {"client", "server", "opt_server"}``; ``round_batch`` holds
    tensors with leading (N, h) dims; ``base_seed`` is the round's int32
    seed (client i's seed is ``fold_seed(base_seed, i)``); ``mask`` the
    (N,) participation mask, all ones by default.  ``uplink="seed_replay"``
    is the paper's lean uplink: clients step with plain SGD at
    ``client_lr`` and the Fed-Server replays their directions from
    (seed, coeffs); it matches ``"dense"`` exactly at h == 1.
    """
    if method != "heron":
        raise NotImplementedError(f"method {method!r}: only the HERON round "
                                  "is ported")
    if uplink not in UPLINKS:
        raise ValueError(uplink)
    if uplink == "seed_replay" and client_lr is None:
        raise ValueError("seed_replay uplink needs client_lr: the "
                         "Fed-Server replays plain-SGD local steps")

    def local_update(cp, oc, batch, seed):
        def dloss(cpx, seeds, mu):
            return api.client_dual_loss(cpx, batch, seeds, mu)

        g, info = Z.zo_gradient_kernel(dloss, cp, seed, zo_cfg,
                                       seed_pred=api.seed_pred)
        if uplink == "seed_replay":
            cp = Z.add_scaled(cp, g, -client_lr)
        else:
            cp, oc = client_opt.update(g, oc, cp)
        return cp, oc, info["aux"], info["loss"], info["coeffs"]

    def round_fn(state, round_batch, base_seed, mask=None):
        N, h = fed.n_clients, fed.h
        client_seeds = O.fold_seed(base_seed, np.arange(N))
        cps, smashed, losses, coeffs = [], [], [], []
        with torch.no_grad():
            for i in range(N):
                cp, oc = state["client"], client_opt.init(state["client"])
                sm_i, co_i = [], []
                for m in range(h):
                    cp, oc, s, loss, co = local_update(
                        cp, oc, _slice_batch(round_batch, i, m),
                        O.fold_seed(client_seeds[i], m))
                    sm_i.append(s)
                    co_i.append(co)
                    losses.append(loss)
                if uplink == "dense":      # the lean uplink sends no params
                    cps.append(cp)
                smashed.append(sm_i)
                coeffs.append(torch.stack(co_i))

        # sequential SFLV2-style server updates: local step, then client
        # (every step's smashed data is uploaded)
        cp_const = tree_map(lambda p: p.detach(), state["client"])
        sp, os_ = state["server"], state["opt_server"]
        s_losses = []
        for m in range(h):
            for i in range(N):
                bt = _slice_batch(round_batch, i, m)
                sm = smashed[i][m].detach()
                sl, g = _value_and_grad(
                    lambda p: api.server_loss(p, cp_const, sm, bt), sp)
                with torch.no_grad():
                    sp, os_ = server_opt.update(g, os_, sp)
                s_losses.append(sl)

        dev = losses[0].device
        if mask is None:
            mask = torch.ones((N,), dtype=torch.float32, device=dev)
        dense_bytes = N * param_bytes(state["client"])
        with torch.no_grad():
            if uplink == "seed_replay":
                new_client = AG.seed_replay_aggregate_kernel(
                    state["client"], client_seeds, torch.stack(coeffs),
                    client_lr, mask, seed_pred=api.seed_pred)
                lean_bytes = seed_replay_uplink_bytes(N, h, zo_cfg.n_pairs)
            else:
                stacked = tree_map(lambda *xs: torch.stack(xs), *cps)
                new_client = AG.fedavg_masked(stacked, mask)
                lean_bytes = dense_bytes
        metrics = {"client_loss": torch.mean(torch.stack(losses)),
                   "server_loss": torch.mean(torch.stack(s_losses)),
                   "participants": torch.sum(mask),
                   "uplink_bytes": float(lean_bytes),
                   "uplink_bytes_dense": float(dense_bytes)}
        return ({"client": new_client, "server": sp, "opt_server": os_},
                metrics)

    return round_fn
