"""SFL federated rounds: HERON-SFL and the paper's first-order baselines
(SFLV1/V2, CSE-FSL, FSL-SAGE, SplitLoRA), mirroring ``make_fed_round``
of :mod:`repro.core.protocols`.

* ``"heron"``: each of N clients takes h local steps of the
  forward-only ZO estimator, under ``torch.no_grad()``.  With the
  config's ``forward_impl="kernel"`` it is the fused dual-probe forward
  on the kernel noise stream (kernels K1-K3 on the card, K2 through
  im2col for the CNN's convs); with the reference's default ``"xla"`` it
  is the paper's Eq. (2) on JAX's threefry stream: plain forwards, no
  kernel.
* ``"cse_fsl"`` / ``"fsl_sage"``: each client takes h first-order steps
  on its aux-head loss (``torch.autograd`` over the plain ops) with
  ``client_opt``.  In the federated round the two are the same method:
  FSL-SAGE's gradient alignment lives only in the reference's
  datacenter step.
* For those three the server takes sequential first-order steps on the
  clients' smashed data of every ``upload_every``-th local step
  (int8-quantized on the way up with ``quantize_uplink``), client after
  client.
* ``"sflv1"`` / ``"sflv2"`` / ``"splitlora"``: the training lock; each
  step differentiates the joint loss through client and server at once.
  SFLV2 and SplitLoRA run the clients in order against one server (for
  SplitLoRA the caller adds adapters with :func:`repro_torch.models.lora
  .add_lora`); SFLV1 gives each client a replica of the round's server
  and averages the replicas after.

The Fed-Server then averages the clients' full params over the
participation mask (``uplink="dense"``), or, for HERON only, rebuilds
them from ``(seed, coeffs)`` alone (``uplink="seed_replay"``).  Clients
run in a Python loop where the JAX package uses ``vmap``.

``FedConfig.sequential_server`` is not ported: no reference code reads
it.

The serving steps (``make_cached_prefill_step``, ``make_serve_step``,
``init_serve_caches``) are the decoder-only half of the reference's;
:mod:`repro_torch.core.decode` drives them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import aggregate as AG
from repro_torch.core import prng as R
from repro_torch.core import zo as Z
from repro_torch.core.split import (dequantize_smashed, param_bytes,
                                    quantize_smashed)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as O
from repro_torch.models import cnn as CNN
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import tree_leaves, tree_map

METHODS = ("heron", "cse_fsl", "fsl_sage", "sflv1", "sflv2", "splitlora")
LOCKED_METHODS = ("sflv1", "sflv2", "splitlora")


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    """Adapter between the model and the round."""
    client_loss: Callable   # (client_params, batch) -> (loss, smashed)
    aux_loss: Callable      # (client_params, smashed, batch) -> loss
    # (server_params, client_const, smashed, batch) -> loss
    server_loss: Callable
    joint_loss: Callable    # (client_params, server_params, batch) -> loss
    # forward_impl="kernel" only: (client_params, batch, seeds_tree, mu)
    # -> (l_clean, l_pert, smashed), both ZO losses of one pair from a
    # single dual-batch forward; None on the threefry path
    client_dual_loss: Callable | None = None
    # leaf-seed predicate the estimator AND the server replay share
    seed_pred: Callable | None = None


FORWARD_IMPLS = ("xla", "kernel")


def kernel_forward(cfg) -> bool:
    """Whether a config's ``forward_impl`` takes the kernel path (the
    fused dual probe) or the threefry path (``"xla"``, the reference's
    default).  The reference's ``"kernel_interpret"`` runs its Pallas
    kernels in interpret mode; the port has no such mode."""
    fi = getattr(cfg, "forward_impl", "xla")
    if fi == "kernel_interpret":
        raise ValueError("forward_impl='kernel_interpret' is the JAX "
                         "package's Pallas interpret mode; the port's "
                         "kernel path is forward_impl='kernel' (plain "
                         "versions on CPU tensors)")
    if fi not in FORWARD_IMPLS:
        raise ValueError(f"forward_impl {fi!r} not in {FORWARD_IMPLS}")
    return fi == "kernel"


def lm_api(cfg: ModelConfig) -> ModelAPI:
    def aux_loss(cp, smashed, batch):
        logits = T.aux_forward(cp, cfg, smashed, batch.get("positions"))
        lbl = batch.get("aux_labels", batch["labels"])
        return T.lm_loss(logits, lbl, cfg.vocab)

    def client_loss(cp, batch):
        s = T.client_forward(cp, cfg, batch["inputs"],
                             batch.get("positions"))
        return aux_loss(cp, s, batch), s

    def server_loss(sp, cp_const, smashed, batch):
        logits = T.server_forward({"client": cp_const, "server": sp}, cfg,
                                  smashed, positions=batch.get("positions"))
        return T.lm_loss(logits, batch["labels"], cfg.vocab)

    def joint_loss(cp, sp, batch):
        logits = T.full_forward({"client": cp, "server": sp}, cfg,
                                batch["inputs"], batch.get("positions"))
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

    if not kernel_forward(cfg):
        return ModelAPI(client_loss, aux_loss, server_loss, joint_loss)
    seed_pred = O.attn_kv_seed_pred if cfg.attn_probe == "scores" else None
    return ModelAPI(client_loss, aux_loss, server_loss, joint_loss,
                    client_dual_loss, seed_pred)


def cnn_api(cfg: CNN.CNNConfig) -> ModelAPI:
    def aux_loss(cp, smashed, batch):
        return CNN.xent(CNN.aux_logits(cp, smashed, cfg), batch["labels"])

    def client_loss(cp, batch):
        s = CNN.client_forward(cp, batch["inputs"], cfg)
        return aux_loss(cp, s, batch), s

    def server_loss(sp, cp_const, smashed, batch):
        return CNN.xent(CNN.server_logits(sp, smashed, cfg),
                        batch["labels"])

    def joint_loss(cp, sp, batch):
        s = CNN.client_forward(cp, batch["inputs"], cfg)
        return CNN.xent(CNN.server_logits(sp, s, cfg), batch["labels"])

    def client_dual_loss(cp, batch, seeds, mu):
        pz = O.Perturb(seeds=seeds, mu=mu, dual=True)
        s2 = CNN.client_forward(cp, batch["inputs"], cfg, pz)
        logits2 = CNN.aux_logits(cp, s2, cfg, pz)
        B = batch["inputs"].shape[0]
        l0 = CNN.xent(logits2[:B], batch["labels"])
        lp = CNN.xent(logits2[B:], batch["labels"])
        return l0, lp, s2[:B]

    return ModelAPI(client_loss, aux_loss, server_loss, joint_loss,
                    client_dual_loss if kernel_forward(cfg) else None)


# ===========================================================================
# serving (decoder-only)
# ===========================================================================

def _decoder_only(cfg, what: str):
    if getattr(cfg, "enc_dec", False):
        raise NotImplementedError(
            f"{what} is decoder-only; enc-dec serving comes with the "
            "enc-dec model, ROADMAP queue 1 item 6")


def make_prefill_step(cfg: ModelConfig):
    """``prefill(params, batch) -> logits``: the whole model's forward."""
    _decoder_only(cfg, "the prefill step")

    def prefill(params, batch):
        return T.full_forward(params, cfg, batch["inputs"],
                              batch.get("positions"))

    return prefill


def decoder_hidden(params, cfg: ModelConfig, caches, tokens, *,
                   decode: bool = False, live=None):
    """Client then server blocks over ``tokens`` with the serving caches
    (written in place): a block prefill of fresh caches, or with
    ``decode`` one token per slot (cache writes only for ``live`` slots
    when given).  Returns the hidden states before the head."""
    x = T.embed_inputs(params["client"], cfg, tokens)
    x, _ = T.apply_stack(params["client"]["layers"], x, cfg,
                         T.client_specs(cfg), caches=caches["client"],
                         decode=decode, live=live)
    x, _ = T.apply_stack(params["server"]["layers"], x, cfg,
                         T.server_specs(cfg), caches=caches["server"],
                         decode=decode, live=live)
    return x


def make_cached_prefill_step(cfg: ModelConfig):
    """Block prefill for serving: one forward over the whole prompt that
    writes the KV / recurrent caches, so decode continues at ``pos =
    prompt_len``.  Returns ``prefill(params, caches, tokens) -> (logits,
    caches)``; the caches must be fresh (``init_serve_caches``, pos 0)
    and are written in place.  On the card the attention layers run K5
    and the RG-LRU layers K6."""
    _decoder_only(cfg, "the cached block prefill")

    def prefill(params, caches, tokens):
        x = decoder_hidden(params, cfg, caches, tokens)
        return T.lm_head(params, cfg, x), caches

    return prefill


def init_serve_caches(cfg: ModelConfig, batch: int, seq: int,
                      per_slot: bool = False, device="cuda"):
    """Zeroed caches of the client and server stacks, ``seq`` tokens per
    row.  ``per_slot=True`` lays them out for the decode engine
    (:mod:`repro_torch.core.decode`): every KV cache carries a per-slot
    ``pos`` vector instead of one scalar, so slots at different sequence
    positions share one batch and finished slots can be recycled."""
    _decoder_only(cfg, "serving")
    dev = resolve_device(device)
    return {part: T.init_stack_cache(cfg, specs(cfg), batch, seq, per_slot,
                                     dev)
            for part, specs in (("client", T.client_specs),
                                ("server", T.server_specs))}


def make_serve_step(cfg: ModelConfig):
    """One decode step: ``serve(params, caches, token, live=None) ->
    (logits, caches)`` for ``token`` (B, 1), the caches written in place
    (only the ``live`` slots' when given)."""
    _decoder_only(cfg, "the serve step")

    def serve(params, caches, token, live=None):
        x = decoder_hidden(params, cfg, caches, token, decode=True,
                           live=live)
        return T.lm_head(params, cfg, x), caches

    return serve


@dataclasses.dataclass(frozen=True)
class FedConfig:
    n_clients: int = 5
    h: int = 4                    # local steps per round
    upload_every: int = 1         # k: smashed upload period
    participation: float = 1.0
    straggler_prob: float = 0.0
    quantize_uplink: bool = False  # int8 smashed-data upload (pq/2)


UPLINKS = ("dense", "seed_replay")


def seed_replay_uplink_bytes(n_clients: int, h: int, n_pairs: int) -> int:
    """Bytes on the wire for the lean uplink: per client one 64-bit key
    plus h·n_pairs fp32 projected-gradient coefficients."""
    return n_clients * (h * n_pairs * 4 + 8)


def _with_leaves(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _value_and_grad(loss_fn, *trees, has_aux: bool = False):
    """``loss_fn(*trees)`` and its gradient with respect to every leaf of
    every tree, from one backward pass (autograd over the plain ops; the
    trees are not modified).  A leaf the loss does not read gets a zero
    gradient, as in JAX.  With ``has_aux`` the function returns ``(loss,
    aux)`` and ``aux`` comes back detached.  Returns ``(loss, grads)``,
    ``grads`` a tuple of trees, one per tree."""
    leaves = [[p.detach().requires_grad_(True) for p in tree_leaves(t)]
              for t in trees]
    flat = [p for ls in leaves for p in ls]
    with torch.enable_grad():
        out = loss_fn(*(_with_leaves(t, ls) for t, ls in zip(trees, leaves)))
        loss = out[0] if has_aux else out
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = iter(torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads))
    gtrees = tuple(tree_map(lambda _: next(grads), t) for t in trees)
    if has_aux:
        return (loss.detach(), out[1].detach()), gtrees
    return loss.detach(), gtrees


def _slice_batch(batch, i, m):
    return {k: v[i, m] for k, v in batch.items()}


def make_local_update(api: ModelAPI, method: str, zo_cfg: Z.ZOConfig,
                      client_opt: Optimizer, uplink: str = "dense",
                      client_lr: float | None = None):
    """One client's local step of an aux-head method (``heron``,
    ``cse_fsl``, ``fsl_sage``): ``local_update(cp, oc, batch, seed) ->
    (cp, oc, smashed, loss, coeffs)``.

    HERON estimates the gradient from forward passes alone, under
    ``torch.no_grad()``: on the kernel stream (``seed`` an int32, where
    the API has a ``client_dual_loss``) or on the threefry stream
    (``seed`` a key).  It steps with plain SGD at ``client_lr`` on the
    lean uplink or with ``client_opt``; ``coeffs`` are its (n_pairs,)
    projected-gradient coefficients.  The first-order clients take
    autograd of ``client_loss`` and step with ``client_opt``; their
    ``coeffs`` are zeros and ``seed`` is unused.  ``smashed`` is the
    forward's cut activation before the step, detached."""
    if method == "heron":
        def estimate(cp, batch, seed):
            if api.client_dual_loss is None:
                return Z.zo_gradient(lambda cpx: api.client_loss(cpx, batch),
                                     cp, seed, zo_cfg)
            return Z.zo_gradient_kernel(
                lambda cpx, seeds, mu: api.client_dual_loss(
                    cpx, batch, seeds, mu),
                cp, seed, zo_cfg, seed_pred=api.seed_pred)

        def local_update(cp, oc, batch, seed):
            with torch.no_grad():
                g, info = estimate(cp, batch, seed)
                if uplink == "seed_replay":
                    cp = Z.add_scaled(cp, g, -client_lr)
                else:
                    cp, oc = client_opt.update(g, oc, cp)
            return cp, oc, info["aux"], info["loss"], info["coeffs"]

        return local_update

    def local_update(cp, oc, batch, seed):
        (loss, smashed), (g,) = _value_and_grad(
            lambda p: api.client_loss(p, batch), cp, has_aux=True)
        with torch.no_grad():
            cp, oc = client_opt.update(g, oc, cp)
        coeffs = torch.zeros((zo_cfg.n_pairs,), dtype=torch.float32,
                             device=loss.device)
        return cp, oc, smashed, loss, coeffs

    return local_update


def make_locked_step(api: ModelAPI, client_opt: Optimizer,
                     server_opt: Optimizer):
    """One step of the training lock (SFLV1/V2, SplitLoRA):
    ``step(cp, oc, sp, os_, batch) -> (cp, oc, sp, os_, loss)``.  One
    backward pass of ``joint_loss`` gives the client's and the server's
    gradients (the server's cut-layer gradient reaches the client), then
    both optimizers step."""
    def step(cp, oc, sp, os_, batch):
        loss, (g_c, g_s) = _value_and_grad(
            lambda c, s: api.joint_loss(c, s, batch), cp, sp)
        with torch.no_grad():
            cp, oc = client_opt.update(g_c, oc, cp)
            sp, os_ = server_opt.update(g_s, os_, sp)
        return cp, oc, sp, os_, loss

    return step


def _make_server_updates(api: ModelAPI, fed: FedConfig,
                         server_opt: Optimizer):
    """Sequential SFLV2-style server FO updates: for every upload step
    ``m % upload_every == 0``, one step per client in client order.
    ``apply(sp, os_, cp_const, round_batch, smashed) -> (sp, os_,
    losses)``, ``smashed[i][m]`` client i's detached cut activations of
    step m."""
    upload_ms = [m for m in range(fed.h) if m % fed.upload_every == 0]

    def apply(sp, os_, cp_const, round_batch, smashed):
        s_losses = []
        for m in upload_ms:
            for i in range(fed.n_clients):
                sm = smashed[i][m]
                if fed.quantize_uplink:
                    sm = dequantize_smashed(*quantize_smashed(sm), sm.dtype)
                bt = _slice_batch(round_batch, i, m)
                sl, (g,) = _value_and_grad(
                    lambda p: api.server_loss(p, cp_const, sm, bt), sp)
                with torch.no_grad():
                    sp, os_ = server_opt.update(g, os_, sp)
                s_losses.append(sl)
        return sp, os_, s_losses

    return apply


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def make_fed_round(api: ModelAPI, method: str, zo_cfg: Z.ZOConfig,
                   fed: FedConfig, client_opt: Optimizer,
                   server_opt: Optimizer, uplink: str = "dense",
                   client_lr: float | None = None):
    """Returns ``round(state, round_batch, key, mask=None) ->
    (state, metrics)``.

    ``state = {"client", "server", "opt_server"}``; ``round_batch`` holds
    tensors with leading (N, h) dims; ``key`` is the round's PRNG key,
    the reference's two uint32 words (:func:`repro_torch.core.prng.
    as_key` takes a JAX key's data as it is).  HERON's clients draw on
    the kernel stream (client i's seed ``fold_seed(seed_from_key(key),
    i)``, step m's ``fold_seed(., m)``) or on the threefry stream (client
    i's key ``fold_in(key, i)``, step m's ``fold_in(., m)``).  The
    (N,) participation mask is ``aggregate.straggler_mask(fold_in(key,
    777), ...)``, as the reference draws it; ``mask=`` overrides it.
    ``uplink="seed_replay"`` is the paper's lean uplink (HERON only):
    clients step with plain SGD at ``client_lr`` and the Fed-Server
    replays their directions from (key, coeffs); it matches ``"dense"``
    exactly at h == 1.
    """
    if method not in METHODS:
        raise ValueError(f"method {method!r} not in {METHODS}")
    if uplink not in UPLINKS:
        raise ValueError(uplink)
    if uplink == "seed_replay":
        if method != "heron":
            raise ValueError("seed_replay uplink requires the forward-only"
                             f" ZO client (method='heron'), got {method!r}")
        if client_lr is None:
            raise ValueError("seed_replay uplink needs client_lr: the "
                             "Fed-Server replays plain-SGD local steps")
    N, h = fed.n_clients, fed.h

    def round_mask(key, mask, device):
        if mask is None:
            mask = AG.straggler_mask(R.fold_in(key, 777), N,
                                     fed.participation, fed.straggler_prob)
        return torch.as_tensor(mask, dtype=torch.float32).to(device)

    def dense_metrics(state, losses, s_losses, mask):
        dense_bytes = float(N * param_bytes(state["client"]))
        return {"client_loss": torch.mean(torch.stack(losses)),
                "server_loss": torch.mean(torch.stack(s_losses)),
                "participants": torch.sum(mask),
                "uplink_bytes": dense_bytes,
                "uplink_bytes_dense": dense_bytes}

    if method in LOCKED_METHODS:
        step = make_locked_step(api, client_opt, server_opt)

        def locked_round(state, round_batch, key, mask=None):
            cps, sps, losses = [], [], []
            sp, os_ = state["server"], state["opt_server"]
            for i in range(N):
                if method == "sflv1":     # a replica of the round's server
                    sp, os_ = state["server"], state["opt_server"]
                cp, oc = state["client"], client_opt.init(state["client"])
                for m in range(h):
                    cp, oc, sp, os_, loss = step(
                        cp, oc, sp, os_, _slice_batch(round_batch, i, m))
                    losses.append(loss)
                cps.append(cp)
                if method == "sflv1":
                    sps.append(sp)
            if method == "sflv1":
                # the replicas' mean; the reference returns the round's
                # server optimizer state unchanged, and so does the port
                sp, os_ = AG.fedavg(_stack(sps)), state["opt_server"]
            mask = round_mask(key, mask, losses[0].device)
            with torch.no_grad():
                new_client = AG.fedavg_masked(_stack(cps), mask)
            return ({"client": new_client, "server": sp, "opt_server": os_},
                    dense_metrics(state, losses, losses, mask))

        return locked_round

    local_update = make_local_update(api, method, zo_cfg, client_opt, uplink,
                                     client_lr)
    server_updates = _make_server_updates(api, fed, server_opt)

    kernel_client = api.client_dual_loss is not None and method == "heron"

    def round_fn(state, round_batch, key, mask=None):
        key = R.as_key(key)
        if kernel_client:
            client_keys = O.fold_seed(Z.seed_from_key(key), np.arange(N))
        else:
            client_keys = Z.fold_in_range(key, N)
        cps, smashed, losses, coeffs = [], [], [], []
        for i in range(N):
            cp, oc = state["client"], client_opt.init(state["client"])
            sm_i, co_i = [], []
            for m in range(h):
                step_key = (O.fold_seed(client_keys[i], m) if kernel_client
                            else R.fold_in(client_keys[i], m))
                cp, oc, s, loss, co = local_update(
                    cp, oc, _slice_batch(round_batch, i, m), step_key)
                sm_i.append(s)
                co_i.append(co)
                losses.append(loss)
            if uplink == "dense":          # the lean uplink sends no params
                cps.append(cp)
            smashed.append(sm_i)
            coeffs.append(torch.stack(co_i))

        cp_const = tree_map(lambda p: p.detach(), state["client"])
        sp, os_, s_losses = server_updates(
            state["server"], state["opt_server"], cp_const, round_batch,
            smashed)

        mask = round_mask(key, mask, losses[0].device)
        metrics = dense_metrics(state, losses, s_losses, mask)
        with torch.no_grad():
            if uplink == "seed_replay":
                if kernel_client:
                    new_client = AG.seed_replay_aggregate_kernel(
                        state["client"], client_keys, torch.stack(coeffs),
                        client_lr, mask, seed_pred=api.seed_pred)
                else:
                    new_client = AG.seed_replay_aggregate(
                        state["client"], client_keys, torch.stack(coeffs),
                        client_lr, zo_cfg, mask)
                metrics["uplink_bytes"] = float(seed_replay_uplink_bytes(
                    N, h, zo_cfg.n_pairs))
            else:
                new_client = AG.fedavg_masked(_stack(cps), mask)
        return ({"client": new_client, "server": sp, "opt_server": os_},
                metrics)

    return round_fn
