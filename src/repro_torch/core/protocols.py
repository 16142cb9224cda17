"""SFL protocols: HERON-SFL and the paper's first-order baselines
(SFLV1/V2, CSE-FSL, FSL-SAGE, SplitLoRA), mirroring
:mod:`repro.core.protocols`: the datacenter step (``init_train_state``,
``make_train_step``, on one device or over a ("data", "model") mesh of
ranks), the federated round (``make_fed_round``) and its buffered-async
form (``make_async_round``).

The datacenter step's mesh mode is the reference's ``lm_api(cfg,
rules)``: the API carries the rules and each leaf's placement
(``ModelAPI.rules`` / ``.shardings``), every rank holds its slabs of the
params and its slab of the batch (``data.pipeline.place_batch``), the
losses are the global batch's means on every rank, and the first-order
gradients are all-reduced over the data group.  Both axes take every
LM family: on the model axis the dense family and qwen2-vl's M-RoPE
attention are tensor-parallel, MoE expert-parallel
(:func:`repro_torch.models.moe.moe_ep`), the recurrent hybrid and
xLSTM families run their mixers on "lru" / "heads" / "d_ff" slabs
(:mod:`repro_torch.models.recurrent`), and the enc-dec's decoder its
cross sub-blocks on the rank's heads and ``dec_embed`` vocab-parallel.

The notes below are the federated round's.

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
  FSL-SAGE's gradient alignment lives only in the datacenter step.
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
``init_serve_caches``) are the reference's: the decoder-only archs' cached
block prefill and decode step, and the enc-dec's decoder step, one token
cross-attending the encoder output kept in its caches;
:mod:`repro_torch.core.decode` drives them.  Like the reference's they
take ``rules``: on a ("data", "model") mesh each rank holds its slabs of
the params and the caches and returns its vocab slab of the logits.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import aggregate as AG
from repro_torch.core import prng as R
from repro_torch.core import zo as Z
from repro_torch.core.split import (combine, dequantize_smashed,
                                    param_bytes, partition,
                                    quantize_smashed)
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.kernels import ops as O
from repro_torch.models import cnn as CNN
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map

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
    # the datacenter step's mesh: the rules and every param leaf's
    # placement ({"client", "server"} trees), None on one device
    rules: SH.AxisRules | None = None
    shardings: dict | None = None


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


def _mesh_rules(rules):
    """``rules``, or None on one device (every mesh axis 1): the
    unsharded program, op for op."""
    if rules is not None and (rules.mesh is None or all(
            n == 1 for n in rules.mesh.shape.values())):
        return None
    return rules


def _placed(rules, batch):
    """The rules for this batch: whether its rows are this rank's slab
    (``place_batch``'s ``"batch_split"``)."""
    if rules is None or rules.batch_split == batch.get("batch_split", True):
        return rules
    return dataclasses.replace(rules, batch_split=batch["batch_split"])


def lm_api(cfg: ModelConfig, rules: SH.AxisRules | None = None) -> ModelAPI:
    """The LM adapter; ``rules`` with a mesh make it the datacenter
    step's mesh mode (each rank's slabs, the global batch's losses)."""
    rules = _mesh_rules(rules)
    W = cfg.vocab_padded

    def placed(batch):
        return _placed(rules, batch)

    def loss(logits, labels):
        return T.lm_loss(logits, labels, cfg.vocab, rules, W)

    def aux_loss(cp, smashed, batch):
        logits = T.aux_forward(cp, cfg, smashed, batch.get("positions"),
                               rules=placed(batch))
        return loss(logits, batch.get("aux_labels", batch["labels"]))

    def client_loss(cp, batch):
        s = T.client_forward(cp, cfg, batch["inputs"],
                             batch.get("positions"), rules=placed(batch))
        return aux_loss(cp, s, batch), s

    def server_logits(cp, sp, smashed, batch):
        return T.server_forward({"client": cp, "server": sp}, cfg, smashed,
                                positions=batch.get("positions"),
                                dec_tokens=batch.get("dec_tokens"),
                                dec_positions=batch.get("dec_positions"),
                                rules=placed(batch))

    def server_loss(sp, cp_const, smashed, batch):
        return loss(server_logits(cp_const, sp, smashed, batch),
                    batch["labels"])

    def joint_loss(cp, sp, batch):
        s = T.client_forward(cp, cfg, batch["inputs"],
                             batch.get("positions"), rules=placed(batch))
        return loss(server_logits(cp, sp, s, batch), batch["labels"])

    def client_dual_loss(cp, batch, seeds, mu):
        pz = O.Perturb(seeds=seeds, mu=mu, dual=True)
        pos = batch.get("positions")
        r = placed(batch)
        s2 = T.client_forward(cp, cfg, batch["inputs"], pos, perturb=pz,
                              rules=r)
        logits2 = T.aux_forward(cp, cfg, s2, T.dual_positions(pos),
                                perturb=pz, rules=r)
        lbl = batch.get("aux_labels", batch["labels"])
        B = batch["inputs"].shape[0]
        return loss(logits2[:B], lbl), loss(logits2[B:], lbl), s2[:B]

    mesh_kw = dict(rules=rules, shardings=T.param_shardings(cfg, rules))
    if not kernel_forward(cfg):
        return ModelAPI(client_loss, aux_loss, server_loss, joint_loss,
                        **mesh_kw)
    seed_pred = O.attn_kv_seed_pred if cfg.attn_probe == "scores" else None
    return ModelAPI(client_loss, aux_loss, server_loss, joint_loss,
                    client_dual_loss, seed_pred, **mesh_kw)


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
# datacenter hybrid step
# ===========================================================================

def init_train_state(rng, params, client_opt: Optimizer,
                     server_opt: Optimizer, tc_pred=None, ts_pred=None,
                     shardings=None):
    """The datacenter step's state: ``{"params", "opt_client",
    "opt_server", "step", "rng"}``, the optimizers over the trainable
    parts (``tc_pred`` / ``ts_pred`` on the leaf paths, all by default).
    ``step`` is a Python int; ``rng`` the key's two words as a uint32
    tensor, the dtype of JAX's raw key data, so a checkpoint holds the
    state leaf for leaf as the reference's.  ``shardings`` (a mesh
    API's ``ModelAPI.shardings``) cuts the full ``params`` to this
    rank's slabs first."""
    if shardings is not None:
        params = SH.shard_tree(params, shardings)
    tc, _ = partition(params["client"], tc_pred or (lambda p: True))
    ts, _ = partition(params["server"], ts_pred or (lambda p: True))
    return {"params": params,
            "opt_client": client_opt.init(tc),
            "opt_server": server_opt.init(ts),
            "step": 0,
            "rng": R.as_key(rng).to(torch.uint32)}


def _stat_places(stats, placed):
    """Adafactor's statistics of a trainable tree (``{"vr", "vc"}`` of a
    factored leaf, ``{"v"}`` of another, at each leaf) placed as their
    leaf: ``vr`` without its last dim, ``vc`` without its second-last.
    Raises ``KeyError`` where ``stats`` is not that layout."""
    if isinstance(placed, dict):
        if not isinstance(stats, dict) or set(stats) != set(placed):
            raise KeyError("not Adafactor's statistics")
        return {k: _stat_places(stats[k], placed[k]) for k in placed}
    if isinstance(placed, (list, tuple)):
        if not isinstance(stats, (list, tuple)) or len(stats) != len(placed):
            raise KeyError("not Adafactor's statistics")
        return type(placed)(_stat_places(a, b) for a, b in zip(stats, placed))
    if not isinstance(stats, dict) or not stats or \
            not set(stats) <= {"vr", "vc", "v"}:
        raise KeyError("not Adafactor's statistics")
    if placed is None or not placed.sharded:
        return {k: None for k in stats}
    if "v" in stats:
        return {"v": placed}
    return {"vr": placed.drop(-1), "vc": placed.drop(-2)}


def train_state_shardings(state, shardings, tc_pred=None, ts_pred=None):
    """The placements of a mesh step's state leaves (for a checkpoint's
    gather and scatter): the params' ``shardings``, an optimizer state's
    subtrees shaped as its trainable part the same, Adafactor's factored
    statistics as their leaf without the dim each averages, and every
    other leaf (counts, the key) replicated."""
    if shardings is None:
        return None

    def opt(ost, placed):
        want = [p for p, _ in tree_leaves_with_path(placed)]
        out = {}
        for k, v in ost.items():
            if isinstance(v, (dict, list, tuple)) and \
                    [p for p, _ in tree_leaves_with_path(v)] == want:
                out[k] = placed
                continue
            try:
                out[k] = _stat_places(v, placed)
            except KeyError:
                out[k] = tree_map(lambda _: None, v)
        return out

    tc, _ = partition(shardings["client"], tc_pred or (lambda p: True))
    ts, _ = partition(shardings["server"], ts_pred or (lambda p: True))
    return {"params": shardings, "opt_client": opt(state["opt_client"], tc),
            "opt_server": opt(state["opt_server"], ts), "step": None,
            "rng": None}


def make_train_step(api: ModelAPI, method: str, zo_cfg: Z.ZOConfig,
                    client_opt: Optimizer, server_opt: Optimizer,
                    tc_pred=None, ts_pred=None, align_weight: float = 1.0,
                    client_shardings=None):
    """Returns ``step(state, batch) -> (state, metrics)``: one hybrid
    step on one device, as the reference's ``make_train_step`` with no
    mesh.  The step's key is ``fold_in(rng, step)``.

    * ``heron``: the forward-only ZO client on the kernel stream (base
      seed ``seed_from_key(key)``, ``zo_gradient_kernel``) where the API
      has a ``client_dual_loss``, else on the threefry stream
      (``zo.zo_gradient`` under ``key``); metric ``zo_coeff_abs``.
    * ``cse_fsl`` / ``fsl_sage``: a first-order client on its aux-head
      loss; ``fsl_sage`` adds ``align_weight`` times the gradient of the
      mean squared gap between the aux head's and the server's cut-layer
      gradients (a double backward through the aux head).
    * For those three the server takes one first-order step on the
      client's detached smashed data.
    * ``sflv1`` / ``sflv2`` / ``splitlora``: one backward of the joint
      loss through client and server (the training lock).

    Only the leaves ``tc_pred`` / ``ts_pred`` select train (all by
    default); the others pass through unchanged.

    With a mesh API (``lm_api(cfg, rules)``) the state holds this rank's
    slabs and the batch its slab (``place_batch``): the ZO draws are the
    slabs of the trainable client params' placements
    (``client_shardings``, the reference's pin of the threefry draw;
    by default ``api.shardings``' client part), the losses the global
    batch's, and the first-order gradients are all-reduced over the data
    group, so every rank steps as the single-device step would on its
    slabs (the optimizers get the slabs' placements: Adafactor's factored
    means are the whole leaf's).
    """
    if method not in METHODS:
        raise ValueError(f"method {method!r} not in {METHODS}")
    tc_pred = tc_pred or (lambda p: True)
    ts_pred = ts_pred or (lambda p: True)
    if client_shardings is None and api.shardings is not None:
        client_shardings, _ = partition(api.shardings["client"], tc_pred)
    if client_shardings is not None and not all(
            isinstance(p, SH.Placement)
            for p in tree_leaves(client_shardings)):
        raise TypeError("client_shardings: a tree of Placements "
                        "(repro_torch.distributed.sharding.tree_shardings) "
                        "matching the trainable client params")
    mesh = None if api.rules is None else api.rules.mesh
    server_shardings = (None if api.shardings is None
                        else partition(api.shardings["server"], ts_pred)[0])

    def mean(x):
        """The global batch's mean of an activation's entries."""
        if mesh is None or mesh.shape.get("data", 1) == 1:
            return torch.mean(x)
        n = torch.tensor(float(x.numel()), device=x.device)
        return (TP.reduce_from(torch.sum(x), mesh, "data")
                / TP.reduce_from(n, mesh, "data"))

    def data_sum(grads):
        TP.all_reduce_tree(tree_leaves(grads), mesh, "data")
        return grads

    def client_grad(tc, fc, batch, key, metrics):
        """``(g_c, client_loss, smashed)`` of the aux-head methods."""
        def closs(tcx):
            return api.client_loss(combine(tcx, fc), batch)

        if method != "heron":
            (c_loss, smashed), (g_c,) = _value_and_grad(closs, tc,
                                                        has_aux=True)
            return g_c, c_loss, smashed
        with torch.no_grad():
            if api.client_dual_loss is not None:
                g_c, info = Z.zo_gradient_kernel(
                    lambda tcx, seeds, mu: api.client_dual_loss(
                        combine(tcx, fc), batch, seeds, mu),
                    tc, Z.seed_from_key(key), zo_cfg,
                    seed_pred=api.seed_pred, shardings=client_shardings)
            else:
                g_c, info = Z.zo_gradient(closs, tc, key, zo_cfg,
                                          shardings=client_shardings)
        metrics["zo_coeff_abs"] = torch.mean(torch.abs(info["coeffs"]))
        return g_c, info["loss"], info["aux"].detach()

    def align_grad(tc, fc, ts, fs, cp_const, smashed, batch):
        """The gradient of FSL-SAGE's alignment term at ``tc``."""
        s = smashed.detach().requires_grad_(True)
        with torch.enable_grad():
            g_srv, = torch.autograd.grad(api.server_loss(
                combine(ts, fs), cp_const, s, batch), s)
        g_srv = g_srv.detach().to(torch.float32)

        def align(tcx):
            s2 = smashed.detach().requires_grad_(True)
            g_aux, = torch.autograd.grad(
                api.aux_loss(combine(tcx, fc), s2, batch), s2,
                create_graph=True)
            return mean(torch.square(g_aux.to(torch.float32) - g_srv))

        _, (g_align,) = _value_and_grad(align, tc)
        return g_align

    def step_fn(state, batch):
        params = state["params"]
        key = R.fold_in(state["rng"], state["step"])
        tc, fc = partition(params["client"], tc_pred)
        ts, fs = partition(params["server"], ts_pred)
        metrics = {}
        if method in LOCKED_METHODS:
            loss, (g_c, g_s) = _value_and_grad(
                lambda c, s: api.joint_loss(combine(c, fc), combine(s, fs),
                                            batch), tc, ts)
            metrics["loss"] = metrics["client_loss"] = loss
            data_sum(g_c)
        else:
            g_c, c_loss, smashed = client_grad(tc, fc, batch, key, metrics)
            cp_const = tree_map(lambda p: p.detach(), params["client"])
            s_loss, (g_s,) = _value_and_grad(
                lambda s: api.server_loss(combine(s, fs), cp_const,
                                          smashed, batch), ts)
            if method == "fsl_sage":
                g_align = align_grad(tc, fc, ts, fs, cp_const, smashed,
                                     batch)
                g_c = tree_map(lambda a, b: a + align_weight * b, g_c,
                               g_align)
            if method != "heron":
                data_sum(g_c)
            metrics["loss"] = s_loss
            metrics["client_loss"] = c_loss
        data_sum(g_s)
        with torch.no_grad():
            new_tc, oc = client_opt.update(g_c, state["opt_client"], tc,
                                           places=client_shardings)
            new_ts, os_ = server_opt.update(g_s, state["opt_server"], ts,
                                            places=server_shardings)
        return ({"params": {"client": combine(new_tc, fc),
                            "server": combine(new_ts, fs)},
                 "opt_client": oc, "opt_server": os_,
                 "step": state["step"] + 1, "rng": state["rng"]}, metrics)

    return step_fn


# ===========================================================================
# serving
# ===========================================================================

def _decoder_only(cfg, what: str):
    """The reference's refusal of enc-dec archs where serving is
    decoder-only: enc-dec serving keeps its cross-attended token loop."""
    if cfg.enc_dec:
        raise ValueError(f"{what} is decoder-only; enc-dec serving keeps "
                         "the token loop")


def make_prefill_step(cfg: ModelConfig, rules: SH.AxisRules | None = None):
    """``prefill(params, batch) -> logits``: the whole model's forward
    (an enc-dec's decoder on ``batch["dec_tokens"]``).  ``rules`` with a
    mesh run it as the training step's mesh mode does: ``params`` the
    rank's slabs (``shard_tree`` by ``T.param_shardings``), ``batch``
    placed by ``place_batch``, the logits this rank's vocab slab."""
    rules = _mesh_rules(rules)

    def prefill(params, batch):
        return T.full_forward(params, cfg, batch["inputs"],
                              batch.get("positions"),
                              batch.get("dec_tokens"),
                              rules=_placed(rules, batch))

    return prefill


def decoder_hidden(params, cfg: ModelConfig, caches, tokens, *,
                   decode: bool = False, live=None, rules=None):
    """Client then server blocks over ``tokens`` with the serving caches
    (written in place): a block prefill of fresh caches, or with
    ``decode`` one token per slot (cache writes only for ``live`` slots
    when given).  Returns the hidden states before the head.  ``rules``
    with a mesh: every block on the rank's slabs, the caches
    :func:`init_serve_caches`' under the same rules."""
    rules = _mesh_rules(rules)
    x = T.embed_inputs(params["client"], cfg, tokens, rules)
    x, _ = T.apply_stack(params["client"]["layers"], x, cfg,
                         T.client_specs(cfg), caches=caches["client"],
                         decode=decode, live=live, rules=rules)
    x, _ = T.apply_stack(params["server"]["layers"], x, cfg,
                         T.server_specs(cfg), caches=caches["server"],
                         decode=decode, live=live, rules=rules)
    return x


def vocab_logits(logits, cfg: ModelConfig, rules=None):
    """The whole padded vocab of logits whose last dim is this rank's
    vocab slab under ``rules`` (all-gathered over "model"); ``logits``
    themselves where the rules leave the vocab whole.  The sampler reads
    the gathered logits, so every rank draws the same token; crop to
    ``cfg.vocab`` after it, a slab is not the first columns."""
    rules = _mesh_rules(rules)
    if T._vocab_v0(cfg, rules) is None:
        return logits
    return TP.gather_from(logits, rules.mesh, dim=-1)


def make_cached_prefill_step(cfg: ModelConfig,
                             rules: SH.AxisRules | None = None):
    """Block prefill for serving: one forward over the whole prompt that
    writes the KV / recurrent caches, so decode continues at ``pos =
    prompt_len``.  Returns ``prefill(params, caches, tokens) -> (logits,
    caches)``; the caches must be fresh (``init_serve_caches``, pos 0)
    and are written in place.  On the card the attention layers run K5
    and the RG-LRU layers K6; the mLSTM / sLSTM cells and the MoE
    dispatch are plain torch, as in the reference.  ``rules`` with a
    mesh: ``params`` the rank's slabs, ``tokens`` its batch rows, the
    caches ``init_serve_caches(..., rules=rules)``'s, the logits its
    vocab slab (as :func:`make_prefill_step`)."""
    _decoder_only(cfg, "the cached block prefill")
    rules = _mesh_rules(rules)

    def prefill(params, caches, tokens):
        x = decoder_hidden(params, cfg, caches, tokens, rules=rules)
        return T.lm_head(params, cfg, x, rules), caches

    return prefill


def init_serve_caches(cfg: ModelConfig, batch: int, seq: int,
                      per_slot: bool = False, device="cuda",
                      rules: SH.AxisRules | None = None):
    """Zeroed caches of the client and server stacks, ``seq`` tokens per
    row.  ``per_slot=True`` lays them out for the decode engine
    (:mod:`repro_torch.core.decode`): every KV cache carries a per-slot
    ``pos`` vector instead of one scalar, so slots at different sequence
    positions share one batch and finished slots can be recycled.  An
    enc-dec's caches are its decoder stack's (``"dec"``, scalar ``pos``
    as in the reference) and the encoder output its cross-attention
    reads, ``"enc_out"`` (batch, seq, d_model), zeros for the caller to
    fill.  ``rules`` with a mesh give this rank's slab: its rows of the
    global ``batch`` over "data" (all of them where the data axis does
    not divide it), and of each block what it reads on the rank (its kv
    heads, its recurrent channels or heads); ``enc_out`` whole on
    d_model."""
    dev = resolve_device(device)
    rules = _mesh_rules(rules)
    if rules is not None:
        batch = rules.sharding_for((batch,), ("batch",)).local_shape[0]
    if cfg.enc_dec:
        return {"dec": T.init_stack_cache(cfg, T.decoder_specs(cfg), batch,
                                          seq, device=dev, rules=rules),
                "enc_out": torch.zeros((batch, seq, cfg.d_model),
                                       dtype=cfg.torch_compute_dtype(),
                                       device=dev)}
    return {part: T.init_stack_cache(cfg, specs(cfg), batch, seq, per_slot,
                                     dev, rules)
            for part, specs in (("client", T.client_specs),
                                ("server", T.server_specs))}


def make_serve_step(cfg: ModelConfig, rules: SH.AxisRules | None = None):
    """One decode step: ``serve(params, caches, token, live=None) ->
    (logits, caches)`` for ``token`` (B, 1), the caches written in place
    (only the ``live`` slots' when given).  An enc-dec's step runs its
    decoder on the token, cross-attending ``caches["enc_out"]``.
    ``rules`` with a mesh: ``params`` the rank's slabs, ``token`` its
    rows, the caches ``init_serve_caches(..., rules=rules)``'s, the
    logits its vocab slab (:func:`vocab_logits` gathers them)."""
    rules = _mesh_rules(rules)

    def serve(params, caches, token, live=None):
        if cfg.enc_dec:
            x = T.decoder_forward(params, cfg, token, caches["enc_out"],
                                  caches=caches["dec"], decode=True,
                                  live=live, rules=rules)
        else:
            x = decoder_hidden(params, cfg, caches, token, decode=True,
                               live=live, rules=rules)
        return T.lm_head(params, cfg, x, rules), caches

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
    ``m % upload_every == 0``, one step per client of ``cids`` in that
    order (all N clients in client order by default; the async round
    passes each flush's clients).  ``apply(sp, os_, cp_const,
    round_batch, smashed, cids=None) -> (sp, os_, losses)``,
    ``smashed[i][m]`` client i's detached cut activations of step m."""
    upload_ms = [m for m in range(fed.h) if m % fed.upload_every == 0]

    def apply(sp, os_, cp_const, round_batch, smashed, cids=None):
        cids = range(fed.n_clients) if cids is None else cids
        s_losses = []
        for m in upload_ms:
            for i in cids:
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


def _round_mask(fed: FedConfig, key, mask, device):
    """The round's (N,) participation mask: ``aggregate.straggler_mask(
    fold_in(key, 777), ...)`` as the reference draws it, or ``mask``."""
    if mask is None:
        mask = AG.straggler_mask(R.fold_in(key, 777), fed.n_clients,
                                 fed.participation, fed.straggler_prob)
    return torch.as_tensor(mask, dtype=torch.float32).to(device)


def _make_cohort_trajectory(api: ModelAPI, method: str, zo_cfg: Z.ZOConfig,
                            fed: FedConfig, client_opt: Optimizer,
                            uplink: str, client_lr):
    """The client side of a round, shared by :func:`make_fed_round` and
    :func:`make_async_round` (the same key stream and step order is what
    makes the async round at ``buffer_k=0`` the sync one bit for bit).
    Returns ``(run, kernel_client)``: ``run(state_client, round_batch,
    key) -> (client_keys, cps, smashed, losses, coeffs)``, client i's
    base seed or key ``client_keys[i]`` (kernel stream: ``fold_seed(
    seed_from_key(key), i)``; threefry: ``fold_in(key, i)``; step m folds
    m on top), its final params ``cps[i]`` (dense uplink only), its
    smashed data ``smashed[i][m]``, the losses in (client, step) order
    and the (N, h, n_pairs) coefficients."""
    local_update = make_local_update(api, method, zo_cfg, client_opt, uplink,
                                     client_lr)
    kernel_client = api.client_dual_loss is not None and method == "heron"

    def run(state_client, round_batch, key):
        N, h = fed.n_clients, fed.h
        if kernel_client:
            client_keys = O.fold_seed(Z.seed_from_key(key), np.arange(N))
        else:
            client_keys = Z.fold_in_range(key, N)
        cps, smashed, losses, coeffs = [], [], [], []
        for i in range(N):
            cp, oc = state_client, client_opt.init(state_client)
            sm_i, co_i = [], []
            for m in range(h):
                step_key = (O.fold_seed(client_keys[i], m) if kernel_client
                            else R.fold_in(client_keys[i], m))
                cp, oc, sm, loss, co = local_update(
                    cp, oc, _slice_batch(round_batch, i, m), step_key)
                sm_i.append(sm)
                co_i.append(co)
                losses.append(loss)
            if uplink == "dense":          # the lean uplink sends no params
                cps.append(cp)
            smashed.append(sm_i)
            coeffs.append(torch.stack(co_i))
        return client_keys, cps, smashed, losses, torch.stack(coeffs)

    return run, kernel_client


def _dense_metrics(state, losses, s_losses, mask, n_clients):
    dense_bytes = float(n_clients * param_bytes(state["client"]))
    return {"client_loss": torch.mean(torch.stack(losses)),
            "server_loss": torch.mean(torch.stack(s_losses)),
            "participants": torch.sum(mask),
            "uplink_bytes": dense_bytes,
            "uplink_bytes_dense": dense_bytes}


def make_fed_round(api: ModelAPI, method: str, zo_cfg: Z.ZOConfig,
                   fed: FedConfig, client_opt: Optimizer,
                   server_opt: Optimizer, uplink: str = "dense",
                   client_lr: float | None = None,
                   replay_shard: str = "none", replay_mesh=None,
                   replay_chunk: int | None = None):
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
    exactly at h == 1.  ``replay_shard`` / ``replay_mesh`` /
    ``replay_chunk`` select the replay's mode (:func:`repro_torch.core.
    aggregate._replay_engine`): ``replay_shard="clients"`` partitions the
    (client, step, pair) stream over that axis of the cohort mesh, whose
    ranks run the cohort and the server steps replicated on the same
    seeds and end the round holding the same state.  ``replay_chunk`` is
    taken for the reference's API and changes nothing in the eager walk.
    The defaults are the flat walk.
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
            mask = _round_mask(fed, R.as_key(key), mask, losses[0].device)
            with torch.no_grad():
                new_client = AG.fedavg_masked(_stack(cps), mask)
            return ({"client": new_client, "server": sp, "opt_server": os_},
                    _dense_metrics(state, losses, losses, mask, N))

        return locked_round

    run_cohort, kernel_client = _make_cohort_trajectory(
        api, method, zo_cfg, fed, client_opt, uplink, client_lr)
    server_updates = _make_server_updates(api, fed, server_opt)

    def round_fn(state, round_batch, key, mask=None):
        key = R.as_key(key)
        client_keys, cps, smashed, losses, coeffs = run_cohort(
            state["client"], round_batch, key)
        cp_const = tree_map(lambda p: p.detach(), state["client"])
        sp, os_, s_losses = server_updates(
            state["server"], state["opt_server"], cp_const, round_batch,
            smashed)

        mask = _round_mask(fed, key, mask, losses[0].device)
        metrics = _dense_metrics(state, losses, s_losses, mask, N)
        with torch.no_grad():
            if uplink == "seed_replay":
                if kernel_client:
                    new_client = AG.seed_replay_aggregate_kernel(
                        state["client"], client_keys, coeffs, client_lr,
                        mask, seed_pred=api.seed_pred, shard=replay_shard,
                        mesh=replay_mesh, chunk=replay_chunk)
                else:
                    new_client = AG.seed_replay_aggregate(
                        state["client"], client_keys, coeffs, client_lr,
                        zo_cfg, mask, shard=replay_shard, mesh=replay_mesh,
                        chunk=replay_chunk)
                metrics["uplink_bytes"] = float(seed_replay_uplink_bytes(
                    N, h, zo_cfg.n_pairs))
            else:
                new_client = AG.fedavg_masked(_stack(cps), mask)
        return ({"client": new_client, "server": sp, "opt_server": os_},
                metrics)

    return round_fn


def make_async_round(api: ModelAPI, method: str, zo_cfg: Z.ZOConfig,
                     fed: FedConfig, client_opt: Optimizer,
                     server_opt: Optimizer, client_lr: float,
                     staleness_alpha: float = 0.0, buffer_k: int = 0,
                     replay_shard: str = "none", replay_mesh=None,
                     replay_chunk: int | None = None):
    """Buffered-async federated round (FedBuff-style) over the lean
    seed-replay uplink, as the reference's ``make_async_round``.

    The client side is the synchronous round's trajectory
    (:func:`_make_cohort_trajectory`); the Fed-Server takes the arrivals
    through :class:`repro_torch.fed.async_engine.AsyncReplayServer`:
    arrival order is the stable sort of ``durations``, the buffer
    snapshots a new global every ``buffer_k`` arrivals, and each entry
    is weighted ``(1 + tau)**-alpha``, ``tau`` the snapshots since the
    client pulled its base model.  After each snapshot the server takes
    its first-order steps on the flushed clients' smashed data, in
    client-id order.  ``buffer_k=0`` is one flush of the whole cohort:
    with ``alpha=0`` the round equals ``make_fed_round(uplink=
    "seed_replay")`` bit for bit, client and server params.

    Returns ``round(state, round_batch, key, durations=None) -> (state,
    metrics)``; ``durations`` is an (N,) array of per-client round times
    (e.g. :func:`repro_torch.fed.cutplan.round_time_s`), driving the
    arrival order and ``sim_makespan_s``, ``time_to_first_update_s`` and
    ``updates_per_sim_s``.  ``replay_shard`` / ``replay_mesh`` /
    ``replay_chunk``: every flush's replay mode, as in
    :func:`make_fed_round`.
    """
    from repro_torch.fed.async_engine import AsyncReplayServer, \
        StalenessConfig

    if method != "heron":
        raise ValueError("the async round rides the seed-replay uplink, "
                         "which needs the forward-only ZO client "
                         f"(method='heron'); got {method!r}")
    if client_lr is None:
        raise ValueError("async round needs client_lr: the Fed-Server "
                         "replays plain-SGD local steps")
    run_cohort, kernel_client = _make_cohort_trajectory(
        api, method, zo_cfg, fed, client_opt, "seed_replay", client_lr)
    server_updates = _make_server_updates(api, fed, server_opt)

    def round_fn(state, round_batch, key, durations=None):
        N, h = fed.n_clients, fed.h
        key = R.as_key(key)
        client_keys, _, smashed, losses, coeffs = run_cohort(
            state["client"], round_batch, key)
        mask = _round_mask(fed, key, None, losses[0].device)
        durations = np.asarray(np.ones((N,)) if durations is None
                               else durations, np.float64)
        order = np.argsort(durations, kind="stable")
        cp_const = tree_map(lambda p: p.detach(), state["client"])
        sp, os_ = state["server"], state["opt_server"]
        s_losses = []

        def on_flush(cids, t):
            nonlocal sp, os_
            sp, os_, sls = server_updates(sp, os_, cp_const, round_batch,
                                          smashed, cids)
            s_losses.extend(sls)

        srv = AsyncReplayServer(
            state["client"], client_lr, zo_cfg, kernel=kernel_client,
            staleness=StalenessConfig(alpha=staleness_alpha),
            buffer_k=buffer_k, shard=replay_shard, mesh=replay_mesh,
            chunk=replay_chunk, seed_pred=api.seed_pred, on_flush=on_flush)
        mask_host = mask.cpu().numpy()
        for cid in order:
            cid = int(cid)
            srv.submit(cid, client_keys[cid], coeffs[cid], base_version=0,
                       mask=float(mask_host[cid]),
                       t_done=float(durations[cid]))
        srv.flush()

        tel = srv.telemetry
        makespan = float(durations.max()) if N else 0.0
        last_t = tel.flush_times[-1] if tel.flush_times else makespan
        metrics = _dense_metrics(state, losses, s_losses, mask, N)
        metrics.update({
            "uplink_bytes": float(seed_replay_uplink_bytes(
                N, h, zo_cfg.n_pairs)),
            "flushes": float(tel.flushes),
            "mean_staleness": float(tel.mean_staleness),
            "sim_makespan_s": makespan,
            "time_to_first_update_s": float(
                tel.flush_times[0]) if tel.flush_times else makespan,
            "updates_per_sim_s": tel.flushes / max(last_t, 1e-9),
        })
        return ({"client": srv.params, "server": sp, "opt_server": os_},
                metrics)

    return round_fn
