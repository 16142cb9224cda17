"""The transformer stack with its SFL split, mirroring
:mod:`repro.models.transformer` (the dense family, the RG-LRU hybrid
RecurrentGemma, xLSTM's mLSTM / sLSTM stacks, the MoE family, qwen2-vl's
M-RoPE and seamless-m4t's enc-dec): the training paths, and the serving
prefill and decode step over per-block caches (``init_stack_cache``).

A modality arch's inputs are its frontend stub's float embeddings (the
vision patches, the audio frames), cast to the compute dtype in place of
the token embedding.  The enc-dec's client holds the encoder's first
``cut_layers`` blocks; its server the rest of the encoder, the
decoder's embedding ``dec_embed`` and its ``decoder`` stack, whose blocks
cross-attend the encoder output between the mixer and the FFN.

Layer stacks keep the JAX package's pattern compression: a segment is a
tuple (one entry per position of the repeating unit) of block-param
trees whose leaves are stacked along a leading ``reps`` axis.  The stack
runs as a Python loop over reps, and the rep index rides in
``Perturb.rep``: it row-offsets the noise of each stacked leaf, so the
forward and the server's whole-leaf replay see the same direction.
Renaming a path or unstacking the reps would change every seed.

A block without a fused ZO lowering (a recurrent mixer, an MoE FFN or a
cross-attention) runs its perturbed forward through the whole-block
fallback: ``theta + mu*U`` materialised for the block's leaves (kernel
K1) and the plain block run on it, as the JAX package does.

The training paths take the datacenter step's ``rules``
(:class:`repro_torch.distributed.sharding.AxisRules`): each rank holds
the slabs :func:`param_shardings` places and its slab of the batch.
Under a "model" axis the dense family is tensor-parallel (attention and
MLP as :mod:`repro_torch.models.attention` and
:func:`repro_torch.models.layers.mlp` say; the embedding, the tied or
untied unembedding and :func:`lm_loss` vocab-parallel), the MoE
family's FFN expert-parallel (:func:`repro_torch.models.moe.moe_ep`)
and the recurrent mixers on their "lru" / "heads" / "d_ff" slabs
(:mod:`repro_torch.models.recurrent`); an enc-dec's decoder embedding
``dec_embed`` is vocab-parallel and its cross sub-blocks attend the
rank's heads; the "data" axis reduces the loss's sums and counts over
the data group.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.kernels import ops as O
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import recurrent as REC
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.tree import tree_map, tree_map_with_path

ATTN_MIXERS = ("global_attn", "local_attn")


# ---------------------------------------------------------------------------
# one block
# ---------------------------------------------------------------------------

def _norm_init(cfg: ModelConfig):
    return L.init_rmsnorm if cfg.norm == "rmsnorm" else L.init_layernorm


_REC = {"rg_lru": (REC.init_rg_lru, REC.rg_lru_block, REC.init_rg_lru_state),
        "mlstm": (REC.init_mlstm, REC.mlstm_block, REC.init_mlstm_state),
        "slstm": (REC.init_slstm, REC.slstm_block, REC.init_slstm_state)}


def init_block(gen, spec: LayerSpec, cfg: ModelConfig, cross: bool = False):
    """One block's params; ``cross`` adds the enc-dec decoder's
    cross-attention (``cross_norm``, ``cross``) between the mixer and the
    FFN."""
    d, dt = cfg.d_model, cfg.torch_param_dtype()
    ni = _norm_init(cfg)
    p: dict[str, Any] = {"norm1": ni(gen, d, dt)}
    if spec.mixer in ATTN_MIXERS:
        p["attn"] = A.init_attention(gen, cfg)
    elif spec.mixer in _REC:
        p["rec"] = _REC[spec.mixer][0](gen, cfg)
    else:
        raise ValueError(spec.mixer)
    if cross:
        p["cross_norm"] = ni(gen, d, dt)
        p["cross"] = A.init_attention(gen, cfg)
    if spec.ffn == "dense":
        p["norm2"] = ni(gen, d, dt)
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, dt, cfg.gated_mlp, False)
    elif spec.ffn == "moe":
        p["norm2"] = ni(gen, d, dt)
        p["moe"] = M.init_moe(gen, cfg)
    elif spec.ffn != "none":
        raise ValueError(spec.ffn)
    if cfg.post_norm:
        p["postnorm1"] = ni(gen, d, dt)
        if spec.ffn != "none":
            p["postnorm2"] = ni(gen, d, dt)
    return p


def _norm(cfg: ModelConfig, params, x, perturb=None):
    fn = L.rmsnorm if cfg.norm == "rmsnorm" else L.layernorm
    return L.norm_apply(fn, params, x, perturb)


def _halves(t, n, axis=0):
    """The clean and perturbed halves of ``t`` on ``axis`` when its
    length there is the dual batch ``n``; else ``t`` for both."""
    if t is None or t.shape[axis] != n:
        return t, t
    return t.narrow(axis, 0, n // 2), t.narrow(axis, n // 2, n - n // 2)


def _block_places(params, spec: LayerSpec, cfg: ModelConfig, rules):
    """The placements of one block's leaves (one layer of its segment's
    stacked leaves) under ``rules``' mesh; None without one."""
    if rules is None or rules.mesh is None:
        return None
    return tree_map(lambda r: rules.sharding_for(tuple(r.shape), r.axes),
                    init_block(L.RULES, spec, cfg, "cross" in params))


def _block_fallback(params, x, spec: LayerSpec, cfg: ModelConfig, perturb,
                    positions=None, enc_out=None, rules=None):
    """Whole-block fallback for blocks without a fused kernel lowering
    (recurrent mixers, MoE FFNs, cross-attention): materialise theta +
    mu*U for the block's seeded leaves and run the unmodified block on
    it.  The noise is the same per-leaf hash stream, so replay stays
    exact; under ``rules``' mesh each slab leaf takes its part of the
    global field (still one K1 launch for the block).  Dual mode runs the
    clean params on the first half of the batch and the perturbed ones
    on the second, as two blocks (so an MoE's capacity is each half's;
    on a mesh each rank's halves are its slabs of the global halves); the
    positions split on their batch axis (dim 0 of (B, S) ids, dim 1 of
    (3, B, S) M-RoPE ids)."""
    pp = O.perturb_tree(params, perturb.seeds, perturb.mu, perturb.rep,
                        places=_block_places(params, spec, cfg, rules))
    if not perturb.dual:
        return apply_block(pp, x, spec, cfg, positions=positions,
                           enc_out=enc_out, rules=rules)
    n = x.shape[0]
    pos = _halves(positions, n, -2)
    enc = _halves(enc_out, n)
    return torch.cat([
        apply_block(params, x[:n // 2], spec, cfg, positions=pos[0],
                    enc_out=enc[0], rules=rules)[0],
        apply_block(pp, x[n // 2:], spec, cfg, positions=pos[1],
                    enc_out=enc[1], rules=rules)[0]], dim=0), None


def apply_block(params, x, spec: LayerSpec, cfg: ModelConfig, *,
                positions=None, cache=None, decode=False, live=None,
                enc_out=None, perturb=None, rules=None):
    """Returns ``(x, cache)``: the block's cache (``{"attn": ...}`` or
    ``{"rec": ...}``, written in place by a prefill or a decode step) or
    None without one.  ``enc_out`` (B, S_enc, d): the encoder output a
    decoder block's cross-attention attends.  ``rules``: the mesh's
    (tensor-parallel attention, MLP and recurrent mixers under a model
    axis, the expert-parallel MoE)."""
    if perturb is not None and not O.any_seed(perturb.seeds):
        perturb = None
    if perturb is not None and (spec.mixer not in ATTN_MIXERS
                                or spec.ffn == "moe"
                                or ("cross" in params
                                    and enc_out is not None)):
        return _block_fallback(params, x, spec, cfg, perturb, positions,
                               enc_out, rules)
    h = _norm(cfg, params["norm1"], x, O.psub(perturb, "norm1"))
    if spec.mixer in ATTN_MIXERS:
        o, _ = A.attention_layer(
            params["attn"], h, cfg, positions=positions,
            local=(spec.mixer == "local_attn"),
            cache=None if cache is None else cache["attn"], decode=decode,
            live=live, perturb=O.psub(perturb, "attn"), rules=rules)
    else:
        o, _ = _REC[spec.mixer][1](params["rec"], h, cfg,
                                   None if cache is None else cache["rec"],
                                   decode=decode, live=live, rules=rules)
    if cfg.post_norm:
        o = _norm(cfg, params["postnorm1"], o, O.psub(perturb, "postnorm1"))
    x = x + o
    if "cross" in params and enc_out is not None:
        x = x + _cross_attention(params, x, cfg, enc_out, rules)
    if spec.ffn == "none":
        return _constrain_hidden(x, cfg, rules), cache
    h = _norm(cfg, params["norm2"], x, O.psub(perturb, "norm2"))
    if spec.ffn == "dense":
        o = L.mlp(params["mlp"], h, cfg.activation,
                  cfg.torch_compute_dtype(), O.psub(perturb, "mlp"),
                  rules=rules, d_ff=cfg.d_ff)
    else:
        o = M.moe_ffn(params["moe"], h, cfg, rules)
    if cfg.post_norm:
        o = _norm(cfg, params["postnorm2"], o, O.psub(perturb, "postnorm2"))
    return _constrain_hidden(x + o, cfg, rules), cache


def _constrain_hidden(x, cfg: ModelConfig, rules):
    """The reference's constraint on the residual stream: the batch on
    the data axes, d_model whole on every rank."""
    if rules is None:
        return x
    return SH.constrain(x, rules, ("batch", None, None),
                        (None, None, cfg.d_model))


def _cross_attention(params, x, cfg: ModelConfig, enc_out, rules=None):
    """The decoder block's cross sub-block: its norm, then attention of
    x's queries over k / v projected from ``enc_out`` (under ``rules``'
    model axis the rank's heads)."""
    o, _ = A.attention_layer(params["cross"],
                             _norm(cfg, params["cross_norm"], x), cfg,
                             kv_x=enc_out, rules=rules)
    return o


def init_block_cache(spec: LayerSpec, cfg: ModelConfig, batch: int,
                     seq: int, per_slot: bool = False, device="cpu",
                     rules=None):
    """A block's zeroed cache; under ``rules`` what the block reads on
    this rank (its kv heads, its recurrent state's channels or heads)."""
    if spec.mixer in ATTN_MIXERS:
        return {"attn": A.init_kv_cache(cfg, batch, seq,
                                        local=(spec.mixer == "local_attn"),
                                        per_slot=per_slot, device=device,
                                        rules=rules)}
    return {"rec": _REC[spec.mixer][2](cfg, batch, device, rules=rules)}


# ---------------------------------------------------------------------------
# pattern-compressed stacks
# ---------------------------------------------------------------------------

def build_segments(specs: Sequence[LayerSpec]):
    """Greedy compression of a spec list into (unit, repeats) segments."""
    specs = list(specs)
    segments: list[tuple[tuple[LayerSpec, ...], int]] = []
    i = 0
    n = len(specs)
    while i < n:
        best = ((specs[i],), 1)
        for ul in range(1, min(8, n - i) + 1):
            unit = tuple(specs[i:i + ul])
            reps = 1
            j = i + ul
            while j + ul <= n and tuple(specs[j:j + ul]) == unit:
                reps += 1
                j += ul
            if reps * ul > best[1] * len(best[0]):
                best = (unit, reps)
        segments.append(best)
        i += len(best[0]) * best[1]
    return segments


def init_stack(gen, cfg: ModelConfig, specs: Sequence[LayerSpec],
               cross: bool = False):
    """A list of segment params, each a tuple (per unit position) of
    block-param trees with a stacked leading 'layers' dim."""
    out = []
    for unit, reps in build_segments(specs):
        per_rep = [tuple(init_block(gen, spec, cfg, cross) for spec in unit)
                   for _ in range(reps)]
        out.append(tree_map(lambda *xs: L.stack_leaves(xs), *per_rep))
    return out


def init_stack_cache(cfg: ModelConfig, specs: Sequence[LayerSpec],
                     batch: int, seq: int, per_slot: bool = False,
                     device="cpu", rules=None):
    """Per segment, a tuple (per unit position) of block caches whose
    leaves carry a leading ``reps`` axis, as the segment's params do
    (each block's under ``rules``: :func:`init_block_cache`)."""
    out = []
    for unit, reps in build_segments(specs):
        one = tuple(init_block_cache(spec, cfg, batch, seq, per_slot, device,
                                     rules) for spec in unit)
        out.append(tree_map(
            lambda t: t[None].repeat((reps,) + (1,) * t.dim()), one))
    return out


def _apply_rep(x, unit, params_rep, cache_rep, seg_seeds, r, cfg, perturb,
               kw):
    """Rep ``r`` of a segment's ``unit``: its blocks in order."""
    for j, spec in enumerate(unit):
        pj = None
        if seg_seeds is not None and O.any_seed(seg_seeds[j]):
            pj = dataclasses.replace(perturb, seeds=seg_seeds[j], rep=r)
        x, _ = apply_block(params_rep[j], x, spec, cfg,
                           cache=None if cache_rep is None else cache_rep[j],
                           perturb=pj, **kw)
    return x


def apply_stack(stack_params, x, cfg: ModelConfig,
                specs: Sequence[LayerSpec], *, positions=None, caches=None,
                decode=False, live=None, enc_out=None, perturb=None,
                rules=None):
    """Returns ``(x, caches)``; the caches (``init_stack_cache``'s
    layout) are written in place, rep r through its views ``c[r]``.
    ``perturb.seeds`` (if given) is a list mirroring ``stack_params``: one
    seed per stacked leaf; rep r runs with ``Perturb.rep = r``.

    With ``cfg.remat``, outside decode, without caches and where autograd
    records (a first-order forward), each rep of a segment's unit runs
    under a non-reentrant ``torch.utils.checkpoint``, as the reference
    wraps its scan body in ``jax.checkpoint``: the backward recomputes
    the rep's forward from its input.  The params reach the rep nested in
    lists and dicts, which only the non-reentrant variant differentiates.
    No block draws from a global generator, so no RNG state is stashed."""
    remat = (cfg.remat and not decode and caches is None
             and torch.is_grad_enabled())
    kw = dict(positions=positions, decode=decode, live=live,
              enc_out=enc_out, rules=rules)
    for si, (unit, reps) in enumerate(build_segments(specs)):
        seg_params = stack_params[si]
        seg_seeds = perturb.seeds[si] if perturb is not None else None
        for r in range(reps):
            args = (x, unit, tree_map(lambda p: p[r], seg_params),
                    None if caches is None
                    else tree_map(lambda c: c[r], caches[si]),
                    seg_seeds, r, cfg, perturb, kw)
            x = (torch.utils.checkpoint.checkpoint(
                _apply_rep, *args, use_reentrant=False,
                preserve_rng_state=False) if remat else _apply_rep(*args))
    return x, caches


# ---------------------------------------------------------------------------
# full language model with SFL split structure
# ---------------------------------------------------------------------------

def client_specs(cfg: ModelConfig):
    """The client's blocks: the first ``cut_layers`` of the stack (of the
    encoder's, for an enc-dec)."""
    specs = cfg.layer_specs()
    if cfg.enc_dec:
        specs = specs[: cfg.n_enc_layers]
    return specs[: cfg.cut_layers]


def server_specs(cfg: ModelConfig):
    """The server's blocks of the stack (the rest of the encoder, for an
    enc-dec; its decoder is :func:`decoder_specs`)."""
    if cfg.enc_dec:
        return cfg.layer_specs()[cfg.cut_layers: cfg.n_enc_layers]
    return cfg.layer_specs()[cfg.cut_layers:]


def decoder_specs(cfg: ModelConfig):
    """enc-dec only: the decoder stack (server side)."""
    return cfg.layer_specs()[cfg.n_enc_layers:]


def aux_specs(cfg: ModelConfig):
    return tuple(cfg.layer_specs()[cfg.cut_layers:
                                   cfg.cut_layers + cfg.aux_layers])


def init_lm(cfg: ModelConfig, seed: int = 0, device="cuda",
            draw_on_device: bool = False, key=None):
    """``{"client": ..., "server": ...}`` from a seeded random init.

    client = embedding + first ``cut_layers`` blocks + aux head
    server = remaining blocks + final norm (+ unembed when untied; + the
             decoder's embedding ``dec_embed`` and its cross-attended
             stack ``decoder`` for an enc-dec)

    By default the draws come from a CPU generator and then move to
    ``device``, so one seed gives the same params on every device.
    ``draw_on_device=True`` draws on ``device``'s own generator instead:
    other values for the same seed, but billions of params in seconds.
    ``key`` (a PRNG key, :mod:`repro_torch.core.prng`) draws the JAX
    package's init instead, ``repro.models.transformer.init_lm(key,
    cfg)``, on ``device``: the port's tree, each leaf drawn as the JAX
    package's ``ParamBuilder`` draws it at its init path
    (:func:`repro_torch.models.layers.jax_init_leaf`).  On the ``meta``
    device the leaves have shapes and dtypes alone.
    """
    dev = resolve_device(device)
    if key is not None:
        return _init_lm_like_jax(cfg, key, dev)
    gen = (None if dev.type == "meta" else
           torch.Generator(dev if draw_on_device else "cpu").manual_seed(seed))
    return tree_map(lambda t: t.to(dev), _lm_tree(cfg, gen))


def _lm_tree(cfg: ModelConfig, gen):
    """init_lm's tree, each leaf from ``gen`` (see
    :func:`repro_torch.models.layers.init_param`)."""
    dt = cfg.torch_param_dtype()
    client: dict[str, Any] = {
        "embed": L.init_embedding(gen, cfg.vocab_padded, cfg.d_model, dt),
        "layers": init_stack(gen, cfg, client_specs(cfg)),
        "aux": init_aux(gen, cfg),
    }
    server: dict[str, Any] = {
        "layers": init_stack(gen, cfg, server_specs(cfg)),
        "final_norm": _norm_init(cfg)(gen, cfg.d_model, dt),
    }
    if cfg.enc_dec:
        server["dec_embed"] = L.init_embedding(gen, cfg.vocab_padded,
                                               cfg.d_model, dt)
        server["decoder"] = init_stack(gen, cfg, decoder_specs(cfg),
                                       cross=True)
    if not cfg.tie_embeddings:
        server["unembed"] = L.init_param(gen, (cfg.d_model, cfg.vocab_padded),
                                         dt, "normal", 0.02,
                                         axes=("d_model", "vocab"))
    return {"client": client, "server": server}


def _global_shape(rule: L.InitRule):
    return ((rule.reps,) if rule.reps else ()) + tuple(rule.shape)


def param_axes(cfg: ModelConfig):
    """The logical axes of every leaf of :func:`init_lm`'s tree (each a
    :class:`repro_torch.distributed.sharding.Logical`), as the
    reference's ``init_lm(None, cfg, mode="axes")``: a stacked leaf's
    leading dim is ``"layers"``."""
    return tree_map(lambda r: SH.Logical(("layers",) * (r.reps > 0)
                                         + r.axes), _lm_tree(cfg, L.RULES))


def param_shardings(cfg: ModelConfig, rules):
    """The placement of every leaf of :func:`init_lm`'s tree on this rank
    (``rules.sharding_for`` of its global shape and :func:`param_axes`);
    None without a mesh."""
    if rules is None or rules.mesh is None:
        return None
    return tree_map(lambda r: rules.sharding_for(
        _global_shape(r), ("layers",) * (r.reps > 0) + r.axes),
        _lm_tree(cfg, L.RULES))


def _jax_init_path(part: str, path: str, rep: int) -> str:
    """The JAX package's init path of the port's leaf ``part/path`` (rep
    ``rep`` of a stacked leaf): a stack's ``layers/<seg>/<pos>/...`` is
    ``<stack>.seg<seg>.rep<rep>.pos<pos>....``, the client's stack
    ``client``, the aux head's ``aux``, the server's ``server``, the
    enc-dec's ``decoder``."""
    keys = path.split("/")
    if keys[0] == "aux" and keys[1] == "layers":
        stack, keys = "aux", keys[1:]
    elif keys[0] == "layers":
        stack = part
    elif keys[0] == "decoder":
        stack = "decoder"
    else:
        return ".".join(keys)
    seg, pos, rest = keys[1], keys[2], keys[3:]
    return ".".join([stack, f"seg{seg}", f"rep{rep}", f"pos{pos}", *rest])


def _init_lm_like_jax(cfg: ModelConfig, key, device="cuda"):
    """``init_lm(cfg, key=key)``: the tree's init rules (the layers' init
    functions given ``L.RULES``), each leaf drawn on ``device`` at its JAX
    init path, a stacked leaf rep by rep."""
    def leaf(part):
        def draw(path, rule):
            if not rule.reps:
                return L.jax_init_leaf(key, _jax_init_path(part, path, 0),
                                       rule, device)
            return torch.stack([L.jax_init_leaf(
                key, _jax_init_path(part, path, r), rule, device)
                for r in range(rule.reps)])
        return draw

    rules = _lm_tree(cfg, L.RULES)
    return {part: tree_map_with_path(leaf(part), rules[part])
            for part in ("client", "server")}


def init_aux(gen, cfg: ModelConfig):
    """Aux head: optional extra blocks + norm + (tied) unembed."""
    p: dict[str, Any] = {"norm": _norm_init(cfg)(gen, cfg.d_model,
                                                 cfg.torch_param_dtype())}
    if cfg.aux_layers > 0:
        p["layers"] = init_stack(gen, cfg, aux_specs(cfg))
    return p


def _embed_scale(cfg: ModelConfig, x):
    """gemma / recurrentgemma scale the embedding by sqrt(d_model), the
    constant rounded to the compute dtype first as in the JAX package."""
    if cfg.name.startswith("gemma") or cfg.name.startswith("recurrentgemma"):
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))
    return x


def _vocab_v0(cfg: ModelConfig, rules):
    """The first global vocab row of this rank's slab of a (vocab_padded,
    d_model) table (the client's ``embed``, the enc-dec's ``dec_embed``)
    and column of the untied unembedding, or None where the rules leave
    the vocab whole."""
    pl = None if rules is None else rules.sharding_for(
        (cfg.vocab_padded, cfg.d_model), ("vocab", "d_model"))
    return pl.bounds[0][0] if pl is not None and pl.sharded else None


def _lookup(embed_params, ids, cfg: ModelConfig, rules=None):
    """Rows ``ids`` of an embedding table (``{"table"}``, the client's
    ``embed`` or the enc-dec's ``dec_embed``) in the compute dtype,
    vocab-parallel where the rules split it."""
    cdt = cfg.torch_compute_dtype()
    v0 = _vocab_v0(cfg, rules)
    if v0 is not None:
        return TP.vocab_embed(embed_params["table"].to(cdt), ids, v0,
                              rules.mesh)
    return L.embed(embed_params, ids, cdt)


def _embed(client_params, cfg: ModelConfig, inputs, rules=None):
    """Token ids through the embedding table (vocab-parallel where the
    rules split it); float inputs (the vision / audio frontend stub's
    patch or frame embeddings) cast to the compute dtype."""
    if inputs.is_floating_point():
        return inputs.to(cfg.torch_compute_dtype())
    return _lookup(client_params["embed"], inputs, cfg, rules)


def embed_inputs(client_params, cfg: ModelConfig, inputs, rules=None):
    return _embed_scale(cfg, _embed(client_params, cfg, inputs, rules))


def _embed_perturbed(client_params, cfg: ModelConfig, inputs, perturb,
                     rules=None):
    """The embedding with the ZO table perturbation.  The noise rows are
    gathered per token id (kernel K1's gathered mode on the card), never
    materializing the (vocab, d_model) field.  In dual mode returns the
    stacked [clean; perturbed] embedding on a doubled batch axis.  Float
    inputs (a frontend stub's) read no table: both halves are the input,
    and the table's seed acts only through the aux head's tied
    unembedding."""
    x = xp = _embed(client_params, cfg, inputs, rules)
    pe = O.psub(perturb, "embed")
    st = None if pe is None else pe.seeds.get("table")
    if st is not None and not inputs.is_floating_point():
        u = O.zo_noise_rows(st, inputs, x.shape[-1])
        xp = (x.to(torch.float32) + float(perturb.mu) * u).to(x.dtype)
    return _embed_scale(cfg, torch.cat([x, xp], dim=0) if perturb.dual
                        else xp)


def dual_positions(positions):
    """Position ids for the dual probe's [clean; perturbed] batch: the
    ids twice on their batch axis, dim 0 of (B, S) and dim 1 of (3, B, S)
    M-RoPE ids.  (The reference concatenates on axis 0, which for M-RoPE
    ids is the t / h / w axis.)"""
    if positions is None:
        return None
    return torch.cat([positions, positions], dim=positions.dim() - 2)


def client_forward(client_params, cfg: ModelConfig, inputs, positions=None,
                   perturb=None, rules=None):
    """Embedding + client blocks -> smashed data (cut-layer activations).
    With ``perturb`` the forward is ZO-perturbed; ``perturb.dual`` rides
    the clean and perturbed probes on one pass over a doubled batch
    axis, the positions doubled on theirs (:func:`dual_positions`)."""
    if perturb is not None and not O.any_seed(perturb.seeds):
        perturb = None
    if perturb is None:
        x = embed_inputs(client_params, cfg, inputs, rules)
    else:
        x = _embed_perturbed(client_params, cfg, inputs, perturb, rules)
        if perturb.dual:
            positions = dual_positions(positions)
    x = _constrain_hidden(x, cfg, rules)
    return apply_stack(client_params["layers"], x, cfg, client_specs(cfg),
                       positions=positions,
                       perturb=O.psub(perturb, "layers"), rules=rules)[0]


def _unembed(x, table_t, cfg: ModelConfig, rules):
    """f32 logits ``x @ table_t`` (table_t (d_model, vocab) or its
    column slab, f32), ``x`` entering a vocab-parallel product through
    ``copy_to``; constrained to the vocab slab the rules give."""
    if _vocab_v0(cfg, rules) is not None:
        x = TP.copy_to(x, rules.mesh)
    logits = x.to(torch.float32) @ table_t
    if rules is not None:
        logits = SH.constrain(logits, rules, ("batch", None, "vocab"),
                              (None, None, cfg.vocab_padded))
    return logits


def aux_forward(client_params, cfg: ModelConfig, smashed, positions=None,
                perturb=None, rules=None):
    """Aux head on smashed data -> logits (the client-local predictor).
    With ``perturb`` the tied unembedding perturbs the table (the
    embedding's leaf and seed, its noise materialised): for the second
    half of the stack in dual mode, for the whole batch otherwise."""
    if perturb is not None and not O.any_seed(perturb.seeds):
        perturb = None
    aux = client_params["aux"]
    pa = O.psub(perturb, "aux")
    x = smashed
    if "layers" in aux:
        x, _ = apply_stack(aux["layers"], x, cfg, aux_specs(cfg),
                           positions=positions, perturb=O.psub(pa, "layers"),
                           rules=rules)
    x = _norm(cfg, aux["norm"], x, O.psub(pa, "norm"))
    pe = O.psub(perturb, "embed")
    st = None if pe is None else pe.seeds.get("table")
    if st is None and rules is None:
        logits = L.unembed(client_params["embed"], x, torch.float32)
    elif st is None:
        logits = _unembed(x, client_params["embed"]["table"].to(
            torch.float32).T, cfg, rules)
    else:
        table = client_params["embed"]["table"].to(torch.float32)
        v0 = _vocab_v0(cfg, rules)
        tp = O.perturb_tree(table, st, perturb.mu, win=None if v0 is None
                            else O.Window(cfg.vocab_padded, v0))
        if perturb.dual:
            half = x.shape[0] // 2
            logits = torch.cat([_unembed(x[:half], table.T, cfg, rules),
                                _unembed(x[half:], tp.T, cfg, rules)], dim=0)
        else:
            logits = _unembed(x, tp.T, cfg, rules)
    return L.softcap(logits, cfg.final_softcap)


def lm_head(params, cfg: ModelConfig, x, rules=None):
    """The final norm, the (tied or untied) unembedding in f32 and the
    final soft-cap: hidden states -> logits (vocab-parallel where the
    rules split the vocab)."""
    server = params["server"]
    x = _norm(cfg, server["final_norm"], x)
    if rules is None and cfg.tie_embeddings:
        logits = L.unembed(params["client"]["embed"], x, torch.float32)
    elif rules is None:
        logits = x.to(torch.float32) @ server["unembed"].to(torch.float32)
    else:
        table_t = (params["client"]["embed"]["table"].T
                   if cfg.tie_embeddings else server["unembed"])
        logits = _unembed(x, table_t.to(torch.float32), cfg, rules)
    return L.softcap(logits, cfg.final_softcap)


def server_forward(params, cfg: ModelConfig, smashed, positions=None,
                   dec_tokens=None, dec_positions=None, rules=None):
    """Server blocks on smashed data -> logits.  An enc-dec's server ends
    its encoder with the final norm, then runs the decoder on
    ``dec_tokens`` cross-attending that output; the same final norm ends
    the decoder."""
    server = params["server"]
    x, _ = apply_stack(server["layers"], smashed, cfg, server_specs(cfg),
                       positions=positions, rules=rules)
    if cfg.enc_dec:
        x = decoder_forward(params, cfg, dec_tokens,
                            _norm(cfg, server["final_norm"], x),
                            positions=dec_positions, rules=rules)
    return lm_head(params, cfg, x, rules)


def decoder_forward(params, cfg: ModelConfig, tokens, enc_out,
                    positions=None, caches=None, decode=False, live=None,
                    rules=None):
    """The enc-dec's decoder on ``tokens``, its blocks cross-attending
    ``enc_out`` -> hidden states before the head; with ``caches`` (its
    stack's, written in place) a prefill or, with ``decode``, a step.
    Under ``rules``' mesh ``dec_embed`` is vocab-parallel where they
    split it and the blocks tensor-parallel, as the encoder's."""
    server = params["server"]
    y = _lookup(server["dec_embed"], tokens, cfg, rules)
    return apply_stack(server["decoder"], y, cfg, decoder_specs(cfg),
                       positions=positions, caches=caches, decode=decode,
                       live=live, enc_out=enc_out, rules=rules)[0]


def full_forward(params, cfg: ModelConfig, inputs, positions=None,
                 dec_tokens=None, rules=None):
    """Whole-model forward (client blocks, then server blocks; no aux
    head) -> logits; an enc-dec's decoder runs on ``dec_tokens`` at
    ``positions``.  Under ``rules``' mesh every block is the rank's
    slab, as in training, and the logits are its vocab slab."""
    smashed = client_forward(params["client"], cfg, inputs, positions,
                             rules=rules)
    return server_forward(params, cfg, smashed, positions, dec_tokens,
                          positions if cfg.enc_dec else None, rules=rules)


def lm_loss(logits, labels, vocab: int, rules=None, width=None):
    """Mean next-token cross entropy; labels == -100 are masked; the
    padded vocab tail is excluded from the softmax.  Under ``rules``'
    mesh: logits whose global ``width`` (by default their own) the rules
    split on the model axis take the vocab-parallel cross entropy, and
    the sums and counts are reduced over the data group, so the loss is
    the mean of the global batch on every rank."""
    mesh = None if rules is None else rules.mesh
    pl = None if mesh is None else rules.sharding_for(
        (width or logits.shape[-1],), ("vocab",))
    if pl is not None and pl.sharded:
        tot, cnt = TP.vocab_cross_entropy(logits, labels, vocab,
                                          pl.bounds[0][0], mesh)
    else:
        V = logits.shape[-1]
        if V > vocab:
            mask = torch.where(torch.arange(V, device=logits.device)
                               >= vocab, -1e30, 0.0).to(logits.dtype)
            logits = logits + mask
        valid = labels != -100
        labels_safe = torch.where(valid, labels, torch.zeros_like(labels))
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, labels_safe[..., None].long())[..., 0]
        tot, cnt = -torch.sum(ll * valid), torch.sum(valid)
    if mesh is not None:
        tot = TP.reduce_from(tot, mesh, "data")
        cnt = TP.reduce_from(cnt.to(tot.dtype), mesh, "data")
    return tot / torch.clamp(cnt, min=1)
