"""The serving cases of the mesh spawns (not a test module; imported by
``torch_train_mesh_ranks.run_rank`` in each spawned process, so it
imports ``repro_torch`` and nothing of JAX or :mod:`repro`).  Each rank
runs the sharded case and the unsharded one on the same inputs and
writes ``serve|...`` entries into the rank's results:

* ``serve|engine|<tag>|...``: ``DecodeEngine(rules=)`` on the rank's
  slabs (``bridge.from_jax`` of the params with their placements) and
  the unsharded engine, over ``torch_serve_mesh_cases``' queue: both
  greedy streams, and the logits the sampler read along them, call by
  call (teacher-forced: both engines fed the same tokens up to the
  first call whose tokens differ) held at ``PREFILL_TOL``
  (``XLSTM_FLOOR`` x max |logits| for xlstm);
* ``serve|s2s|...``: seamless-m4t-medium's token loop
  (``launch/serve.enc_dec_stream(rules=)``) likewise;
* ``serve|step|...`` (world 4): gpt2-tiny's cached prefill and two serve
  steps on (2, 2), each's logits the (batch rows, vocab columns) slab of
  the unsharded ones';
* ``serve|moe1|...``: one MoE layer at one token a row on the mesh
  against the unsharded layer, with the dropped entries of both;
* ``serve|rec|...`` / ``serve|attn|...``: each recurrent mixer and the
  attention layer, a block prefill into a fresh state / cache and then
  one decode step (one slot not live), on the rank's slabs against the
  whole layer: the output and the state / cache slab.

A case that raises writes its traceback as its failure, so one broken
case does not hide the others.
"""
import contextlib
import dataclasses
import traceback

import numpy as np
import torch

import torch_serve_mesh_cases as SC
from repro_torch.bridge import from_jax, to_numpy
from repro_torch.configs.gpt2 import gpt2_tiny
from repro_torch.configs.registry import get_config
from repro_torch.core import decode as D
from repro_torch.core import prng as R
from repro_torch.core import protocols as P
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.mesh import make_local_mesh
from repro_torch.launch import serve as SERVE
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import recurrent as REC
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_map

# the same bars as the sharded prefill and the mixers on their slabs
# (torch_train_mesh_ranks)
PREFILL_TOL = dict(rtol=2e-5, atol=2e-5)
XLSTM_FLOOR = 1e-4
LAYER_RTOL, LAYER_ATOL = 1e-5, 4e-6


def _rules(mp):
    return SH.AxisRules(mesh=make_local_mesh(mp), enable_fsdp=False)


def _guarded(out, key, fn):
    """``out[key]``: the failures ``fn()`` returns, or its traceback."""
    try:
        fails = fn()
    except Exception:  # noqa: BLE001 (a case's error is its failure)
        fails = [traceback.format_exc()[-3000:]]
    out[key] = np.array("\n".join(fails))


def _close(got, want):
    return torch.allclose(got, want, rtol=LAYER_RTOL,
                          atol=LAYER_ATOL * float(want.abs().max()))


@contextlib.contextmanager
def recording_sampler():
    """Every ``decode.sample_logits`` call's logits (whole vocab, f32)
    and the tokens it drew, in call order."""
    calls, sample = [], D.sample_logits

    def rec(logits, keys, sampler):
        tok = sample(logits, keys, sampler)
        calls.append((logits.clone(), tok.clone()))
        return tok

    D.sample_logits = rec
    try:
        yield calls
    finally:
        D.sample_logits = sample


def logits_along(got, want, xlstm):
    """The logits two runs' samplers read, call by call, up to and
    including the first call whose drawn tokens differ: the failures."""
    fails = []
    if len(got) != len(want):
        fails.append(f"{len(got)} sampler calls, unsharded {len(want)}")
    for i, ((lg, tg), (lw, tw)) in enumerate(zip(got, want)):
        tol = (dict(rtol=0.0, atol=XLSTM_FLOOR * float(lw.abs().max()))
               if xlstm else PREFILL_TOL)
        if lg.shape != lw.shape or not torch.allclose(lg, lw, **tol):
            err = ((lg - lw).abs().max() if lg.shape == lw.shape
                   else tuple(lg.shape))
            fails.append(f"logits of sampler call {i}: {err}")
            break
        if not torch.equal(tg, tw):
            fails.append(f"sampler call {i}: tokens {tg.tolist()} vs "
                         f"{tw.tolist()} on logits within the bar (a "
                         "near tie)")
            break
    return fails


def _config(arch, cf=None):
    cfg = get_config(arch, smoke=True)
    if cf is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=cf))
    return cfg


def _params(cfg, rules):
    """The port's ``init_lm(key=PRNGKey(0))`` whole, and its slabs
    through the bridge."""
    full = T.init_lm(cfg, device="cpu", key=R.PRNGKey(0))
    return full, from_jax(to_numpy(full), "cpu",
                          T.param_shardings(cfg, rules))


def engine_case(tag, arch, mp, cf, out):
    def run():
        cfg, rules = _config(arch, cf), _rules(mp)
        full, slab = _params(cfg, rules)
        prompts = SC.prompts(cfg.vocab)
        res = {}
        for name, params, r in (("full", full, None), ("mesh", slab, rules)):
            eng = D.DecodeEngine(params, cfg, slots=SC.SLOTS,
                                 capacity=SC.CAPACITY,
                                 segment_len=SC.SEGMENT, device="cpu",
                                 rules=r)
            with recording_sampler() as calls:
                rids = [eng.submit(p, m) for p, (_, m) in
                        zip(prompts, SC.QUEUE)]
                streams = eng.run()
            res[name] = ([streams[i] for i in rids], calls)
            out[f"serve|engine|{tag}|{name}"] = SC.pad_streams(res[name][0])
        return logits_along(res["mesh"][1], res["full"][1],
                            cfg.family == "ssm")
    _guarded(out, f"serve|engine|{tag}|fail", run)


def s2s_case(out):
    def run():
        arch, batch, prompt_len, max_new = SC.S2S
        cfg, rules = _config(arch), _rules(2)
        full, slab = _params(cfg, rules)
        res = {}
        for name, params, r in (("full", full, None), ("mesh", slab, rules)):
            with recording_sampler() as calls:
                toks, _, _ = SERVE.enc_dec_stream(
                    params, cfg, batch, prompt_len, max_new,
                    D.SamplerConfig(), device="cpu", rules=r)
            res[name] = calls
            out[f"serve|s2s|{name}"] = toks.numpy()
        return logits_along(res["mesh"], res["full"], False)
    _guarded(out, "serve|s2s|fail", run)


def step_case(out):
    """gpt2-tiny on (2, 2): a 4 x 6 prompt through the cached prefill,
    then two serve steps; each rank's logits against the slab of the
    unsharded ones'."""
    def run():
        cfg, rules = gpt2_tiny(), _rules(2)
        full, slab = _params(cfg, rules)
        g = np.random.default_rng(5)
        prompt = torch.as_tensor(g.integers(0, cfg.vocab, (4, 6)))
        steps = [torch.as_tensor(g.integers(0, cfg.vocab, (4, 1)))
                 for _ in range(2)]
        rows = slice(*rules.sharding_for((4,), ("batch",)).bounds[0])
        logits = {}
        for name, params, r, cut in (("full", full, None, slice(None)),
                                     ("mesh", slab, rules, rows)):
            caches = P.init_serve_caches(cfg, 4, 12, device="cpu", rules=r)
            lg, caches = P.make_cached_prefill_step(cfg, r)(
                params, caches, prompt[cut])
            got = [lg]
            serve = P.make_serve_step(cfg, r)
            for tok in steps:
                lg, caches = serve(params, caches, tok[cut])
                got.append(lg)
            logits[name] = got
        fails = []
        for i, (got, want) in enumerate(zip(logits["mesh"], logits["full"])):
            want = SH.shard(want, rules.sharding_for(
                tuple(want.shape), ("batch", None, "vocab")))
            if got.shape != want.shape:
                fails.append(f"call {i}: logits {tuple(got.shape)}, the "
                             f"slab {tuple(want.shape)}")
            elif not torch.allclose(got, want, **PREFILL_TOL):
                fails.append(f"call {i}: max err "
                             f"{float((got - want).abs().max()):.3g}")
        if logits["mesh"][0].shape[-1] * 2 != cfg.vocab_padded:
            fails.append("the logits are not a vocab slab")
        return fails
    _guarded(out, "serve|step|fail", run)


def _seeded(init, cfg, seed=0):
    """``init(gen, cfg)``'s leaves, the 1-D ones moved off their init (a
    bias or a norm read at the wrong columns shows), and the placements
    of its leaves (``init(L.RULES, cfg)``)."""
    gen = torch.Generator().manual_seed(seed)
    full = tree_map(lambda t: t + 0.1 * torch.randn(
        t.shape, generator=gen) if t.dim() == 1 else t, init(gen, cfg))
    return full, init(L.RULES, cfg)


# the MoE at one token a row: qwen3-moe's smoke layer at capacity factor
# 1.0 (16 tokens, two choices, 8 experts: each expert keeps 4 entries,
# so the capacity binds), shared experts off and on
MOE1 = [("shared0", 0), ("shared1", 1)]


def moe_one_token_case(out):
    """``moe_ffn`` on a (16, 1, d) input: on the (1, 2) mesh's expert slabs
    against the unsharded layer, the dropped entries of both."""
    rules = _rules(2)
    for tag, shared in MOE1:
        def run():
            cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, capacity_factor=1.0, n_shared_experts=shared))
            full, rule = _seeded(M.init_moe, cfg, seed=shared)
            places = tree_map(lambda r: rules.sharding_for(
                tuple(r.shape), r.axes), rule)
            x = torch.as_tensor(np.random.default_rng(9).standard_normal(
                (16, 1, cfg.d_model)).astype(np.float32))
            with M.recording_drops() as want_drops:
                want = M.moe_ffn(full, x, cfg)
            with M.recording_drops() as got_drops:
                got = M.moe_ffn(tree_map(SH.shard, full, places), x, cfg,
                                rules)
            out[f"serve|moe1|{tag}|drops"] = np.array(
                [sum(got_drops), sum(want_drops)])
            return [] if _close(got, want) else [
                f"out: max err {float((got - want).abs().max()):.3g}"]
        _guarded(out, f"serve|moe1|{tag}|fail", run)


_MIXERS = {"rg_lru": ("recurrentgemma-9b", REC.init_rg_lru,
                      REC.rg_lru_block, REC.init_rg_lru_state),
           "mlstm": ("xlstm-1.3b", REC.init_mlstm, REC.mlstm_block,
                     REC.init_mlstm_state),
           "slstm": ("xlstm-1.3b", REC.init_slstm, REC.slstm_block,
                     REC.init_slstm_state)}


def _state_slab(mixer, cfg, rules, state):
    """The rank's slab of a whole state: the RG-LRU's "lru" channels, the
    mLSTM's heads and conv channels, the whole sLSTM state."""
    if mixer == "rg_lru":
        w = cfg.lru_width or cfg.d_model
        tp = L.DenseTP.of(rules, (cfg.d_model, w), ("d_model", "lru"))
        n = w // rules.mesh.shape["model"]
        return {k: t[..., tp.col0:tp.col0 + n] for k, t in state.items()}
    if mixer == "mlstm":
        *_, c0, dn = REC._mlstm_layout(cfg, rules)
        dh = cfg.d_model // cfg.n_heads
        h0, hn = c0 // dh, dn // dh
        C, n, m = state["cell"]
        return {"cell": (C[:, h0:h0 + hn], n[:, h0:h0 + hn],
                         m[:, h0:h0 + hn]),
                "conv": state["conv"][..., c0:c0 + dn]}
    return state


def _prefill_then_decode(block, params, cfg, state, rules, x, x1, live):
    """A block prefill of ``x`` into ``state``, its output and a copy of
    the state it wrote, then one decode step of ``x1`` with ``live``."""
    with torch.no_grad():
        y, _ = block(params, x, cfg, state=state, rules=rules)
        after = tree_map(torch.clone, state)
        y1, _ = block(params, x1, cfg, state=state, decode=True, live=live,
                      rules=rules)
    return (y, after), (y1, state)


def _held(fails, what, got, want):
    """Each leaf of ``got`` against ``want``'s: its shape, and its values
    at the layer bars (integer leaves, the positions, exactly)."""
    for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        if g.shape != w.shape:
            fails.append(f"{what}[{i}]: {tuple(g.shape)}, the slab "
                         f"{tuple(w.shape)}")
        elif not (_close(g, w) if g.is_floating_point()
                  else torch.equal(g, w)):
            fails.append(f"{what}[{i}]: max err "
                         f"{float((g - w).abs().max()):.3g}")


def rec_state_cases(out):
    """Each recurrent mixer on (1, 2): a prefill of 12 tokens into a fresh
    state, then one decode step with slot 1 not live; the outputs and
    the state slabs against the whole block's (``serve|rec|<mixer>|<0 or
    1>|fail``: 0 the prefill, 1 the decode step)."""
    rules = _rules(2)
    for mixer, (arch, init, block, init_state) in _MIXERS.items():
        res = {}

        def run():
            cfg = get_config(arch, smoke=True)
            full, rule = _seeded(init, cfg)
            places = tree_map(lambda r: rules.sharding_for(
                tuple(r.shape), r.axes), rule)
            g = np.random.default_rng(4)
            x, x1 = (torch.as_tensor(g.standard_normal(
                (2, s, cfg.d_model)).astype(np.float32)) for s in (12, 1))
            live = torch.tensor([True, False])
            res["want"] = _prefill_then_decode(
                block, full, cfg, init_state(cfg, 2), None, x, x1, live)
            res["got"] = _prefill_then_decode(
                block, tree_map(SH.shard, full, places), cfg,
                init_state(cfg, 2, rules=rules), rules, x, x1, live)
            for k in (0, 1):
                (y, st), (yw, sw) = res["got"][k], res["want"][k]
                fails = [] if _close(y, yw) else ["out"]
                _held(fails, "state", st, _state_slab(mixer, cfg, rules, sw))
                out[f"serve|rec|{mixer}|{k}|fail"] = np.array(
                    "\n".join(fails))
            return []
        _guarded(out, f"serve|rec|{mixer}|error", run)


# the attention layer's caches on (1, 2): (config, local): qwen2-1.5b's
# two kv heads (one a rank), recurrentgemma's one kv head under four q
# heads on a ring of its window 8 (narrowed to the rank's GQA group; the
# 12-token prompt wraps the ring), seamless's four
ATTN_CASES = [("qwen2-1.5b", False), ("recurrentgemma-9b", True),
              ("seamless-m4t-medium", False)]


def attn_cache_cases(out):
    """The attention layer on (1, 2): a prefill of 12 tokens into a fresh
    per-slot cache of 16, then one decode step with slot 1 not live; the
    outputs and the cache slab (``AttnTP.kv_heads`` of the whole cache)
    against the whole layer's (``serve|attn|<0 or 1>|fail``)."""
    rules = _rules(2)
    fails = {0: [], 1: []}

    def run():
        for arch, local in ATTN_CASES:
            cfg = get_config(arch, smoke=True)
            full, rule = _seeded(lambda gen, c: A.init_attention(gen, c),
                                 cfg)
            places = tree_map(lambda r: rules.sharding_for(
                tuple(r.shape), r.axes), rule)
            g = np.random.default_rng(6)
            x, x1 = (torch.as_tensor(g.standard_normal(
                (2, s, cfg.d_model)).astype(np.float32)) for s in (12, 1))
            live = torch.tensor([True, False])

            def layer(params, r):
                cache = A.init_kv_cache(cfg, 2, 16, local=local,
                                        per_slot=True, rules=r)
                with torch.no_grad():
                    y, _ = A.attention_layer(params, x, cfg, local=local,
                                             cache=cache, rules=r)
                    after = tree_map(torch.clone, cache)
                    y1, _ = A.attention_layer(params, x1, cfg, local=local,
                                              cache=cache, decode=True,
                                              live=live, rules=r)
                return (y, after), (y1, cache)

            want = layer(full, None)
            got = layer(tree_map(SH.shard, full, places), rules)
            tp = A.AttnTP.of(cfg, rules)

            def read(t):        # the kv heads of a whole cache the rank reads
                if tp.kv_local:
                    k0 = tp.kv.col0 // cfg.resolved_head_dim
                    return t[:, :, k0:k0 + tp.n_kv]
                return tp.kv_heads(t)
            for k in (0, 1):
                (y, c), (yw, cw) = got[k], want[k]
                if not _close(y, yw):
                    fails[k].append(f"{arch} out")
                _held(fails[k], f"{arch} cache",
                      [c["k"], c["v"], c["pos"]],
                      [read(cw["k"]), read(cw["v"]), cw["pos"]])
        return []
    _guarded(out, "serve|attn|error", run)
    for k in (0, 1):
        out[f"serve|attn|{k}|fail"] = np.array("\n".join(fails[k]))


def run_cases(out, world):
    """Every serving case of a spawn of ``world`` ranks."""
    for tag, arch, mp, cf in SC.ENGINES[world]:
        engine_case(tag, arch, mp, cf, out)
    if world == 4:
        step_case(out)
        return
    s2s_case(out)
    moe_one_token_case(out)
    rec_state_cases(out)
    attn_cache_cases(out)
