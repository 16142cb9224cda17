"""The port's serving caches against the JAX package on the CPU: the
streaming causal conv, the RG-LRU block's prefill state and decode step,
the serve caches' tree, the KV-cache prefill (prefix and ring), the
decode attention, and per port arch (smoke configs, f32) the cached
block prefill and one serve step, logits and caches at ``rtol=atol=1e-5``
(the forwards' tolerance of ``test_torch_dense_configs.py``; xlstm-1.3b
at ``torch_serve_parity.XLSTM_TOL``).

The port writes its caches in place and masks the writes of finished
slots (``live``); the JAX package rebuilds the caches and freezes
finished slots with ``decode._select_live``: both must give the same
caches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_round_parity import one_torch_thread  # noqa: F401
from torch_serve_parity import (DECODER_ONLY, RULES, TOL, XLSTM_TOL,
                                assert_trees_close, jax_config)
from repro.configs import registry as JREG
from repro.core import decode as JD
from repro.core import protocols as JP
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import recurrent as JR
from repro.models import transformer as JT
from repro_torch.bridge import from_jax
from repro_torch.configs import registry as REG
from repro_torch.core import protocols as P
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import recurrent as REC

jax.config.update("jax_platform_name", "cpu")


def _rg_params(jcfg):
    pb = JL.ParamBuilder(jax.random.PRNGKey(1), "init", jnp.float32)
    jp = JR.init_rg_lru(pb, "rec", jcfg)
    return jp, from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def test_streaming_causal_conv1d_matches_jax():
    """The conv fed in three chunks with its state equals JAX's streaming
    conv chunk for chunk, and the whole sequence at once."""
    jcfg = JREG.get_config("recurrentgemma-9b", smoke=True)
    jp, tp = _rg_params(jcfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    js = jnp.zeros((2, 3, 64), jnp.float32)
    ts = torch.zeros((2, 3, 64))
    outs = []
    for a, b in ((0, 4), (4, 5), (5, 9)):
        jo, js = JL.causal_conv1d(jp["conv"], jnp.asarray(x[:, a:b]), js)
        to, ts = L.causal_conv1d(tp["conv"], torch.as_tensor(x[:, a:b]), ts)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
        outs.append(to)
    whole = L.causal_conv1d(tp["conv"], torch.as_tensor(x))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), whole.numpy(),
                               **TOL)


def test_rg_lru_prefill_state_and_decode_step_match_jax():
    """The sequence path (K6's plain version) writes the state it ends
    in; two decode steps from it (one with a finished row) match JAX's
    state and outputs, the finished row's state unchanged."""
    jcfg = JREG.get_config("recurrentgemma-9b", smoke=True)
    cfg = REG.get_config("recurrentgemma-9b", smoke=True)
    jp, tp = _rg_params(jcfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)
    jo, jst = JR.rg_lru_block(jp, jnp.asarray(x), jcfg, RULES,
                              state=JR.init_rg_lru_state(jcfg, 2))
    st = REC.init_rg_lru_state(cfg, 2)
    to, st2 = REC.rg_lru_block(tp, torch.as_tensor(x), cfg, state=st)
    assert st2 is st
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    assert_trees_close(st, jax.tree.map(np.asarray, jst))
    for live in (None, torch.tensor([True, False])):
        xt = rng.standard_normal((2, 1, 64)).astype(np.float32)
        jo, jnew = JR.rg_lru_block(jp, jnp.asarray(xt), jcfg, RULES,
                                   state=jst, decode=True)
        if live is not None:
            jnew = JD._select_live(jnp.asarray(live.numpy()),
                                   jax.tree.map(lambda t: t[None], jnew),
                                   jax.tree.map(lambda t: t[None], jst))
            jnew = jax.tree.map(lambda t: t[0], jnew)
        to, _ = REC.rg_lru_block(tp, torch.as_tensor(xt), cfg, state=st,
                                 decode=True, live=live)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        assert_trees_close(st, jax.tree.map(np.asarray, jnew))
        jst = jnew


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_init_serve_caches_tree_matches_jax(arch, smoke, per_slot):
    """The same tree as the reference's: containers, keys, the leading
    reps axis, shapes and dtypes (bf16 at full width), and its initial
    values (zeros, but the mLSTM's m = -inf and the sLSTM's n = 1)."""
    jcfg, cfg = jax_config(arch, smoke), REG.get_config(arch, smoke)
    ref = jax.tree.map(np.asarray, JP.init_serve_caches(jcfg, 2, 12,
                                                        per_slot))
    got = P.init_serve_caches(cfg, 2, 12, per_slot, device="cpu")
    assert_trees_close(got, ref, tol=dict(rtol=0, atol=0))


def _kv_inputs(seed, B, S, K=2, D=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, K, D)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("S", [5, 8, 13], ids=["S<size", "S=size",
                                                "S>size-ring"])
def test_prefill_cache_matches_jax(S):
    """A prompt's k/v written into a fresh 8-entry cache: a prefix write,
    the whole cache, and the ring rolled by ``S % size``."""
    k, v = _kv_inputs(S, 2, S)
    jcache = {"k": jnp.zeros((2, 8, 2, 8)), "v": jnp.zeros((2, 8, 2, 8)),
              "pos": jnp.zeros((2,), jnp.int32)}
    ref = JA._prefill_cache(jcache, jnp.asarray(k), jnp.asarray(v))
    cache = {"k": torch.zeros((2, 8, 2, 8)), "v": torch.zeros((2, 8, 2, 8)),
             "pos": torch.zeros((2,), dtype=torch.int32)}
    A._prefill_cache(cache, torch.as_tensor(k), torch.as_tensor(v))
    assert_trees_close(cache, jax.tree.map(np.asarray, ref),
                       tol=dict(rtol=0, atol=0))


@pytest.mark.parametrize("valid", [6, [3, 9, 1]], ids=["scalar", "per-slot"])
@pytest.mark.parametrize("window,cap", [(0, None), (4, 5.0)],
                         ids=["plain", "window-softcap"])
def test_decode_attention_matches_jax(valid, window, cap):
    """GQA 4:2 at head_dim 8 over a 9-entry cache."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((3, 1, 4, 8)).astype(np.float32)
    k, v = _kv_inputs(12, 3, 9)
    ref = JA.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(valid, jnp.int32), window=window,
                              cap=cap)
    got = A.decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v),
                             torch.as_tensor(valid, dtype=torch.int32),
                             window=window, cap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_cached_prefill_and_serve_step_match_jax(arch):
    """A 10-token block prefill into per-slot caches of 14 (the window-8
    local layers' rings wrap), then two serve steps: the first with both
    slots live, the second with slot 1 finished (JAX: the step, then
    ``_select_live``).  The live slots' logits and every cache leaf at
    1e-5; the cache-free ``make_prefill_step`` gives the prefill's
    logits."""
    jcfg, cfg = jax_config(arch), REG.get_config(arch, smoke=True)
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab, (2, 10)).astype(np.int32)
    jc = JP.init_serve_caches(jcfg, 2, 14, per_slot=True)
    jl, jc = jax.jit(JP.make_cached_prefill_step(jcfg, RULES))(
        jp, jc, jnp.asarray(prompt))
    tc = P.init_serve_caches(cfg, 2, 14, per_slot=True, device="cpu")
    tl, tc = P.make_cached_prefill_step(cfg)(tp, tc, torch.as_tensor(prompt))
    tol = XLSTM_TOL if arch == "xlstm-1.3b" else TOL
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    assert_trees_close(tc, jax.tree.map(np.asarray, jc), tol=tol)
    # the cache-free prefill step (the whole model's forward) agrees
    full = P.make_prefill_step(cfg)(tp, {"inputs": torch.as_tensor(prompt)})
    np.testing.assert_allclose(full.numpy(), tl.numpy(), **TOL)
    jserve = jax.jit(JP.make_serve_step(jcfg, RULES))
    serve = P.make_serve_step(cfg)
    for live in ([True, True], [True, False]):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jnew = jserve(jp, jc, jnp.asarray(tok))
        jc = JD._select_live(jnp.asarray(live), jnew, jc)
        tl, tc = serve(tp, tc, torch.as_tensor(tok), torch.tensor(live))
        # a finished slot's logits too: both packages attend its token
        # and then discard it (an MoE block routes it beside the live
        # ones)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        assert_trees_close(tc, jax.tree.map(np.asarray, jc), tol=tol)
