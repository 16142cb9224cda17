"""The xLSTM family (xlstm-1.3b: mLSTM / sLSTM blocks) of the port against
the JAX package on its smoke config (f32): the config values, the
forwards and the loss, the dual-probe losses through the whole-block
fallback, one HERON round on the kernel stream and one on the threefry
stream (the reference's default), and one CSE-FSL round.  Params come
from the JAX init through the bridge, tokens from numpy seeds.  The
helpers here also drive the MoE family's file,
``tests/test_torch_family_rounds_moe.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_round_parity as RP
from torch_round_parity import one_torch_thread  # noqa: F401
from repro.configs import registry as JREG
from repro.core import protocols as JP
from repro.core import zo as JZ
from repro.kernels import ops as JO
from repro.models import transformer as JT
from repro.optim import optimizers as JOPT
from repro_torch.bridge import from_jax
from repro_torch.configs import registry as REG
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.kernels import ops as O
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as OPT

jax.config.update("jax_platform_name", "cpu")

XLSTM, QWEN_MOE, KIMI = "xlstm-1.3b", "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"
# The forwards, rtol 1e-5 and an absolute floor of ``atol`` x max
# |ref|: the smoke MoE's expert leaves are drawn at 1/sqrt(n_experts)
# (the reference's fan-in is a leaf's first axis), so its residual stream
# reaches |x| ~ 30 and an f32 ulp there is 2e-6; xlstm's stack adds
# ~1.5e-6 x max|x| a layer (torch's exp / log_sigmoid against XLA:CPU's,
# through the mLSTM's h = num / |n.q| and per-head norm;
# tests/torch_serve_parity.XLSTM_TOL): measured up to 9e-7 x max|x|
# (MoE) and 2.2e-5 x max|x| (xlstm's logits).
FWD_ATOL = {QWEN_MOE: 4e-6, KIMI: 4e-6, XLSTM: 1e-4}
# the kernel and threefry rounds' rates (tests/test_torch_round.py's and
# torch_round_parity's gaussian ones); the server's AdamW eps 1e-6 as the
# recurrentgemma round: a rounding-noise gradient entry moves a param by
# O(lr) at eps 1e-8
MU, LR, SERVER_LR, EPS, N = 1e-2, 1e-3, 1e-4, 1e-6, 2
KEY = jax.random.PRNGKey(9)
# xlstm's gradients are ill-conditioned in f32: JAX's own server gradient
# moves by up to 5e-5 x max|g| of a leaf when the client params move by
# one ulp, and the port's differs from JAX's by up to 2e-4 x max|g|
# (measured).  A first AdamW step g / (|g| + eps) then moves a param by
# up to lr * dg / eps, O(lr) at eps 1e-6, so xlstm's rounds run AdamW at
# eps 1e-3 on both sides (lr * dg / eps < 1e-7 here), and the optimizer
# moments, which carry g itself, are held at 5e-4 x their leaf's max.
XLSTM_EPS, XLSTM_MOMENT_ATOL = 1e-3, 5e-4


def _assert_close(name, got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=FWD_ATOL[name] * np.abs(ref).max())


def _assert_state(name, new, ref, params):
    """The round's state at ``PARAM_TOL``; xlstm's optimizer moments at
    ``XLSTM_MOMENT_ATOL`` x their leaf's max."""
    if name != XLSTM:
        RP.assert_state_close(new, ref, params)
        return
    RP.assert_state_close(new, ref, params, parts=("client", "server"))
    got, want = RP.leaves(new["opt_server"]), jax.tree.leaves(
        ref["opt_server"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(
            a, b, rtol=RP.PARAM_TOL["rtol"],
            atol=XLSTM_MOMENT_ATOL * float(np.abs(b).max()))


def _setup(name):
    """``(jax smoke config, port smoke config, numpy params)``."""
    jcfg = JREG.get_config(name, smoke=True)
    p = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, REG.get_config(name, smoke=True), jax.tree.map(np.asarray,
                                                                  p)


def _tokens(vocab, b=2, s=16, seed=3):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return toks[:, :-1], toks[:, 1:]


def config_values_match(name, smoke):
    """Every field of the port's config holds the reference's value (the
    MoE block's as a tuple: the two packages' ``MoECfg`` classes)."""
    cfg, jcfg = REG.get_config(name, smoke), JREG.get_config(name, smoke)
    fields = [f.name for f in dataclasses.fields(cfg)]
    assert set(fields) <= {f.name for f in dataclasses.fields(jcfg)}
    for f in fields:
        a, b = getattr(cfg, f), getattr(jcfg, f)
        if f == "pattern":
            assert [(s.mixer, s.ffn) for s in a] == [(s.mixer, s.ffn)
                                                    for s in b]
        elif f == "moe" and b is not None:
            assert dataclasses.astuple(a) == dataclasses.astuple(b)
        else:
            assert a == b, f


def forwards_match(name):
    """The whole model's logits and the loss."""
    jcfg, cfg, params = _setup(name)
    inputs, labels = _tokens(cfg.vocab)
    tp = from_jax(params, device="cpu")
    lg_ref = jax.jit(lambda p, i: JT.full_forward(p, jcfg, RP.RULES, i))(
        params, inputs)
    lg = T.full_forward(tp, cfg, torch.as_tensor(inputs))
    _assert_close(name, lg.numpy(), lg_ref)
    np.testing.assert_allclose(
        float(T.lm_loss(lg, torch.as_tensor(labels), cfg.vocab)),
        float(JT.lm_loss(lg_ref, labels, jcfg.vocab)), rtol=1e-6)


def dual_loss_matches(name):
    """l_clean, l_pert and the smashed data of one dual-probe pass: every
    client block runs the whole-block fallback (K1's theta + mu*U, then
    the plain block on each half)."""
    jcfg, cfg, params = _setup(name)
    japi = JP.lm_api(dataclasses.replace(jcfg, forward_impl="kernel"),
                     RP.RULES)
    api = P.lm_api(cfg.replace(forward_impl="kernel"))
    inputs, labels = _tokens(cfg.vocab)
    cp = params["client"]
    l0r, lpr, sr = jax.jit(japi.client_dual_loss)(
        cp, {"inputs": inputs, "labels": labels},
        JO.leaf_seed_tree(cp, jnp.int32(-2024)), MU)
    l0, lp, s = api.client_dual_loss(
        from_jax(cp, device="cpu"),
        {"inputs": torch.as_tensor(inputs), "labels": torch.as_tensor(labels)},
        O.leaf_seed_tree(cp, -2024), MU)
    np.testing.assert_allclose(float(l0), float(l0r), rtol=1e-5)
    np.testing.assert_allclose(float(lp), float(lpr), rtol=1e-5)
    _assert_close(name, s.numpy(), sr)
    assert float(l0) != float(lp)


def zo_round_matches(name, stream):
    """One HERON round (N=2, h=1, the lean uplink) of each package from
    the same params, tokens and key: ``stream`` "kernel" is the fused
    dual probe's hash stream, "threefry" the reference's default
    (gaussian directions)."""
    jcfg, cfg, params = _setup(name)
    impl = "kernel" if stream == "kernel" else "xla"
    japi = JP.lm_api(dataclasses.replace(jcfg, forward_impl=impl), RP.RULES)
    api = P.lm_api(cfg.replace(forward_impl=impl))
    assert (api.client_dual_loss is None) == (stream == "threefry")
    rb = RP.round_batch("lm", N, 1, vocab=cfg.vocab)
    kw = dict(uplink="seed_replay", client_lr=LR)
    scale = "sphere" if stream == "kernel" else "gaussian"
    eps = XLSTM_EPS if name == XLSTM else EPS
    ref, jm = RP.jax_round(japi, "heron", params, rb,
                           JP.FedConfig(n_clients=N, h=1), JOPT.zo_sgd(LR),
                           JOPT.adamw(SERVER_LR, eps=eps), KEY,
                           JZ.ZOConfig(mu=MU, n_pairs=1, scale=scale), **kw)
    new, m = RP.port_round(api, "heron", params, rb,
                           P.FedConfig(n_clients=N, h=1), OPT.zo_sgd(LR),
                           OPT.adamw(SERVER_LR, eps=eps), KEY,
                           Z.ZOConfig(mu=MU, n_pairs=1, scale=scale), **kw)
    _assert_state(name, new, ref, params)
    RP.assert_metrics_close(m, jm)


def cse_fsl_round_matches(name):
    """CSE-FSL (first-order clients on the aux head, the dense uplink)
    at torch_round_parity's first-order rates (xlstm's AdamW at
    ``XLSTM_EPS``), h=1, all clients."""
    jcfg, cfg, params = _setup(name)
    rb = RP.round_batch("lm", RP.FO_N, 1, vocab=cfg.vocab)
    fed = dict(n_clients=RP.FO_N, h=1)
    eps = XLSTM_EPS if name == XLSTM else RP.FO_EPS
    ref, jm = RP.jax_round(
        JP.lm_api(jcfg, RP.RULES), "cse_fsl", params, rb,
        JP.FedConfig(**fed), JOPT.adamw(RP.FO_LR, eps=eps),
        JOPT.adamw(RP.FO_SERVER_LR, eps=eps), RP.FO_KEY,
        JZ.ZOConfig(mu=RP.FO_MU))
    new, m = RP.port_round(
        P.lm_api(cfg), "cse_fsl", params, rb, P.FedConfig(**fed),
        OPT.adamw(RP.FO_LR, eps=eps), OPT.adamw(RP.FO_SERVER_LR, eps=eps),
        RP.FO_KEY, Z.ZOConfig(mu=RP.FO_MU))
    _assert_state(name, new, ref, params)
    RP.assert_metrics_close(m, jm)


@pytest.mark.parametrize("smoke", [False, True])
def test_config_values_match_reference(smoke):
    config_values_match(XLSTM, smoke)


def test_forwards_and_loss_match_jax():
    forwards_match(XLSTM)


def test_client_dual_loss_matches_jax():
    dual_loss_matches(XLSTM)


@pytest.mark.parametrize("stream", ["kernel", "threefry"])
def test_heron_round_matches_jax(stream):
    zo_round_matches(XLSTM, stream)


def test_cse_fsl_round_matches_jax():
    cse_fsl_round_matches(XLSTM)
