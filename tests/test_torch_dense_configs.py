"""The dense-family configs of the port (qwen2-1.5b, qwen2.5-32b,
command-r-35b, gemma2-27b) against the JAX package on their smoke
configs: the same field values, the client / aux / server forwards and
the loss at ``rtol=atol=1e-5``, the fused dual-probe losses in both
attention-probe modes, one HERON round on the kernel stream at
``PARAM_TOL``, and the port's registry.

Between them they reach what gpt2 and recurrentgemma do not: QKV biases
(qwen), untied unembedding (qwen2.5), layernorm with a gated MLP
(command-r), post-block norms, attention and final soft-caps, a
query-scale override and local/global alternation (gemma2)."""
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

ARCHS = ["qwen2-1.5b", "qwen2.5-32b", "command-r-35b", "gemma2-27b"]
TOL = dict(rtol=1e-5, atol=1e-5)
# the kernel round (tests/test_torch_round.py's rates; the server's
# AdamW eps 1e-6 as the recurrentgemma round: a rounding-noise gradient
# entry moves a param by O(lr) at eps 1e-8)
MU, LR, SERVER_LR, EPS, N = 1e-2, 1e-3, 1e-4, 1e-6, 2
KEY = jax.random.PRNGKey(9)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """``(name, jax smoke config, port smoke config, numpy params)``."""
    jcfg = JREG.get_config(request.param, smoke=True)
    cfg = REG.get_config(request.param, smoke=True)
    p = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    return request.param, jcfg, cfg, jax.tree.map(np.asarray, p)


def _tokens(vocab, b=2, s=16, seed=3):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return toks[:, :-1], toks[:, 1:]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_config_values_match_reference(name, smoke):
    """Every field the port's config has holds the reference's value."""
    cfg, jcfg = REG.get_config(name, smoke), JREG.get_config(name, smoke)
    fields = [f.name for f in dataclasses.fields(cfg)]
    assert set(fields) <= {f.name for f in dataclasses.fields(jcfg)}
    for f in fields:
        if f == "pattern":
            assert [(s.mixer, s.ffn) for s in cfg.pattern] == [
                (s.mixer, s.ffn) for s in jcfg.pattern]
        else:
            assert getattr(cfg, f) == getattr(jcfg, f), f


def test_forwards_and_loss_match_jax(arch):
    _, jcfg, cfg, params = arch
    inputs, labels = _tokens(cfg.vocab)
    tp = from_jax(params, device="cpu")
    ti, tl = torch.as_tensor(inputs), torch.as_tensor(labels)
    s_ref, _ = JT.client_forward(params["client"], jcfg, RP.RULES, inputs)
    s = T.client_forward(tp["client"], cfg, ti)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), **TOL)
    a_ref = JT.aux_forward(params["client"], jcfg, RP.RULES, s_ref)
    np.testing.assert_allclose(T.aux_forward(tp["client"], cfg, s).numpy(),
                               np.asarray(a_ref), **TOL)
    lg_ref, _ = JT.server_forward(params, jcfg, RP.RULES, s_ref)
    lg = T.server_forward(tp, cfg, s)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)
    np.testing.assert_allclose(float(T.lm_loss(lg, tl, cfg.vocab)),
                               float(JT.lm_loss(lg_ref, labels, jcfg.vocab)),
                               rtol=1e-6)


@pytest.mark.parametrize("probe", ["weights", "scores"])
def test_client_dual_loss_matches_jax(arch, probe):
    """Both losses of one fused dual-probe pass and the smashed data (the
    JAX side's "kernel" path runs its xla emulation on the CPU)."""
    _, jcfg, cfg, params = arch
    japi = JP.lm_api(dataclasses.replace(jcfg, forward_impl="kernel",
                                         attn_probe=probe), RP.RULES)
    api = P.lm_api(cfg.replace(forward_impl="kernel", attn_probe=probe))
    inputs, labels = _tokens(cfg.vocab, seed=5)
    cp = params["client"]
    l0r, lpr, sr = jax.jit(japi.client_dual_loss)(
        cp, {"inputs": inputs, "labels": labels},
        JO.leaf_seed_tree(cp, jnp.int32(-2024), japi.seed_pred), MU)
    l0, lp, s = api.client_dual_loss(
        from_jax(cp, device="cpu"),
        {"inputs": torch.as_tensor(inputs),
         "labels": torch.as_tensor(labels)},
        O.leaf_seed_tree(cp, -2024, api.seed_pred), MU)
    np.testing.assert_allclose(float(l0), float(l0r), rtol=1e-5)
    np.testing.assert_allclose(float(lp), float(lpr), rtol=1e-5)
    assert float(l0) != float(lp)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), **TOL)


def test_kernel_round_matches_jax(arch):
    """One HERON round (N=2, h=1) on the kernel stream with the lean
    uplink, from the same params, tokens and key."""
    _, jcfg, cfg, params = arch
    japi = JP.lm_api(dataclasses.replace(jcfg, forward_impl="kernel"),
                     RP.RULES)
    api = P.lm_api(cfg.replace(forward_impl="kernel"))
    rb = RP.round_batch("lm", N, 1, vocab=cfg.vocab)
    kw = dict(uplink="seed_replay", client_lr=LR)
    ref, jm = RP.jax_round(japi, "heron", params, rb,
                           JP.FedConfig(n_clients=N, h=1), JOPT.zo_sgd(LR),
                           JOPT.adamw(SERVER_LR, eps=EPS), KEY,
                           JZ.ZOConfig(mu=MU, n_pairs=1), **kw)
    new, m = RP.port_round(api, "heron", params, rb,
                           P.FedConfig(n_clients=N, h=1), OPT.zo_sgd(LR),
                           OPT.adamw(SERVER_LR, eps=EPS), KEY,
                           Z.ZOConfig(mu=MU, n_pairs=1), **kw)
    RP.assert_state_close(new, ref, params)
    RP.assert_metrics_close(m, jm)


def test_registry():
    """The port's registry is the reference's, and gpt2."""
    assert set(REG.ARCH_IDS) == set(JREG.ARCH_IDS) | {"gpt2"}
    assert set(ARCHS) | {"recurrentgemma-9b", "xlstm-1.3b",
                         "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b",
                         "qwen2-vl-2b", "seamless-m4t-medium"} == \
        set(JREG.ARCH_IDS)
    assert REG.get_config("gpt2").name == "gpt2-small"
    assert REG.get_config("gpt2", smoke=True).name == "gpt2-tiny"
    assert REG.get_config("recurrentgemma-9b").n_layers == 38
    for name in JREG.ARCH_IDS:
        for smoke in (False, True):
            assert REG.get_config(name, smoke).name == \
                JREG.get_config(name, smoke).name
    assert REG.get_config("qwen2-vl-2b").rope_kind == "mrope"
    assert REG.get_config("seamless-m4t-medium", smoke=True).enc_dec
    with pytest.raises(KeyError):
        REG.get_config("gpt5")
