"""The MoE family (qwen3-moe-30b-a3b, kimi-k2-1t-a32b) of the port against
the JAX package on their smoke configs (f32), with the helpers of
``tests/test_torch_family_rounds.py``: the config values, the forwards
and the loss, the dual-probe losses through the whole-block fallback
(every MoE block takes it), qwen3-moe's HERON round on the kernel and
the threefry streams and its CSE-FSL round, and kimi-k2's round with its
Adafactor server."""
import dataclasses

import jax
import pytest

import test_torch_family_rounds as FR
import torch_round_parity as RP
from torch_round_parity import one_torch_thread  # noqa: F401
from repro.core import protocols as JP
from repro.core import zo as JZ
from repro.optim import optimizers as JOPT
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.optim import optimizers as OPT

jax.config.update("jax_platform_name", "cpu")

ARCHS = [FR.QWEN_MOE, FR.KIMI]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_config_values_match_reference(name, smoke):
    FR.config_values_match(name, smoke)


@pytest.mark.parametrize("name", ARCHS)
def test_forwards_and_loss_match_jax(name):
    FR.forwards_match(name)


@pytest.mark.parametrize("name", ARCHS)
def test_client_dual_loss_matches_jax(name):
    FR.dual_loss_matches(name)


@pytest.mark.parametrize("stream", ["kernel", "threefry"])
def test_heron_round_matches_jax(stream):
    FR.zo_round_matches(FR.QWEN_MOE, stream)


def test_cse_fsl_round_matches_jax():
    FR.cse_fsl_round_matches(FR.QWEN_MOE)


def test_kimi_round_with_adafactor_server_matches_jax():
    """kimi-k2's smoke config (cut after one block, tied table) on the
    kernel stream with the config's server optimizer, Adafactor."""
    jcfg, cfg, params = FR._setup(FR.KIMI)
    assert cfg.optimizer == jcfg.optimizer == "adafactor"
    japi = JP.lm_api(dataclasses.replace(jcfg, forward_impl="kernel"),
                     RP.RULES)
    api = P.lm_api(cfg.replace(forward_impl="kernel"))
    rb = RP.round_batch("lm", FR.N, 1, vocab=cfg.vocab)
    kw = dict(uplink="seed_replay", client_lr=FR.LR)
    fed = dict(n_clients=FR.N, h=1)
    ref, jm = RP.jax_round(japi, "heron", params, rb, JP.FedConfig(**fed),
                           JOPT.zo_sgd(FR.LR),
                           JOPT.make_optimizer(jcfg.optimizer, FR.SERVER_LR),
                           FR.KEY, JZ.ZOConfig(mu=FR.MU, n_pairs=1), **kw)
    new, m = RP.port_round(api, "heron", params, rb, P.FedConfig(**fed),
                           OPT.zo_sgd(FR.LR),
                           OPT.make_optimizer(cfg.optimizer, FR.SERVER_LR),
                           FR.KEY, Z.ZOConfig(mu=FR.MU, n_pairs=1), **kw)
    RP.assert_state_close(new, ref, params)
    RP.assert_metrics_close(m, jm)
