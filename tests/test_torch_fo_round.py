"""The port's aux-head first-order rounds (CSE-FSL, FSL-SAGE) against
``make_fed_round`` of :mod:`repro.core.protocols`: the same params
(through the bridge), the same batches from a numpy seed, JAX's
participation mask passed in.  On gpt2-tiny and the small CNN of
``benchmarks/run.py:_fed_accuracy`` (N=3): client, server and server
optimizer state after the round at the round tests' ``PARAM_TOL``, the
metrics within the same tolerance.  Also the refusal of the lean uplink
for a first-order method, and that a first-order round reaches none of
the ZO kernels K1-K5 (their wrappers are counted on the CPU, where each
call would be a launch on the card).  The training-lock methods are in
``tests/test_torch_fo_locked_round.py``, the CSE-FSL round on the
recurrentgemma smoke config in ``tests/test_torch_fo_round_rg.py``."""
import dataclasses

import pytest
import torch

import torch_round_parity as RP
from repro_torch.bridge import from_jax
from repro_torch.configs.gpt2 import gpt2_tiny
from repro_torch.configs.recurrentgemma_9b import smoke_config as rg_smoke
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.kernels import ops as O
from repro_torch.kernels import zo_matmul as ZM
from repro_torch.models import cnn as CNN
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as OPT

AUX_METHODS = ("cse_fsl", "fsl_sage")
FO_METHODS = AUX_METHODS + P.LOCKED_METHODS
LR, MU, N = RP.FO_LR, RP.FO_MU, RP.FO_N


@pytest.fixture(scope="module", params=["lm", "cnn"])
def model(request):
    setup = {"lm": RP.lm_setup, "cnn": RP.cnn_setup}[request.param]
    return request.param, setup()


@pytest.mark.parametrize("case", RP.FO_CASES, ids=RP.FO_CASE_IDS)
@pytest.mark.parametrize("method", AUX_METHODS)
def test_fo_round_matches_jax(model, method, case):
    kind, setup = model
    RP.fo_round_case(kind, setup, method, case)


@pytest.mark.parametrize("method", FO_METHODS)
def test_seed_replay_refused_for_fo_methods(method):
    api = P.cnn_api(CNN.CNNConfig(**RP.CNN_KW))
    for lr in (1e-3, None):
        with pytest.raises(ValueError, match="method='heron'"):
            P.make_fed_round(api, method, Z.ZOConfig(), P.FedConfig(),
                             OPT.adamw(LR), OPT.adamw(LR),
                             uplink="seed_replay", client_lr=lr)
    with pytest.raises(ValueError, match="not in"):
        P.make_fed_round(api, "fedsgd", Z.ZOConfig(), P.FedConfig(),
                         OPT.adamw(LR), OPT.adamw(LR))


# every entry point through which a forward reaches K1-K6; the models
# look each up at call time through one of these modules
WRAPPERS = [(ZM, "zo_noise_tree", "K1"), (ZM, "zo_noise_rows", "K1"),
            (O, "zo_noise_rows", "K1"), (O, "zo_dual_matmul", "K2"),
            (O, "zo_dual_flash_attention", "K3"), (O, "zo_matmul", "K4"),
            (O, "flash_attention", "K5"), (O, "rg_lru_scan", "K6")]


@pytest.fixture
def calls(monkeypatch):
    counts = {k: 0 for k in ("K1", "K2", "K3", "K4", "K5", "K6")}

    def counted(fn, k):
        def wrapper(*a, **kw):
            counts[k] += 1
            return fn(*a, **kw)
        return wrapper

    for mod, name, k in WRAPPERS:
        monkeypatch.setattr(mod, name, counted(getattr(mod, name), k))
    return counts


def _small_round(api, params, method, rb):
    copt = OPT.zo_sgd(LR) if method == "heron" else OPT.adamw(LR)
    sopt = OPT.adamw(LR)
    state = {"client": params["client"], "server": params["server"],
             "opt_server": sopt.init(params["server"])}
    rnd = P.make_fed_round(api, method, Z.ZOConfig(mu=MU),
                           P.FedConfig(n_clients=N, h=1), copt, sopt)
    rnd(state, {k: torch.as_tensor(v) for k, v in rb.items()}, (0, 7))


@pytest.mark.parametrize("method", ("heron",) + FO_METHODS)
def test_fo_round_reaches_no_zo_kernel(calls, method):
    """A first-order round calls none of K1-K5 (K6 runs in the RG-LRU
    blocks only); the HERON round, the control, calls K1-K3."""
    cfg = dataclasses.replace(gpt2_tiny(), attn_probe="weights",
                              forward_impl="kernel")
    params = T.init_lm(cfg, seed=0, device="cpu")
    _small_round(P.lm_api(cfg), params, method,
                 RP.round_batch("lm", N, 1, vocab=cfg.vocab))
    ccfg = CNN.CNNConfig(**RP.CNN_KW, forward_impl="kernel")
    _small_round(P.cnn_api(ccfg), CNN.init_cnn(ccfg, seed=0, device="cpu"),
                 method, RP.round_batch("cnn", N, 1))
    if method == "heron":
        assert calls["K1"] > 0 and calls["K2"] > 0 and calls["K3"] > 0
        assert calls["K4"] == calls["K5"] == calls["K6"] == 0
    else:
        assert calls == {k: 0 for k in calls}, calls


def test_fo_round_recurrentgemma_reaches_k6_only(calls):
    cfg = rg_smoke()
    params = from_jax(RP.rg_setup()[2], device="cpu")
    _small_round(P.lm_api(cfg), params, "cse_fsl",
                 RP.round_batch("lm", N, 1, vocab=cfg.vocab))
    # per client its step's client and aux RG-LRU blocks, then one
    # server step on its smashed data; each block's forward twice, the
    # second in the backward's recompute (cfg.remat, the default)
    assert cfg.remat
    n_rg = sum(s.mixer == "rg_lru" for s in T.client_specs(cfg)
               + T.aux_specs(cfg) + T.server_specs(cfg))
    assert calls["K6"] == 2 * N * n_rg > 0, calls
    assert all(calls[k] == 0 for k in ("K1", "K2", "K3", "K4", "K5"))
