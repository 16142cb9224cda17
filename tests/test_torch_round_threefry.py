"""The HERON round on the threefry stream (``forward_impl="xla"``, the
reference's default) against :mod:`repro.core.protocols` on gpt2-tiny:
same params (through the bridge), batches and round key; the port draws
the participation and straggler mask itself from the key and must draw
JAX's.  Also the masks alone, the absence of kernel launches and the
``forward_impl`` resolution.

The states are held at ``PARAM_TOL``, at the rates of
``torch_round_parity.THREEFRY_RATES`` (why those: there)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_round_parity as RP
from torch_round_parity import one_torch_thread  # noqa: F401
from repro.configs.gpt2 import gpt2_tiny as jax_gpt2_tiny
from repro.core import aggregate as JAG
from repro_torch.configs.gpt2 import gpt2_tiny
from repro_torch.core import aggregate as AG
from repro_torch.core import prng as R
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.kernels import ops as O
from repro_torch.kernels import zo_matmul as ZM
from repro_torch.models import cnn as CNN
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as OPT

jax.config.update("jax_platform_name", "cpu")

KEY = jax.random.PRNGKey(13)
# (h, scale, uplink, participation, straggler_prob): h 1 and 2, both
# scales and both uplinks, drawn masks in two; the small CNN's cases are
# in tests/test_torch_round_threefry_cnn.py
CASES = [(1, "sphere", "seed_replay", 1.0, 0.0),
         (2, "gaussian", "seed_replay", 2 / 3, 0.3),
         (1, "gaussian", "dense", 1.0, 0.0),
         (2, "sphere", "dense", 2 / 3, 0.0)]
SERVER_LR = 1e-4


@pytest.mark.parametrize("case", CASES, ids=RP.threefry_case_ids(CASES))
def test_threefry_round_matches_jax(case):
    RP.threefry_round_case("lm", case, KEY)


MASK_CASES = [(n, frac, p) for n in (1, 3, 5, 8) for frac in (1.0, 0.5, 0.3)
              for p in (0.0, 0.3, 0.9)]


@pytest.mark.parametrize("seed", [0, 9, 13])
def test_round_mask_drawn_equals_jax(seed):
    """The round's mask, ``straggler_mask(fold_in(key, 777), ...)``,
    bit for bit over cohort sizes, fractions and drop probabilities (the
    fallback to the participation mask included)."""
    key = jax.random.PRNGKey(seed)
    mk = jax.random.fold_in(key, 777)
    tk = R.fold_in(np.asarray(key), 777)
    for n, frac, p in MASK_CASES:
        want = np.asarray(JAG.straggler_mask(mk, n, frac, p))
        got = AG.straggler_mask(tk, n, frac, p)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(
            (n, frac, p)))
        np.testing.assert_array_equal(
            AG.participation_mask(tk, n, frac).numpy(),
            np.asarray(JAG.participation_mask(mk, n, frac)))


def test_threefry_round_launches_no_kernel(monkeypatch):
    """On the threefry path the client's probes are plain forwards and
    the replay draws with threefry: no K1-K5 wrapper is reached."""
    calls = []
    for mod, name in ((ZM, "zo_noise_tree"), (ZM, "zo_noise_rows"),
                      (O, "zo_noise_rows"), (O, "zo_dual_matmul"),
                      (O, "zo_dual_flash_attention"), (O, "zo_matmul"),
                      (O, "flash_attention")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k:
                            calls.append(_n))
    cfg = gpt2_tiny()
    ccfg = CNN.CNNConfig(**RP.CNN_KW)
    for api, params, rb in (
            (P.lm_api(cfg), T.init_lm(cfg, seed=0, device="cpu"),
             RP.round_batch("lm", 2, 1, vocab=cfg.vocab)),
            (P.cnn_api(ccfg), CNN.init_cnn(ccfg, seed=0, device="cpu"),
             RP.round_batch("cnn", 2, 1))):
        sopt = OPT.adamw(SERVER_LR)
        rnd = P.make_fed_round(api, "heron", Z.ZOConfig(mu=1e-2),
                               P.FedConfig(n_clients=2, h=1),
                               OPT.zo_sgd(1e-3), sopt, uplink="seed_replay",
                               client_lr=1e-3)
        state = {"client": params["client"], "server": params["server"],
                 "opt_server": sopt.init(params["server"])}
        new, m = rnd(state, {k: torch.as_tensor(v) for k, v in rb.items()},
                     R.PRNGKey(3))
        assert np.isfinite(float(m["client_loss"]))
    assert calls == []


def test_forward_impl_resolution():
    """The reference's default is ``"xla"`` (threefry, no dual loss);
    ``"kernel"`` gives the fused dual probe; ``"kernel_interpret"`` (the
    reference's Pallas interpret mode) raises and names ``"kernel"``."""
    assert gpt2_tiny().forward_impl == jax_gpt2_tiny().forward_impl == "xla"
    assert CNN.CNNConfig().forward_impl == "xla"
    assert P.lm_api(gpt2_tiny()).client_dual_loss is None
    assert P.cnn_api(CNN.CNNConfig()).client_dual_loss is None
    kcfg = dataclasses.replace(gpt2_tiny(), forward_impl="kernel",
                               attn_probe="scores")
    api = P.lm_api(kcfg)
    assert api.client_dual_loss is not None
    assert api.seed_pred is O.attn_kv_seed_pred
    assert P.lm_api(dataclasses.replace(kcfg, forward_impl="xla")
                    ).seed_pred is None
    for bad in ("kernel_interpret", "pallas"):
        with pytest.raises(ValueError, match="kernel"):
            P.lm_api(dataclasses.replace(gpt2_tiny(), forward_impl=bad))
        with pytest.raises(ValueError, match="kernel"):
            P.cnn_api(CNN.CNNConfig(forward_impl=bad))
