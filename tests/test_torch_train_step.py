"""The port's datacenter step (``init_train_state`` / ``make_train_step``)
against :mod:`repro.core.protocols` on gpt2-tiny: two steps from the same
params, the same batches (a numpy seed) and ``PRNGKey(1)``, the JAX step
jitted.  HERON on the kernel stream (JAX's xla emulation) and on the
threefry stream, and the aux-head first-order clients CSE-FSL and
FSL-SAGE (with its alignment term).  Params and both optimizer states at
``PARAM_TOL`` (rtol 2e-5, atol 1e-6), losses at rtol 2e-5.  The
training-lock methods, the CNN and recurrentgemma are in
``test_torch_train_step_locked.py``."""
import dataclasses

import numpy as np
import pytest

import torch_round_parity as RP
from torch_round_parity import one_torch_thread  # noqa: F401
from repro.configs.gpt2 import gpt2_tiny as jax_gpt2_tiny
from repro.core import protocols as JP
from repro.core import zo as JZ
from repro.optim import optimizers as JOPT
from repro_torch.configs.gpt2 import gpt2_tiny
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.optim import optimizers as OPT

# AdamW at the first-order rounds' rates on both sides (see
# torch_round_parity.FO_LR): the server's first step is ~g/|g|
SOPT = (JOPT.adamw(RP.FO_SERVER_LR, eps=RP.FO_EPS),
        OPT.adamw(RP.FO_SERVER_LR, eps=RP.FO_EPS))
# a coefficient is dim_factor (l_pert - l_clean) / mu and the packages'
# losses differ by a few f32 ulps: its tolerance is 16 ulps of the loss
# times dim_factor / mu (one pair)
COEFF_ULPS = 16


def _lm_setup(forward_impl):
    return RP.lm_setup(dataclasses.replace(jax_gpt2_tiny(),
                                           forward_impl=forward_impl),
                       gpt2_tiny().replace(forward_impl=forward_impl))


def _check_metrics(m, jm, coeff_atol=None):
    for k in ("loss", "client_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=RP.PARAM_TOL["rtol"])
    assert ("zo_coeff_abs" in m) == ("zo_coeff_abs" in jm)
    if "zo_coeff_abs" in jm:
        np.testing.assert_allclose(float(m["zo_coeff_abs"]),
                                   float(jm["zo_coeff_abs"]), rtol=0,
                                   atol=coeff_atol)


# (forward_impl, scale) -> (mu, client lr): the kernel stream and the
# gaussian at the kernel round's rates, the sphere at the threefry
# rounds' (torch_round_parity.THREEFRY_RATES)
HERON_CASES = {("kernel", "gaussian"): (1e-2, 1e-3),
               ("xla", "gaussian"): RP.THREEFRY_RATES["gaussian"],
               ("xla", "sphere"): RP.THREEFRY_RATES["sphere"]}


@pytest.mark.parametrize("impl,scale", list(HERON_CASES),
                         ids=[f"{i}-{s}" for i, s in HERON_CASES])
def test_heron_train_step_matches_jax(impl, scale):
    setup = _lm_setup(impl)
    if impl == "kernel":
        assert setup[1].client_dual_loss is not None
    mu, lr = HERON_CASES[(impl, scale)]
    batches = RP.step_batches("lm", vocab=jax_gpt2_tiny().vocab)
    (jst, jm), (st, m) = RP.train_steps_pair(
        setup, "heron",
        (JZ.ZOConfig(mu=mu, scale=scale), Z.ZOConfig(mu=mu, scale=scale)),
        (JOPT.zo_sgd(lr), OPT.zo_sgd(lr)), SOPT, batches)
    RP.assert_train_state_close(st, jst, setup[2])
    d = (1.0 if scale == "gaussian" or impl == "kernel"
         else sum(x.size for x in RP.leaves(setup[2]["client"])))
    ulp = float(np.spacing(np.float32(float(jm["client_loss"]))))
    _check_metrics(m, jm, coeff_atol=COEFF_ULPS * ulp * d / mu)


@pytest.mark.parametrize("method", ["cse_fsl", "fsl_sage"])
def test_aux_head_fo_train_step_matches_jax(method):
    setup = _lm_setup("xla")
    batches = RP.step_batches("lm", vocab=jax_gpt2_tiny().vocab)
    (jst, jm), (st, m) = RP.train_steps_pair(
        setup, method, (JZ.ZOConfig(), Z.ZOConfig()),
        (JOPT.adamw(RP.FO_LR, eps=RP.FO_EPS),
         OPT.adamw(RP.FO_LR, eps=RP.FO_EPS)), SOPT, batches)
    RP.assert_train_state_close(st, jst, setup[2])
    _check_metrics(m, jm)


def test_fsl_sage_alignment_moves_the_client():
    """FSL-SAGE differs from CSE-FSL only by the alignment gradient: the
    port's two steps from one state give other client params, the same
    server params."""
    _, api, params = _lm_setup("xla")
    import torch
    from repro_torch.bridge import from_jax
    from repro_torch.core import prng as R
    b = {k: torch.as_tensor(v) for k, v in RP.step_batches(
        "lm", vocab=jax_gpt2_tiny().vocab, n=1)[0].items()}
    out = {}
    for method in ("cse_fsl", "fsl_sage"):
        opt = OPT.adamw(RP.FO_LR, eps=RP.FO_EPS)
        st = P.init_train_state(R.PRNGKey(1), from_jax(params, "cpu"), opt,
                                opt)
        out[method] = P.make_train_step(api, method, Z.ZOConfig(), opt,
                                        opt)(st, b)[0]["params"]
    cse, sage = (RP.leaves(out[k]["client"]) for k in ("cse_fsl",
                                                       "fsl_sage"))
    assert any(not np.array_equal(a, c) for a, c in zip(cse, sage))
    for a, c in zip(RP.leaves(out["cse_fsl"]["server"]),
                    RP.leaves(out["fsl_sage"]["server"])):
        np.testing.assert_array_equal(a, c)


def test_train_step_validation():
    _, api, _ = _lm_setup("xla")
    opt = OPT.adamw(1e-3)
    with pytest.raises(ValueError, match="method"):
        P.make_train_step(api, "nope", Z.ZOConfig(), opt, opt)
    with pytest.raises(TypeError, match="Placement"):
        P.make_train_step(api, "heron", Z.ZOConfig(), opt, opt,
                          client_shardings=object())
    assert JP.METHODS == P.METHODS
