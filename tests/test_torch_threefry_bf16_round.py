"""One HERON round on the threefry stream on a bf16 copy of gpt2-tiny
(N=3, h=1, seed_replay, ``THREEFRY_RATES``), the port against
:mod:`repro.core.protocols`, both scales: the round of the full-width
gpt2-small threefry phase at a size the CPU runs.

The two packages' bf16 forwards and backwards round in other places, so
their states are not held at ``PARAM_TOL``; each part is held at what
bf16 arithmetic allows, stated in the test (the estimator's pieces:
``tests/test_torch_threefry_bf16.py``)."""
import jax
import numpy as np
import pytest
import torch

import torch_round_parity as RP
from torch_round_parity import one_torch_thread  # noqa: F401
from repro.configs.gpt2 import gpt2_tiny as jax_gpt2_tiny
from repro.core import protocols as JP
from repro.core import zo as JZ
from repro.optim import optimizers as JOPT
from repro_torch.bridge import from_jax
from repro_torch.core import prng as R
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.optim import optimizers as OPT

jax.config.update("jax_platform_name", "cpu")

KEY = jax.random.PRNGKey(13)
N = RP.THREEFRY_N


@pytest.fixture(scope="module")
def setup():
    japi, api, params = RP.bf16_lm_setup()
    rb = RP.round_batch("lm", N, 1, vocab=jax_gpt2_tiny().vocab)
    return japi, api, params, rb


def _rounds(setup, scale):
    japi, api, params, rb = setup
    mu, lr = RP.THREEFRY_RATES[scale]
    kw = dict(uplink="seed_replay", client_lr=lr)
    fed = dict(n_clients=N, h=1)
    return RP.jax_round(japi, "heron", params, rb, JP.FedConfig(**fed),
                        JOPT.zo_sgd(lr), JOPT.adamw(RP.THREEFRY_SERVER_LR),
                        KEY, JZ.ZOConfig(mu=mu, scale=scale), **kw), \
        RP.port_round(api, "heron", params, rb, P.FedConfig(**fed),
                      OPT.zo_sgd(lr), OPT.adamw(RP.THREEFRY_SERVER_LR), KEY,
                      Z.ZOConfig(mu=mu, scale=scale), **kw)


@pytest.fixture(scope="module")
def f32_moments(setup):
    """The server's AdamW moments after JAX's round on the same values in
    f32: the yardstick of bf16's own error.  With h=1 the server trains
    on the clean forward's smashed data, so they do not depend on the
    scale."""
    _, _, params, rb = setup
    p32 = jax.tree.map(lambda x: np.asarray(x).astype(np.float32), params)
    mu, lr = RP.THREEFRY_RATES["gaussian"]
    ref, _ = RP.jax_round(JP.lm_api(jax_gpt2_tiny(), RP.RULES), "heron", p32,
                          rb, JP.FedConfig(n_clients=N, h=1),
                          JOPT.zo_sgd(lr), JOPT.adamw(RP.THREEFRY_SERVER_LR),
                          KEY, JZ.ZOConfig(mu=mu), uplink="seed_replay",
                          client_lr=lr)
    return {k: np.concatenate([x.ravel() for x in RP.f32_leaves(
        ref["opt_server"][k])]) for k in ("m", "v")}


def _coeff_spread(setup, scale):
    """``|lr / N sum_i (c_i - c_i^JAX) u_i|`` entrywise, in JAX's leaf
    order: the replay of the gaps between the two packages' coefficients,
    each client's ``zo_gradient`` on its batch and step key in both."""
    japi, api, params, rb = setup
    mu, lr = RP.THREEFRY_RATES[scale]
    zo, jzo = Z.ZOConfig(mu=mu, scale=scale), JZ.ZOConfig(mu=mu, scale=scale)
    cp = from_jax(params, device="cpu")["client"]
    jcoeffs = jax.jit(lambda p, k, b: JZ.zo_gradient(
        lambda q: japi.client_loss(q, b), p, k, jzo)[1]["coeffs"])
    spread = [np.zeros(x.shape, np.float64)
              for x in RP.f32_leaves(params["client"])]
    for i in range(N):
        bi = {k: v[i, 0] for k, v in rb.items()}
        bt = {k: torch.as_tensor(v) for k, v in bi.items()}
        sk = R.fold_in(R.fold_in(np.asarray(KEY), i), 0)
        jc = np.asarray(jcoeffs(params["client"], jax.random.fold_in(
            jax.random.fold_in(KEY, i), 0), bi), np.float64)
        with torch.no_grad():
            _, info = Z.zo_gradient(lambda q: api.client_loss(q, bt), cp,
                                    sk, zo)
        dc = info["coeffs"].numpy().astype(np.float64) - jc
        for p, kp in enumerate(Z.fold_in_range(sk, len(dc))):
            u = RP.f32_leaves(Z.direction_like(kp, cp, zo))
            for s, x in zip(spread, u):
                s += lr / N * dc[p] * x
    return [np.abs(s) for s in spread]


@pytest.mark.parametrize("scale", ["sphere", "gaussian"])
def test_bf16_round_matches_jax(setup, f32_moments, scale):
    """- the losses within ``BF16_LOSS_RTOL``; participants and bytes
      equal;
    - the server's AdamW moments (f32) no further from JAX's than twice
      JAX's own bf16 moments are from the f32 round's;
    - each server param within one bf16 step plus 2 N h server lr: the
      server takes N h AdamW steps (one a client and local step), each
      moves an entry by ~lr (m / sqrt(v) ~ sign(g) while the gradients
      keep their scale), and a near-zero g may take the other sign in
      the other package;
    - each client param within one bf16 step plus the replay of the
      coefficient gaps (:func:`_coeff_spread`; the gaps are bounded by
      the losses in ``test_torch_threefry_bf16.py``)."""
    (ref, jm), (new, m) = _rounds(setup, scale)
    for k in ("client_loss", "server_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=RP.BF16_LOSS_RTOL)
    for k in ("participants", "uplink_bytes", "uplink_bytes_dense"):
        assert float(m[k]) == float(jm[k]), k
    for k, y32 in f32_moments.items():
        a, b = (np.concatenate([x.ravel() for x in RP.f32_leaves(
            s["opt_server"][k])]) for s in (new, ref))
        assert np.linalg.norm(a - b) <= 2 * np.linalg.norm(b - y32), (
            k, np.linalg.norm(a - b), np.linalg.norm(b - y32))
    for a, b in zip(RP.f32_leaves(new["server"]),
                    RP.f32_leaves(ref["server"])):
        assert (np.abs(a - b) <= RP.bf16_step(a, b)
                + 2 * N * RP.THREEFRY_SERVER_LR).all(), np.abs(a - b).max()
    for a, b, s in zip(RP.f32_leaves(new["client"]),
                       RP.f32_leaves(ref["client"]),
                       _coeff_spread(setup, scale)):
        assert (np.abs(a - b) <= RP.bf16_step(a, b) + s * (1 + 1e-3)
                + 1e-7).all(), (np.abs(a - b).max(), s.max())
