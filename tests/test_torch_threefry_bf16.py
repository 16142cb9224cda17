"""The threefry estimator on a bf16 copy of gpt2-tiny against
:mod:`repro.core.zo`, both scales: the arithmetic of the full-width
gpt2-small threefry round (bf16 params) at a size the CPU runs.  The
round itself: ``tests/test_torch_threefry_bf16_round.py``.

In bf16 the two packages' forwards round their activations in other
orders, so their losses differ by ~1e-5 relative, not by f32 ulps, and a
coefficient multiplies that gap by ``dim_factor / mu``.  Each piece is
held at the tolerance its arithmetic allows, stated where it is used:
- the probe ``theta + mu*u`` (``add_scaled``: an f32 sum cast back to
  bf16) is bit-equal to JAX's, and so is the set of entries it moves;
- the losses at those params agree within ``RP.BF16_LOSS_RTOL``, and each
  coefficient gap is no larger than its losses' gaps make it;
- Eq. 2's sphere at mu 1e-3: the probe moves under 2 % of the entries
  and the coefficients are off the same params' f32 coefficients by more
  than their size, in JAX as in the port (the reference's arithmetic)."""
import jax
import numpy as np
import pytest
import torch

import torch_round_parity as RP
from torch_round_parity import one_torch_thread  # noqa: F401
from repro.configs.gpt2 import gpt2_tiny as jax_gpt2_tiny
from repro.core import protocols as JP
from repro.core import zo as JZ
from repro_torch.bridge import from_jax
from repro_torch.configs.gpt2 import gpt2_tiny
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.tree import tree_map

jax.config.update("jax_platform_name", "cpu")

KEY = jax.random.PRNGKey(21)
# the directions are f32 whatever the params' type (test_torch_zo_threefry)
DIR_TOL = dict(rtol=4e-6, atol=1e-8)


@pytest.fixture(scope="module")
def setup():
    """``(jax_api, port_api, numpy params)`` of gpt2-tiny in bf16 (JAX's
    init), the port's copy of the params, and a batch."""
    japi, api, params = RP.bf16_lm_setup()
    toks = np.random.default_rng(4).integers(0, gpt2_tiny().vocab, (2, 17))
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    return japi, api, params, from_jax(params, device="cpu"), batch


@pytest.mark.parametrize("scale", ["sphere", "gaussian"])
def test_bf16_probe_matches_jax(setup, scale):
    """``theta + mu*u`` in bf16 bit for bit, for two pair keys; at mu
    1e-3 the sphere's ``mu*u`` (~3e-6 an entry) is under half a bf16 step
    of every weight, so only zeros (the biases) move; gaussian moves
    most entries."""
    _, _, params, tp, _ = setup
    mu = 1e-3
    zo, jzo = Z.ZOConfig(mu=mu, scale=scale), JZ.ZOConfig(mu=mu, scale=scale)
    old = RP.f32_leaves(params["client"])
    d = sum(x.size for x in old)
    for key in JZ.fold_in_range(KEY, 2):
        got = RP.f32_leaves(Z.add_scaled(tp["client"], Z.direction_like(
            np.asarray(key), tp["client"], zo), mu))
        want = RP.f32_leaves(JZ.add_scaled(params["client"], JZ.direction_like(
            key, params["client"], jzo), mu))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        moved = sum(int((b != o).sum()) for b, o in zip(want, old))
        if scale == "sphere":
            assert 0 < moved < 0.02 * d
        else:
            assert moved > 0.5 * d


@pytest.mark.parametrize("scale", ["sphere", "gaussian"])
def test_bf16_zo_gradient_matches_jax(setup, scale):
    """The clean losses within ``RP.BF16_LOSS_RTOL``; each pair's perturbed
    loss of the port against JAX's, which its coefficient gives back
    (``l_clean + coeff mu n_pairs / dim_factor``: XLA fuses the jitted
    estimator's bf16 forwards otherwise than an eager call, so JAX's
    loss is taken from the estimator itself), within ``RP.BF16_LOSS_RTOL``
    too.  That is: the coefficients differ by no more than those loss
    gaps times ``dim_factor / (mu n_pairs)``.  The port's coefficient is
    its own losses' (bit for bit); its replay of JAX's coefficients
    against JAX's gradient: the direction tolerance."""
    japi, api, params, tp, batch = setup
    cp, npc = tp["client"], params["client"]
    mu, n_pairs = 1e-3, 2
    zo = Z.ZOConfig(mu=mu, n_pairs=n_pairs, scale=scale)
    jzo = JZ.ZOConfig(mu=mu, n_pairs=n_pairs, scale=scale)
    bt = {k: torch.as_tensor(v) for k, v in batch.items()}
    gj, ij = jax.jit(lambda p, k: JZ.zo_gradient(
        lambda q: japi.client_loss(q, batch), p, k, jzo))(npc, KEY)
    with torch.no_grad():
        g, info = Z.zo_gradient(lambda q: api.client_loss(q, bt), cp,
                                np.asarray(KEY), zo)
    l0, jl0 = info["loss"], float(ij["loss"])
    np.testing.assert_allclose(float(l0), jl0, rtol=RP.BF16_LOSS_RTOL)
    dim = Z.tree_size(cp) if scale == "sphere" else 1.0
    for p, key in enumerate(Z.fold_in_range(np.asarray(KEY), n_pairs)):
        with torch.no_grad():
            lp = api.client_loss(Z.add_scaled(
                cp, Z.direction_like(key, cp, zo), mu), bt)[0]
        assert torch.equal(info["coeffs"][p],
                           dim * (lp - l0) / mu / n_pairs)
        jlp = jl0 + float(ij["coeffs"][p]) * mu * n_pairs / dim
        np.testing.assert_allclose(float(lp), jlp, rtol=RP.BF16_LOSS_RTOL)
    gr = Z.replay_gradient(cp, np.asarray(KEY),
                           torch.as_tensor(np.array(ij["coeffs"])), zo)
    ref = jax.tree.leaves(gj)
    atol = 8 * float(np.spacing(np.float32(max(
        float(np.abs(np.asarray(x)).max()) for x in ref))))
    for a, b in zip(RP.f32_leaves(gr), ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=DIR_TOL["rtol"],
                                   atol=atol)


def test_bf16_sphere_is_rounding_noise(setup):
    """Eq. 2's sphere at mu 1e-3 on bf16 params: JAX's own coefficients
    are off its coefficients on the same values in f32 (same key, same
    batch) by more than their size, and so are the port's; gaussian
    directions at the same mu stay within 20 % of f32."""
    japi, api, params, tp, batch = setup
    jcfg32 = jax_gpt2_tiny()
    japi32 = JP.lm_api(jcfg32, RP.RULES)
    api32 = P.lm_api(gpt2_tiny())
    npc32 = jax.tree.map(lambda x: np.asarray(x).astype(np.float32),
                         params["client"])
    cp32 = tree_map(lambda t: t.float(), tp["client"])
    bt = {k: torch.as_tensor(v) for k, v in batch.items()}
    for scale, worse in (("sphere", True), ("gaussian", False)):
        jzo = JZ.ZOConfig(mu=1e-3, n_pairs=4, scale=scale)
        zo = Z.ZOConfig(mu=1e-3, n_pairs=4, scale=scale)
        c = {}
        for name, a, p in (("jax", japi, params["client"]),
                           ("jax32", japi32, npc32)):
            _, info = JZ.zo_gradient(lambda q: a.client_loss(q, batch), p,
                                     KEY, jzo)
            c[name] = np.asarray(info["coeffs"], np.float64)
        with torch.no_grad():
            for name, a, p in (("port", api, tp["client"]),
                               ("port32", api32, cp32)):
                _, info = Z.zo_gradient(lambda q: a.client_loss(q, bt), p,
                                        np.asarray(KEY), zo)
                c[name] = info["coeffs"].numpy().astype(np.float64)
        for bf, f32 in (("jax", "jax32"), ("port", "port32")):
            off = np.linalg.norm(c[bf] - c[f32]) / np.linalg.norm(c[f32])
            assert (off > 1.0) if worse else (off < 0.2), (scale, bf, c)
