"""The threefry ZO estimator of the port (``repro_torch.core.zo``,
``aggregate.seed_replay_aggregate``) against :mod:`repro.core.zo` on
gpt2-tiny.

The port's parameter tree comes from its own init, whose dicts are in
insertion order (``embed, layers, aux``), not sorted: leaf ``i`` of JAX's
flatten order must still get key ``i`` of the split.  Directions are held
within a few f32 ulps of JAX's (``DIR_TOL``); coefficients within the
finite-difference floor; replays are fed JAX's coefficients, so their
check sees the directions alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_round_parity as RP
from torch_round_parity import one_torch_thread  # noqa: F401
from repro.configs.gpt2 import gpt2_tiny as jax_gpt2_tiny
from repro.core import aggregate as JAG
from repro.core import protocols as JP
from repro.core import zo as JZ
from repro_torch.configs.gpt2 import gpt2_tiny
from repro_torch.core import aggregate as AG
from repro_torch.core import prng as R
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves_with_path, tree_map

jax.config.update("jax_platform_name", "cpu")

# normals within 4 ulps (test_torch_prng.py); the sphere's norm is a sum
# of ~5e4 squares in another order, a few ulps more
DIR_TOL = dict(rtol=1e-6, atol=1e-9)
KEY = jax.random.PRNGKey(21)


@pytest.fixture(scope="module")
def client():
    """gpt2-tiny's client tree from the port's init (insertion order) and
    the same values as numpy for JAX."""
    cp = T.init_lm(gpt2_tiny(), seed=0, device="cpu")["client"]
    return cp, tree_map(lambda t: t.numpy(), cp)


def _batch(seed=4):
    toks = np.random.default_rng(seed).integers(0, gpt2_tiny().vocab,
                                                (2, 17))
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


def _close(ours, ref, **tol):
    """Leaves of a port tree against a JAX tree, in JAX's order."""
    got = [t.numpy() for _, t in tree_leaves_with_path(ours,
                                                       sort_keys=True)]
    want = [np.asarray(x) for x in jax.tree.leaves(ref)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **tol)


def test_tree_is_not_in_sorted_order(client):
    cp, _ = client
    plain = [p for p, _ in tree_leaves_with_path(cp)]
    jax_order = [p for p, _ in tree_leaves_with_path(cp, sort_keys=True)]
    assert plain != jax_order and sorted(plain) != plain
    assert Z.tree_size(cp) == JZ.tree_size(client[1])


@pytest.mark.parametrize("scale", ["gaussian", "sphere"])
def test_directions_match_jax(client, scale):
    cp, npc = client
    zo, jzo = Z.ZOConfig(scale=scale), JZ.ZOConfig(scale=scale)
    for key in (KEY, jax.random.fold_in(KEY, 3)):
        got = Z.direction_like(np.asarray(key), cp, zo)
        _close(got, JZ.direction_like(key, npc, jzo), **DIR_TOL)
    # the norm of a sphere direction and of JAX's normals
    z = Z.normal_like(np.asarray(KEY), cp)
    np.testing.assert_allclose(float(Z.global_norm(z)),
                               float(JZ.global_norm(
                                   JZ.normal_like(KEY, npc))), rtol=1e-6)
    u = Z.unit_sphere_like(np.asarray(KEY), cp)
    np.testing.assert_allclose(float(Z.global_norm(u)), 1.0, rtol=1e-6)


def test_fold_in_range_matches_jax():
    np.testing.assert_array_equal(
        Z.fold_in_range(np.asarray(KEY), 5).numpy(),
        np.asarray(JZ.fold_in_range(KEY, 5)).astype(np.int64))


@pytest.mark.parametrize("scale,n_pairs", [("gaussian", 1), ("sphere", 1),
                                           ("gaussian", 3), ("sphere", 2)])
def test_zo_gradient_matches_jax(client, scale, n_pairs):
    """Coefficients: the two packages' losses differ by a few f32 ulps
    (other summation orders), and the coefficient multiplies that by
    ``dim_factor / (mu n_pairs)``: ``COEFF_ULPS`` ulps of the loss, so
    the check is absolute.  The gradient: the port's replay of JAX's
    coefficients against JAX's gradient (directions only)."""
    cp, npc = client
    mu = 1e-2
    zo = Z.ZOConfig(mu=mu, n_pairs=n_pairs, scale=scale)
    jzo = JZ.ZOConfig(mu=mu, n_pairs=n_pairs, scale=scale)
    bj = _batch()
    bt = {k: torch.as_tensor(v) for k, v in bj.items()}
    japi = JP.lm_api(jax_gpt2_tiny(), RP.RULES)
    api = P.lm_api(gpt2_tiny())
    gj, ij = jax.jit(lambda p, k: JZ.zo_gradient(
        lambda q: japi.client_loss(q, bj), p, k, jzo))(npc, KEY)
    with torch.no_grad():
        g, info = Z.zo_gradient(lambda q: api.client_loss(q, bt), cp,
                                np.asarray(KEY), zo)
    np.testing.assert_allclose(float(info["loss"]), float(ij["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(info["aux"].numpy(), np.asarray(ij["aux"]),
                               rtol=1e-5, atol=1e-5)
    dim = Z.tree_size(cp) if scale == "sphere" else 1.0
    floor = COEFF_ULPS * float(np.spacing(np.float32(info["loss"]))) \
        * dim / (mu * n_pairs)
    assert info["coeffs"].shape == (n_pairs,)
    np.testing.assert_allclose(info["coeffs"].numpy(),
                               np.asarray(ij["coeffs"]), rtol=0, atol=floor)
    jc = torch.as_tensor(np.array(ij["coeffs"]))
    gr = Z.replay_gradient(cp, np.asarray(KEY), jc, zo)
    _close(gr, gj, rtol=DIR_TOL["rtol"] * 4, atol=_replay_atol(gj))
    # the port's own gradient is its own replay of its coefficients
    mine = Z.replay_gradient(cp, np.asarray(KEY), info["coeffs"], zo)
    for (_, x), (_, y) in zip(tree_leaves_with_path(mine),
                              tree_leaves_with_path(g)):
        assert torch.equal(x, y)


COEFF_ULPS = 8


def _replay_atol(ref_tree):
    """Cancellation across pairs: a few ulps of the largest entry."""
    return 8 * float(np.spacing(np.float32(max(
        float(np.abs(np.asarray(x)).max()) for x in jax.tree.leaves(
            ref_tree)))))


def _close_update(got, want, cp, npc):
    """The updates ``new - old`` of both packages: the direction
    tolerance, and a few ulps of the largest entry for the rounding of
    ``old + update`` and for cancellation across directions."""
    delta = tree_map(lambda a, b: a - b, got, cp)
    jdelta = jax.tree.map(lambda a, b: np.asarray(a) - b, want, npc)
    _close(delta, jdelta, rtol=DIR_TOL["rtol"] * 4,
           atol=_replay_atol(jdelta) + _replay_atol(want) / 4)


@pytest.mark.parametrize("scale", ["gaussian", "sphere"])
def test_replay_update_matches_jax(client, scale):
    cp, npc = client
    zo, jzo = Z.ZOConfig(scale=scale), JZ.ZOConfig(scale=scale)
    coeffs = np.array([0.7, -1.3], np.float32)
    got = Z.replay_update(cp, np.asarray(KEY), torch.as_tensor(coeffs),
                          0.05, zo)
    want = JZ.replay_update(npc, KEY, jnp.asarray(coeffs), 0.05, jzo)
    _close_update(got, want, cp, npc)
    got_c, got_l = Z.zo_projected_coeffs(
        lambda q: (Z.global_norm(q), None), cp, np.asarray(KEY), zo)
    assert got_c.shape == (1,) and float(got_l) == float(Z.global_norm(cp))


@pytest.mark.parametrize("mask", [None, [1.0, 0.0, 1.0]])
@pytest.mark.parametrize("scale", ["gaussian", "sphere"])
def test_seed_replay_aggregate_matches_jax(client, scale, mask):
    """JAX's coefficients and client keys in, one flat walk: the update
    (new - old) within the direction tolerance; a masked-out client's
    coefficients never reach it."""
    cp, npc = client
    zo, jzo = Z.ZOConfig(scale=scale), JZ.ZOConfig(scale=scale)
    rng = np.random.default_rng(5)
    coeffs = rng.standard_normal((3, 2, 2)).astype(np.float32)
    keys = JZ.fold_in_range(KEY, 3)
    tmask = None if mask is None else torch.tensor(mask)
    got = AG.seed_replay_aggregate(cp, np.asarray(keys),
                                   torch.as_tensor(coeffs), 0.05, zo, tmask)
    want = JAG.seed_replay_aggregate(
        npc, keys, jnp.asarray(coeffs), 0.05, jzo,
        None if mask is None else jnp.asarray(mask))
    _close_update(got, want, cp, npc)
    if mask is not None:
        poisoned = coeffs.copy()
        poisoned[1] = 1e6
        again = AG.seed_replay_aggregate(cp, np.asarray(keys),
                                         torch.as_tensor(poisoned), 0.05,
                                         zo, tmask)
        for (_, a), (_, b) in zip(tree_leaves_with_path(again),
                                  tree_leaves_with_path(got)):
            assert torch.equal(a, b)


def test_replay_tokens_match_jax():
    coeffs = np.ones((3, 2, 4), np.float32)
    keys = JZ.fold_in_range(KEY, 3)
    w = jnp.asarray([1.0, 0.0, 1.0])
    jt, js = JAG.replay_token_stream(keys, jnp.asarray(coeffs), 0.1, w, 2.0)
    tt, ts = AG.replay_token_stream(np.asarray(keys),
                                    torch.as_tensor(coeffs), 0.1,
                                    torch.as_tensor(np.array(w)), 2.0)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt).astype(np.int64))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_n_pairs_0(client):
    """As the reference: the clean loss and aux, a zero f32 gradient and
    coefficients of shape (0,); replaying none is zero."""
    cp, npc = client
    bj = _batch()
    bt = {k: torch.as_tensor(v) for k, v in bj.items()}
    japi = JP.lm_api(jax_gpt2_tiny(), RP.RULES)
    jzo = JZ.ZOConfig(n_pairs=0)
    _, ij = JZ.zo_gradient(lambda q: japi.client_loss(q, bj), npc, KEY, jzo)
    with torch.no_grad():
        g, info = Z.zo_gradient(
            lambda q: P.lm_api(gpt2_tiny()).client_loss(q, bt), cp,
            np.asarray(KEY), Z.ZOConfig(n_pairs=0))
    assert info["coeffs"].shape == (0,) == ij["coeffs"].shape
    np.testing.assert_allclose(float(info["loss"]), float(ij["loss"]),
                               rtol=1e-6)
    for _, t in tree_leaves_with_path(g):
        assert t.dtype == torch.float32 and not bool(t.any())
    r = Z.replay_gradient(cp, np.asarray(KEY), torch.zeros((0,)),
                          Z.ZOConfig())
    assert all(not bool(t.any()) for _, t in tree_leaves_with_path(r))


def test_seed_from_key_and_key_forms():
    for k in (KEY, jax.random.PRNGKey(2 ** 31 - 1),
              jax.random.fold_in(KEY, 5)):
        want = int(JZ.seed_from_key(k))
        for form in (np.asarray(k), tuple(int(w) for w in np.asarray(k)),
                     torch.as_tensor(np.asarray(k).astype(np.int64))):
            assert Z.seed_from_key(form) == want
    assert R.as_key(np.asarray(KEY)).dtype == torch.int64
