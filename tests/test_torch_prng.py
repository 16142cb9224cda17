"""The port's threefry (``repro_torch.core.prng``) against ``jax.random``
under the partitionable layout the JAX package sets: keys, ``fold_in``,
``split``, 32-bit bits, uniforms, permutations and Bernoulli masks bit
for bit; normals within 4 f32 ulps, most of them exactly (XLA:CPU's
``log1p`` is not correctly rounded, the port's is)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets jax_threefry_partitionable)
from repro.core import zo as JZ
from repro_torch.core import prng as R
from repro_torch.core import zo as Z
from torch_round_parity import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

SEEDS = [0, 1, 42, 2 ** 31 - 1, 20261016]
# more than 2^16 entries, odd sizes, several ranks
SHAPES = [(1,), (5,), (3, 7), (2, 3, 5), (70001,), (257, 300)]
NORMAL_ULPS = 4
# share of normals equal to JAX's bit for bit (measured ~0.990 over
# 300 x 1001 draws; the rest within 3 ulps)
NORMAL_EXACT_SHARE = 0.985


def _keys():
    """A key from a seed and two derived keys whose high word is not 0
    (every seed's key is checked in test_prng_key_fold_in_split)."""
    k = jax.random.PRNGKey(SEEDS[2])
    return [k, jax.random.fold_in(k, 777),
            jax.random.split(jax.random.PRNGKey(SEEDS[4]))[1]]


def _np(k):
    return np.asarray(k).astype(np.int64)


def _ulps(a, b):
    """Distance in f32 ulps (ordered integer views)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_split(seed):
    jk = jax.random.PRNGKey(seed)
    tk = R.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    for d in (0, 1, 2, 777, 12345, 2 ** 31, 2 ** 32 - 1):
        np.testing.assert_array_equal(R.fold_in(tk, d).numpy(),
                                      _np(jax.random.fold_in(jk, d)))
    for n in (1, 2, 3, 7, 64):
        np.testing.assert_array_equal(R.split(tk, n).numpy(),
                                      _np(jax.random.split(jk, n)))
    np.testing.assert_array_equal(
        R.fold_in_many(tk, np.arange(5)).numpy(),
        _np(jax.vmap(lambda i: jax.random.fold_in(jk, i))(jnp.arange(5))))
    assert Z.seed_from_key(tk) == int(JZ.seed_from_key(jk))


def test_fold_in_many_per_key():
    ks = jnp.stack([jax.random.PRNGKey(s) for s in SEEDS])
    d = np.arange(len(SEEDS)) * 3 + 1
    want = jax.vmap(jax.random.fold_in)(ks, jnp.asarray(d))
    np.testing.assert_array_equal(
        R.fold_in_many(torch.as_tensor(_np(ks)), d).numpy(), _np(want))
    # a key given as JAX's raw uint32 data
    np.testing.assert_array_equal(R.as_key(np.asarray(ks[1])).numpy(),
                                  _np(ks[1]))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_bit_equal(shape):
    for jk in _keys():
        tk = R.as_key(np.asarray(jk))
        np.testing.assert_array_equal(
            R.random_bits(tk, shape).numpy(),
            _np(jax.random.bits(jk, shape, jnp.uint32)))
        for lo, hi in ((0.0, 1.0), (-3.3, 7.1), (0.1, 0.3), (-1e-3, 5.0)):
            got = R.uniform(tk, shape, lo, hi).numpy()
            want = np.asarray(jax.random.uniform(jk, shape, minval=lo,
                                                 maxval=hi))
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))


def test_windows_do_not_change_the_draw(monkeypatch):
    """A draw in windows of 1000 entries equals the draw in one."""
    tk = R.fold_in(R.PRNGKey(3), 9)
    shape = (37, 101)
    one = (R.random_bits(tk, shape), R.uniform(tk, shape, -2.0, 3.0),
           R.normal(tk, shape))
    monkeypatch.setattr(R, "WINDOW", 1000)
    for a, b in zip(one, (R.random_bits(tk, shape),
                          R.uniform(tk, shape, -2.0, 3.0),
                          R.normal(tk, shape))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 5, 13, 100, 1000, 70000])
def test_permutation_bit_equal(n):
    for jk in _keys()[:2]:
        np.testing.assert_array_equal(
            R.permutation(R.as_key(np.asarray(jk)), n).numpy(),
            np.asarray(jax.random.permutation(jk, n)))


@pytest.mark.parametrize("p", [0.0, 0.05, 0.3, 0.5, 0.9, 1.0])
def test_bernoulli_bit_equal(p):
    for jk in _keys():
        for shape in ((7,), (1000,)):
            np.testing.assert_array_equal(
                R.bernoulli(R.as_key(np.asarray(jk)), p, shape).numpy(),
                np.asarray(jax.random.bernoulli(jk, p, shape)))


def test_normal_within_ulps_and_mostly_exact():
    total = exact = 0
    for jk in _keys():
        want = np.asarray(jax.random.normal(jk, (300, 1001)))
        got = R.normal(R.as_key(np.asarray(jk)), (300, 1001)).numpy()
        d = _ulps(got, want)
        assert d.max() <= NORMAL_ULPS, d.max()
        total += d.size
        exact += int((d == 0).sum())
    assert exact / total >= NORMAL_EXACT_SHARE, exact / total


@pytest.mark.parametrize("shape", SHAPES)
def test_normal_shapes(shape):
    for jk in _keys()[:2]:
        want = np.asarray(jax.random.normal(jk, shape))
        got = R.normal(R.as_key(np.asarray(jk)), shape)
        assert got.shape == shape and got.dtype == torch.float32
        assert _ulps(got.numpy(), want).max() <= NORMAL_ULPS


def test_erf_inv_matches_xla():
    """XLA's f32 ErfInv on uniforms over (-1, 1) and at the edges."""
    x = R.uniform(R.PRNGKey(5), (200000,), -1.0, 1.0)
    x = torch.cat([x, torch.tensor([0.0, -0.0, 1.0, -1.0, 0.999999,
                                    -0.9999999, 1e-30])])
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x.numpy())))
    got = R.erf_inv(x).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert _ulps(got[fin], want[fin]).max() <= NORMAL_ULPS


def _golden():
    """``chip_smoke.THREEFRY_GOLDEN``: the literals the card is held to."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.THREEFRY_GOLDEN


def test_chip_smoke_golden_table_is_jax():
    """The table chip_smoke.py holds the card's threefry to is what the
    installed jax draws (and the port on the CPU)."""
    g = _golden()
    key = jax.random.PRNGKey(g["seed"])
    k = jax.random.fold_in(key, 777)
    def u32(a):
        return np.asarray(a).astype(np.uint32).reshape(-1).tolist()

    def f32(a):
        return np.asarray(a, np.float32).view(np.uint32).tolist()

    assert u32(key) == g["key"] and u32(k) == g["fold_in_777"]
    assert [u32(r) for r in jax.random.split(k, 3)] == g["split_3"]
    assert u32(jax.random.bits(k, (8,), jnp.uint32)) == g["bits_8"]
    assert u32(jax.random.bits(k, (70001,), jnp.uint32)[-4:]) == \
        g["bits_70001_last_4"]
    assert f32(jax.random.uniform(k, (8,))) == g["uniform_8"]
    assert f32(jax.random.uniform(k, (8,), minval=-3.3, maxval=7.1)) == \
        g["uniform_m3.3_7.1_8"]
    assert f32(jax.random.normal(k, (16,))) == g["normal_16"]
    assert np.asarray(jax.random.permutation(k, 10)).tolist() == \
        g["permutation_10"]
    assert np.asarray(jax.random.bernoulli(k, 0.3, (16,))).astype(
        int).tolist() == g["bernoulli_0.3_16"]
    tk = R.fold_in(R.PRNGKey(g["seed"]), 777)
    assert R.random_bits(tk, (8,)).tolist() == g["bits_8"]
    assert R.permutation(tk, 10).tolist() == g["permutation_10"]
