"""The port's counter-hash noise stream and seed scheme against the JAX
package, bit for bit: the same seed must give the same U in JAX, in the
port's plain PyTorch version and (on the card) in kernel K1."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gpt2 import gpt2_tiny as jax_gpt2_tiny
from repro.kernels import ops as JO
from repro.kernels import zo_matmul as JZM
from repro.models import transformer as JT
from repro_torch.bridge import from_jax
from repro_torch.kernels import noise as N
from repro_torch.kernels import ops as O

jax.config.update("jax_platform_name", "cpu")

I32_MAX = 2**31 - 1


@pytest.fixture(scope="module")
def client_tree():
    params = JT.init_lm(jax.random.PRNGKey(0), jax_gpt2_tiny())
    return jax.tree.map(np.asarray, params["client"])


@pytest.mark.parametrize("rows,cols,row_off,col_off,seed", [
    (8, 16, 0, 0, 7),
    (33, 70, 5, 3, -123456789),
    (4, 5, I32_MAX - 2, -3, -1),
    (64, 48, 3 * 64, 0, I32_MAX),
    (1, 211, 2**30, 17, -2**31),
])
def test_uniform_noise_bit_equal(rows, cols, row_off, col_off, seed):
    ref = np.asarray(JZM.uniform_noise(jnp.int32(seed), (rows, cols),
                                       row_offset=jnp.int32(row_off),
                                       col_offset=jnp.int32(col_off)))
    got = N.uniform_noise(seed, (rows, cols), row_off, col_off,
                          device="cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got).max() < np.sqrt(3.0)


def test_uniform_noise_at_broadcast_and_seed_vectors():
    rng = np.random.default_rng(0)
    seeds = rng.integers(-2**31, 2**31, (5, 1, 1), dtype=np.int64)
    rows = rng.integers(0, 50432, (1, 7, 1), dtype=np.int64)
    cols = np.arange(12)[None, None, :]
    ref = np.asarray(JZM.uniform_noise_at(jnp.asarray(seeds, jnp.int32),
                                          jnp.asarray(rows, jnp.int32),
                                          jnp.asarray(cols, jnp.int32)))
    got = N.uniform_noise_at(torch.as_tensor(seeds), torch.as_tensor(rows),
                             torch.as_tensor(cols)).numpy()
    assert got.shape == (5, 7, 12)
    np.testing.assert_array_equal(got, ref)
    # the embedding-lookup form the client forward uses
    ids = torch.as_tensor(rows[0, :, 0]).reshape(7)
    np.testing.assert_array_equal(
        O.zo_noise_rows(int(seeds[2, 0, 0]), ids, 12).numpy(), ref[2])


@pytest.mark.parametrize("seed,i", [
    (0, 0), (-1, 7), (I32_MAX, -2**31), (123456789, 2**20 + 3),
])
def test_fold_seed_scalar(seed, i):
    ref = int(JO.fold_seed(jnp.int32(seed), jnp.int32(i)))
    assert O.fold_seed(seed, i) == ref


def test_fold_seed_vectors():
    rng = np.random.default_rng(1)
    seeds = rng.integers(-2**31, 2**31, (9,), dtype=np.int64)
    steps = np.arange(9)
    ref = np.asarray(JO.fold_seed(jnp.asarray(seeds, jnp.int32),
                                  jnp.asarray(steps, jnp.int32)))
    got = O.fold_seed(seeds, steps)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        O.fold_seed(seeds[3], steps),
        np.asarray(JO.fold_seed(jnp.int32(seeds[3]),
                                jnp.asarray(steps, jnp.int32))))


@pytest.mark.parametrize("path", [
    "", "embed/table", "layers/0/0/attn/wq/w", "aux/layers/0/0/mlp/up/w",
    "attn/scores", "ünïcode/path",
])
def test_path_hash(path):
    assert O.path_hash(path) == JO.path_hash(path)


@pytest.mark.parametrize("base", [0, 42, -7, I32_MAX, -2**31])
@pytest.mark.parametrize("pred", [None, "attn_kv"])
def test_leaf_seed_tree_matches_jax(client_tree, base, pred):
    jpred = JO.attn_kv_seed_pred if pred else None
    tpred = O.attn_kv_seed_pred if pred else None
    ref = JO.leaf_seed_tree(client_tree, jnp.int32(base), jpred)
    got = O.leaf_seed_tree(client_tree, base, tpred)
    ref_l = jax.tree.leaves(ref, is_leaf=lambda x: x is None)
    got_l = jax.tree.leaves(got, is_leaf=lambda x: x is None)
    assert len(ref_l) == len(got_l)
    for r, g in zip(ref_l, got_l):
        assert (r is None) == (g is None)
        if r is not None:
            assert int(r) == g                      # int32 wrapping add
    # wk/w and wv/w of the client block and the aux block
    assert sum(g is None for g in got_l) == (4 if pred else 0)


def test_attn_score_seed_matches_jax(client_tree):
    jseeds = JO.leaf_seed_tree(client_tree, jnp.int32(-99))
    tseeds = O.leaf_seed_tree(client_tree, -99)
    block_j = jseeds["layers"][0][0]["attn"]
    block_t = tseeds["layers"][0][0]["attn"]
    assert O.attn_score_seed(block_t) == int(JO.attn_score_seed(block_j))
    assert O.ATTN_SCORE_SALT == JO.ATTN_SCORE_SALT
    assert O.attn_score_seed({"wq": {"w": None}}) is None


def test_kernel_direction_tree_bit_equal(client_tree):
    params = from_jax(client_tree, device="cpu")
    for base in (5, -2**31 + 3):
        ref = JO.kernel_direction_tree(
            client_tree, JO.leaf_seed_tree(client_tree, jnp.int32(base)))
        got = O.kernel_direction_tree(params, O.leaf_seed_tree(params, base))
        for r, g in zip(jax.tree.leaves(ref), jax.tree.leaves(
                jax.tree.map(lambda t: t.numpy(), got))):
            np.testing.assert_array_equal(g, np.asarray(r))


def test_perturb_tree_matches_jax(client_tree):
    params = from_jax(client_tree, device="cpu")
    norm_j = client_tree["aux"]["norm"]
    seeds = O.leaf_seed_tree(norm_j, 11)
    ref = JO.perturb_tree(norm_j, JO.leaf_seed_tree(norm_j, jnp.int32(11)),
                          0.05, rep=2)
    got = O.perturb_tree(params["aux"]["norm"], seeds, 0.05, rep=2)
    for k in ("scale", "bias"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
