"""The port's data (:mod:`repro_torch.data`), its ``prng.randint`` and
``prng.categorical(shape=)``, the JAX-keyed init and ``gpt2_medium``
against the JAX package: randint, categorical labels, bigram batches,
round batches and partitions bit for bit; the mixture images within 4
f32 ulps of ``noise`` (the port's normals are within 4 ulps of JAX's);
``init_lm(key=)`` within 4 f32 ulps of each leaf's largest entry."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gpt2 import gpt2_medium as jax_gpt2_medium
from repro.configs.gpt2 import gpt2_tiny as jax_gpt2_tiny
from repro.configs.qwen2_1_5b import smoke_config as jax_qwen_smoke
from repro.configs.kimi_k2_1t_a32b import smoke_config as jax_kimi_smoke
from repro.configs.qwen3_moe_30b_a3b import smoke_config as jax_moe_smoke
from repro.configs.recurrentgemma_9b import smoke_config as jax_rg_smoke
from repro.configs.xlstm_1_3b import smoke_config as jax_xlstm_smoke
from repro.data import partition as JPA
from repro.data import pipeline as JPL
from repro.data import synthetic as JS
from repro.models import transformer as JT
from repro_torch.configs.gpt2 import gpt2_medium, gpt2_tiny
from repro_torch.configs.qwen2_1_5b import smoke_config as qwen_smoke
from repro_torch.configs.kimi_k2_1t_a32b import smoke_config as kimi_smoke
from repro_torch.configs.qwen3_moe_30b_a3b import smoke_config as moe_smoke
from repro_torch.configs.recurrentgemma_9b import smoke_config as rg_smoke
from repro_torch.configs.xlstm_1_3b import smoke_config as xlstm_smoke
from repro_torch.core import prng as R
from repro_torch.data import partition as PA
from repro_torch.data import pipeline as PL
from repro_torch.data import synthetic as S
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves_with_path

SHAPES = [(), (8,), (3, 5)]
ULP = float(np.finfo(np.float32).eps)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("maxval", [4, 10, 211, 50257, 151936])
def test_randint_equals_jax(maxval, shape):
    for seed in (0, 7, 2 ** 31 - 1):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                             shape, 0, maxval))
        got = R.randint(R.PRNGKey(seed), shape, 0, maxval).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_randint_offset_and_empty_span_equal_jax():
    k = jax.random.PRNGKey(3)
    for lo, hi in ((-5, 9), (100, 70000), (5, 5), (9, 2)):
        np.testing.assert_array_equal(
            R.randint(R.PRNGKey(3), (16,), lo, hi).numpy(),
            np.asarray(jax.random.randint(k, (16,), lo, hi)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("classes", [4, 10])
def test_categorical_shape_equals_jax(classes, shape):
    logits = np.log(np.random.default_rng(classes).dirichlet(
        [0.5] * classes)).astype(np.float32)
    for seed in (1, 2):
        want = np.asarray(jax.random.categorical(
            jax.random.PRNGKey(seed), jnp.asarray(logits), shape=shape))
        got = R.categorical(R.PRNGKey(seed), torch.as_tensor(logits),
                            shape=shape).numpy()
        np.testing.assert_array_equal(got, want)


def test_categorical_shape_must_end_in_batch():
    with pytest.raises(ValueError, match="batch shape"):
        R.categorical(R.PRNGKey(0), torch.zeros((3, 4)), shape=(2,))


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_bigram_batch_equals_jax():
    ds, jds = S.BigramLM(211, 17, seed=1), JS.BigramLM(211, 17, seed=1)
    for seed in (0, 5):
        _assert_batches_equal(ds.batch(R.PRNGKey(seed), 4),
                              jds.batch(jax.random.PRNGKey(seed), 4))


def test_round_batches_equal_jax():
    ds, jds = S.BigramLM(211, 9), JS.BigramLM(211, 9)
    rb = PL.round_batches(ds, R.PRNGKey(3), 3, 2, 2)
    assert rb["inputs"].shape == (3, 2, 2, 8)
    _assert_batches_equal(rb, JPL.round_batches(jds, jax.random.PRNGKey(3),
                                                3, 2, 2))


def test_mixture_images_equal_jax():
    g = S.GaussianMixtureImages(classes=10, hw=8, noise=0.6)
    jg = JS.GaussianMixtureImages(classes=10, hw=8, noise=0.6)
    probs = PA.dirichlet_client_probs(3, 10, 0.3, seed=2)
    jprobs = JPA.dirichlet_client_probs(3, 10, 0.3, seed=2)
    for cp, jcp in ((None, None), (probs[1], jprobs[1])):
        got = g.batch(R.PRNGKey(4), 32, cp)
        want = jg.batch(jax.random.PRNGKey(4), 32, jcp)
        np.testing.assert_array_equal(got["labels"].numpy(),
                                      np.asarray(want["labels"]))
        # the normals z are within 4 ulps of JAX's and |z| < 8 here, so
        # the images (mean + noise z) are within 4 ulps of 8 times noise
        np.testing.assert_allclose(got["inputs"].numpy(),
                                   np.asarray(want["inputs"]), rtol=0,
                                   atol=4 * ULP * 8 * 0.6)
    rb = PL.round_batches(g, R.PRNGKey(5), 3, 2, 4, client_probs=probs)
    jrb = JPL.round_batches(jg, jax.random.PRNGKey(5), 3, 2, 4,
                            client_probs=jprobs)
    np.testing.assert_array_equal(rb["labels"].numpy(),
                                  np.asarray(jrb["labels"]))


@pytest.mark.parametrize("alpha", [0.1, 1.0, float("inf"), 0.0])
def test_partitions_equal_jax(alpha):
    got = PA.dirichlet_client_probs(5, 10, alpha, seed=3)
    want = JPA.dirichlet_client_probs(5, 10, alpha, seed=3)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(PA.iid_client_probs(4, 3).numpy(),
                                  np.asarray(JPA.iid_client_probs(4, 3)))


def test_place_batch():
    b = PL.place_batch({"x": torch.ones(2)}, "cpu")
    assert b["x"].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PL.place_batch({"x": torch.ones(2)})


def test_gpt2_medium_equals_jax():
    got, want = gpt2_medium(), jax_gpt2_medium()
    for f in dataclasses.fields(got):
        if f.name == "pattern":
            assert [(s.mixer, s.ffn) for s in got.pattern] == [
                (s.mixer, s.ffn) for s in want.pattern]
        else:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.n_layers, got.d_model, got.cut_layers, got.aux_layers) == (
        24, 1024, 6, 3)


@pytest.mark.parametrize("pair", [
    (jax_gpt2_tiny, gpt2_tiny), (jax_qwen_smoke, qwen_smoke),
    (jax_rg_smoke, rg_smoke), (jax_xlstm_smoke, xlstm_smoke),
    (jax_moe_smoke, moe_smoke), (jax_kimi_smoke, kimi_smoke)],
    ids=["gpt2-tiny", "qwen2-smoke", "recurrentgemma-smoke", "xlstm-smoke",
         "qwen3-moe-smoke", "kimi-k2-smoke"])
def test_init_lm_with_key_equals_jax_init(pair):
    jcfg, cfg = pair[0](), pair[1]()
    want = jax.tree.leaves(JT.init_lm(jax.random.PRNGKey(0), jcfg))
    got = [t for _, t in tree_leaves_with_path(
        T.init_lm(cfg, device="cpu", key=R.PRNGKey(0)), sort_keys=True)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == cfg.torch_param_dtype()
        b = np.asarray(b, np.float32)
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.float().numpy(), b, rtol=0,
                                   atol=4 * ULP * max(np.abs(b).max(),
                                                      1e-30))


def test_init_rules_are_the_generator_trees():
    """The JAX-keyed init draws the rules the layers' init functions
    state (``init_param`` given ``RULES``): one rule per leaf of the
    generator's tree, of its shape and dtype (a stacked leaf's reps in
    ``reps``), zeros and ones where the generator's tree has them."""
    from repro_torch.models import layers as L
    cfg = rg_smoke()
    rules = tree_leaves_with_path(T._lm_tree(cfg, L.RULES), sort_keys=True)
    drawn = tree_leaves_with_path(T.init_lm(cfg, seed=1, device="cpu"),
                                  sort_keys=True)
    assert [p for p, _ in rules] == [p for p, _ in drawn]
    inits = set()
    for (path, rule), (_, t) in zip(rules, drawn):
        shape = ((rule.reps,) if rule.reps else ()) + rule.shape
        assert shape == tuple(t.shape) and rule.dtype == t.dtype, path
        assert rule.reps == (t.shape[0] if "layers" in path else 0), path
        if rule.init in ("zeros", "ones"):
            assert bool((t == (rule.init == "ones")).all()), path
        inits.add(rule.init)
    assert inits == {"zeros", "normal", "lru_lambda"}
