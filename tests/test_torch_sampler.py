"""The port's decode sampler against ``jax.random`` and the JAX
package's ``sample_logits`` on the CPU.

The uniforms behind the Gumbel noise are JAX's bit for bit (one threefry
pass over a (B, V) block, a key per row, equals ``jax.vmap`` over the
keys).  The two logs of ``-log(-log(u))`` are torch's: each within 1 f32
ulp of XLA's, the Gumbel value within 1 ulp of ``max(|g|, 1)`` (near
g = 0 an ulp of g itself is meaningless).  On seeded logits the sampled
tokens are JAX's for greedy, temperature, top-k and top-p."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_round_parity import one_torch_thread  # noqa: F401
from repro.core import decode as JD
from repro_torch.core import decode as D
from repro_torch.core import prng as R

jax.config.update("jax_platform_name", "cpu")

TINY = float(np.finfo(np.float32).tiny)


def _keys(n, seed=3):
    """``n`` per-row keys ``fold_in(PRNGKey(seed), i)``: JAX's (uint32)
    and the port's (int64) copy."""
    jk = jax.vmap(jax.random.fold_in)(
        jnp.broadcast_to(jax.random.PRNGKey(seed), (n, 2)).astype(
            jnp.uint32), jnp.arange(n))
    return jk, torch.as_tensor(np.asarray(jk).astype(np.int64))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_fold_in_rows_on_tensors_match_jax():
    """The decode loop's step keys ``fold_in(keys[b], gen[b])`` from
    tensors, without a host round trip, equal ``jax.vmap(fold_in)``."""
    jk, tk = _keys(6)
    gen = np.array([0, 1, 5, 2 ** 20, 7, 3], np.int32)
    ref = jax.vmap(jax.random.fold_in)(jk, jnp.asarray(gen))
    got = R.fold_in_many(tk, torch.as_tensor(gen))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("minval", [0.0, TINY], ids=["0", "tiny"])
def test_uniform_rows_bit_equal_jax_vmap(minval):
    """One (B, V) threefry block with a key per row == ``jax.vmap`` of
    ``jax.random.uniform`` over the keys, bit for bit; and each row ==
    the one-key :func:`prng.uniform`."""
    jk, tk = _keys(5)
    V = 3001
    ref = jax.vmap(lambda k: jax.random.uniform(k, (V,), minval=minval,
                                                maxval=1.0))(jk)
    got = R.uniform_rows(tk, V, minval, 1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(R.uniform(tk[2], (V,), minval).numpy(),
                                  got[2].numpy())


def test_gumbel_within_one_ulp_of_jax():
    """``gumbel`` (one key) and the rows' noise against
    ``jax.random.gumbel``: -log(u) within 1 ulp, the outer log of the
    same w within 1 ulp, g within 1 ulp of max(|g|, 1)."""
    jk, tk = _keys(8)
    V = 4000
    ref = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(jk))
    u = R.uniform_rows(tk, V, TINY, 1.0)
    w = -torch.log(u)
    assert _ulps(w.numpy(), -jnp.log(jnp.asarray(u.numpy()))).max() <= 1
    assert _ulps(torch.log(w).numpy(),
                 jnp.log(jnp.asarray(w.numpy()))).max() <= 1
    for got in (R._gumbel_from_uniform(u).numpy(),
                np.stack([R.gumbel(tk[i], (V,)).numpy() for i in range(8)])):
        scale = np.spacing(np.maximum(np.abs(ref), 1.0).astype(np.float32))
        assert (np.abs(got - ref) <= scale).all()
    ref1 = np.asarray(jax.random.gumbel(jk[0], (3, 50)))
    got1 = R.gumbel(tk[0], (3, 50)).numpy()
    assert (np.abs(got1 - ref1) <= np.spacing(
        np.maximum(np.abs(ref1), 1.0).astype(np.float32))).all()


def test_categorical_matches_jax():
    """One key over a batch of rows, and a key per row."""
    jk, tk = _keys(4)
    logits = np.random.default_rng(1).standard_normal((64, 300)).astype(
        np.float32) * 2
    ref = jax.random.categorical(jk[1], jnp.asarray(logits))
    got = R.categorical(tk[1], torch.as_tensor(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    jk, tk = _keys(64)
    ref = jax.vmap(jax.random.categorical)(jk, jnp.asarray(logits))
    got = R.categorical_rows(tk, torch.as_tensor(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


SAMPLERS = {
    "greedy": dict(),
    "temperature": dict(greedy=False, temperature=0.8),
    "top-k": dict(greedy=False, temperature=0.8, top_k=40),
    "top-p": dict(greedy=False, temperature=1.0, top_p=0.9),
    "top-k-top-p": dict(greedy=False, temperature=0.7, top_k=50,
                        top_p=0.95),
    "top-k-1": dict(greedy=False, temperature=0.7, top_k=1),
    "cold": dict(greedy=False, temperature=0.0),
}


@pytest.mark.parametrize("name", SAMPLERS)
def test_sample_logits_tokens_equal_jax(name):
    """Seeded (16, 4000) logits with a key per row: the port's tokens are
    JAX's."""
    jk, tk = _keys(16, seed=7)
    logits = np.random.default_rng(2).standard_normal((16, 4000)).astype(
        np.float32) * 3
    ref = JD.sample_logits(jnp.asarray(logits), jk,
                           JD.SamplerConfig(**SAMPLERS[name]))
    got = D.sample_logits(torch.as_tensor(logits), tk,
                          D.SamplerConfig(**SAMPLERS[name]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sampler_fixed_key_distribution():
    """The contract of the JAX package's test of the same name on a known
    4-token distribution: greedy and degenerate truncations give the
    argmax; fixed keys are deterministic; frequencies follow the logit
    order; top-k 2 masks tokens 2 and 3."""
    base = torch.log(torch.tensor([0.6, 0.25, 0.1, 0.05]))
    n = 512
    logits = base.expand(n, 4).contiguous()
    _, keys = _keys(n, seed=0)

    assert bool((D.sample_logits(logits, keys, D.SamplerConfig()) == 0).all())
    top1 = D.sample_logits(logits, keys, D.SamplerConfig(
        greedy=False, temperature=0.7, top_k=1))
    assert bool((top1 == 0).all())
    nucleus = D.sample_logits(logits, keys, D.SamplerConfig(
        greedy=False, temperature=1.0, top_p=0.1))
    assert bool((nucleus == 0).all())        # argmax always survives

    s = D.SamplerConfig(greedy=False, temperature=1.0)
    draws = D.sample_logits(logits, keys, s)
    assert torch.equal(draws, D.sample_logits(logits, keys, s))
    counts = np.bincount(draws.numpy(), minlength=4)
    assert counts.sum() == n and counts.argmax() == 0
    assert counts[0] > counts[3] + 50        # 0.6 vs 0.05 mass
    topk2 = D.sample_logits(logits, keys, D.SamplerConfig(
        greedy=False, temperature=1.0, top_k=2))
    assert bool((topk2 <= 1).all())          # tokens 2, 3 masked out
