"""The port's compressors (``repro_torch.distributed.collectives``)
against :mod:`repro.distributed.collectives` on the cases of
``tests/test_fault.py`` and on seeded random trees: the top-k masks are
equal (ties at the threshold kept), the int8 codes and scales bit-equal
(``torch.round`` and ``jnp.round`` both round half to even), and the
error-feedback residuals allclose at 1e-6.  Tree dicts are built with
sorted keys, so the port's leaf order is JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as JC
from repro_torch.distributed import collectives as C
from repro_torch.tree import tree_leaves, tree_map


def _trees(seed):
    """The same values as a numpy tree (for JAX) and a torch tree."""
    rng = np.random.default_rng(seed)
    np_tree = {"a": rng.standard_normal((64,)).astype(np.float32),
               "b": {"c": (3.0 * rng.standard_normal((8, 8))).astype(
                   np.float32),
                     "d": rng.standard_normal((3, 5, 7)).astype(np.float32)},
               "e": np.array([0.5, -1.5, 2.5, 127.0, -0.0, 1.0],
                             np.float32)}
    return np_tree, tree_map(torch.as_tensor, np_tree)


def _leaves_np(tree):
    return [np.asarray(x) for x in tree_leaves(tree)]


def _jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_topk_sparsify_fault_case():
    s = C.topk_sparsify({"a": torch.tensor([1.0, -5.0, 0.1, 3.0])}, 0.5)
    np.testing.assert_array_equal(s["a"].numpy(), [0.0, -5.0, 0.0, 3.0])


@pytest.mark.parametrize("frac", [1e-6, 0.1, 0.25, 0.5, 1.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_topk_masks_equal(seed, frac):
    np_tree, tree = _trees(seed)
    got = _leaves_np(C.topk_sparsify(tree, frac))
    want = _jax_leaves(JC.topk_sparsify(jax.tree.map(jnp.asarray, np_tree),
                                        frac))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a != 0, b != 0)
        np.testing.assert_array_equal(a, b)


def test_topk_keeps_ties_at_the_threshold():
    x = {"a": torch.tensor([2.0, -2.0, 1.0, 2.0, 0.5])}
    got = C.topk_sparsify(x, 0.2)["a"].numpy()     # k = 1; three tie
    want = np.asarray(JC.topk_sparsify({"a": jnp.asarray(x["a"].numpy())},
                                       0.2)["a"])
    np.testing.assert_array_equal(got, [2.0, -2.0, 0.0, 2.0, 0.0])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_codes_and_scales_bit_equal(seed):
    np_tree, tree = _trees(seed)
    q, scales = C.quantize_int8(tree)
    jq, jscales = JC.quantize_int8(jax.tree.map(jnp.asarray, np_tree))
    for a, b in zip(_leaves_np(q), _jax_leaves(jq)):
        assert a.dtype == np.int8
        np.testing.assert_array_equal(a, b)
    assert [float(s) for s in scales] == [float(s) for s in jscales]
    back = C.dequantize_int8(q, scales)
    jback = JC.dequantize_int8(jq, jscales)
    for a, b in zip(_leaves_np(back), _jax_leaves(jback)):
        np.testing.assert_array_equal(a, b)


def test_int8_roundtrip_bounded():
    _, tree = _trees(3)
    q, scales = C.quantize_int8(tree)
    for x, y in zip(tree_leaves(tree),
                    tree_leaves(C.dequantize_int8(q, scales))):
        amax = float(torch.max(torch.abs(x)))
        assert float(torch.max(torch.abs(x - y))) <= amax / 127.0 + 1e-6


def test_int8_rounds_half_to_even():
    # x / scale == 0.5, 1.5, 2.5 exactly at amax 127
    x = {"a": torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 127.0])}
    q, _ = C.quantize_int8(x)
    np.testing.assert_array_equal(q["a"].numpy(), [0, 2, 2, 0, -2, 127])


@pytest.mark.parametrize("compressor", ["topk", "int8"])
def test_error_feedback_residuals_match(compressor):
    """Twelve rounds of ``compress(g + e)`` with the port's and the
    reference's compressors on the same gradients: the sent trees and
    the residuals allclose at 1e-6."""
    ef, jef = C.ErrorFeedback(), JC.ErrorFeedback()
    if compressor == "topk":
        comp = lambda t: C.topk_sparsify(t, 0.25)               # noqa
        jcomp = lambda t: JC.topk_sparsify(t, 0.25)             # noqa
    else:
        comp = lambda t: C.dequantize_int8(*C.quantize_int8(t))  # noqa
        jcomp = lambda t: JC.dequantize_int8(*JC.quantize_int8(t))  # noqa
    np_tree, tree = _trees(4)
    err, jerr = ef.init(tree), jef.init(jax.tree.map(jnp.asarray, np_tree))
    for r in range(12):
        g_np, g = _trees(10 + r)
        c, err = ef.compress(g, err, comp)
        jc, jerr = jef.compress(jax.tree.map(jnp.asarray, g_np), jerr, jcomp)
        for a, b in zip(_leaves_np(c) + _leaves_np(err),
                        _jax_leaves(jc) + _jax_leaves(jerr)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_error_feedback_unbiased_over_time():
    ef = C.ErrorFeedback()
    g = {"a": torch.tensor([1.0, 0.5, 0.25, 0.1])}
    err = ef.init(g)
    sent = torch.zeros(4)
    for _ in range(12):
        c, err = ef.compress(g, err, lambda x: C.topk_sparsify(x, 0.25))
        sent = sent + c["a"]
    np.testing.assert_allclose((sent / 12).numpy(), g["a"].numpy(),
                               rtol=0.35)
