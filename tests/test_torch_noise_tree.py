"""Kernel K1's tree launch on the CPU: its segment table as a pure
function of the leaves, the plain versions of its accumulate and perturb
modes against the JAX package's direction accumulation and
``perturb_tree`` bit for bit, and the ZO estimator at ``n_pairs=0``
against :func:`repro.core.zo.zo_gradient_kernel`.

The JAX side runs eagerly, op by op, as the reference writes the
accumulation (``g + coeff * u``), so both sides round the product, then
the sum, and agree bit for bit."""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gpt2 import gpt2_tiny as jax_gpt2_tiny
from repro.core import zo as JZ
from repro.kernels import ops as JO
from repro.models import transformer as JT
from repro_torch.bridge import from_jax
from repro_torch.core import zo as Z
from repro_torch.kernels import ops as O
from repro_torch.kernels import zo_matmul as ZM
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def client_tree():
    params = JT.init_lm(jax.random.PRNGKey(0), jax_gpt2_tiny())
    return jax.tree.map(np.asarray, params["client"])


def _segments(tree, seeds, rep=0):
    return [O.leaf_segment(s, p.shape, rep) for p, s in zip(
        tree_leaves(tree), tree_leaves(seeds))]


def test_segment_table_covers_each_seeded_leaf_once(client_tree):
    """Every leaf of the gpt2-tiny client tree is one segment of one
    launch, in traversal order, with ceil(rows/32) * ceil(cols/128)
    tiles and prefix sums as its tile0."""
    params = from_jax(client_tree, device="cpu")
    segs = _segments(params, O.leaf_seed_tree(params, 3))
    launches = ZM.plan_launches(segs)
    assert len(launches) == 1
    idx, t0s, total = launches[0]
    assert idx == list(range(len(segs)))
    tiles = [-(-s.rows // 32) * -(-s.cols // 128) for s in segs]
    assert [s.tiles for s in segs] == tiles
    assert t0s == list(np.cumsum([0] + tiles[:-1]))
    assert total == sum(tiles)
    for seg, p in zip(segs, tree_leaves(params)):
        assert seg.rows * seg.cols == p.numel()


@pytest.mark.parametrize("n,limit", [(150, 64), (64, 64), (65, 64),
                                     (7, 3)])
def test_segment_table_chunks_past_the_parameter_limit(n, limit):
    """A tree of more leaves than a launch's table holds splits into
    launches of at most ``limit`` segments, each with its own prefix
    sums; leaves without elements take no place."""
    segs = [ZM.Segment(1 + i % 70, 1 + (7 * i) % 300, i) for i in range(n)]
    segs.insert(5, ZM.Segment(0, 12, 99))
    launches = ZM.plan_launches(segs, limit)
    assert len(launches) == -(-n // limit)
    seen = []
    for idx, t0s, total in launches:
        assert 0 < len(idx) <= limit
        tiles = [segs[i].tiles for i in idx]
        assert t0s == list(np.cumsum([0] + tiles[:-1]))
        assert total == sum(tiles)
        seen += idx
    assert seen == [i for i, s in enumerate(segs) if s.rows * s.cols]


def test_segment_table_layout_matches_the_kernel():
    """The ctypes table has the layout csrc/zo_noise.cu asserts: 56-byte
    segments, 64 of them, then the launch's fields; 3,616 bytes, inside
    the 4 KB kernel parameter space."""
    assert ZM.MAX_SEGMENTS == 64
    assert ctypes.sizeof(ZM._Segment) == 56
    assert ctypes.sizeof(ZM._Table) == 64 * 56 + 32 <= 4096
    assert ZM._Segment.flags.offset == 48
    assert ZM._Table.tiles.offset == 64 * 56
    assert ZM._Table.mu.offset == 64 * 56 + 24


@pytest.mark.parametrize("base", [5, -2**31 + 3])
@pytest.mark.parametrize("pred", [None, "attn_kv"])
def test_accumulate_mode_matches_jax_accumulation(client_tree, base, pred):
    """Two pairs of ``g + coeff * u`` into an f32 tree: the port's
    accumulate mode (plain version) against the JAX directions
    accumulated eagerly, bit for bit; with the score-probe predicate the
    k/v leaves have no seed and add a zero direction."""
    params = from_jax(client_tree, device="cpu")
    jpred = JO.attn_kv_seed_pred if pred else None
    tpred = O.attn_kv_seed_pred if pred else None
    g = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32), params)
    jg = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), client_tree)
    for k, coeff in enumerate((0.37, -1.25e-3)):
        sp = O.fold_seed(base, k)
        c = torch.tensor(coeff, dtype=torch.float32)
        assert O.accumulate_direction_tree(
            g, O.leaf_seed_tree(params, sp, tpred), c) is g
        ju = JO.kernel_direction_tree(
            client_tree, JO.leaf_seed_tree(client_tree, jnp.int32(sp), jpred))
        jc = jnp.float32(coeff)
        jg = jax.tree.map(lambda gl, ul: gl + jc * ul, jg, ju)
    got = tree_leaves_with_path(g)
    want = jax.tree.leaves(jg)
    assert len(got) == len(want)
    for (path, a), b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=path)


@pytest.mark.parametrize("rep", [0, 1])
def test_perturb_mode_matches_jax_perturb_tree(client_tree, rep):
    """``theta + mu*U`` over the whole gpt2-tiny client tree (f32) and in
    bf16, at rep 0 and rep 1 (the rows of a stacked leaf's second slice):
    the port's perturb mode against the JAX ``perturb_tree``, bit for
    bit."""
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        jtree = jax.tree.map(lambda p: jnp.asarray(p, jdtype), client_tree)
        params = tree_map(lambda p: p.to(dtype),
                          from_jax(client_tree, device="cpu"))
        seeds = O.leaf_seed_tree(params, 11)
        got = O.perturb_tree(params, seeds, 0.05, rep=rep)
        ref = JO.perturb_tree(jtree, JO.leaf_seed_tree(jtree, jnp.int32(11)),
                              0.05, rep=rep)
        for a, b in zip(tree_leaves(got), jax.tree.leaves(ref)):
            assert a.dtype == dtype
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))


def test_perturb_mode_leaves_unseeded_leaves_alone(client_tree):
    """Leaves whose seed is None come back as the same tensors."""
    params = from_jax(client_tree, device="cpu")
    seeds = O.leaf_seed_tree(params, 4, O.attn_kv_seed_pred)
    got = O.perturb_tree(params, seeds, 0.1)
    same = [a is b for a, b in zip(tree_leaves(got), tree_leaves(params))]
    unseeded = [s is None for _, _, s in O._paired_leaves(params, seeds)]
    assert same == unseeded and sum(same) == 4   # the k/v weights


def test_cpu_tree_calls_count_no_launch(client_tree):
    """The plain versions run for CPU tensors: no K1 launch is counted."""
    params = from_jax(client_tree, device="cpu")
    before = ZM.LAUNCHES["zo_noise"]
    seeds = O.leaf_seed_tree(params, 9)
    O.kernel_direction_tree(params, seeds)
    O.perturb_tree(params, seeds, 1e-3)
    O.accumulate_direction_tree(
        tree_map(lambda p: torch.zeros(p.shape), params), seeds, 0.5)
    assert ZM.LAUNCHES["zo_noise"] == before


def test_zo_gradient_kernel_n_pairs_0_matches_jax(client_tree):
    """With no pairs the reference evaluates the dual loss once on the
    base seed's tree and returns a zero gradient, the clean loss and aux,
    and coefficients of shape (0,); the port does the same."""
    params = from_jax(client_tree, device="cpu")

    def jloss(p, seeds, mu):
        s = sum(jnp.sum(x * x) for x in jax.tree.leaves(p))
        return s, s + mu, {"seed": min(int(x) for x in
                                       jax.tree.leaves(seeds))}

    def tloss(p, seeds, mu):
        s = sum(torch.sum(x * x) for x in tree_leaves(p))
        return s, s + mu, {"seed": min(tree_leaves(seeds))}

    jg, jinfo = JZ.zo_gradient_kernel(jloss, client_tree, jnp.int32(77),
                                      JZ.ZOConfig(mu=1e-2, n_pairs=0))
    g, info = Z.zo_gradient_kernel(tloss, params, 77,
                                   Z.ZOConfig(mu=1e-2, n_pairs=0))
    assert info["coeffs"].shape == (0,) == jinfo["coeffs"].shape
    assert info["coeffs"].dtype == torch.float32
    # f32 sums of squares in two orders
    np.testing.assert_allclose(float(info["loss"]), float(jinfo["loss"]),
                               rtol=1e-5)
    assert info["aux"]["seed"] == jinfo["aux"]["seed"]   # the base seed
    for a, b in zip(tree_leaves(g), jax.tree.leaves(jg)):
        assert a.dtype == torch.float32 and not a.any()
        assert a.shape == b.shape
    assert Z.replay_gradient_kernel(params, 77, info["coeffs"]) is not None


def test_tree_calls_keep_no_reference_to_leaves():
    """The tree walks hold no leaf after they return: without the cyclic
    garbage collector, a tree's tensors are freed as soon as the caller
    drops them (a reference cycle kept a round's f32 accumulator and the
    f32 tied table alive on the card, 270 MB above the peak)."""
    import gc
    import weakref
    was = gc.isenabled()
    gc.disable()
    try:
        acc = {"a": torch.zeros(10), "b": [torch.zeros(3, 4), None]}
        refs = [weakref.ref(acc["a"]), weakref.ref(acc["b"][0])]
        O.accumulate_direction_tree(acc, {"a": 5, "b": [6, None]}, 0.5)
        p = torch.ones(7)
        refs += [weakref.ref(p)]
        out = O.perturb_tree(p, 3, 0.1)
        refs += [weakref.ref(out)]
        u = O.kernel_direction_tree({"w": p}, {"w": 4})
        refs += [weakref.ref(u["w"])]
        del acc, p, out, u
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        if was:
            gc.enable()
