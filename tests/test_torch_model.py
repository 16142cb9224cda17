"""The port's gpt2-tiny model against :mod:`repro.models.transformer` on
the same params (loaded through the bridge) and the same tokens: tree
paths and shapes, the client / aux / server forwards, the loss, and the
fused dual-probe client loss in both attention-probe modes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gpt2 import gpt2_tiny as jax_gpt2_tiny
from repro.core import protocols as JP
from repro.distributed.sharding import AxisRules
from repro.kernels import ops as JO
from repro.models import transformer as JT
from repro_torch.bridge import from_jax
from repro_torch.configs.gpt2 import gpt2_tiny
from repro_torch.core import protocols as P
from repro_torch.kernels import ops as O
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves_with_path

jax.config.update("jax_platform_name", "cpu")

RULES = AxisRules(mesh=None)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def params():
    p = JT.init_lm(jax.random.PRNGKey(0), jax_gpt2_tiny())
    return jax.tree.map(np.asarray, p)


def _tokens(b=2, s=16, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jax_gpt2_tiny().vocab, (b, s + 1))
    return toks[:, :-1], toks[:, 1:]


def test_init_lm_tree_paths_and_shapes(params):
    ours = T.init_lm(gpt2_tiny(), seed=0, device="cpu")
    # (jax.tree.map returns dicts with sorted keys: compare sorted)
    ref = sorted((p, a.shape, str(a.dtype)) for p, a in
                 tree_leaves_with_path(params))
    got = sorted((p, tuple(t.shape), str(t.dtype).split(".")[-1])
                 for p, t in tree_leaves_with_path(ours))
    assert got == ref
    # stacked (reps, ...) leaves survive the bridge with their paths
    bridged = from_jax(params, device="cpu")
    assert sorted((p, tuple(t.shape)) for p, t in tree_leaves_with_path(
        bridged)) == [(p, s) for p, s, _ in ref]


def test_forwards_and_loss_match_jax(params):
    inputs, labels = _tokens()
    jcfg, cfg = jax_gpt2_tiny(), gpt2_tiny()
    tp = from_jax(params, device="cpu")
    ti, tl = torch.as_tensor(inputs), torch.as_tensor(labels)

    s_ref, _ = JT.client_forward(params["client"], jcfg, RULES, inputs)
    s = T.client_forward(tp["client"], cfg, ti)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), **TOL)

    a_ref = JT.aux_forward(params["client"], jcfg, RULES, s_ref)
    a = T.aux_forward(tp["client"], cfg, s)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), **TOL)

    lg_ref, _ = JT.server_forward(params, jcfg, RULES, s_ref)
    lg = T.server_forward(tp, cfg, s)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)

    l_ref = JT.lm_loss(lg_ref, labels, jcfg.vocab)
    np.testing.assert_allclose(float(T.lm_loss(lg, tl, cfg.vocab)),
                               float(l_ref), rtol=1e-6)
    masked = labels.copy()
    masked[:, ::3] = -100
    np.testing.assert_allclose(
        float(T.lm_loss(lg, torch.as_tensor(masked), cfg.vocab)),
        float(JT.lm_loss(lg_ref, masked, jcfg.vocab)), rtol=1e-6)


@pytest.mark.parametrize("probe", ["weights", "scores"])
@pytest.mark.parametrize("mu", [0.0, 1e-2])
@pytest.mark.parametrize("impl", ["kernel", "kernel_interpret"])
def test_client_dual_loss_matches_jax(params, probe, mu, impl):
    """l_clean and l_pert of one fused dual-probe pass; the JAX side runs
    its xla emulation ("kernel" on CPU) or the Pallas kernels in
    interpret mode ("kernel_interpret")."""
    jcfg = dataclasses.replace(jax_gpt2_tiny(), forward_impl=impl,
                               attn_probe=probe)
    cfg = dataclasses.replace(gpt2_tiny(), attn_probe=probe,
                              forward_impl="kernel")
    japi, api = JP.lm_api(jcfg, RULES), P.lm_api(cfg)
    assert (api.seed_pred is None) == (japi.seed_pred is None)
    inputs, labels = _tokens()
    cp = params["client"]
    jseeds = JO.leaf_seed_tree(cp, jnp.int32(-12345), japi.seed_pred)
    seeds = O.leaf_seed_tree(cp, -12345, api.seed_pred)
    l0r, lpr, sr = jax.jit(japi.client_dual_loss)(
        cp, {"inputs": inputs, "labels": labels}, jseeds, mu)
    l0, lp, s = api.client_dual_loss(
        from_jax(cp, device="cpu"),
        {"inputs": torch.as_tensor(inputs),
         "labels": torch.as_tensor(labels)}, seeds, mu)
    np.testing.assert_allclose(float(l0), float(l0r), rtol=1e-5)
    np.testing.assert_allclose(float(lp), float(lpr), rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), **TOL)
    if mu == 0.0:
        assert float(l0) == float(lp)
    else:
        assert float(l0) != float(lp)


def test_partition_combine_param_bytes_match_jax(params):
    from repro.core import split as JS
    from repro_torch.core import split as S
    cp = params["client"]
    pred = lambda p: "/attn/" in p or p.startswith("embed")  # noqa: E731
    jsel, jrest = JS.partition(cp, pred)
    sel, rest = S.partition(from_jax(cp, device="cpu"), pred)
    for ours, ref in ((sel, jsel), (rest, jrest)):
        got = sorted(p for p, _ in tree_leaves_with_path(ours))
        want = sorted(p for p, _ in tree_leaves_with_path(
            jax.tree.map(np.asarray, ref)))
        assert got == want and got
    merged = S.combine(sel, rest)
    for (p, a), (q, b) in zip(tree_leaves_with_path(merged),
                              tree_leaves_with_path(from_jax(cp,
                                                             device="cpu"))):
        assert p == q and torch.equal(a, b)
    assert S.param_bytes(sel) == JS.param_bytes(jsel)
    assert S.param_bytes(from_jax(cp, device="cpu")) == JS.param_bytes(cp)
