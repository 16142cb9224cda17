"""The single-probe ZO forward (``Perturb(dual=False)``) of the port
against the JAX package: kernel K4's plain version against the Pallas
``zo_matmul`` in interpret mode, the two-pass baseline
``zo_dual_forward_split``, K5's CPU path against the Pallas
``flash_attention``, and the gpt2-tiny and CNN single-probe losses and
smashed data against the JAX forwards with the Pallas kernels
interpreted (f32, rtol=1e-5, atol=1e-5)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gpt2 import gpt2_tiny as jax_gpt2_tiny
from repro.configs.resnet18_cifar import smoke_config as jax_smoke_config
from repro.distributed.sharding import AxisRules
from repro.kernels import flash_attention as JFA
from repro.kernels import ops as JO
from repro.kernels import zo_matmul as JZM
from repro.models import cnn as JCNN
from repro.models import transformer as JT
from repro_torch.bridge import from_jax
from repro_torch.configs.gpt2 import gpt2_tiny
from repro_torch.configs.resnet18_cifar import smoke_config
from repro_torch.core import protocols as P
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as O
from repro_torch.kernels import zo_matmul as ZM
from repro_torch.models import cnn as CNN
from repro_torch.models import transformer as T

jax.config.update("jax_platform_name", "cpu")

RULES = AxisRules(mesh=None)
TOL = dict(rtol=1e-5, atol=1e-5)


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


@pytest.mark.parametrize("perturb,mu", [(True, 0.05), (True, 0.0),
                                        (False, 0.05)])
@pytest.mark.parametrize("row_offset", [0, 3 * 32])
def test_zo_matmul_plain_vs_pallas(perturb, mu, row_offset):
    x, w = _arrays(0, (16, 32), (32, 48), scale=0.5)
    ref = JZM.zo_matmul(x, w, 123, mu, row_offset=row_offset, bm=8, bn=16,
                        bk=16, interpret=True, perturb=perturb)
    y = ZM.zo_matmul(torch.as_tensor(x), torch.as_tensor(w), 123, mu,
                     row_offset=row_offset, perturb=perturb)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **TOL)


def test_zo_dual_forward_split_matches_jax_and_fused():
    x, w = _arrays(1, (16, 32), (32, 48), scale=0.5)
    rc, rp = JO.zo_dual_forward_split(x, w, 9, 0.05, bm=8, bn=16, bk=16)
    tx, tw = torch.as_tensor(x), torch.as_tensor(w)
    clean, pert = O.zo_dual_forward_split(tx, tw, 9, 0.05)
    np.testing.assert_allclose(clean.numpy(), np.asarray(rc), **TOL)
    np.testing.assert_allclose(pert.numpy(), np.asarray(rp), **TOL)
    # the plain versions of the fused pass and the two-pass split are one
    # computation, so they agree exactly
    fc, fp = O.zo_dual_forward(tx, tw, 9, 0.05)
    assert torch.equal(fc, clean) and torch.equal(fp, pert)


@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=8, cap=5.0),
                                dict(causal=False, cap=3.0)])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_flash_attention_plain_vs_pallas(kw, kv_heads):
    """GQA, window, soft-cap; Skv = 29 is ragged against the block 16."""
    q, k, v = _arrays(2, (2, 32, 4, 16), (2, 29, kv_heads, 16),
                      (2, 29, kv_heads, 16))
    ref = JFA.flash_attention(q, k, v, bq=16, bk=16, interpret=True, **kw)
    got = FA.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=8, cap=5.0),
                                dict(causal=False, cap=3.0)])
@pytest.mark.parametrize("kv_heads", [4, 2])
@pytest.mark.parametrize("head_dim", [128, 256])
def test_flash_attention_plain_vs_pallas_wide_heads(head_dim, kv_heads, kw):
    """K5's CPU path at the head widths the card's tensor-core route
    added (qwen2's 128, recurrentgemma's 256); Skv = 29 is ragged."""
    q, k, v = _arrays(5, (2, 32, 4, head_dim), (2, 29, kv_heads, head_dim),
                      (2, 29, kv_heads, head_dim))
    ref = JFA.flash_attention(q, k, v, bq=16, bk=16, interpret=True, **kw)
    got = FA.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _lm_single_loss(mod, cp, cfg, inputs, labels, pz, rules=()):
    """client + aux forward under one probe, then the LM loss."""
    s = mod.client_forward(cp, cfg, *rules, inputs, perturb=pz)
    if rules:
        s = s[0]
    logits = mod.aux_forward(cp, cfg, *rules, s, perturb=pz)
    return mod.lm_loss(logits, labels, cfg.vocab), s


@pytest.mark.parametrize("probe", ["weights", "scores"])
@pytest.mark.parametrize("mu", [0.0, 1e-2])
def test_lm_single_probe_matches_jax(probe, mu):
    """gpt2-tiny under ``Perturb(dual=False)``: the JAX forward runs the
    Pallas zo_matmul and flash_attention in interpret mode.  The single
    probe's loss is also the l_pert of the port's dual pass."""
    jcfg = dataclasses.replace(jax_gpt2_tiny(),
                               forward_impl="kernel_interpret",
                               attn_probe=probe)
    cfg = dataclasses.replace(gpt2_tiny(), attn_probe=probe,
                              forward_impl="kernel")
    params = jax.tree.map(np.asarray,
                          JT.init_lm(jax.random.PRNGKey(0), jcfg))
    cp = params["client"]
    api = P.lm_api(cfg)
    jpred = JO.attn_kv_seed_pred if probe == "scores" else None
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (2, 17))
    inputs, labels = toks[:, :-1], toks[:, 1:]
    jpz = JO.Perturb(seeds=JO.leaf_seed_tree(cp, jnp.int32(-12345), jpred),
                     mu=mu, dual=False, impl="interpret")
    lr, sr = jax.jit(lambda p: _lm_single_loss(
        JT, p, jcfg, inputs, labels, jpz, (RULES,)))(cp)
    seeds = O.leaf_seed_tree(cp, -12345, api.seed_pred)
    tcp = from_jax(cp, device="cpu")
    ti, tl = torch.as_tensor(inputs), torch.as_tensor(labels)
    loss, s = _lm_single_loss(T, tcp, cfg, ti, tl,
                              O.Perturb(seeds=seeds, mu=mu, dual=False))
    np.testing.assert_allclose(float(loss), float(lr), rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), **TOL)
    if probe == "weights":
        _, lp, _ = api.client_dual_loss(tcp, {"inputs": ti, "labels": tl},
                                        seeds, mu)
        np.testing.assert_allclose(float(loss), float(lp), rtol=1e-5)


@pytest.mark.parametrize("client_blocks", [1, 2])
@pytest.mark.parametrize("mu", [0.0, 1e-2])
def test_cnn_single_probe_matches_jax(client_blocks, mu):
    """The CNN client forward and aux loss under ``Perturb(dual=False)``
    (K4 over im2col patches; client_blocks=2 adds the stride-2 proj)."""
    jcfg = dataclasses.replace(jax_smoke_config(),
                               client_blocks=client_blocks)
    cfg = dataclasses.replace(smoke_config(), client_blocks=client_blocks,
                              forward_impl="kernel")
    params = jax.tree.map(np.asarray,
                          JCNN.init_cnn(jax.random.PRNGKey(0), jcfg))
    cp = params["client"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, (4,))
    jpz = JO.Perturb(seeds=JO.leaf_seed_tree(cp, jnp.int32(77)), mu=mu,
                     dual=False, impl="interpret")

    def jloss(p):
        s = JCNN.client_forward(p, x, jcfg, jpz)
        return JCNN.xent(JCNN.aux_logits(p, s, jcfg, jpz), y), s

    lr, sr = jax.jit(jloss)(cp)
    tcp = from_jax(cp, device="cpu")
    seeds = O.leaf_seed_tree(cp, 77)
    pz = O.Perturb(seeds=seeds, mu=mu, dual=False)
    s = CNN.client_forward(tcp, torch.as_tensor(x), cfg, pz)
    loss = CNN.xent(CNN.aux_logits(tcp, s, cfg, pz), torch.as_tensor(y))
    np.testing.assert_allclose(float(loss), float(lr), rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), **TOL)
    _, lp, _ = P.cnn_api(cfg).client_dual_loss(
        tcp, {"inputs": torch.as_tensor(x), "labels": torch.as_tensor(y)},
        seeds, mu)
    np.testing.assert_allclose(float(loss), float(lp), rtol=1e-5)
