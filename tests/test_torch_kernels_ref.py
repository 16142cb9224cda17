"""The port's plain kernel versions against the JAX package's Pallas
kernels in interpret mode (f32, rtol=1e-5, atol=1e-5).  The CUDA kernels
themselves are held to these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as JFA
from repro.kernels import ops as JO
from repro.kernels import zo_matmul as JZM
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as O
from repro_torch.kernels import ref as R
from repro_torch.kernels import zo_matmul as ZM

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-5, atol=1e-5)


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


@pytest.mark.parametrize("pa,pb,mu_a,mu_b", [
    (False, True, 0.0, 0.05),          # clean + perturbed
    (True, True, 0.05, -0.05),         # antithetic pair
    (True, False, 0.02, 0.0),
])
@pytest.mark.parametrize("row_offset", [0, 3 * 32])
def test_zo_dual_matmul_plain_vs_pallas(pa, pb, mu_a, mu_b, row_offset):
    xa, xb, w = _arrays(0, (16, 32), (16, 32), (32, 48), scale=0.5)
    ref_a, ref_b = JZM.zo_dual_matmul(
        xa, xb, w, 123, mu_a, mu_b, row_offset=row_offset, bm=8, bn=16,
        bk=16, interpret=True, perturb_a=pa, perturb_b=pb)
    ya, yb = ZM.zo_dual_matmul(torch.as_tensor(xa), torch.as_tensor(xb),
                               torch.as_tensor(w), 123, mu_a, mu_b,
                               row_offset=row_offset, perturb_a=pa,
                               perturb_b=pb)
    np.testing.assert_allclose(ya.numpy(), np.asarray(ref_a), **TOL)
    np.testing.assert_allclose(yb.numpy(), np.asarray(ref_b), **TOL)


def test_zo_noise_plain_vs_pallas():
    ref = np.asarray(JO.zo_noise(jnp.zeros((48, 80)), 31, bn=16, bk=16))
    np.testing.assert_array_equal(
        O.zo_noise(31, (48, 80), device="cpu").numpy(), ref)


VARIANTS = [
    dict(causal=True),
    dict(causal=True, window=8, cap=5.0),
    dict(causal=False, cap=3.0),
]


@pytest.mark.parametrize("kw", VARIANTS)
@pytest.mark.parametrize("kv_heads", [4, 2])
@pytest.mark.parametrize("mode", ["weights", "scores", "antithetic"])
def test_zo_dual_flash_attention_plain_vs_pallas(kw, kv_heads, mode):
    """Both probe modes, GQA, window, soft-cap; Skv = 29 is ragged
    against the Pallas kv block of 16."""
    B, Sq, Skv, H, D = 2, 32, 29, 4, 16
    qa, qb, k, v, kb, vb = _arrays(
        1, (B, Sq, H, D), (B, Sq, H, D), (B, Skv, kv_heads, D),
        (B, Skv, kv_heads, D), (B, Skv, kv_heads, D), (B, Skv, kv_heads, D))
    args = dict(seed=-77, row_offset=2 * H * Sq)
    if mode == "weights":
        args.update(kb=kb, vb=vb, perturb_a=False, perturb_b=False)
    elif mode == "scores":
        args.update(mu_b=0.3, perturb_a=False, perturb_b=True)
    else:
        args.update(mu_a=0.3, mu_b=-0.3, perturb_a=True, perturb_b=True)
    ra, rb = JFA.zo_dual_flash_attention(qa, qb, k, v, bq=16, bk=16,
                                         interpret=True, **args, **kw)
    targs = {n: torch.as_tensor(a) if isinstance(a, np.ndarray) else a
             for n, a in args.items()}
    oa, ob = FA.zo_dual_flash_attention(
        torch.as_tensor(qa), torch.as_tensor(qb), torch.as_tensor(k),
        torch.as_tensor(v), **targs, **kw)
    np.testing.assert_allclose(oa.numpy(), np.asarray(ra), **TOL)
    np.testing.assert_allclose(ob.numpy(), np.asarray(rb), **TOL)


@pytest.mark.parametrize("kw", VARIANTS)
@pytest.mark.parametrize("mode", ["weights", "scores", "antithetic"])
@pytest.mark.parametrize("head_dim", [128, 256])
def test_zo_dual_flash_attention_plain_vs_pallas_wide_heads(head_dim, mode,
                                                            kw):
    """K3's CPU path at the head widths the card's tensor-core route added
    (qwen2's 128, recurrentgemma's 256), GQA 2:1, both probe modes;
    Skv = 29 is ragged against the Pallas kv block of 16."""
    B, Sq, Skv, H, Kv, D = 2, 32, 29, 4, 2, head_dim
    qa, qb, k, v, kb, vb = _arrays(
        7, (B, Sq, H, D), (B, Sq, H, D), (B, Skv, Kv, D), (B, Skv, Kv, D),
        (B, Skv, Kv, D), (B, Skv, Kv, D))
    args = dict(seed=-77, row_offset=2 * H * Sq)
    if mode == "weights":
        args.update(kb=kb, vb=vb, perturb_a=False, perturb_b=False)
    elif mode == "scores":
        args.update(mu_b=0.3, perturb_a=False, perturb_b=True)
    else:
        args.update(mu_a=0.3, mu_b=-0.3, perturb_a=True, perturb_b=True)
    ra, rb = JFA.zo_dual_flash_attention(qa, qb, k, v, bq=16, bk=16,
                                         interpret=True, **args, **kw)
    targs = {n: torch.as_tensor(a) if isinstance(a, np.ndarray) else a
             for n, a in args.items()}
    oa, ob = FA.zo_dual_flash_attention(
        torch.as_tensor(qa), torch.as_tensor(qb), torch.as_tensor(k),
        torch.as_tensor(v), **targs, **kw)
    np.testing.assert_allclose(oa.numpy(), np.asarray(ra), **TOL)
    np.testing.assert_allclose(ob.numpy(), np.asarray(rb), **TOL)


def test_flash_attention_ref_vs_pallas():
    q, k, v = _arrays(2, (2, 32, 4, 16), (2, 29, 2, 16), (2, 29, 2, 16))
    ref = JFA.flash_attention(q, k, v, causal=True, window=8, cap=5.0,
                              bq=16, bk=16, interpret=True)
    got = R.flash_attention_ref(torch.as_tensor(q), torch.as_tensor(k),
                                torch.as_tensor(v), causal=True, window=8,
                                cap=5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
