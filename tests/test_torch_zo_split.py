"""The arithmetic of K2 / K4's tensor-core route for bf16 operands
(``csrc/zo_wgmma_matmul.cuh``), emulated on the CPU by
``ref.zo_matmul_split_ref``, and the route's predicate (bf16 and f32;
the f32 arithmetic is in ``tests/test_torch_zo_tf32.py``).

The route feeds the tensor cores bf16 fragments, so the perturbed weight
``p = w + mu*u`` (f32) goes in as two bf16 terms, ``hi = bf16(p)`` and
``lo = bf16(p - hi)``.  These tests hold the emulation to the plain f32
version under the card check's tolerance (``chip_smoke.check_k2``:
``|d| <= 2^-7 |ref| + 1e-4 max|ref|`` elementwise) at gpt2-small's client
shapes, and record that one bf16 rounding of ``p`` does not hold it.
Inputs come from numpy seeds; the noise is the port's plain hash field,
which equals the JAX package's bit for bit (``tests/test_torch_noise.py``).
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels import zo_matmul as JZM
from repro_torch.kernels import noise as N
from repro_torch.kernels import ref as R
from repro_torch.kernels import zo_matmul as ZM

jax.config.update("jax_platform_name", "cpu")

# gpt2-small's client projections (K, N) at M = 1024 rows per stream
SHAPES = ((768, 768), (768, 3072), (3072, 768))
# (perturb_a, perturb_b, mu_a, mu_b) per unit mu: chip_smoke's K2 flags
FLAGS = ((False, True, 0.0, 1.0), (True, True, 1.0, -1.0))
M = 1024
SEED = -99


def _inputs(K, Nn, seed=0):
    rng = np.random.default_rng(seed)
    xa, xb = (torch.as_tensor(rng.standard_normal((M, K), dtype=np.float32))
              .to(torch.bfloat16) for _ in range(2))
    w = torch.as_tensor(rng.standard_normal((K, Nn), dtype=np.float32)
                        * K ** -0.5).to(torch.bfloat16)
    u = N.uniform_noise(SEED, (K, Nn), 2 * K, device="cpu")
    return xa, xb, w, u


def _k2_ok(got, ref):
    """chip_smoke.check_k2's bf16 tolerance, elementwise."""
    d = (got.float() - ref.float()).abs()
    r = ref.float().abs()
    return d <= 2 ** -7 * r + 1e-4 * r.max()


@pytest.mark.parametrize("flags", FLAGS, ids=["clean+pert", "antithetic"])
@pytest.mark.parametrize("mu", [1e-3, 0.5])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_split_route_within_k2_tolerance(shape, mu, flags):
    K, Nn = shape
    pa, pb, ma, mb = flags
    xa, xb, w, u = _inputs(K, Nn)
    ra, rb = R.zo_dual_matmul_ref(xa, xb, w, u, ma * mu, mb * mu,
                                  perturb_a=pa, perturb_b=pb)
    for x, m, p, ref in ((xa, ma * mu, pa, ra), (xb, mb * mu, pb, rb)):
        got = R.zo_matmul_split_ref(x, w, u, m, perturb=p)
        assert got.dtype == torch.bfloat16 and got.shape == (M, Nn)
        ok = _k2_ok(got, ref)
        assert bool(ok.all()), (
            f"{int((~ok).sum())} elements outside the tolerance")


@pytest.mark.parametrize("mu", [1e-3, 0.5])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_split_terms_rebuild_p(shape, mu):
    """hi + lo is within 2^-16 of p, relative; p - hi is exact in f32."""
    K, Nn = shape
    _, _, w, u = _inputs(K, Nn)
    p = w.float() + mu * u
    hi, lo = R.split_bf16(p)
    resid = p.double() - hi.double()
    assert torch.equal((p - hi.float()).double(), resid)
    err = (p.double() - (hi.double() + lo.double())).abs()
    assert bool((err <= 2 ** -16 * p.double().abs()).all())
    assert float(lo.float().abs().max()) > 0.0


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_single_bf16_rounding_breaks_k2_tolerance(shape):
    """Why the route splits p: one bf16 rounding of p (feeding the tensor
    cores bf16(p) alone) moves the perturbed outputs outside the
    tolerance at the main path's mu, while the split stays inside."""
    K, Nn = shape
    _, xb, w, u = _inputs(K, Nn)
    mu = 1e-3
    ref = R.zo_matmul_ref(xb, w, u, mu)
    p = w.float() + mu * u
    single = (xb.float() @ p.to(torch.bfloat16).float()).to(torch.bfloat16)
    assert int((~_k2_ok(single, ref)).sum()) > 1000
    assert bool(_k2_ok(R.zo_matmul_split_ref(xb, w, u, mu), ref).all())


@pytest.mark.parametrize("pa,pb,mu_a,mu_b", [(False, True, 0.0, 0.05),
                                             (True, True, 0.05, -0.05)])
def test_split_route_vs_pallas_bf16(pa, pb, mu_a, mu_b):
    """The emulation against the JAX package's Pallas dual kernel in
    interpret mode on the same bf16 inputs, under the same tolerance."""
    rng = np.random.default_rng(3)
    xa, xb = (rng.standard_normal((64, 128), dtype=np.float32)
              for _ in range(2))
    w = rng.standard_normal((128, 96), dtype=np.float32) * 128 ** -0.5
    ta, tb, tw = (torch.as_tensor(a).to(torch.bfloat16) for a in (xa, xb, w))
    ja, jb, jw = (np.asarray(t.float().numpy()) for t in (ta, tb, tw))
    ref_a, ref_b = JZM.zo_dual_matmul(
        jax.numpy.asarray(ja, jax.numpy.bfloat16),
        jax.numpy.asarray(jb, jax.numpy.bfloat16),
        jax.numpy.asarray(jw, jax.numpy.bfloat16), 7, mu_a, mu_b,
        row_offset=256, bm=32, bn=32, bk=32, interpret=True, perturb_a=pa,
        perturb_b=pb)
    u = N.uniform_noise(7, (128, 96), 256, device="cpu")
    for x, mu, p, ref in ((ta, mu_a, pa, ref_a), (tb, mu_b, pb, ref_b)):
        got = R.zo_matmul_split_ref(x, tw, u, mu, perturb=p)
        want = torch.tensor(np.asarray(ref.astype(jax.numpy.float32)))
        assert bool(_k2_ok(got, want).all())


@pytest.mark.parametrize("dtype,K,Nn,ptrs,want", [
    (torch.bfloat16, 768, 3072, (0, 16, 4096), True),
    (torch.bfloat16, 776, 840, (256, 1024 + 16 * 3), True),
    (torch.bfloat16, 8, 8, (16,), True),
    (torch.float32, 768, 768, (0, 16), True),
    (torch.float32, 27, 64, (0, 16), False),
    (torch.float32, 64, 10, (0, 16), False),
    (torch.float32, 768, 768, (0, 4), False),
    (torch.bfloat16, 27, 64, (0, 16), False),
    (torch.bfloat16, 64, 70, (0, 16), False),
    (torch.bfloat16, 64, 10, (0, 16), False),
    (torch.bfloat16, 768, 768, (0, 8), False),
    (torch.bfloat16, 768, 768, (2, 16), False),
    (torch.bfloat16, 0, 768, (0, 16), False),
], ids=["gpt2-up", "ragged-mult8", "tiny", "f32", "f32-K27", "f32-N10",
        "f32-ptr4", "K27", "N70", "N10", "ptr8", "ptr2", "K0"])
def test_tensor_core_route_predicate(dtype, K, Nn, ptrs, want):
    assert ZM.tensor_core_route(dtype, K, Nn, ptrs) is want


def test_tensor_core_route_on_tensor_views():
    """A view one bf16 element into a buffer is not 16-byte aligned, so a
    launch on it takes the CUDA-core loop; whole tensors are aligned."""
    buf = torch.empty(64 * 64 + 8, dtype=torch.bfloat16)
    whole = buf[:64 * 64].view(64, 64)
    shifted = buf[1:64 * 64 + 1].view(64, 64)
    assert ZM.tensor_core_route(torch.bfloat16, 64, 64, (whole.data_ptr(),))
    assert not ZM.tensor_core_route(torch.bfloat16, 64, 64,
                                    (shifted.data_ptr(),))


def test_cpu_calls_count_no_launch():
    """The wrappers run the plain versions for CPU tensors and count no
    launch on either route."""
    before = dict(ZM.LAUNCHES)
    assert {"zo_dual_matmul_tc", "zo_matmul_tc"} <= set(before)
    rng = np.random.default_rng(5)
    xa, xb, w = (torch.as_tensor(rng.standard_normal(s, dtype=np.float32))
                 .to(torch.bfloat16) for s in ((16, 32), (16, 32), (32, 32)))
    _, yb = ZM.zo_dual_matmul(xa, xb, w, SEED, 0.0, 0.5, row_offset=64)
    y = ZM.zo_matmul(xb, w, SEED, 0.5, row_offset=64)
    assert torch.equal(y, yb)
    assert ZM.LAUNCHES == before
