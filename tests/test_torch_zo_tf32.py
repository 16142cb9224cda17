"""The arithmetic of K2 / K4's tensor-core route for f32 operands
(``csrc/zo_tf32_matmul.cuh``, 3xTF32), emulated on the CPU by
``ref.zo_matmul_tf32x3_ref``.

The route feeds the tensor cores tf32 operands, so x and the perturbed
weight ``p = w + mu*u`` each go in as two tf32 terms, ``hi = tf32(v)``
and ``lo = tf32(v - hi)`` (``ref.split_tf32``: round to nearest, ties
away from zero, as ``cvt.rna.tf32.f32``), and each k8 step runs
``x_hi·p_hi + x_hi·p_lo + x_lo·p_hi``.  These tests hold the emulation
to the plain f32 version under the card check's f32 tolerance
(``chip_smoke.check_k2``: ``|d| <= 1e-4 max|ref|``) and within
``ref.tf32x3_slack`` (the bound ``chip_smoke.py`` holds the kernel to
against the emulation) at ResNet-18's block-conv shape (576 x 64) and a
ragged 776 x 840, record that one tf32 term does not hold the
tolerance, and check the emulation against the JAX package's Pallas dual
kernel in interpret mode.  Inputs come from numpy seeds; the noise is
the port's plain hash field, which equals the JAX package's bit for bit
(``tests/test_torch_noise.py``).
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels import zo_matmul as JZM
from repro_torch.kernels import noise as N
from repro_torch.kernels import ref as R

jax.config.update("jax_platform_name", "cpu")

# ResNet-18's block-0 conv over im2col patches (K = 3*3*64, N = 64) and a
# ragged shape with K, N multiples of 8 but not of the 32 x 64 tiles
SHAPES = ((576, 64), (776, 840))
M = 2048
# (perturb_a, perturb_b, mu_a, mu_b) per unit mu: chip_smoke's K2 flags
FLAGS = ((False, True, 0.0, 1.0), (True, True, 1.0, -1.0))
SEED = -99


def _inputs(K, Nn, seed=0):
    rng = np.random.default_rng(seed)
    xa, xb = (torch.as_tensor(rng.standard_normal((M, K), dtype=np.float32))
              for _ in range(2))
    w = torch.as_tensor(rng.standard_normal((K, Nn), dtype=np.float32)
                        * K ** -0.5)
    u = N.uniform_noise(SEED, (K, Nn), 2 * K, device="cpu")
    return xa, xb, w, u


def _k2_ok(got, ref):
    """chip_smoke.check_k2's f32 tolerance, elementwise."""
    return (got - ref).abs() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("flags", FLAGS, ids=["clean+pert", "antithetic"])
@pytest.mark.parametrize("mu", [1e-3, 0.5])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tf32x3_within_k2_tolerance(shape, mu, flags):
    """Both streams of a dual launch: the emulation within the f32
    tolerance of the plain version and within the slack the card check
    allows the kernel around the emulation; 3xTF32 is ~1e-6 of max|ref|
    from the plain f32 product (the plain version is ~5e-7 from exact)."""
    K, Nn = shape
    pa, pb, ma, mb = flags
    xa, xb, w, u = _inputs(K, Nn)
    ra, rb = R.zo_dual_matmul_ref(xa, xb, w, u, ma * mu, mb * mu,
                                  perturb_a=pa, perturb_b=pb)
    for x, m, p, ref in ((xa, ma * mu, pa, ra), (xb, mb * mu, pb, rb)):
        got = R.zo_matmul_tf32x3_ref(x, w, u, m, perturb=p)
        assert got.dtype == torch.float32 and got.shape == (M, Nn)
        ok = _k2_ok(got, ref)
        assert bool(ok.all()), (
            f"{int((~ok).sum())} elements outside the tolerance")
        d = (got - ref).abs()
        assert float(d.max()) <= 4e-6 * float(ref.abs().max())
        assert bool((d <= R.tf32x3_slack(x, w, u, m, perturb=p)).all())


@pytest.mark.parametrize("mu", [1e-3, 0.5])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_split_tf32_terms_rebuild_p(shape, mu):
    """hi and lo carry no bits below tf32's 10-bit mantissa; p - hi is
    exact in f32; hi + lo is within 2^-21 of p, relative."""
    K, Nn = shape
    _, _, w, u = _inputs(K, Nn)
    p = w + mu * u
    hi, lo = R.split_tf32(p)
    for t in (hi, lo):
        assert int((t.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert torch.equal((p - hi).double(), p.double() - hi.double())
    err = (p.double() - (hi.double() + lo.double())).abs()
    assert bool((err <= 2 ** -21 * p.double().abs()).all())
    assert float(lo.abs().max()) > 0.0


def test_tf32_rounding_is_nearest_ties_away():
    """The split's rounding on hand-made bit patterns: below, at and
    above half of tf32's last place, both signs (cvt.rna.tf32.f32)."""
    def f(bits):
        return torch.tensor(np.array(bits, dtype=np.uint32).view(np.int32)
                            ).view(torch.float32)

    def bits(t):
        return t.view(torch.int32).numpy().view(np.uint32).tolist()

    src = [0x3F800FFF, 0x3F801000, 0x3F801001, 0x3F803000, 0x3F802FFF]
    want = [0x3F800000, 0x3F802000, 0x3F802000, 0x3F804000, 0x3F802000]
    hi, _ = R.split_tf32(f(src))
    assert bits(hi) == want
    hi, _ = R.split_tf32(f([b | 0x80000000 for b in src]))
    assert bits(hi) == [b | 0x80000000 for b in want]
    hi, lo = R.split_tf32(f([0x3F801000]))
    assert bits(lo) == [0xBA000000]            # 1 + 2^-11 - (1 + 2^-10)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_single_tf32_term_breaks_k2_tolerance(shape):
    """Why the route splits both operands: one tf32 term (x_hi·p_hi, what
    the tensor cores give for plain TF32) moves the perturbed outputs
    outside the f32 tolerance at the main path's mu, ~2.6e-4 of max|ref|
    at these shapes, at least 100x the three-term error."""
    K, Nn = shape
    _, xb, w, u = _inputs(K, Nn)
    mu = 1e-3
    ref = R.zo_matmul_ref(xb, w, u, mu)
    xh, _ = R.split_tf32(xb)
    ph, _ = R.split_tf32(w + mu * u)
    single = xh @ ph
    three = R.zo_matmul_tf32x3_ref(xb, w, u, mu)
    assert int((~_k2_ok(single, ref)).sum()) > 10000
    assert bool(_k2_ok(three, ref).all())
    e1 = float((single - ref).abs().max())
    e3 = float((three - ref).abs().max())
    assert e1 >= 100 * e3, (e1, e3)


@pytest.mark.parametrize("pa,pb,mu_a,mu_b", [(False, True, 0.0, 0.05),
                                             (True, True, 0.05, -0.05)])
def test_tf32x3_vs_pallas_f32(pa, pb, mu_a, mu_b):
    """The emulation against the JAX package's Pallas dual kernel in
    interpret mode on the same f32 inputs, under the f32 tolerance."""
    rng = np.random.default_rng(3)
    xa, xb = (rng.standard_normal((64, 128), dtype=np.float32)
              for _ in range(2))
    w = rng.standard_normal((128, 96), dtype=np.float32) * 128 ** -0.5
    ref_a, ref_b = JZM.zo_dual_matmul(
        jax.numpy.asarray(xa), jax.numpy.asarray(xb), jax.numpy.asarray(w),
        7, mu_a, mu_b, row_offset=256, bm=32, bn=32, bk=32, interpret=True,
        perturb_a=pa, perturb_b=pb)
    u = N.uniform_noise(7, (128, 96), 256, device="cpu")
    tw = torch.as_tensor(w)
    for x, mu, p, ref in ((xa, mu_a, pa, ref_a), (xb, mu_b, pb, ref_b)):
        got = R.zo_matmul_tf32x3_ref(torch.as_tensor(x), tw, u, mu,
                                     perturb=p)
        want = torch.as_tensor(np.array(ref))
        assert want.dtype == torch.float32
        assert bool(_k2_ok(got, want).all())
