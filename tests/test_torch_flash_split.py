"""The arithmetic of K3 / K5's tensor-core route for bf16 operands
(``csrc/flash_wgmma.cuh``), emulated on the CPU by
``ref.flash_attention_tc_ref``, and the route's choice.

The route feeds the tensor cores bf16 fragments, so the softmax weights
``p`` (f32) go into ``p @ v`` as two bf16 terms, ``hi = bf16(p)`` and
``lo = bf16(p - hi)``, over kv tiles of 64 columns (32 at head_dim
256).  These tests hold the emulation to the plain full-score version
under the card check's bf16 tolerance (``chip_smoke.check_k3``:
``|d| <= 2^-7 |ref| + 1e-3`` elementwise) in both probe modes at
gpt2-small's shape and at head_dim 128 and 256 with GQA 16:1 and a
window, record that one bf16 rounding of ``p`` does not hold it, hold
the emulation against the JAX package's Pallas kernel in interpret mode
on the same bf16 inputs, and check which route each launch would take.
Inputs come from numpy seeds; the score noise is the port's plain hash
field, which equals the JAX package's bit for bit
(``tests/test_torch_noise.py``).
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as JFA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import noise as N
from repro_torch.kernels import ref as R

jax.config.update("jax_platform_name", "cpu")

# (name, B, S, H, Kv, D, kwargs): chip_smoke's K3 / K5 cases
CASES = [("gpt2-small", 4, 256, 12, 12, 64, {}),
         ("gqa-window-cap-ragged", 2, 200, 8, 2, 64,
          dict(window=64, cap=30.0)),
         ("d128-gqa16-window", 1, 512, 16, 1, 128, dict(window=256)),
         ("d256-gqa16-window", 1, 1024, 16, 1, 256, dict(window=512))]
SEED = 77


def _inputs(B, S, H, Kv, D, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.as_tensor(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to(torch.bfloat16)
    return mk(B, S, H, D), mk(B, S, Kv, D), mk(B, S, Kv, D)


def _noise(H, S):
    """The score field a K3 launch at row_offset 5*H*S reads."""
    return N.uniform_noise(SEED, (H * S, S), 5 * H * S,
                           device="cpu").reshape(H, S, S)


def _ref(q, k, v, u, mu, kw):
    """The plain version of the stream (K5's, or K3's perturbed one)."""
    if u is None:
        return R.flash_attention_ref(q, k, v, **kw)
    _, ob = R.zo_dual_flash_attention_ref(q, q, k, v, u=u, mu_b=mu,
                                          perturb_b=True, **kw)
    return ob


def _k3_bad(got, ref):
    """Elements outside chip_smoke.check_k3's bf16 tolerance."""
    d = (got.float() - ref.float()).abs()
    return int((d > 2 ** -7 * ref.float().abs() + 1e-3).sum())


@pytest.mark.parametrize("mode,mu", [("weights", 0.0), ("scores", 0.5),
                                     ("scores", -0.5)],
                         ids=["weights", "scores+", "scores-"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tc_route_within_k3_tolerance(case, mode, mu):
    _, B, S, H, Kv, D, kw = case
    q, k, v = _inputs(B, S, H, Kv, D)
    u = _noise(H, S) if mode == "scores" else None
    got = R.flash_attention_tc_ref(q, k, v, bkv=FA.tc_kv_tile(D), u=u, mu=mu,
                                   **kw)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _k3_bad(got, _ref(q, k, v, u, mu, kw)) == 0


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_single_bf16_rounding_of_p_breaks_k3_tolerance(case):
    """Why the route splits p: one bf16 rounding of the softmax weights
    (feeding the tensor cores bf16(p) alone) moves outputs outside the
    tolerance at every shape, while the split stays inside."""
    _, B, S, H, Kv, D, kw = case
    q, k, v = _inputs(B, S, H, Kv, D, seed=1)
    ref = _ref(q, k, v, None, 0.0, kw)
    bkv = FA.tc_kv_tile(D)
    single = R.flash_attention_tc_ref(q, k, v, bkv=bkv, split_p=False, **kw)
    assert _k3_bad(single, ref) > 10
    assert _k3_bad(R.flash_attention_tc_ref(q, k, v, bkv=bkv, **kw), ref) == 0


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("mode", ["weights", "scores", "antithetic"])
def test_tc_emulation_vs_pallas_bf16(mode, D):
    """The emulation of both streams against the JAX package's Pallas
    dual kernel in interpret mode on the same bf16 inputs (GQA 2:1, a
    window, a soft-cap, Skv = 29 ragged against the kv tile), under the
    same tolerance."""
    B, Sq, Skv, H, Kv = 2, 32, 29, 4, 2
    rng = np.random.default_rng(D)
    arrs = [rng.standard_normal(s, dtype=np.float32) for s in (
        (B, Sq, H, D), (B, Sq, H, D), (B, Skv, Kv, D), (B, Skv, Kv, D),
        (B, Skv, Kv, D), (B, Skv, Kv, D))]
    qa, qb, k, v, kb, vb = (torch.as_tensor(a).to(torch.bfloat16)
                            for a in arrs)
    jx = [jax.numpy.asarray(t.float().numpy(), jax.numpy.bfloat16)
          for t in (qa, qb, k, v, kb, vb)]
    kw = dict(causal=True, window=8, cap=5.0)
    args = dict(seed=-7, row_offset=2 * H * Sq)
    if mode == "weights":
        args.update(perturb_a=False, perturb_b=False)
        jk = dict(kb=jx[4], vb=jx[5])
    elif mode == "scores":
        args.update(mu_b=0.3, perturb_a=False, perturb_b=True)
        jk = {}
    else:
        args.update(mu_a=0.3, mu_b=-0.3, perturb_a=True, perturb_b=True)
        jk = {}
    ra, rb = JFA.zo_dual_flash_attention(*jx[:4], **jk, bq=16, bk=16,
                                         interpret=True, **args, **kw)
    u = N.uniform_noise(-7, (H * Sq, Skv), 2 * H * Sq,
                        device="cpu").reshape(H, Sq, Skv)
    kbb, vbb = (kb, vb) if mode == "weights" else (k, v)
    bkv = FA.tc_kv_tile(D)
    for q, kk, vv, p, mu, ref in (
            (qa, k, v, args["perturb_a"], args.get("mu_a", 0.0), ra),
            (qb, kbb, vbb, args["perturb_b"], args.get("mu_b", 0.0), rb)):
        got = R.flash_attention_tc_ref(q, kk, vv, bkv=bkv,
                                       u=u if p else None, mu=mu, **kw)
        want = torch.tensor(np.asarray(ref.astype(jax.numpy.float32)))
        assert _k3_bad(got, want) == 0


@pytest.mark.parametrize("dtype,D,Skv,ptrs,want", [
    (torch.bfloat16, 64, 256, (0, 16, 4096), True),
    (torch.bfloat16, 16, 29, (32,), True),
    (torch.bfloat16, 32, 1, (0,), True),
    (torch.bfloat16, 128, 512, (0, 16), True),
    (torch.bfloat16, 256, 1024, (0, 16), True),
    (torch.float32, 64, 256, (0, 16), False),
    (torch.float32, 128, 256, (0, 16), False),
    (torch.bfloat16, 64, 256, (0, 8), False),
    (torch.bfloat16, 64, 256, (2, 16), False),
    (torch.bfloat16, 64, 0, (0, 16), False),
    (torch.bfloat16, 80, 256, (0, 16), True),
    (torch.bfloat16, 512, 256, (0, 16), False),
    (torch.bfloat16, 8, 256, (0, 16), True),
    (torch.bfloat16, 112, 256, (0, 16), True),
    (torch.bfloat16, 100, 256, (0, 16), False),
], ids=["gpt2", "D16", "D32", "D128", "D256", "f32", "f32-D128", "ptr8",
        "ptr2", "Skv0", "D80", "D512", "D8", "D112", "D100"])
def test_tensor_core_route_predicate(dtype, D, Skv, ptrs, want):
    """The tensor cores take bf16 at any head width that is a multiple of
    8 up to 256 (TMA's 16-byte row strides), with aligned pointers and a
    non-empty K/V."""
    assert FA.tensor_core_route(dtype, D, Skv, ptrs) is want


@pytest.mark.parametrize("D,tc,loop,kv_tile", [
    (8, 16, 8, 64), (16, 16, 16, 64), (64, 64, 64, 64), (112, 128, 128, 64),
    (128, 128, 128, 64), (200, 256, 256, 32), (256, 256, 256, 32)],
    ids=["D8", "D16", "D64", "D112", "D128", "D200", "D256"])
def test_head_dims_per_route(D, tc, loop, kv_tile):
    """Each route runs a head width at the smallest compiled width that
    holds it: the tensor cores at 16 / 32 / 64 / 128 / 256, the loop also
    at 8; the tensor cores' kv tile narrows to 32 columns past 128."""
    assert FA.HEAD_DIMS["tensor cores"] == (16, 32, 64, 128, 256)
    assert FA.HEAD_DIMS["CUDA-core loop"] == (8, 16, 32, 64, 128, 256)
    assert FA.compiled_width("tensor cores", D) == tc
    assert FA.compiled_width("CUDA-core loop", D) == loop
    assert FA.tc_kv_tile(D) == kv_tile


@pytest.mark.parametrize("dtype,D,ptrs,want", [
    (torch.bfloat16, 256, (0, 16), True),
    (torch.bfloat16, 128, (0, 16), True),
    (torch.float32, 128, (0, 16), False),
    (torch.bfloat16, 128, (2, 16), False),
    (torch.float32, 64, (0, 16), False),
    (torch.bfloat16, 8, (0, 16), True),
    (torch.float32, 8, (0, 16), False),
    (torch.bfloat16, 112, (0, 16), True),
    (torch.float32, 112, (0, 16), False),
    (torch.float32, 256, (0, 16), False),
    (torch.bfloat16, 100, (0, 16), False),
], ids=["bf16-D256", "bf16-D128", "f32-D128", "bf16-D128-misaligned",
        "f32-D64", "bf16-D8", "f32-D8", "bf16-D112", "f32-D112", "f32-D256",
        "bf16-D100"])
def test_route_choice(dtype, D, ptrs, want):
    assert FA.route("flash_attention", dtype, D, 64, ptrs) is want


@pytest.mark.parametrize("dtype,D,ptrs,refused", [
    (torch.float32, 256, (0, 16), False),
    (torch.bfloat16, 256, (2, 16), False),
    (torch.bfloat16, 264, (0, 16), True),
    (torch.float32, 512, (0, 16), True),
], ids=["f32", "bf16-misaligned", "bf16-D264", "f32-D512"])
def test_route_refuses_head_dim_256_on_the_loop(dtype, D, ptrs, refused):
    """head_dim 256 off the tensor cores (f32, or bf16 that TMA cannot
    take) now runs on the CUDA-core loop, which has a 32-row D = 256
    instance; only a width past 256 is refused, by either route, naming
    the limit and the kernel; it is never sent to the plain version."""
    if not refused:
        assert FA.route("zo_dual_flash_attention", dtype, D, 64, ptrs) is \
            False
        return
    with pytest.raises(ValueError) as err:
        FA.route("zo_dual_flash_attention", dtype, D, 64, ptrs)
    msg = str(err.value)
    assert str(D) in msg and "256" in msg and "CUDA-core loop" in msg
    assert "zo_dual_flash_attention" in msg


def test_cpu_calls_count_no_launch():
    """The wrappers run the plain versions for CPU tensors at every head
    width (256 included) and count no launch on either route."""
    before = dict(FA.LAUNCHES)
    assert {"zo_dual_flash_attention_tc", "flash_attention_tc"} <= \
        set(before)
    q, k, v = _inputs(1, 40, 4, 1, 256, seed=3)
    oa, _ = FA.zo_dual_flash_attention(q, q, k, v, kb=k, vb=v,
                                       perturb_b=False, window=16)
    assert torch.equal(FA.flash_attention(q, k, v, window=16), oa)
    assert FA.LAUNCHES == before
