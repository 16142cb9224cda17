"""Kernels K1-K6 on a CUDA card against their plain PyTorch versions,
the single-probe kernels against the matching stream of the fused ones
bit for bit, the tensor-core routes of K2 / K4 (bf16, and f32 as 3xTF32)
and the bf16 ones of K3 / K5, and the decode engine card against CPU.

Imports neither JAX nor the JAX package, so it runs on the machine with
the card (which has no JAX) with the repository's conftest skipped:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Without a card the tests skip.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import noise as N
from repro_torch.kernels import ref as R
from repro_torch.kernels import rg_lru as RG
from repro_torch.kernels import zo_matmul as ZM


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


@pytest.mark.gpu
def test_cuda_kernels_match_plain():
    """K1 bit for bit; K2 and K3 in f32 to 1e-4 (other summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    got = ZM.zo_noise(-5, (300, 130), 17, 3, device=dev)
    assert torch.equal(got, N.uniform_noise(-5, (300, 130), 17, 3,
                                            device=dev))
    ids = torch.randint(0, 50432, (3, 40), device=dev)
    assert torch.equal(ZM.zo_noise_rows(9, ids, 96), N.uniform_noise_at(
        9, ids[..., None], torch.arange(96, device=dev)))
    xa, xb, w = (torch.as_tensor(a, device=dev) for a in _arrays(
        3, (100, 200), (100, 200), (200, 70), scale=0.3))
    u = N.uniform_noise(4, w.shape, 200, device=dev)
    for pa, pb in ((False, True), (True, True)):
        ya, yb = ZM.zo_dual_matmul(xa, xb, w, 4, 0.1, -0.1, row_offset=200,
                                   perturb_a=pa, perturb_b=pb)
        ra, rb = R.zo_dual_matmul_ref(xa, xb, w, u, 0.1, -0.1, perturb_a=pa,
                                      perturb_b=pb)
        torch.testing.assert_close(ya, ra, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(yb, rb, rtol=1e-4, atol=1e-4)
    qa, qb, k, v = (torch.as_tensor(a, device=dev) for a in _arrays(
        4, (2, 70, 4, 64), (2, 70, 4, 64), (2, 70, 2, 64), (2, 70, 2, 64)))
    un = N.uniform_noise(6, (4 * 70, 70), device=dev).reshape(4, 70, 70)
    oa, ob = FA.zo_dual_flash_attention(qa, qb, k, v, seed=6, mu_b=0.3,
                                        window=20, cap=5.0)
    ra, rb = R.zo_dual_flash_attention_ref(qa, qb, k, v, u=un, mu_b=0.3,
                                           window=20, cap=5.0)
    torch.testing.assert_close(oa, ra, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ob, rb, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_single_probe_kernels_match_plain_and_fused_streams():
    """K4 and K5 in f32 to 1e-4 of their plain versions (other summation
    order), over ragged shapes (K = 27, N = 10; Skv = 70 against the
    64-wide kv tile); and bit for bit equal to the matching stream of K2
    and K3, which run the same tile code."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for (M, K, Nn) in ((100, 27, 64), (130, 64, 10)):
        xa, x, w = (torch.as_tensor(a, device=dev) for a in _arrays(
            5, (M, K), (M, K), (K, Nn), scale=0.3))
        u = N.uniform_noise(8, w.shape, 2 * K, device=dev)
        for perturb in (True, False):
            y = ZM.zo_matmul(x, w, 8, 0.1, row_offset=2 * K,
                             perturb=perturb)
            ref = (R.zo_matmul_ref(x, w, u, 0.1) if perturb
                   else R.matmul_ref(x, w))
            torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-4)
            ya, yb = ZM.zo_dual_matmul(xa, x, w, 8, 0.0, 0.1,
                                       row_offset=2 * K, perturb_b=perturb)
            assert torch.equal(y, yb)
        xh, wh = x.to(torch.bfloat16), w.to(torch.bfloat16)
        _, yb = ZM.zo_dual_matmul(xh, xh, wh, 8, 0.0, 0.1)
        assert torch.equal(ZM.zo_matmul(xh, wh, 8, 0.1), yb)
    for dtype in (torch.float32, torch.bfloat16):
        q, qb, k, v, kb, vb = (torch.as_tensor(a, device=dev).to(dtype)
                               for a in _arrays(
            6, (2, 70, 4, 64), (2, 70, 4, 64), (2, 70, 2, 64),
            (2, 70, 2, 64), (2, 70, 2, 64), (2, 70, 2, 64)))
        for kw in (dict(), dict(window=20, cap=5.0),
                   dict(causal=False, cap=3.0)):
            o = FA.flash_attention(q, k, v, **kw)
            if dtype == torch.float32:
                torch.testing.assert_close(
                    o, R.flash_attention_ref(q, k, v, **kw), rtol=1e-4,
                    atol=1e-4)
            oa, _ = FA.zo_dual_flash_attention(
                q, qb, k, v, kb=kb, vb=vb, perturb_a=False,
                perturb_b=False, **kw)
            assert torch.equal(o, oa)


# chip_smoke.py's K6_SHAPES (the recurrentgemma round's) and K6_RAGGED
K6_SHAPES = ((2, 512, 4096), (4, 512, 4096))
K6_RAGGED = ((1, 77, 1000), (1, 509, 4099), (3, 130, 129))


@pytest.mark.gpu
def test_cuda_rg_lru_scan_matches_plain():
    """K6 forward and reverse mode bit for bit against the plain loops
    (each step a multiply, then an add, in both) at the round's shapes and
    ragged ones (S and W not multiples of the 32-step stage or the
    32-channel block; W % 4 != 0 takes the cp.async producer, the rest
    TMA); its autograd backward against autograd through the plain loop to
    1e-6 (the same two-term sums, so equal in practice)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for (B, S, W) in K6_SHAPES + K6_RAGGED + ((1, 37, 70),):
        rng = np.random.default_rng(B * S)
        a = torch.as_tensor(rng.uniform(0.3, 0.999, (B, S, W)).astype(
            np.float32), device=dev)
        b, g = (torch.as_tensor(x, device=dev) for x in _arrays(
            B + 1, (B, S, W), (B, S, W)))
        h = RG.rg_lru_scan(a, b)
        assert torch.equal(h, R.rg_lru_scan_ref(a, b))
        da, db = RG.rg_lru_scan_reverse(a, g, h)
        rda, rdb = R.rg_lru_scan_reverse_ref(a, g, h)
        assert torch.equal(da, rda) and torch.equal(db, rdb)
        ta, tb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        ka, kb = torch.autograd.grad(torch.sum(RG.rg_lru_scan(ta, tb) * g),
                                     (ta, tb))
        pa, pb = torch.autograd.grad(
            torch.sum(R.rg_lru_scan_ref(ta, tb) * g), (ta, tb))
        torch.testing.assert_close(ka, pa, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(kb, pb, rtol=1e-6, atol=1e-6)


def _misaligned_by(x, elems):
    """A contiguous copy of ``x`` ``elems`` elements into a buffer."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    out = buf[elems:elems + x.numel()].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.gpu
def test_cuda_zo_noise_tree_modes_match_plain():
    """K1's tree launch in its three modes, bit for bit against the plain
    tensor code, over 70 leaves (two launches of the 64-segment table):
    ragged widths (cols 1, 10, 130), f32 and bf16 leaves, leaves one
    element into a buffer (the element-wise path), rep row offsets, and in
    accumulate mode leaves without a seed (a zero direction) and a scale
    read from a 0-d view of a device vector."""
    from repro_torch.kernels import ops as O
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    shapes = [(3, 40, 768), (130,), (1,), (64, 10), (2, 33, 130), (300, 96),
              (5, 4, 1)] * 10
    leaves, seeds = [], []
    for i, shp in enumerate(shapes):
        x = torch.as_tensor(rng.standard_normal(shp).astype(np.float32),
                            device=dev)
        if i % 3 == 1:
            x = x.to(torch.bfloat16)
        if i % 4 == 2:
            x = _misaligned_by(x, 1)
        leaves.append(x)
        seeds.append(int(rng.integers(-2**31, 2**31)))
    cpu = [t.cpu() for t in leaves]
    for rep in (0, 2):
        n0 = ZM.LAUNCHES["zo_noise"]
        got = O.perturb_tree(leaves, seeds, 0.37, rep)
        assert ZM.LAUNCHES["zo_noise"] == n0 + 2
        want = O.perturb_tree(cpu, seeds, 0.37, rep)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    n0 = ZM.LAUNCHES["zo_noise"]
    u = O.kernel_direction_tree(leaves, seeds)
    assert ZM.LAUNCHES["zo_noise"] == n0 + 2
    for a, b in zip(u, O.kernel_direction_tree(cpu, seeds)):
        assert torch.equal(a.cpu(), b)
    acc = [_misaligned_by(t.float(), 3) if i % 5 == 0 else t.float()
           for i, t in enumerate(leaves)]
    acc_cpu = [t.cpu() for t in acc]
    sc = torch.tensor([0.5, -1.3e-3, 7.0], device=dev)
    part = [None if i % 6 == 5 else s for i, s in enumerate(seeds)]
    for k in range(3):
        n0 = ZM.LAUNCHES["zo_noise"]
        O.accumulate_direction_tree(acc, part, sc[k])
        assert ZM.LAUNCHES["zo_noise"] == n0 + 2
        O.accumulate_direction_tree(acc_cpu, part, sc[k].cpu())
    for a, b in zip(acc, acc_cpu):
        assert torch.equal(a.cpu(), b)
    ids = torch.randint(0, 50432, (3, 41), device=dev)
    for n_cols in (96, 130):
        assert torch.equal(ZM.zo_noise_rows(9, ids, n_cols),
                           N.uniform_noise_at(9, ids[..., None], torch.arange(
                               n_cols, device=dev)))


def _k2_ok(got, ref):
    """chip_smoke.check_k2's bf16 tolerance, elementwise: one bf16
    rounding step (2^-7 relative) plus 1e-4 of max|ref| for f32 sums in
    another order."""
    d = (got.float() - ref.float()).abs()
    r = ref.float().abs()
    return bool((d <= 2 ** -7 * r + 1e-4 * r.max()).all())


def _split_ok(got, x, w, u, mu, perturb):
    """Against the route's own arithmetic (ref.zo_matmul_split_ref, f32
    sums): half a bf16 step of the output rounding (2^-8 relative) plus
    one f32 ulp of the sum of |products| per wgmma step (two per k16 step
    when perturbed), for the tensor cores' other accumulation order."""
    emu = R.zo_matmul_split_ref(x, w, u, mu, perturb=perturb,
                                out_dtype=torch.float32)
    if perturb:
        hi, lo = R.split_bf16(w.float() + mu * u)
        mag = x.float().abs() @ (hi.float().abs() + lo.float().abs())
    else:
        mag = x.float().abs() @ w.float().abs()
    steps = (2 if perturb else 1) * -(-x.shape[1] // 16)
    d = (got.float() - emu).abs()
    return bool((d <= 2 ** -8 * emu.abs() + steps * 2 ** -23 * mag).all())


@pytest.mark.gpu
def test_cuda_zo_matmul_tensor_core_route():
    """K2 and K4 on the bf16 tensor-core route at ragged shapes (the M, K
    and N tails of the 128 x 64 x 64 tiles, and M = 1): within check_k2's
    tolerance of the plain version and within a few f32 ulps of the
    route's split arithmetic; K4 equal to K2's clean and perturbed streams
    bit for bit; the route counters show which route each call took,
    including a bf16 N = 70 call on the CUDA-core loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for M, K, Nn in ((1000, 776, 840), (1, 776, 840), (300, 64, 70)):
        xa, xb, w = (torch.as_tensor(a, device=dev).to(torch.bfloat16)
                     for a in _arrays(M + K, (M, K), (M, K), (K, Nn)))
        w = (w.float() * K ** -0.5).to(torch.bfloat16)
        u = N.uniform_noise(11, w.shape, 3 * K, device=dev)
        tc = Nn % 8 == 0
        for mu in (1e-3, 0.5):
            for pa, pb, ma, mb in ((False, True, 0.0, mu),
                                   (True, True, mu, -mu)):
                before = dict(ZM.LAUNCHES)
                ya, yb = ZM.zo_dual_matmul(xa, xb, w, 11, ma, mb,
                                           row_offset=3 * K, perturb_a=pa,
                                           perturb_b=pb)
                ka = ZM.zo_matmul(xa, w, 11, ma, row_offset=3 * K,
                                  perturb=pa)
                kb = ZM.zo_matmul(xb, w, 11, mb, row_offset=3 * K,
                                  perturb=pb)
                assert ZM.LAUNCHES["zo_dual_matmul"] == \
                    before["zo_dual_matmul"] + 1
                assert ZM.LAUNCHES["zo_matmul"] == before["zo_matmul"] + 2
                assert ZM.LAUNCHES["zo_dual_matmul_tc"] == \
                    before["zo_dual_matmul_tc"] + int(tc)
                assert ZM.LAUNCHES["zo_matmul_tc"] == \
                    before["zo_matmul_tc"] + 2 * int(tc)
                assert torch.equal(ka, ya) and torch.equal(kb, yb)
                ra, rb = R.zo_dual_matmul_ref(xa, xb, w, u, ma, mb,
                                              perturb_a=pa, perturb_b=pb)
                assert _k2_ok(ya, ra) and _k2_ok(yb, rb)
                if tc:
                    assert _split_ok(ya, xa, w, u, ma, pa)
                    assert _split_ok(yb, xb, w, u, mb, pb)


@pytest.mark.gpu
def test_cuda_zo_matmul_tf32_route():
    """K2 and K4 on the f32 tensor-core route (3xTF32) at ragged shapes
    (the M, K and N tails of the 128 x 32 x 64 tiles, M = 1, ResNet-18's
    576 x 64): within check_k2's f32 tolerance of the plain version and
    within ref.tf32x3_slack of the route's emulation; K4 equal to K2's
    clean and perturbed streams bit for bit; the route counters show which
    route each call took, including an f32 N = 70 call on the CUDA-core
    loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for M, K, Nn in ((1000, 776, 840), (1, 776, 840), (4099, 576, 64),
                     (300, 64, 70)):
        xa, xb, w = (torch.as_tensor(a, device=dev) for a in _arrays(
            M + K, (M, K), (M, K), (K, Nn)))
        w = w * K ** -0.5
        u = N.uniform_noise(11, w.shape, 3 * K, device=dev)
        tc = Nn % 8 == 0
        for mu in (1e-3, 0.5):
            for pa, pb, ma, mb in ((False, True, 0.0, mu),
                                   (True, True, mu, -mu)):
                before = dict(ZM.LAUNCHES)
                ya, yb = ZM.zo_dual_matmul(xa, xb, w, 11, ma, mb,
                                           row_offset=3 * K, perturb_a=pa,
                                           perturb_b=pb)
                ka = ZM.zo_matmul(xa, w, 11, ma, row_offset=3 * K,
                                  perturb=pa)
                kb = ZM.zo_matmul(xb, w, 11, mb, row_offset=3 * K,
                                  perturb=pb)
                assert ZM.LAUNCHES["zo_dual_matmul"] == \
                    before["zo_dual_matmul"] + 1
                assert ZM.LAUNCHES["zo_matmul"] == before["zo_matmul"] + 2
                assert ZM.LAUNCHES["zo_dual_matmul_tc"] == \
                    before["zo_dual_matmul_tc"] + int(tc)
                assert ZM.LAUNCHES["zo_matmul_tc"] == \
                    before["zo_matmul_tc"] + 2 * int(tc)
                assert torch.equal(ka, ya) and torch.equal(kb, yb)
                ra, rb = R.zo_dual_matmul_ref(xa, xb, w, u, ma, mb,
                                              perturb_a=pa, perturb_b=pb)
                for got, ref, x, m, p in ((ya, ra, xa, ma, pa),
                                          (yb, rb, xb, mb, pb)):
                    assert got.dtype == torch.float32
                    d = (got - ref).abs()
                    assert bool((d <= 1e-4 * ref.abs().max()).all())
                    if tc:
                        emu = R.zo_matmul_tf32x3_ref(x, w, u, m, perturb=p)
                        assert bool(((got - emu).abs() <= R.tf32x3_slack(
                            x, w, u, m, perturb=p)).all())


def _k3_ok(got, ref):
    """chip_smoke.check_k3's bf16 tolerance, elementwise: one bf16
    rounding step of the output (2^-7 relative) plus 1e-3."""
    d = (got.float() - ref.float()).abs()
    return bool((d <= 2 ** -7 * ref.float().abs() + 1e-3).all())


def _misaligned(x):
    """A copy of ``x`` one element into a buffer: contiguous, not
    16-byte aligned, so K3 / K5 take the CUDA-core loop for it."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    out = buf[1:1 + x.numel()].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.gpu
def test_cuda_flash_attention_tensor_core_route():
    """K3 and K5 on the bf16 tensor-core route at head_dim 64, 256, 8 and
    112 (ragged S against the query and kv tiles, GQA, a window, a
    soft-cap; 8 and 112 zero-filled to the compiled widths 16 and 128):
    within check_k3's tolerance of the plain version in the weights,
    scores and antithetic scores modes; K5 equal to K3's weights-mode
    streams bit for bit, on the tensor cores and (inputs not 16-byte
    aligned) on the CUDA-core loop; the route counters show where each
    call went.  f32 at head_dim 8, 112 and 256 on the loop within
    check_k3's f32 tolerance (1e-4), K5 equal to K3's stream; only a head
    past 256 is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for (B, S, H, Kv, D, kw) in ((2, 200, 8, 2, 64, dict(window=64,
                                                          cap=30.0)),
                                 (1, 300, 4, 1, 256, dict(window=100)),
                                 (2, 150, 4, 2, 8, dict(cap=5.0)),
                                 (1, 200, 6, 2, 112, dict(window=70))):
        qa, qb, k, v, kb, vb = (torch.as_tensor(a, device=dev).to(
            torch.bfloat16) for a in _arrays(
            D + S, (B, S, H, D), (B, S, H, D), (B, S, Kv, D), (B, S, Kv, D),
            (B, S, Kv, D), (B, S, Kv, D)))
        u = N.uniform_noise(13, (H * S, S), 3 * H * S,
                            device=dev).reshape(H, S, S)
        for mkw in (dict(kb=kb, vb=vb, perturb_a=False, perturb_b=False),
                    dict(perturb_a=False, perturb_b=True, mu_b=0.5),
                    dict(perturb_a=True, perturb_b=True, mu_a=0.5,
                         mu_b=-0.5)):
            before = dict(FA.LAUNCHES)
            oa, ob = FA.zo_dual_flash_attention(qa, qb, k, v, seed=13,
                                                row_offset=3 * H * S,
                                                **mkw, **kw)
            assert FA.LAUNCHES["zo_dual_flash_attention_tc"] == \
                before["zo_dual_flash_attention_tc"] + 1
            ra, rb = R.zo_dual_flash_attention_ref(qa, qb, k, v, u=u, **mkw,
                                                   **kw)
            assert _k3_ok(oa, ra) and _k3_ok(ob, rb)
        routes = [((qa, qb, k, v, kb, vb), 1),
                  ([_misaligned(x) for x in (qa, qb, k, v, kb, vb)], 0)]
        for (xa, xb, xk, xv, xkb, xvb), tc in routes:
            before = dict(FA.LAUNCHES)
            o5a = FA.flash_attention(xa, xk, xv, **kw)
            o5b = FA.flash_attention(xb, xkb, xvb, **kw)
            oa, ob = FA.zo_dual_flash_attention(xa, xb, xk, xv, kb=xkb,
                                                vb=xvb, perturb_a=False,
                                                perturb_b=False, **kw)
            assert FA.LAUNCHES["flash_attention"] == \
                before["flash_attention"] + 2
            assert FA.LAUNCHES["flash_attention_tc"] == \
                before["flash_attention_tc"] + 2 * tc
            assert FA.LAUNCHES["zo_dual_flash_attention_tc"] == \
                before["zo_dual_flash_attention_tc"] + tc
            assert torch.equal(o5a, oa) and torch.equal(o5b, ob)
            assert _k3_ok(o5a, R.flash_attention_ref(xa, xk, xv, **kw))
    # f32 on the loop at D = 8, 112 and 256 (32-row tiles) within
    # check_k3's f32 tolerance in every mode, K5 == K3's streams
    for D in (8, 112, 256):
        q, qb, k, v, kb, vb = (torch.as_tensor(a, device=dev) for a in
                               _arrays(D, (1, 100, 4, D), (1, 100, 4, D),
                                       (1, 100, 2, D), (1, 100, 2, D),
                                       (1, 100, 2, D), (1, 100, 2, D)))
        u = N.uniform_noise(5, (4 * 100, 100), device=dev).reshape(4, 100,
                                                                    100)
        for mkw in (dict(kb=kb, vb=vb, perturb_a=False, perturb_b=False),
                    dict(perturb_a=True, perturb_b=True, mu_a=0.5,
                         mu_b=-0.5)):
            oa, ob = FA.zo_dual_flash_attention(q, qb, k, v, seed=5,
                                                window=40, **mkw)
            ra, rb = R.zo_dual_flash_attention_ref(q, qb, k, v, u=u,
                                                   window=40, **mkw)
            torch.testing.assert_close(oa, ra, rtol=0, atol=1e-4)
            torch.testing.assert_close(ob, rb, rtol=0, atol=1e-4)
        o5 = FA.flash_attention(q, k, v, window=40)
        oa, _ = FA.zo_dual_flash_attention(q, qb, k, v, kb=kb, vb=vb,
                                           perturb_a=False, perturb_b=False,
                                           window=40)
        assert torch.equal(o5, oa)
    # only a head past 256 is refused, by either route
    q, k, v = (torch.as_tensor(a, device=dev) for a in _arrays(
        9, (1, 64, 2, 264), (1, 64, 1, 264), (1, 64, 1, 264)))
    before = dict(FA.LAUNCHES)
    with pytest.raises(ValueError, match="256"):
        FA.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="256"):
        FA.zo_dual_flash_attention(q.to(torch.bfloat16), q.to(torch.bfloat16),
                                   k.to(torch.bfloat16), v.to(torch.bfloat16))
    assert FA.LAUNCHES == before


def _fo_small_round(method, dev, kind):
    """A small first-order round (N=2, h=2, AdamW at eps 1e-6) on
    ``dev``: gpt2-tiny (2 x 16 tokens) or the small CNN (4 images 8x8),
    params from a seed on the CPU."""
    from repro_torch.configs.gpt2 import gpt2_tiny
    from repro_torch.core import protocols as P
    from repro_torch.core import zo as Z
    from repro_torch.models import cnn as CNN
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import adamw
    rng = np.random.default_rng(3)
    if kind == "lm":
        cfg = gpt2_tiny()
        params = T.init_lm(cfg, seed=0, device=dev)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 2, 2, 17)),
                               device=dev)
        rb = {"inputs": toks[..., :-1], "labels": toks[..., 1:]}
        api = P.lm_api(cfg)
    else:
        cfg = CNN.CNNConfig(widths=(8, 16), blocks_per_stage=1, classes=4)
        params = CNN.init_cnn(cfg, seed=0, device=dev)
        rb = {"inputs": torch.as_tensor(rng.standard_normal(
                  (2, 2, 4, 8, 8, 3), dtype=np.float32), device=dev),
              "labels": torch.as_tensor(rng.integers(0, 4, (2, 2, 4)),
                                        device=dev)}
        api = P.cnn_api(cfg)
    opt = adamw(1e-4, eps=1e-6)
    state = {"client": params["client"], "server": params["server"],
             "opt_server": opt.init(params["server"])}
    rnd = P.make_fed_round(api, method, Z.ZOConfig(mu=1e-2),
                           P.FedConfig(n_clients=2, h=2), opt, opt)
    return rnd(state, rb, (0, 5))


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["sflv2", "cse_fsl"])
def test_cuda_fo_round_matches_cpu(method, monkeypatch):
    """A first-order round on the card (cuBLAS / cuDNN f32, TF32 off)
    against the same round on the CPU: losses rtol 1e-4, params |d| <=
    1e-5 + 1e-4 |p| (chip_smoke.py's check_small_round); no ZO kernel
    launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.tree import tree_leaves
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    for kind in ("lm", "cnn"):
        before = {**ZM.LAUNCHES, **FA.LAUNCHES}
        (gc, mc), (pc, mp) = (_fo_small_round(method, d, kind)
                              for d in (torch.device("cuda"),
                                        torch.device("cpu")))
        assert {**ZM.LAUNCHES, **FA.LAUNCHES} == before
        for k in ("client_loss", "server_loss"):
            assert abs(float(mc[k]) - float(mp[k])) <= 1e-4 * abs(
                float(mp[k])), (kind, k)
        for part in ("client", "server"):
            for a, b in zip(tree_leaves(gc[part]), tree_leaves(pc[part])):
                d = (a.cpu().float() - b.float()).abs()
                assert bool((d <= 1e-5 + 1e-4 * b.float().abs()).all()), (
                    kind, part, float(d.max()))


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _threefry_round(dev, scale):
    """A small HERON round on the threefry stream (gpt2-tiny, N=4, h=1,
    participation 0.5 with stragglers: the mask drawn from the key)."""
    from repro_torch.configs.gpt2 import gpt2_tiny
    from repro_torch.core import protocols as P
    from repro_torch.core import zo as Z
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import adamw, zo_sgd
    cfg = gpt2_tiny()
    params = T.init_lm(cfg, seed=0, device=dev)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 1, 2, 17)), device=dev)
    rb = {"inputs": toks[..., :-1], "labels": toks[..., 1:]}
    mu, lr = (1e-2, 1e-3) if scale == "gaussian" else (1e-1, 1e-4)
    sopt = adamw(1e-4)
    state = {"client": params["client"], "server": params["server"],
             "opt_server": sopt.init(params["server"])}
    rnd = P.make_fed_round(
        P.lm_api(cfg), "heron", Z.ZOConfig(mu=mu, scale=scale),
        P.FedConfig(n_clients=4, h=1, participation=0.5,
                    straggler_prob=0.3), zo_sgd(lr), sopt,
        uplink="seed_replay", client_lr=lr)
    return rnd(state, rb, (0, 77))


@pytest.mark.gpu
def test_cuda_threefry_matches_golden_and_cpu():
    """The card's threefry against chip_smoke.py's golden table (JAX's
    draws): bits, uniforms and Bernoulli bit for bit, normals within 4
    ulps; and a small threefry round on the card against the CPU
    (losses rtol 1e-4, params |d| <= 1e-5 + 1e-4 |p|), with no K1-K5
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.core import prng as PR
    from repro_torch.tree import tree_leaves
    cs = _chip_smoke()
    dev = torch.device("cuda")
    cs.check_threefry(dev)
    g = cs.THREEFRY_GOLDEN
    k = PR.fold_in(PR.PRNGKey(g["seed"]), 777)
    assert PR.random_bits(k, (8,), dev).cpu().tolist() == g["bits_8"]
    for scale in ("gaussian", "sphere"):
        before = {**ZM.LAUNCHES, **FA.LAUNCHES}
        (gc, mc), (pc, mp) = (_threefry_round(d, scale) for d in (
            dev, torch.device("cpu")))
        assert {**ZM.LAUNCHES, **FA.LAUNCHES} == before
        assert float(mc["participants"]) == float(mp["participants"])
        for key in ("client_loss", "server_loss"):
            assert abs(float(mc[key]) - float(mp[key])) <= 1e-4 * abs(
                float(mp[key])), (scale, key)
        for part in ("client", "server"):
            for a, b in zip(tree_leaves(gc[part]), tree_leaves(pc[part])):
                d = (a.cpu().float() - b.float()).abs()
                assert bool((d <= 1e-5 + 1e-4 * b.float().abs()).all()), (
                    scale, part, float(d.max()))


def _serve_smoke(arch, dev, params=None, dtype=None, sampler=None):
    """The decode engine on ``arch``'s smoke config (2 slots, capacity
    24, segments of 4, prompts of 5 and 9 tokens, 6 new): the token
    streams and the K5 / K6 launches of the run."""
    from repro_torch.configs import registry as REG
    from repro_torch.core import decode as D
    from repro_torch.models import transformer as T
    cfg = REG.get_config(arch, smoke=True)
    if dtype is not None:
        cfg = cfg.replace(param_dtype=dtype, compute_dtype=dtype)
    if params is None:
        params = T.init_lm(cfg, seed=0, device=dev)
    prompts = [np.random.default_rng(0).integers(0, cfg.vocab, size=n)
               for n in (5, 9)]
    eng = D.DecodeEngine(params, cfg, slots=2, capacity=24, segment_len=4,
                         sampler=D.SamplerConfig(**(sampler or {})),
                         device=dev)
    before = {**FA.LAUNCHES, **RG.LAUNCHES}
    rids = [eng.submit(p, 6) for p in prompts]
    out = eng.run()
    after = {**FA.LAUNCHES, **RG.LAUNCHES}
    return ([out[r] for r in rids], {k: after[k] - before[k] for k in after},
            cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "recurrentgemma-9b"])
def test_cuda_serve_engine_matches_cpu(arch):
    """The decode engine on the card against the CPU (f32 smoke config):
    the same greedy and sampled token streams, K5 once per attention
    layer and K6 once per RG-LRU layer in each admission's prefill and
    never in decode; on a bf16 copy of the config K5 runs on the tensor
    cores."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    cpu, dev = torch.device("cpu"), torch.device("cuda")
    sampled = dict(greedy=False, temperature=0.8, top_k=40, top_p=0.95)
    for sampler in (None, sampled):
        ref, _, cfg = _serve_smoke(arch, cpu, sampler=sampler)
        pg = tree_map(lambda t: t.to(dev), T.init_lm(cfg, seed=0,
                                                      device="cpu"))
        got, launches, _ = _serve_smoke(arch, dev, pg, sampler=sampler)
        assert got == ref, sampler
        specs = cfg.layer_specs()
        n_rec = sum(s.mixer == "rg_lru" for s in specs)
        assert launches["flash_attention"] == 2 * (len(specs) - n_rec)
        assert launches["rg_lru_scan"] == 2 * n_rec
        assert launches["flash_attention_tc"] == 0     # f32: the loop
    _, launches, cfg = _serve_smoke(arch, dev, dtype="bfloat16")
    n_attn = sum(s.mixer != "rg_lru" for s in cfg.layer_specs())
    assert launches["flash_attention_tc"] == 2 * n_attn
