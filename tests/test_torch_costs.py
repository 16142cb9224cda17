"""The port's cost counter (:mod:`repro_torch.launch.costs`) and the
kernel wrappers' cost records (:mod:`repro_torch.kernels.records`).

* Counted FLOPs are exact: a matmul, a gradient, a Python loop of 7
  products and a nested 5 x 3 loop (the counterparts of
  ``tests/test_roofline.py``'s scan cases: eager PyTorch unrolls the
  loop that XLA's ``while`` hides), and equal ``FlopCounterMode``'s on
  the qwen2-1.5b smoke step.
* Each K1-K6 wrapper on ``meta`` tensors launches nothing
  (``LAUNCHES`` does not move), returns outputs of the launch's shapes
  and dtypes, and records its cost: K2-K5's FLOPs equal
  ``FlopCounterMode`` over the plain version on the CPU at the same
  shapes, the bytes the hand formula (each operand read once, each
  result written once).  On the CPU a wrapper records nothing.
* The peak tracker matches a hand count of live storages.
* Every ``tensor_parallel`` collective's counted bytes equal the ring
  formula on a fake process group of 8 ranks (in a subprocess: the
  group is process-wide).
"""
import os
import subprocess
import sys

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import records as REC
from repro_torch.kernels import rg_lru as RG
from repro_torch.kernels import zo_matmul as ZM
from repro_torch.launch import costs as C

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = torch.device("meta")


def _flops(fn, *args):
    return C.total_costs(fn, *args)["flops"]


def test_matmul_flops_exact():
    x = torch.zeros((256, 512))
    w = torch.zeros((512, 128))
    assert _flops(lambda a, b: a @ b, x, w) == 2 * 256 * 512 * 128


def test_grad_flops_exact():
    """The forward product and the weight gradient's (x needs none)."""
    w = torch.zeros((128, 128), requires_grad=True)
    x = torch.zeros((64, 128))

    def grad(w, x):
        return torch.autograd.grad(torch.sum((x @ w) ** 2), w)[0]

    assert _flops(grad, w, x) == 2 * (2 * 64 * 128 * 128)


def test_loop_of_products_exact():
    x = torch.zeros((128, 128), dtype=torch.bfloat16, device=META)
    ws = torch.zeros((7, 128, 128), dtype=torch.bfloat16, device=META)

    def f(x, ws):
        for w in ws:
            x = x @ w
        return x

    assert _flops(f, x, ws) == 7 * 2 * 128 ** 3


def test_nested_loop_exact():
    x = torch.zeros((64, 64), device=META)
    ws = torch.zeros((5, 64, 64), device=META)

    def f(x, ws):
        for w in ws:
            for _ in range(3):
                x = x @ w
        return x

    assert _flops(f, x, ws) == 15 * 2 * 64 ** 3


class _PlainBytes(TorchDispatchMode):
    """The bytes rule without the meta signature cache: every op run,
    the operands and results of each non-view, non-``empty*`` op."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and not func._opname.startswith("empty"):
            self.bytes += sum(t.numel() * t.element_size() for t in
                              tree_flatten((args, kwargs, out))[0]
                              if isinstance(t, torch.Tensor))
        return out


def test_step_counts_equal_uncached_counts():
    """Over one datacenter step on meta tensors (qwen2-1.5b smoke, the
    threefry stream): the counter's FLOPs (``FlopCounterMode``'s
    registry, repeats answered from the meta signature cache) equal
    ``FlopCounterMode``'s own count, its bytes a count that runs every
    op, and two counts agree."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import prng as R
    from repro_torch.core import protocols as P
    from repro_torch.core import zo as Z
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import make_optimizer
    cfg = get_config("qwen2-1.5b", smoke=True)
    copt, sopt = make_optimizer("zo_sgd", 1e-3), make_optimizer("adamw", 1e-3)
    state = P.init_train_state(R.PRNGKey(0), T.init_lm(cfg, device="meta"),
                               copt, sopt)
    tok = torch.empty((4, 32), dtype=torch.int32, device=META)
    batch = {"inputs": tok, "labels": tok}
    step = P.make_train_step(P.lm_api(cfg), "heron",
                             Z.ZOConfig(mu=1e-3), copt, sopt)
    pb = _PlainBytes()
    with FlopCounterMode(display=False) as fc, pb:
        step(state, batch)
    a, b = (C.total_costs(step, state, batch) for _ in range(2))
    assert a["flops"] == fc.get_total_flops() > 0
    assert a["bytes"] == pb.bytes > 0
    assert a == b


def test_peak_tracker_hand_count():
    x = torch.empty((64, 128), device=META)
    w = torch.empty((128, 256), device=META)

    def f(x, w):
        y = x @ w                  # 64 KiB
        z = torch.relu(y)          # + 64 KiB
        del y
        u = z * 2                  # + 64 KiB - 64 KiB freed
        return u.sum()             # + 4 B, z and u alive

    c = C.total_costs(f, x, w)
    args = 4 * (64 * 128 + 128 * 256)
    assert c["argument_bytes"] == args
    assert c["peak_bytes"] == args + 2 * 4 * 64 * 256 + 4
    assert c["output_bytes"] == 4


def _mm_inputs(dtype, dev, M=32, K=48, N=40):
    return (torch.randn((M, K)).to(dtype).to(dev),
            torch.randn((M, K)).to(dtype).to(dev),
            torch.randn((K, N)).to(dtype).to(dev))


def _attn_inputs(dtype, dev, B=2, S=16, H=4, Kv=2, D=8):
    q = [torch.randn((B, S, H, D)).to(dtype).to(dev) for _ in range(2)]
    kv = [torch.randn((B, S, Kv, D)).to(dtype).to(dev) for _ in range(4)]
    return q, kv


def _plain_flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _records(fn):
    before = {**ZM.LAUNCHES, **FA.LAUNCHES, **RG.LAUNCHES}
    with REC.recording() as recs:
        out = fn()
    assert {**ZM.LAUNCHES, **FA.LAUNCHES, **RG.LAUNCHES} == before
    return out, recs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_k4_records_match_plain_flops(dtype):
    M, K, N = 32, 48, 40
    es = torch.tensor([], dtype=dtype).element_size()
    xa, xb, w = _mm_inputs(dtype, "cpu")
    ma, mb, mw = (t.to(META) for t in (xa, xb, w))
    (ya, yb), recs = _records(lambda: ZM.zo_dual_matmul(ma, mb, mw, 3, 0.0,
                                                        1e-3))
    assert ya.device == META and ya.shape == (M, N) and yb.dtype == dtype
    plain = _plain_flops(lambda: ZM.zo_dual_matmul(xa, xb, w, 3, 0.0, 1e-3))
    assert recs == [("zo_dual_matmul", plain,
                     es * (2 * M * K + K * N + 2 * M * N))]
    y, recs = _records(lambda: ZM.zo_matmul(ma, mw, 3, 1e-3))
    assert y.shape == (M, N) and y.dtype == dtype
    plain = _plain_flops(lambda: ZM.zo_matmul(xa, w, 3, 1e-3))
    assert recs == [("zo_matmul", plain, es * (M * K + K * N + M * N))]
    with REC.recording() as recs:
        ZM.zo_dual_matmul(xa, xb, w, 3, 0.0, 1e-3)
        ZM.zo_matmul(xa, w, 3, 1e-3)
    assert recs == []


@pytest.mark.parametrize("mode", ["weights", "scores"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_k5_records_match_plain_flops(mode, dtype):
    B, S, H, Kv, D = 2, 16, 4, 2, 8
    es = torch.tensor([], dtype=dtype).element_size()
    (qa, qb), (k, v, kb, vb) = _attn_inputs(dtype, "cpu")
    meta = [t.to(META) for t in (qa, qb, k, v, kb, vb)]

    def k3(qa, qb, k, v, kb, vb):
        if mode == "weights":
            return FA.zo_dual_flash_attention(qa, qb, k, v, kb=kb, vb=vb,
                                              perturb_b=False)
        return FA.zo_dual_flash_attention(qa, qb, k, v, seed=9, mu_b=1e-3)

    (oa, ob), recs = _records(lambda: k3(*meta))
    assert oa.shape == qa.shape and ob.device == META
    q_b, kv_b = B * S * H * D, B * S * Kv * D
    sets = 2 if mode == "weights" else 1
    plain = _plain_flops(lambda: k3(qa, qb, k, v, kb, vb))
    assert recs == [("zo_dual_flash_attention", plain,
                     es * (4 * q_b + 2 * sets * kv_b))]
    o, recs = _records(lambda: FA.flash_attention(*meta[:1], *meta[2:4]))
    assert o.shape == qa.shape
    plain = _plain_flops(lambda: FA.flash_attention(qa, k, v))
    assert recs == [("flash_attention", plain, es * (2 * q_b + 2 * kv_b))]
    with REC.recording() as recs:
        k3(qa, qb, k, v, kb, vb)
    assert recs == []


def test_k1_records_bytes():
    """One record a launch (``plan_launches``), no FLOPs; the field's,
    the accumulator's and a bf16 perturbation's bytes; the gathered
    rows' output and int32 ids."""
    segs = [ZM.Segment(3, 40, 1), ZM.Segment(5, 8, 2), ZM.Segment(2, 2, None)]
    outs = [torch.empty(s.rows * s.cols, device=META) for s in segs]
    _, recs = _records(lambda: ZM.zo_noise_tree("field", segs[:2],
                                                outs[:2]))
    assert recs == [("zo_noise", 0.0, 4.0 * (120 + 40))]
    sc = torch.zeros((), device=META)
    _, recs = _records(lambda: ZM.zo_noise_tree("accumulate", segs, outs,
                                                scale=sc))
    assert recs == [("zo_noise", 0.0, 8.0 * (120 + 40 + 4))]
    ins = [torch.empty(s.rows * s.cols, dtype=torch.bfloat16, device=META)
           for s in segs[:2]]
    pouts = [torch.empty_like(t) for t in ins]
    _, recs = _records(lambda: ZM.zo_noise_tree("perturb", segs[:2], pouts,
                                                ins=ins, mu=1e-3))
    assert recs == [("zo_noise", 0.0, 2.0 * 2 * (120 + 40))]
    many = [ZM.Segment(1, 4, i) for i in range(ZM.MAX_SEGMENTS + 1)]
    _, recs = _records(lambda: ZM.zo_noise_tree(
        "field", many, [torch.empty(4, device=META) for _ in many]))
    assert [r[2] for r in recs] == [4.0 * 4 * ZM.MAX_SEGMENTS, 16.0]
    ids = torch.zeros((2, 5), dtype=torch.int64, device=META)
    rows, recs = _records(lambda: ZM.zo_noise_rows(3, ids, 7))
    assert rows.shape == (2, 5, 7) and rows.dtype == torch.float32
    assert recs == [("zo_noise", 0.0, 4.0 * 10 * (7 + 1))]
    with REC.recording() as recs:
        ZM.zo_noise_tree("field", segs[:1], [torch.empty(120)])
        ZM.zo_noise_rows(3, torch.zeros((2, 5), dtype=torch.int64), 7)
    assert recs == []


def test_k6_records_forward_and_reverse():
    """K6 forward (12 B an element) and, through autograd on meta, its
    reverse mode (20 B); no FLOPs; nothing on the CPU."""
    a = torch.empty((2, 8, 16), device=META, requires_grad=True)
    b = torch.empty((2, 8, 16), device=META, requires_grad=True)

    def fwd_bwd():
        h = RG.rg_lru_scan(a, b)
        h.sum().backward()
        return h

    h, recs = _records(fwd_bwd)
    assert h.shape == (2, 8, 16) and a.grad.shape == a.shape
    n = 2 * 8 * 16
    assert recs == [("rg_lru_scan", 0.0, 12.0 * n),
                    ("rg_lru_scan", 0.0, 20.0 * n)]
    with REC.recording() as recs:
        RG.rg_lru_scan(torch.rand((2, 8, 16)), torch.rand((2, 8, 16)))
    assert recs == []


def test_counter_adds_kernel_records():
    xa, xb, w = (t.to(META) for t in _mm_inputs(torch.bfloat16, "cpu"))
    c = C.total_costs(lambda: ZM.zo_dual_matmul(xa, xb, w, 3, 0.0, 1e-3))
    k = c["kernel_records"]["zo_dual_matmul"]
    assert k == {"launches": 1, "flops": 2 * 2 * 32 * 48 * 40,
                 "bytes": 2.0 * (2 * 32 * 48 + 48 * 40 + 2 * 32 * 40)}
    assert c["flops"] == k["flops"]


COLLECTIVES = r"""
import json
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.mesh import make_local_mesh
from repro_torch.launch import costs as C

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_local_mesh(8)
x = torch.empty((4, 16), device="meta", requires_grad=True)
ids = torch.empty((3,), dtype=torch.int64, device="meta")
leaves = [torch.empty((5,), device="meta"), torch.empty((7,), device="meta")]
cases = {
    "copy_to": lambda: TP.copy_to(x, mesh).sum().backward(),
    "reduce_from": lambda: TP.reduce_from(x, mesh),
    "gather_from": lambda: TP.gather_from(x, mesh),
    "split_to": lambda: TP.split_to(x, mesh).sum().backward(),
    "reduce_scatter": lambda: TP.reduce_scatter(x, mesh),
    "all_to_all": lambda: TP.all_to_all(x, mesh, split_dim=1, concat_dim=0),
    "all_gather_ints": lambda: TP.all_gather_ints(ids, mesh, "model"),
    "all_max": lambda: TP.all_max(x, mesh),
    "all_reduce_tree": lambda: TP.all_reduce_tree(leaves, mesh, "model"),
}
out = {}
for name, fn in cases.items():
    c = C.total_costs(fn)
    out[name] = [c["collectives"], c["n_collectives"], c["collective_links"]]
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_tensor_parallel_collectives_ring_bytes():
    """On a fake group of 8 ranks (one node: NVLink), each collective's
    bytes by the reference's ring model: an all-reduce of n bytes 2n·7/8,
    an all-gather 7/8 of its output, an all-to-all 7/8 of its output;
    the port's reduce-scatter is the all-reduce it runs (gloo has none)
    and ``split_to``'s backward an all-gather."""
    import json
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    r = subprocess.run([sys.executable, "-c", COLLECTIVES], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    n = 4 * 16 * 4                       # x's bytes
    ar, ag = 2 * n * 7 / 8, 8 * n * 7 / 8
    want = {"copy_to": {"all-reduce": ar}, "reduce_from": {"all-reduce": ar},
            "gather_from": {"all-gather": ag},
            "split_to": {"all-gather": n * 7 / 8},
            "reduce_scatter": {"all-reduce": ar},
            "all_to_all": {"all-to-all": n * 7 / 8},
            "all_gather_ints": {"all-gather": 8 * 3 * 8 * 7 / 8},
            "all_max": {"all-reduce": ar},
            "all_reduce_tree": {"all-reduce": 2 * 48 * 7 / 8}}
    for name, coll in want.items():
        kinds, count, links = got[name]
        assert kinds == pytest.approx(coll), name
        assert count == 1, name
        assert links == pytest.approx({"nvlink": sum(coll.values())}), name
    assert C.ring_bytes("reduce-scatter", 10, 8) == 70
    assert C.ring_bytes("collective-permute", 10, 8) == 10
