"""Wrappers of kernels K1 (``csrc/zo_noise.cu``), K2
(``csrc/zo_dual_matmul.cu``) and K4 (``csrc/zo_matmul.cu``), the
counterparts of ``zo_noise``, ``zo_dual_matmul`` and ``zo_matmul`` in
:mod:`repro.kernels.zo_matmul`.

A wrapper launches its kernel for CUDA tensors, on PyTorch's current
stream, and raises if the launch fails.  It takes the plain PyTorch
version only for tensors on the CPU.  On ``meta`` tensors it checks the
shapes, launches nothing and returns empty outputs (a dry run's cost
count).  ``LAUNCHES`` counts kernel launches (never plain-version calls),
so a run can show that it went through the kernels; each launch, and
each meta call in its place, records its cost
(:mod:`repro_torch.kernels.records`).

K1 draws U(seed) for a list of leaves in one launch (:func:`zo_noise_tree`,
one launch per ``MAX_SEGMENTS`` leaves) and hands each element to its
consumer there: the field itself, ``acc + s*U`` into an f32 accumulator,
or ``dtype(p + mu*U)``.  :func:`plan_launches` lays the leaves out as the
kernel's segment table, a pure function of their shapes.

K2 and K4 have two routes on the card, chosen by
:func:`tensor_core_route`: operands whose shapes and pointers suit TMA
run on the tensor cores (bf16 in ``csrc/zo_wgmma_matmul.cuh``, f32 as
3xTF32 in ``csrc/zo_tf32_matmul.cuh``), everything else on the CUDA-core
tile loop (``csrc/zo_tile_matmul.cuh``).
``LAUNCHES["zo_dual_matmul"]`` / ``["zo_matmul"]`` count every launch;
the ``_tc`` keys count those that took the tensor cores.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels import noise as N
from repro_torch.kernels import records as REC
from repro_torch.kernels import ref as R

LAUNCHES = {"zo_noise": 0, "zo_dual_matmul": 0, "zo_dual_matmul_tc": 0,
            "zo_matmul": 0, "zo_matmul_tc": 0}

# K1's table (csrc/zo_noise.cu): segments per launch, the tile, the modes
MAX_SEGMENTS = 64
TILE_ROWS, TILE_COLS = 32, 128
MODES = {"field": 0, "accumulate": 1, "perturb": 2}
_BF16, _ZERO, _VEC = 1, 2, 4


@dataclasses.dataclass(frozen=True)
class Segment:
    """One leaf of a K1 launch: U(seed) on a (rows, cols) window at a
    global (row_offset, col_offset); ``seed=None`` is a zero direction
    (accumulate mode adds ``s*0``)."""
    rows: int
    cols: int
    seed: int | None
    row_offset: int = 0
    col_offset: int = 0

    @property
    def tiles(self) -> int:
        return (-(-self.rows // TILE_ROWS)) * (-(-self.cols // TILE_COLS))


def plan_launches(segments, max_segments: int = MAX_SEGMENTS):
    """The launches of a K1 tree call, a pure function of the segments:
    ``[(indices, tile0s, tiles)]``, each launch at most ``max_segments``
    segments with at least one tile, ``tile0s`` the prefix sums of their
    tile counts and ``tiles`` the total.  Segments without elements take
    no place.  Needs no card."""
    out, idx, t0s, total = [], [], [], 0
    for i, seg in enumerate(segments):
        if seg.rows * seg.cols == 0:
            continue
        if len(idx) == max_segments:
            out.append((idx, t0s, total))
            idx, t0s, total = [], [], 0
        idx.append(i)
        t0s.append(total)
        total += seg.tiles
    if idx:
        out.append((idx, t0s, total))
    return out


class _Segment(ctypes.Structure):
    _fields_ = [("out", ctypes.c_void_p), ("inp", ctypes.c_void_p),
                ("tile0", ctypes.c_longlong), ("rows", ctypes.c_uint),
                ("cols", ctypes.c_uint), ("seed", ctypes.c_uint),
                ("row_offset", ctypes.c_uint), ("col_offset", ctypes.c_uint),
                ("col_tiles", ctypes.c_uint), ("flags", ctypes.c_uint),
                ("unused", ctypes.c_uint)]


class _Table(ctypes.Structure):
    _fields_ = [("seg", _Segment * MAX_SEGMENTS), ("tiles", ctypes.c_longlong),
                ("scale", ctypes.c_void_p), ("n", ctypes.c_int),
                ("mode", ctypes.c_int), ("mu", ctypes.c_float),
                ("unused", ctypes.c_int)]


def _plain_noise(seg: Segment, device):
    return N.uniform_noise(seg.seed, (seg.rows, seg.cols), seg.row_offset,
                           seg.col_offset, device=device)


def zo_noise_tree(mode: str, segments, outs, ins=None, scale=None,
                  mu=0.0):
    """K1 over a list of leaves, one launch per ``MAX_SEGMENTS``.

    ``outs[i]`` and ``ins[i]`` are contiguous tensors of
    ``segments[i].rows * segments[i].cols`` elements.  Modes:
      * ``"field"``: ``outs[i] = U_i`` (f32);
      * ``"accumulate"``: ``outs[i] += scale * U_i`` in place (f32;
        ``scale`` a 0-d f32 tensor on the device, read by the kernel);
      * ``"perturb"``: ``outs[i] = (ins[i].float() + mu*U_i).to(dtype)``
        (f32 or bf16, ``outs[i]`` of ``ins[i]``'s dtype).
    A segment with ``seed=None`` has U = 0.  CPU tensors run the plain
    tensor code of each mode, leaf by leaf; meta tensors launch nothing
    (the outputs are the caller's) and record each launch's cost."""
    code = MODES[mode]
    if not outs:
        return
    dev = outs[0].device
    if dev.type == "cpu":
        for i, seg in enumerate(segments):
            o = outs[i].view(seg.rows, seg.cols)
            if mode == "field":
                o.copy_(_plain_noise(seg, dev))
            elif mode == "accumulate":
                u = (torch.zeros((seg.rows, seg.cols), dtype=torch.float32)
                     if seg.seed is None else _plain_noise(seg, dev))
                o.copy_(o + scale * u)
            else:
                p = ins[i].view(seg.rows, seg.cols)
                o.copy_((p.to(torch.float32) + float(mu)
                         * _plain_noise(seg, dev)).to(p.dtype))
        return
    tensors = list(outs) + list(ins or [])
    if mode == "accumulate":
        tensors.append(scale)
    build.require_cuda("zo_noise_tree", *tensors)
    if mode == "accumulate" and (scale.dtype != torch.float32
                                 or scale.numel() != 1):
        raise ValueError(f"zo_noise_tree: scale must be one f32 value, got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    for i, seg in enumerate(segments):
        o = outs[i]
        want = (ins[i].dtype if mode == "perturb" else torch.float32)
        if o.dtype != want or o.numel() != seg.rows * seg.cols or (
                mode == "perturb" and (ins[i].numel() != o.numel()
                                       or want not in build.DTYPE_CODES)):
            raise ValueError(f"zo_noise_tree {mode}: leaf {i} of {seg} is "
                             f"{o.dtype} {tuple(o.shape)}")
        if mode != "accumulate" and seg.seed is None:
            raise ValueError(f"zo_noise_tree {mode}: leaf {i} has no seed")
    launches = plan_launches(segments)
    if dev.type == "meta":
        for idx, _, _ in launches:
            _record_tree(mode, segments, outs, idx)
        return
    lib = build.library("zo_noise")
    for idx, t0s, tiles in launches:
        t = _Table()
        for k, (i, t0) in enumerate(zip(idx, t0s)):
            seg, o = segments[i], outs[i]
            p = ins[i] if mode == "perturb" else None
            bf16 = o.dtype == torch.bfloat16
            align = 8 if bf16 else 16
            vec = seg.cols % 4 == 0 and all(
                x.data_ptr() % align == 0 for x in (o, p) if x is not None)
            t.seg[k] = _Segment(
                o.data_ptr(), None if p is None else p.data_ptr(), t0,
                seg.rows, seg.cols, N._u32(0 if seg.seed is None
                                           else seg.seed),
                N._u32(seg.row_offset), N._u32(seg.col_offset),
                -(-seg.cols // TILE_COLS),
                _BF16 * bf16 + _ZERO * (seg.seed is None) + _VEC * vec, 0)
        t.tiles, t.n, t.mode, t.mu = tiles, len(idx), code, float(mu)
        t.scale = scale.data_ptr() if mode == "accumulate" else None
        build.check(lib.zo_noise_tree(ctypes.byref(t), build.stream(dev)),
                    "zo_noise_tree")
        LAUNCHES["zo_noise"] += 1
        _record_tree(mode, segments, outs, idx)


def _record_tree(mode, segments, outs, idx):
    """The cost record of one K1 tree launch over ``segments[idx]``."""
    REC.record("zo_noise", 0, sum(REC.noise_tree_bytes(
        mode, segments[i].rows * segments[i].cols, outs[i].element_size())
        for i in idx))


def zo_noise(seed, shape, row_offset=0, col_offset=0, *, device):
    """K1, field mode: U(seed) on a (rows, cols) window at a global
    offset, f32 (one segment)."""
    dev = torch.device(device)
    rows, cols = (int(s) for s in shape)
    if dev.type == "cpu":
        return N.uniform_noise(seed, (rows, cols), row_offset, col_offset,
                               device=dev)
    out = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    zo_noise_tree("field", [Segment(rows, cols, seed, row_offset,
                                    col_offset)], [out])
    return out


def zo_noise_rows(seed, ids: torch.Tensor, n_cols: int):
    """K1, gathered mode: ``U[ids[..., None], arange(n_cols)]`` with
    shape ``ids.shape + (n_cols,)``, f32."""
    if ids.device.type == "cpu":
        cols = torch.arange(n_cols, dtype=torch.int64, device=ids.device)
        return N.uniform_noise_at(seed, ids[..., None], cols)
    flat = ids.reshape(-1).to(torch.int32).contiguous()
    out = torch.empty((flat.numel(), n_cols), dtype=torch.float32,
                      device=ids.device)
    dev = build.require_cuda("zo_noise_rows", flat, out)
    if out.numel():
        if dev.type != "meta":
            err = build.library("zo_noise").zo_noise_rows(
                out.data_ptr(), flat.data_ptr(), flat.numel(), n_cols,
                int(N._u32(seed)), build.stream(dev))
            build.check(err, "zo_noise_rows")
            LAUNCHES["zo_noise"] += 1
        REC.record("zo_noise", 0, 4 * flat.numel() * (n_cols + 1))
    return out.reshape(tuple(ids.shape) + (n_cols,))


def _check_matmul(what, w, *xs):
    """Device, contiguity, shapes and dtype of a K2 / K4 launch."""
    dev = build.require_cuda(what, *xs, w)
    x = xs[0]
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] \
            or any(t.shape != x.shape for t in xs):
        raise ValueError(f"{what}: shapes "
                         f"{[tuple(t.shape) for t in xs]} @ "
                         f"{tuple(w.shape)}")
    if any(t.dtype != w.dtype for t in xs) or w.dtype not in \
            build.DTYPE_CODES:
        raise ValueError(f"{what}: dtypes {[t.dtype for t in xs]}, "
                         f"{w.dtype}; expected one of f32 / bf16")
    return dev


def tensor_core_route(dtype, K: int, N: int, ptrs) -> bool:
    """Whether a K2 / K4 launch of (M, K) @ (K, N) runs on the tensor
    cores: bf16 or f32 operands, K and N positive multiples of 8 (TMA's
    row strides are multiples of 16 bytes) and every base pointer in
    ``ptrs`` 16-byte aligned (TMA's base addresses).  Anything else takes
    the CUDA-core loop.  A pure function of its arguments: it needs no
    card."""
    return (dtype in build.DTYPE_CODES and K > 0 and N > 0 and K % 8 == 0
            and N % 8 == 0 and all(int(p) % 16 == 0 for p in ptrs))


def _tf32_scratch(dtype, streams, K, N, dev):
    """The f32 tensor-core route's scratch: each stream's W + mu*U split
    into two tf32 terms, transposed (``2 * streams`` (N, K) f32 blocks);
    None for bf16.  The wrapper holds it across the launch; once freed,
    PyTorch's allocator hands it out only to work queued after it."""
    if dtype != torch.float32:
        return None
    return torch.empty((2 * streams, N, K), dtype=torch.float32, device=dev)


def zo_dual_matmul(xa, xb, w, seed, mu_a, mu_b, *, row_offset=0,
                   col_offset=0, perturb_a: bool = False,
                   perturb_b: bool = True):
    """K2: ``(xa @ (W + mu_a*U), xb @ (W + mu_b*U))`` for one read of W.

    xa, xb: (M, K); w: (K, N); one dtype, f32 or bf16; f32 accumulation,
    outputs in x's dtype.  ``perturb_a`` / ``perturb_b`` select the
    streams that see the noise (clean + perturbed by default;
    ``perturb_a=True, mu_b=-mu_a`` is the antithetic pair).  ``W``'s
    element (k, n) reads ``U[row_offset + k, col_offset + n]``: a layer
    of a stacked leaf, or a tensor-parallel slab of a larger W.
    """
    if xa.device.type == "cpu":
        u = None
        if perturb_a or perturb_b:
            u = N.uniform_noise(seed, w.shape, row_offset, col_offset,
                                device=w.device)
        return R.zo_dual_matmul_ref(xa, xb, w, u, mu_a, mu_b,
                                    perturb_a=perturb_a, perturb_b=perturb_b)
    dev = _check_matmul("zo_dual_matmul", w, xa, xb)
    M, K = xa.shape
    Nn = w.shape[1]
    ya = torch.empty((M, Nn), dtype=xa.dtype, device=dev)
    yb = torch.empty((M, Nn), dtype=xa.dtype, device=dev)
    if ya.numel() and dev.type == "meta":
        REC.record("zo_dual_matmul", *REC.matmul_cost(
            M, K, Nn, xa.element_size(), streams=2))
    elif ya.numel():
        lib = build.library("zo_dual_matmul")
        ptrs = (xa.data_ptr(), xb.data_ptr(), w.data_ptr(), ya.data_ptr(),
                yb.data_ptr())
        args = (*ptrs, M, K, Nn, build.DTYPE_CODES[xa.dtype],
                int(perturb_a), int(perturb_b), int(N._u32(seed)),
                float(mu_a), float(mu_b), int(N._u32(row_offset)),
                int(N._u32(col_offset)))
        tc = tensor_core_route(xa.dtype, K, Nn, ptrs)
        if tc:
            scratch = _tf32_scratch(xa.dtype, 2, K, Nn, dev)
            err = lib.zo_dual_matmul_tc(
                *args, None if scratch is None else scratch.data_ptr(),
                build.stream(dev))
        else:
            err = lib.zo_dual_matmul(*args, build.stream(dev))
        build.check(err, "zo_dual_matmul")
        LAUNCHES["zo_dual_matmul"] += 1
        LAUNCHES["zo_dual_matmul_tc"] += int(tc)
        REC.record("zo_dual_matmul", *REC.matmul_cost(
            M, K, Nn, xa.element_size(), streams=2))
    return ya, yb


def zo_matmul(x, w, seed, mu, *, row_offset=0, col_offset=0,
              perturb: bool = True):
    """K4: ``y = x @ (W + mu*U(seed))``, or ``x @ W`` with
    ``perturb=False`` (the clean pass of the two-pass baseline).

    x: (M, K); w: (K, N); one dtype, f32 or bf16; f32 accumulation,
    output in x's dtype.  Equals stream b of :func:`zo_dual_matmul` with
    the same (seed, mu, row_offset, col_offset) bit for bit on the card
    when both take the same route.
    """
    if x.device.type == "cpu":
        if not perturb:
            return R.matmul_ref(x, w)
        u = N.uniform_noise(seed, w.shape, row_offset, col_offset,
                            device=w.device)
        return R.zo_matmul_ref(x, w, u, mu)
    dev = _check_matmul("zo_matmul", w, x)
    M, K = x.shape
    Nn = w.shape[1]
    y = torch.empty((M, Nn), dtype=x.dtype, device=dev)
    if y.numel() and dev.type == "meta":
        REC.record("zo_matmul", *REC.matmul_cost(M, K, Nn, x.element_size()))
    elif y.numel():
        lib = build.library("zo_matmul")
        ptrs = (x.data_ptr(), w.data_ptr(), y.data_ptr())
        args = (*ptrs, M, K, Nn, build.DTYPE_CODES[x.dtype], int(perturb),
                int(N._u32(seed)), float(mu), int(N._u32(row_offset)),
                int(N._u32(col_offset)))
        tc = tensor_core_route(x.dtype, K, Nn, ptrs)
        if tc:
            scratch = _tf32_scratch(x.dtype, 1, K, Nn, dev)
            err = lib.zo_matmul_tc(
                *args, None if scratch is None else scratch.data_ptr(),
                build.stream(dev))
        else:
            err = lib.zo_matmul(*args, build.stream(dev))
        build.check(err, "zo_matmul")
        LAUNCHES["zo_matmul"] += 1
        LAUNCHES["zo_matmul_tc"] += int(tc)
        REC.record("zo_matmul", *REC.matmul_cost(M, K, Nn, x.element_size()))
    return y
