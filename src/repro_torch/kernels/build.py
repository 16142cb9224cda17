"""Builds the CUDA kernels of ``csrc/`` with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for ``sm_90a`` at first use into ``_build/`` beside
this file (git-ignored).  All sources compile at once, one nvcc process
each.  A library's file name carries a hash of its sources and flags, so
an edited kernel is rebuilt and a stale one is never loaded.  A failed
build raises; nothing falls back to the plain versions.

Every C entry point returns ``cudaGetLastError()`` after its launch, and
:func:`check` turns a non-zero code into an exception: a refused launch
(too many threads, too much shared memory) never runs, and a later
``torch.cuda.synchronize()`` would not report it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # csrc/convert.cuh

_P, _I, _LL, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_uint, ctypes.c_float)
# library -> C function -> argument types (all return the cudaError_t code)
SIGNATURES = {
    "zo_noise": {
        "zo_noise_tree": [_P, _P],
        "zo_noise_rows": [_P, _P, _LL, _LL, _U, _P],
    },
    "zo_dual_matmul": {
        "zo_dual_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _U,
                           _F, _F, _U, _U, _P],
        "zo_dual_matmul_tc": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _U, _F, _F, _U, _U, _P, _P],
    },
    "zo_dual_flash_attention": {
        "zo_dual_flash_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                    _F, _F, _U, _F, _F, _U, _P],
        "zo_dual_flash_attention_tc": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                       _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                       _I, _F, _F, _U, _F, _F, _U, _P],
    },
    "zo_matmul": {
        "zo_matmul": [_P, _P, _P, _I, _I, _I, _I, _I, _U, _F, _U, _U, _P],
        "zo_matmul_tc": [_P, _P, _P, _I, _I, _I, _I, _I, _U, _F, _U, _U, _P,
                         _P],
    },
    "flash_attention": {
        "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _I, _F, _F, _P],
        "flash_attention_tc": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _F, _F, _P],
    },
    "rg_lru_scan": {
        "rg_lru_scan": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source on the machine with the card")
    return nvcc


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all() -> float:
    """Compile every library that is not built yet, one nvcc per source,
    all started together.  Returns the seconds spent.  The compiler's
    report (registers, shared memory, spills) goes to ``_build/*.log``."""
    t0 = time.perf_counter()
    todo = [n for n in SIGNATURES if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed)."""
    lib = _loaded.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")


def stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the C handle."""
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(what: str, *tensors: torch.Tensor) -> torch.device:
    """Check that the tensors share one CUDA device and are contiguous.
    The ``meta`` device passes too: there a wrapper checks the launch's
    shapes, records its cost (:mod:`repro_torch.kernels.records`) and
    returns empty outputs without launching."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: non-contiguous input {tuple(t.shape)}")
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"{what}: expected CUDA (or meta) tensors, got "
                         f"{dev}")
    return dev
