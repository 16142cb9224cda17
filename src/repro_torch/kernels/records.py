"""Cost records of the kernel wrappers.

A kernel launch is opaque to PyTorch's dispatcher: a counter over aten
ops (:mod:`repro_torch.launch.costs`) sees a wrapper's output
allocations but neither its kernel's products nor its traffic.  So each
wrapper reports its kernel's work here, once per launch, on CUDA tensors
(where it launches) and on ``meta`` tensors (where it launches nothing
and returns empty outputs of the launch's shapes), to every counter
that is open (:func:`recording`).  On the CPU a wrapper runs the plain
version, whose aten ops the counter sees, so it records nothing.

A record's FLOPs are those that ``FlopCounterMode`` counts over the
kernel's plain version at the same shapes (K1 and K6 have no products);
its bytes are each operand read once and each result written once, the
bytes of the bound column of the kernel table in ``PERF.md``.
"""
from __future__ import annotations

import contextlib

_SINKS: list[list] = []


def record(name: str, flops: float, nbytes: float) -> None:
    """One launch of kernel ``name`` (a ``LAUNCHES`` key) to every open
    counter."""
    for sink in _SINKS:
        sink.append((name, float(flops), float(nbytes)))


@contextlib.contextmanager
def recording():
    """Collect the records of the launches made inside: yields the list
    that ``(name, flops, bytes)`` tuples are appended to."""
    sink: list = []
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.remove(sink)


def matmul_cost(M: int, K: int, N: int, itemsize: int, streams: int = 1):
    """``(flops, bytes)`` of K2 (``streams=2``) or K4 (1): ``streams``
    products (M, K) @ (K, N) on one read of W."""
    return (2.0 * streams * M * K * N,
            float(itemsize * (streams * M * K + K * N + streams * M * N)))


def attention_cost(B: int, Sq: int, Skv: int, H: int, Kv: int, D: int,
                   itemsize: int, streams: int = 1, kv_sets: int = 1):
    """``(flops, bytes)`` of K3 (``streams=2``; ``kv_sets`` 2 in the
    weights mode, 1 in the scores mode) or K5 (1, 1): the plain version
    scores every (q, kv) pair, ``QK^T`` and ``PV`` at 2 * D each."""
    q_bytes, kv_bytes = B * Sq * H * D, B * Skv * Kv * D
    return (4.0 * streams * B * H * Sq * Skv * D,
            float(itemsize * (2 * streams * q_bytes + 2 * kv_sets
                              * kv_bytes)))


def noise_tree_bytes(mode: str, n: int, itemsize: int = 4) -> float:
    """K1's bytes over ``n`` elements of a tree launch: the f32 field
    written, the f32 accumulator read and written, or the leaf read and
    its ``itemsize`` result written."""
    return float({"field": 4 * n, "accumulate": 8 * n,
                  "perturb": 2 * itemsize * n}[mode])


def scan_bytes(n: int, reverse: bool) -> float:
    """K6's bytes over ``n`` elements: ``a``, ``b`` read and ``h`` written
    (12 B an element), or in reverse ``a``, ``g``, ``h`` read and ``da``,
    ``db`` written (20 B)."""
    return float((20 if reverse else 12) * n)
