"""Kernel dispatch and the per-leaf seed scheme, mirroring
:mod:`repro.kernels.ops`.

Dispatch: :func:`zo_noise`, :func:`zo_dual_matmul`,
:func:`zo_dual_flash_attention`, :func:`zo_matmul`,
:func:`flash_attention` and :func:`rg_lru_scan` launch kernels K1-K6 for
CUDA tensors and run the plain PyTorch versions for CPU tensors (the wrappers decide by the
tensor's device; there is no backend knob).

Seed scheme: every parameter leaf gets ``seed_leaf = base_seed +
fnv1a(path)`` (int32, wrapping), and its noise is defined on the
canonical 2-D view (prod(shape[:-1]), shape[-1]).  A leaf stacked along a
leading scan axis (reps, K, N) is one (reps*K, N) field and rep r reads
rows [r*K, (r+1)*K) through ``row_offset``, so per-rep kernel calls and
whole-leaf replay regenerate the same direction.  Under a mesh a rank
holds a slab of a leaf and draws the slab's part of the global field:
a :class:`Window` places one layer's slab (its global rows and its first
row and column), :func:`leaf_segments` a whole slab, one K1 segment per
layer where the rows are split.  Seeds are Python ints
(or int32 numpy arrays for seed vectors): they derive on the host and
reach the kernels as launch arguments.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any

import numpy as np
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rg_lru as RG
from repro_torch.kernels import zo_matmul as ZM

zo_noise = ZM.zo_noise
zo_noise_rows = ZM.zo_noise_rows
zo_dual_matmul = ZM.zo_dual_matmul
zo_dual_flash_attention = FA.zo_dual_flash_attention
zo_matmul = ZM.zo_matmul
flash_attention = FA.flash_attention
# the Pallas wrapper's bt / bw are TPU tiles; K6 takes none
rg_lru_scan = RG.rg_lru_scan

_M32 = 0xFFFFFFFF


def zo_dual_forward(x, w, seed, mu):
    """(clean, perturbed) pair of the two-point estimator from ONE fused
    pass (kernel K2: one read of W serves both)."""
    return zo_dual_matmul(x, x, w, seed, 0.0, mu, perturb_a=False,
                          perturb_b=True)


def zo_dual_forward_split(x, w, seed, mu):
    """The unfused baseline of :func:`zo_dual_forward`: two independent
    passes over W (two K4 launches, clean then perturbed)."""
    clean = zo_matmul(x, w, seed, 0.0, perturb=False)
    pert = zo_matmul(x, w, seed, mu, perturb=True)
    return clean, pert


def _int32(v: int) -> int:
    v &= _M32
    return v - (1 << 32) if v >= 1 << 31 else v


# ===========================================================================
# per-layer seed derivation + tree-level noise utilities
# ===========================================================================

def path_hash(path: str) -> int:
    """Stable 31-bit FNV-1a hash of a '/'-joined tree path."""
    h = 2166136261
    for ch in path.encode():
        h = ((h ^ ch) * 16777619) & _M32
    return h & 0x7FFFFFFF


def fold_seed(seed, i):
    """Derive a child int32 seed, elementwise over numpy arrays (one call
    folds a whole client-seed vector by a step index).  Scalars in give a
    Python int out."""
    s = np.asarray(seed, np.int64)
    ii = np.asarray(i, np.int64)
    shape = np.broadcast_shapes(s.shape, ii.shape)
    s = (np.broadcast_to(s, shape) & _M32).astype(np.uint32).reshape(-1)
    ii = (np.broadcast_to(ii, shape) & _M32).astype(np.uint32).reshape(-1)
    x = (s ^ (ii * np.uint32(0x9E3779B9))) + np.uint32(0x7F4A7C15)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x2C1B3C6D)
    x = x ^ (x >> np.uint32(12))
    out = x.view(np.int32).reshape(shape)
    return int(out) if out.ndim == 0 else out


def leaf_seed_tree(tree, base_seed, pred=None):
    """Per-leaf seeds ``base_seed + path_hash(path)`` (int32 wrapping
    add) mirroring ``tree``.  ``None`` leaves and leaves rejected by
    ``pred(path)`` map to ``None``: layers skip perturbation for them."""
    base = int(base_seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{path}/{i}" if path else str(i))
                              for i, v in enumerate(node))
        if node is None:
            return None
        if pred is not None and not pred(path):
            return None
        return _int32(base + path_hash(path))

    return walk(tree, "")


# score-probe seed scheme: the per-layer score field's seed is the
# layer's wq leaf seed folded with a fixed salt
ATTN_SCORE_SALT = path_hash("attn/scores")


def attn_score_seed(seeds):
    """``fold_seed(seed(wq/w), ATTN_SCORE_SALT)``; None when wq is not
    ZO-seeded (frozen / LoRA-only layers skip the score probe)."""
    if not isinstance(seeds, dict):
        return None
    sw = seeds.get("wq")
    sw = sw.get("w") if isinstance(sw, dict) else None
    if sw is None:
        return None
    return fold_seed(sw, ATTN_SCORE_SALT)


def attn_score_field(seed, n_heads, seq_q, seq_kv, row_offset=0, *,
                     device):
    """Materialized (H, Sq, Skv) score-noise field: head h, query row i,
    kv column j reads ``U[row_offset + h*Sq + i, j]``."""
    u = zo_noise(seed, (n_heads * seq_q, seq_kv), row_offset, device=device)
    return u.reshape(n_heads, seq_q, seq_kv)


def attn_kv_seed_pred(path: str) -> bool:
    """Seed predicate for ``attn_probe="scores"``: the attention k/v
    projections are not weight-perturbed (both streams attend the clean
    k/v; the probe moves to the score field), so their leaves leave both
    the client's seeds and the server's replay."""
    return "attn/wk/" not in path and "attn/wv/" not in path


def any_seed(seeds) -> bool:
    if seeds is None:
        return False
    if isinstance(seeds, dict):
        return any(any_seed(v) for v in seeds.values())
    if isinstance(seeds, (list, tuple)):
        return any(any_seed(v) for v in seeds)
    return True


@dataclasses.dataclass(frozen=True)
class Window:
    """Where a slab of one layer of a leaf sits in the leaf's noise field:
    the layer's global ``rows`` (of the canonical 2-D view) and the slab's
    first global row ``row0`` and column ``col0``."""
    rows: int
    row0: int = 0
    col0: int = 0


def leaf_segment(seed, shape, rep=0, win: Window | None = None) -> \
        ZM.Segment:
    """K1's segment for one (possibly rep-sliced) leaf: U(seed) on its
    canonical 2-D view (prod(shape[:-1]), shape[-1]), ``rep`` offsetting
    the rows for a slice of a stacked leaf; ``win`` places a slab of it
    (by default the leaf is whole)."""
    shape = tuple(int(s) for s in shape) or (1,)
    rows = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    if win is None:
        win = Window(rows)
    return ZM.Segment(rows, shape[-1], seed, int(rep) * win.rows + win.row0,
                      win.col0)


def leaf_segments(seed, place):
    """The K1 segments of this rank's slab of a leaf (``place`` a
    :class:`repro_torch.distributed.sharding.Placement`, global shape and
    bounds), as ``[(segment, start, size)]`` over the slab's flat
    layout: one segment per index of the dims before the last split
    leading dim (a row slab of a stacked leaf: one per layer), the last
    dim's slab as the column offset."""
    shape, bounds = tuple(place.shape) or (1,), tuple(place.bounds) or ((0, 1),)
    (c0, c1) = bounds[-1]
    lead, lb = shape[:-1], bounds[:-1]
    split = [d for d in range(len(lead)) if lb[d] != (0, lead[d])]
    j = split[-1] if split else 0
    inner = int(np.prod(lead[j + 1:])) if lead else 1
    rows = (lb[j][1] - lb[j][0]) * inner if lead else 1
    out, start = [], 0
    for idx in itertools.product(*(range(a, b) for a, b in lb[:j])):
        flat = 0
        for d, i in enumerate(idx):
            flat = flat * lead[d] + i
        r0 = (flat * lead[j] + lb[j][0]) * inner if lead else 0
        out.append((ZM.Segment(rows, c1 - c0, seed, r0, c0), start,
                    rows * (c1 - c0)))
        start += rows * (c1 - c0)
    return out


def _paired_leaves(params, seeds, path=(), out=None):
    """``[(path, leaf, seed)]`` over the non-None leaves of ``params``
    with the matching node of ``seeds`` (None where a subtree has no
    seeds), in traversal order.  (A plain recursion: a nested recursive
    closure would hold the leaves in a reference cycle until the garbage
    collector runs.)"""
    out = [] if out is None else out
    if isinstance(params, dict):
        for k, v in params.items():
            _paired_leaves(v, None if seeds is None else seeds[k],
                           path + (k,), out)
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            _paired_leaves(v, None if seeds is None else seeds[i],
                           path + (i,), out)
    elif params is not None:
        out.append((path, params, seeds))
    return out


def _rebuild(tree, values, path=()):
    """``tree`` with the leaves at the paths of ``values`` replaced."""
    if path in values:
        return values[path]
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, path + (i,))
                          for i, v in enumerate(tree))
    return tree


def _tree_segments(leaves, places, rep=0, win: Window | None = None):
    """``(segments, outs)`` of K1 over ``[(path, tensor, seed)]``: a
    tensor's whole view as one segment (``rep`` and ``win`` as
    :func:`leaf_segment`'s), or with ``places`` (a dict path ->
    Placement of one layer's leaf) its slab's segments over flat views of
    it, ``rep`` layers down."""
    segs, outs = [], []
    for path, t, s in leaves:
        pl = None if places is None else places.get(path)
        if pl is None or not pl.sharded:
            segs.append(leaf_segment(s, t.shape, rep, win))
            outs.append(t)
            continue
        layer_rows = int(np.prod(pl.shape[:-1])) if len(pl.shape) > 1 else 1
        flat = t.view(-1)
        for seg, start, n in leaf_segments(s, pl):
            segs.append(dataclasses.replace(
                seg, row_offset=seg.row_offset + int(rep) * layer_rows))
            outs.append(flat[start:start + n])
    return segs, outs


def _place_paths(places):
    """A tree of placements as a dict keyed like :func:`_paired_leaves`'
    paths (None: no placements)."""
    if places is None:
        return None
    return {path: pl for path, pl, _ in _paired_leaves(places, None)}


def kernel_direction_tree(params, seeds, places=None):
    """Materialized f32 direction U for a whole tree, one K1 launch for
    its seeded leaves (None seed -> zeros): the replay-side oracle of the
    in-kernel stream.  ``places`` (a matching tree of placements) draws
    each slab leaf's part of the global field."""
    leaves = _paired_leaves(params, seeds)
    out, seeded = {}, []
    for path, p, s in leaves:
        u = (torch.zeros if s is None else torch.empty)(
            p.shape, dtype=torch.float32, device=p.device)
        out[path] = u
        if s is not None:
            seeded.append((path, u, s))
    ZM.zo_noise_tree("field", *_tree_segments(seeded, _place_paths(places)))
    return _rebuild(params, out)


def accumulate_direction_tree(acc, seeds, scale, places=None):
    """``acc + scale * U(seeds)`` into the f32 tree ``acc`` in place, one
    K1 launch for the whole tree: the direction accumulation of the ZO
    gradient and of the seed replay.  A leaf whose seed is None adds
    ``scale * 0``, as a zero direction does.  ``scale`` is a 0-d tensor
    (or a number) that the kernel reads on the device.  ``places`` (a
    matching tree of placements) adds each slab leaf's part of the
    global field."""
    leaves = _paired_leaves(acc, seeds)
    if not leaves:
        return acc
    dev = leaves[0][1].device
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    ZM.zo_noise_tree("accumulate",
                     *_tree_segments(leaves, _place_paths(places)),
                     scale=scale)
    return acc


def perturb_tree(params, seeds, mu, rep=0, win: Window | None = None,
                 places=None):
    """``theta + mu*U(seeds)`` leaf by leaf in the leaf's dtype, one K1
    launch for the seeded leaves; leaves without a seed are returned as
    they are.  ``win`` places a slab (for a tree of one leaf); ``places``
    (a tree of placements matching ``params``, one layer's leaves: a
    block's under a mesh) draws each slab leaf's part of the global
    field, ``rep`` layers down."""
    if seeds is None:
        return params
    leaves = [(path, p, s) for path, p, s in _paired_leaves(params, seeds)
              if s is not None]
    out = {path: torch.empty_like(p, memory_format=torch.contiguous_format)
           for path, p, _ in leaves}
    places = _place_paths(places)
    segs, outs = _tree_segments([(path, out[path], s)
                                 for path, _, s in leaves], places, rep, win)
    _, ins = _tree_segments([(path, p.contiguous(), s)
                             for path, p, s in leaves], places, rep, win)
    ZM.zo_noise_tree("perturb", segs, outs, ins=ins, mu=mu)
    return _rebuild(params, out)


@dataclasses.dataclass(frozen=True)
class Perturb:
    """Perturbation context threaded through the client forward.

    ``seeds`` mirrors the layer's param subtree (ints / None); ``rep`` is
    the scan-segment repeat index (row offset into stacked leaves).
    ``dual=True`` means the activations carry [clean; perturbed] halves
    stacked along the leading batch axis and one fused pass (kernels K2,
    K3) serves both; ``dual=False`` is the single-probe forward of
    ``theta + mu*U`` alone (kernels K4, K5).
    """
    seeds: Any
    mu: float
    rep: int = 0
    dual: bool = False


def psub(perturb: Perturb | None, key):
    """Narrow a Perturb to a child subtree; None when nothing under
    ``key`` is seeded."""
    if perturb is None or perturb.seeds is None:
        return None
    s = perturb.seeds
    sub = s.get(key) if isinstance(s, dict) else s[key]
    if not any_seed(sub):
        return None
    return dataclasses.replace(perturb, seeds=sub)
