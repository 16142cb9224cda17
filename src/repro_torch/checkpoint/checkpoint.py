"""Fault-tolerant checkpointing in the on-disk format of
:mod:`repro.checkpoint.checkpoint`, so either package restores what the
other wrote.

* ``<dir>/step_XXXXXXXX/payload.npz`` holds leaf ``i`` as ``p{i}``, in
  JAX's flatten order (dict keys sorted, lists and tuples in order,
  ``None`` an empty subtree); bf16 leaves are stored as f32 (lossless)
  and cast back on restore.
* ``manifest.json`` holds the step, the leaf count and each leaf's dtype
  name (numpy's: ``float32``, ``bfloat16``, ``int32``, ``uint32``...).
* A save writes a temporary directory and publishes it with
  ``os.rename`` (atomic); the newest ``keep`` steps are kept.

Leaves are tensors or Python ints.  A Python int (an optimizer's or the
train state's step count) is stored as an int32 scalar, the reference's
``jnp.int32`` step, and restored as an int.  A tensor restores onto its
template leaf's device.

Under the datacenter step's mesh (``shardings``, the state's placements:
:func:`repro_torch.core.protocols.train_state_shardings`) every rank
takes part in gathering the slabs and rank 0 alone writes, so the files
are an unsharded run's; a restore reads the full leaves and keeps this
rank's slabs, on a mesh of any width or on one device (the elasticity
:func:`repro_torch.distributed.fault.remesh` is for).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as SH
from repro_torch.tree import tree_leaves_with_path, tree_map_with_path


def _leaves(tree):
    return [leaf for _, leaf in tree_leaves_with_path(tree, sort_keys=True)]


def _to_numpy(leaf):
    """``(array to store, dtype name)``."""
    if not isinstance(leaf, torch.Tensor):       # a Python int
        return np.asarray(leaf, np.int32), "int32"
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.to(torch.float32).numpy(), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def save(ckpt_dir: str, step: int, tree, keep: int = 3,
         shardings=None) -> str:
    """Write ``tree`` as step ``step`` and keep the newest ``keep``;
    with ``shardings`` (every rank calls it) the gathered tree, written
    by rank 0 while the others wait."""
    final = os.path.join(ckpt_dir, f"step_{int(step):08d}")
    if shardings is not None:
        tree = SH.gather_tree(tree, shardings)
        if dist.is_initialized():
            if dist.get_rank() == 0:
                _write(ckpt_dir, step, tree, keep)
            dist.barrier()
            return final
    _write(ckpt_dir, step, tree, keep)
    return final


def _write(ckpt_dir: str, step: int, tree, keep: int):
    os.makedirs(ckpt_dir, exist_ok=True)
    payload, dtypes = {}, []
    for i, leaf in enumerate(_leaves(tree)):
        arr, dt = _to_numpy(leaf)
        payload[f"p{i}"] = arr
        dtypes.append(dt)
    tmp = tempfile.mkdtemp(dir=ckpt_dir)
    np.savez(os.path.join(tmp, "payload.npz"), **payload)
    manifest = {"step": int(step), "n_leaves": len(dtypes),
                "dtypes": dtypes}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    final = os.path.join(ckpt_dir, f"step_{int(step):08d}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    _gc(ckpt_dir, keep)


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str):
    """The published steps, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, d, "manifest.json")):
            out.append(int(d[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str):
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def _from_numpy(arr, dt: str, tmpl):
    """A stored leaf in its saved dtype (bf16 comes back from f32) on
    the template leaf's device; an int where the template has one."""
    if not isinstance(tmpl, torch.Tensor):
        return int(arr)
    t = torch.from_numpy(np.array(arr))      # a writable copy, 0-d kept
    if dt == "bfloat16":
        t = t.to(torch.bfloat16)
    return t.to(tmpl.device)


def restore(ckpt_dir: str, template, step: int | None = None,
            shardings=None):
    """Restore into the structure of ``template`` (leaf count and shapes
    checked; with ``shardings`` the template's leaves are this rank's
    slabs, cut from the stored full leaves).  Returns ``(tree, step)``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{int(step):08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "payload.npz"))
    paths = tree_leaves_with_path(template, sort_keys=True)
    assert manifest["n_leaves"] == len(paths), "structure mismatch"
    places = dict(tree_leaves_with_path(shardings)) if shardings else {}
    values = {}
    for i, ((p, tmpl), dt) in enumerate(zip(paths, manifest["dtypes"])):
        arr = data[f"p{i}"]
        pl = places.get(p)
        want = (tuple(pl.shape) if pl is not None else tuple(tmpl.shape)
                if isinstance(tmpl, torch.Tensor) else ())
        assert arr.shape == want, f"leaf {i} ({p}): {arr.shape} vs {want}"
        values[p] = _from_numpy(SH.shard(arr, pl), dt, tmpl)
    return tree_map_with_path(lambda p, _: values[p], template), step
