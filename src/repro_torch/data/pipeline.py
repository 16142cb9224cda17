"""Round batching and device placement, as :mod:`repro.data.pipeline`.

A federated round batch carries leading (N, h) axes, client ``i``'s
step ``m`` drawn under ``fold_in(fold_in(key, i), m)``.  Placement is
onto one device and, under the datacenter step's mesh, onto this rank's
slab of the batch axis, as the reference's ``place_batch(batch, rules)``
shards it over the data axes.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng as R
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path


def place_batch(batch, device="cuda", rules=None):
    """Every leaf of ``batch`` on ``device``; under ``rules``' mesh, this
    rank's slab of it on the ``"batch"`` logical axis (the reference's
    ``spec_for``: sharded over the data axes where they divide it, else
    replicated).  The batch axis is a leaf's first, but the second-last
    of ``positions`` ((B, S) ids, or qwen2-vl's (3, B, S) M-RoPE ids,
    which the reference's first-axis rule would leave whole beside a
    sharded batch).  Under a mesh the placed batch also holds
    ``"batch_split"``, a bool: whether its rows are this rank's slab (a
    model's activations cannot tell a slab from a whole batch that did
    not divide; ``protocols.lm_api`` hands it to the rules)."""
    dev = resolve_device(device)
    if rules is None or rules.mesh is None:
        return tree_map(lambda x: x.to(dev), batch)

    def place(path, x):
        axis = x.dim() - 2 if path == "positions" else 0
        logical = tuple("batch" if d == axis else None
                        for d in range(x.dim()))
        return rules.sharding_for(x.shape, logical)

    places = tree_map_with_path(place, batch)
    out = tree_map(lambda x, pl: SH.shard(x, pl).to(dev), batch, places)
    out["batch_split"] = any(pl.sharded for pl in tree_leaves(places))
    return out


def round_batches(dataset, key, n_clients: int, h: int, batch_size: int,
                  client_probs=None):
    """A federated round batch with leading (N, h) axes (on the host)."""
    def one(i, m):
        k = R.fold_in(R.fold_in(key, i), m)
        if client_probs is not None:
            return dataset.batch(k, batch_size, client_probs[i])
        return dataset.batch(k, batch_size)

    per_client = [tree_map(lambda *xs: torch.stack(xs),
                           *[one(i, m) for m in range(h)])
                  for i in range(n_clients)]
    return tree_map(lambda *xs: torch.stack(xs), *per_client)
