"""Round batching and device placement, as :mod:`repro.data.pipeline`.

A federated round batch carries leading (N, h) axes, client ``i``'s
step ``m`` drawn under ``fold_in(fold_in(key, i), m)``.  Placement is
onto one device; the reference's mesh placement (a batch sharded over
the data axes) comes with the mesh, ROADMAP queue 1 item 7.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng as R
from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


def place_batch(batch, device="cuda"):
    """Every leaf of ``batch`` on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda x: x.to(dev), batch)


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
