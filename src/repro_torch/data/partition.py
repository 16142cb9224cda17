"""Non-IID client partitioning (Dirichlet label skew, paper Fig. 3a), as
:mod:`repro.data.partition`: the same numpy draws, as f32 tensors."""
from __future__ import annotations

import numpy as np
import torch


def dirichlet_client_probs(n_clients: int, n_classes: int, alpha: float,
                           seed: int = 0) -> torch.Tensor:
    """(N, C) per-client class distributions; alpha -> inf is IID."""
    rng = np.random.default_rng(seed)
    if alpha <= 0 or not np.isfinite(alpha):
        return iid_client_probs(n_clients, n_classes)
    probs = rng.dirichlet([alpha] * n_classes, size=n_clients)
    return torch.from_numpy(probs.astype(np.float32))


def iid_client_probs(n_clients: int, n_classes: int) -> torch.Tensor:
    return torch.full((n_clients, n_classes), 1.0 / n_classes,
                      dtype=torch.float32)
