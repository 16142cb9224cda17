"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.

    The default is the card.  Asking for CUDA where there is none raises:
    there is no silent CPU fallback, so a run that was meant for the GPU
    cannot quietly time the CPU.  Pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions")
    return dev
