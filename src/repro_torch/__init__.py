"""PyTorch + CUDA port of the HERON-SFL system in :mod:`repro`.

The package mirrors ``repro``'s layout module for module.  It imports
``torch`` and numpy only: never ``jax`` and nothing of ``repro``.  Every
Pallas kernel on the ported path has a hand-written CUDA C++ kernel for
Hopper (``kernels/csrc``) and a plain PyTorch version beside it; a
wrapper launches the kernel for CUDA tensors and takes the plain version
only for CPU tensors.

Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise unless the caller passes ``device="cpu"`` (see
:mod:`repro_torch.device`).
"""
