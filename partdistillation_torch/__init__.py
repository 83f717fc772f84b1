"""PyTorch/CUDA port of the JAX PartDistillation package, for NVIDIA Hopper.

The package mirrors the JAX package's module paths. Plain tensor code is
PyTorch; each Pallas kernel on the ported path is a hand-written CUDA kernel
under ``csrc/``, built with nvcc at first use (``utils/native_lib.py``). Every
kernel wrapper takes its plain PyTorch version only for tensors on the CPU; a
CUDA tensor gets the kernel or an exception.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; under
``torchrun`` a bare ``cuda`` is the rank's own GPU, ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import os

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise, ``cuda:LOCAL_RANK`` for a bare ``cuda`` under ``torchrun``.
    Raises when CUDA is asked for and absent (no silent CPU run)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
