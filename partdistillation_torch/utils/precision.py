"""Full f32 precision for the port's f32 stages.

On the card, cuBLAS and cuDNN may run an f32 product or convolution in TF32
(10 mantissa bits) when ``torch.backends.cuda.matmul.allow_tf32`` or
``torch.backends.cudnn.allow_tf32`` is set; the second is set by default.
TF32 moves the k-means centroids, the stage-2 / stage-4 labels, the dCRF's
messages and the CLIP crops away from the reference's f32 results. The f32
stages compute inside ``full_f32``: both flags off while it is active, the
caller's values back on exit.

``TORCH_ALLOW_TF32_CUBLAS_OVERRIDE`` forces TF32 in cuBLAS whatever the
flags say, so on a CUDA device ``full_f32`` refuses to run under it.
bf16 products are untouched by the flags and run outside the context.
"""

from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["full_f32", "TF32_OVERRIDE"]

TF32_OVERRIDE = "TORCH_ALLOW_TF32_CUBLAS_OVERRIDE"
_TRUE = ("1", "ON", "YES", "TRUE", "Y")


@contextlib.contextmanager
def full_f32(device):
    """Both TF32 flags off for the body; the caller's values restored after.
    ``device`` (a device or its name) is where the body computes: on a CUDA
    device the context raises while ``TORCH_ALLOW_TF32_CUBLAS_OVERRIDE`` is
    set, since no flag can then keep cuBLAS in f32."""
    override = os.environ.get(TF32_OVERRIDE, "").strip().upper() in _TRUE
    if override and torch.device(device).type == "cuda":
        raise RuntimeError(f"{TF32_OVERRIDE} is set: cuBLAS would run the f32 products of "
                           "this stage in TF32 whatever the flags say; unset it")
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
