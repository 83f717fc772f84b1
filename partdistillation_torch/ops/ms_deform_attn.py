"""Multi-scale deformable attention sampling core.

Counterpart of the JAX package's ``ops/ms_deform_attn.py``: for every
(query, head, level, point) the per-head value map is sampled bilinearly at a
fractional location (align_corners=False, so pixel = loc * size - 0.5;
corners outside the map read zero) and summed with its attention weight.

The JAX package offers several formulations of this one function (its
``mode``: ``take``, ``onehot_mxu``, ``pallas_folded``), chosen for the TPU's
sake. The port has one: the P-folded sampling of ``ops/msda_sampling.py``,
its plain version for CPU tensors and its kernel (``csrc/msda_folded.cu``,
one launch per call) for CUDA tensors. The JAX package's ``banded`` mode,
exact only while every tap stays within a band of rows around its query, is
not ported (ROADMAP).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .msda_sampling import msda_folded

__all__ = ["ms_deform_attn"]


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """value (B, S, M, D) with S = sum of H_l * W_l; sampling_locations
    (B, Lq, M, L, P, 2) in [0, 1], last axis (x, y); attention_weights
    (B, Lq, M, L, P). Returns (B, Lq, M * D) in value's dtype."""
    return msda_folded(value, spatial_shapes, sampling_locations, attention_weights)
