"""The host library's C++ operators, bound with ctypes.

Counterpart of the JAX package's ``ops/native.py``: the C++ CPU forward of
multi-scale deformable attention (``csrc_host/ms_deform_attn_cpu.cc``, an
implementation independent of ``ops/msda_sampling.py``'s, used to
cross-check it and for host-side inference), called with plain pointers
where the JAX package registers an XLA custom call. The library is built
with ``g++`` at the first call (``utils/native_lib.load_host_library``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["ms_deform_attn_cpu"]


def ms_deform_attn_cpu(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                       sampling_locations: torch.Tensor,
                       attention_weights: torch.Tensor) -> torch.Tensor:
    """``ops.ms_deform_attn.ms_deform_attn``'s dense function in C++ on CPU
    tensors: value (B, S, M, D), sampling_locations (B, Lq, M, L, P, 2) in
    [0, 1] as (x, y), attention_weights (B, Lq, M, L, P) -> (B, Lq, M * D)
    f32 (inputs taken in f32). A tensor on another device raises."""
    from ..utils.native_lib import load_host_library

    for t in (value, sampling_locations, attention_weights):
        if t.device.type != "cpu":
            raise ValueError(f"ms_deform_attn_cpu takes CPU tensors, got one on {t.device}")
    b, s, m, d = value.shape
    lq, n_levels, n_points = (sampling_locations.shape[1], sampling_locations.shape[3],
                              sampling_locations.shape[4])
    if tuple(sampling_locations.shape) != (b, lq, m, n_levels, n_points, 2) \
            or tuple(attention_weights.shape) != (b, lq, m, n_levels, n_points):
        raise ValueError(f"ms_deform_attn_cpu: value {tuple(value.shape)}, locations "
                         f"{tuple(sampling_locations.shape)}, weights "
                         f"{tuple(attention_weights.shape)} do not fit")
    shapes = np.ascontiguousarray(np.asarray(spatial_shapes, np.int32).reshape(-1, 2))
    if len(shapes) != n_levels:
        raise ValueError(f"{len(shapes)} spatial shapes for {n_levels} levels")
    val, loc, attw = (t.detach().float().contiguous()
                      for t in (value, sampling_locations, attention_weights))
    out = torch.empty((b, lq, m * d), dtype=torch.float32)
    rc = load_host_library().pd_ms_deform_attn_cpu(
        val.data_ptr(), shapes.ctypes.data, loc.data_ptr(), attw.data_ptr(),
        b, s, m, d, lq, n_levels, n_points, out.data_ptr())
    if rc != 0:
        raise ValueError(f"spatial shapes {shapes.tolist()} do not sum to S = {s}")
    return out
