"""Bit-packed boolean-mask wire format.

The port's own copy of the JAX package's ``utils/bitpack.py``: the host
packs the masks with numpy's ``packbits`` (8x fewer bytes to the device),
the device unpacks them in torch; masks made on the device (the stage-2 and
stage-4 stores) are packed there, so that only bits cross to the host. The
layout is ``np.packbits`` /
``np.unpackbits``'s: the most significant bit first within a byte, the last
axis padded up to a byte boundary.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["packed_width", "pack_bits_np", "unpack_bits_np", "pack_bits", "unpack_bits"]


def packed_width(w: int) -> int:
    return (w + 7) // 8


def pack_bits_np(x: np.ndarray) -> np.ndarray:
    """(..., W) bool -> (..., ceil(W/8)) uint8 (host side)."""
    return np.packbits(np.asarray(x, bool), axis=-1)


def unpack_bits_np(packed: np.ndarray, w: int) -> np.ndarray:
    """(..., ceil(W/8)) uint8 -> (..., W) bool (host side)."""
    return np.unpackbits(np.asarray(packed), axis=-1)[..., :w].astype(bool)


def unpack_bits(packed: torch.Tensor, w: int) -> torch.Tensor:
    """(..., ceil(W/8)) uint8 -> (..., W) bool, on the tensor's device."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))[..., :w].bool()


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """(..., W) bool -> (..., ceil(W/8)) uint8, on the tensor's device."""
    w = x.shape[-1]
    pad = packed_width(w) * 8 - w
    bits = torch.nn.functional.pad(x.to(torch.uint8), (0, pad))
    bits = bits.reshape(x.shape[:-1] + (packed_width(w), 8))
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=x.device)
    return (bits * weights).sum(-1, dtype=torch.uint8)
