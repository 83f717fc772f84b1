"""Bit-packed boolean-mask wire format of the train batches.

The port's own copy of the JAX package's ``utils/bitpack.py``: the host
packs the masks with numpy's ``packbits`` (8x fewer bytes to the device),
the device unpacks them in torch. The layout is ``np.packbits`` /
``np.unpackbits``'s: the most significant bit first within a byte, the last
axis padded up to a byte boundary.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["packed_width", "pack_bits_np", "unpack_bits_np", "unpack_bits"]


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
