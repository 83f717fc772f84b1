"""Shared inputs of the deformable-sampling tests (``test_torch_slice6_ops.py``
on the CPU, ``test_torch_slice6_kernels_cuda.py`` on the card): level sets
and the placement of pixel coordinates on, across and off a map."""

import numpy as np

ENCODER = ((20, 20), (40, 40), (80, 80))
THREE = ((6, 5), (3, 3), (1, 1))
EIGHT = ((4, 6), (3, 3), (2, 5), (1, 1), (7, 2), (2, 2), (5, 5), (1, 3))


def edge_pixels(rng: np.random.Generator, shape, size, placement: str) -> np.ndarray:
    """f32 pixel coordinates on a map of ``size`` (broadcast to ``shape``):
    "spread" from two pixels before to two beyond the map; "edge" with
    x0 = -1 or x0 = size - 1 (one corner column on the map), wholly outside
    (x0 = -3 or size + 1) or inside, in equal shares; "off" two to five
    pixels beyond either edge."""
    u = rng.uniform(0.0, 1.0, size=shape)
    if placement == "spread":
        out = u * (size + 4.0) - 2.0
    elif placement == "off":
        out = np.where(u < 0.5, -2.0 - 3.0 * u, size + 1.0 + 3.0 * u)
    else:
        frac = rng.uniform(0.1, 0.9, size=shape)
        kind = rng.integers(0, 5, size=shape)
        base = np.select([kind == 0, kind == 1, kind == 2, kind == 3],
                         [np.full(shape, -1.0), size - 1.0, np.full(shape, -3.0), size + 1.0],
                         np.floor(u * size))
        out = base + frac
    return np.broadcast_to(out, shape).astype(np.float32)
