"""COCO-compatible run-length-encoding (RLE) mask codec, pure numpy.

The port's own copy of the JAX package's ``utils/rle.py`` numpy codec. Its
``counts`` bytes equal those of that package (and of pycocotools):

  * column-major (Fortran) run lengths, first run counts zeros
  * compressed "counts" string: per-count delta (vs. count[i-2]) encoded in
    5-bit groups, offset by 48 into printable ASCII

The JAX package prefers a C++ codec (``native/rle_codec.cc``) where it is
built; the port does not build or load it (ROADMAP).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "encode",
    "decode",
    "area",
    "iou_matrix",
    "merge",
    "encode_batch",
    "decode_batch",
]


def _mask_to_runs(mask: np.ndarray) -> np.ndarray:
    """Fortran-order run lengths, starting with the zero run (possibly 0)."""
    flat = np.asarray(mask, dtype=np.uint8).flatten(order="F")
    n = flat.size
    if n == 0:
        return np.zeros((0,), dtype=np.int64)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    boundaries = np.concatenate(([0], change, [n]))
    runs = np.diff(boundaries)
    if flat[0] == 1:  # spec: first run is always the count of zeros
        runs = np.concatenate(([0], runs))
    return runs.astype(np.int64)


def _runs_to_mask(runs: np.ndarray, h: int, w: int) -> np.ndarray:
    total = int(np.sum(runs))
    if total != h * w:
        raise ValueError(f"RLE runs sum to {total}, expected {h * w}")
    vals = np.zeros(len(runs), dtype=np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, runs)
    return flat.reshape((h, w), order="F")


def _compress_counts(runs: np.ndarray) -> bytes:
    out = bytearray()
    runs = [int(r) for r in runs]
    for i, cnt in enumerate(runs):
        x = cnt if i < 2 else cnt - runs[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def _decompress_counts(s: bytes) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode("ascii")
    runs: list[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)  # sign extension
        if len(runs) >= 2:
            x += runs[-2]
        runs.append(x)
    return np.asarray(runs, dtype=np.int64)


def encode(mask: np.ndarray) -> dict:
    """Encode a binary HxW mask into a COCO compressed RLE dict."""
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"expected HxW mask, got shape {mask.shape}")
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": _compress_counts(_mask_to_runs(mask))}


def decode(rle: dict) -> np.ndarray:
    """Decode a COCO RLE dict (compressed bytes/str or raw count list)."""
    h, w = int(rle["size"][0]), int(rle["size"][1])
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        runs = _decompress_counts(counts)
    else:
        runs = np.asarray(counts, dtype=np.int64)
    return _runs_to_mask(runs, h, w)


def area(rle: dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        runs = _decompress_counts(counts)
    else:
        runs = np.asarray(counts)
    return int(np.sum(runs[1::2]))


def merge(rles: list[dict], intersect: bool = False) -> dict:
    """Union (or intersection) of several same-size RLE masks."""
    if not rles:
        raise ValueError("merge of empty list")
    acc = decode(rles[0]).astype(bool)
    for r in rles[1:]:
        m = decode(r).astype(bool)
        acc = acc & m if intersect else acc | m
    return encode(acc.astype(np.uint8))


def iou_matrix(dets: list[dict], gts: list[dict]) -> np.ndarray:
    """Pairwise mask IoU between two RLE lists -> (len(dets), len(gts)) f64.

    Matches the semantics of pycocotools.mask.iou with iscrowd=0.
    """
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)), dtype=np.float64)
    d = np.stack([decode(r).astype(bool).ravel() for r in dets])  # (D, HW)
    g = np.stack([decode(r).astype(bool).ravel() for r in gts])  # (G, HW)
    inter = (d.astype(np.int64) @ g.T.astype(np.int64)).astype(np.float64)
    da = d.sum(-1, keepdims=True).astype(np.float64)
    ga = g.sum(-1, keepdims=True).astype(np.float64).T
    union = da + ga - inter
    return np.where(union > 0, inter / np.maximum(union, 1.0), 0.0)


def encode_batch(masks: np.ndarray) -> list[dict]:
    """Encode an (N, H, W) stack of binary masks."""
    return [encode(m) for m in np.asarray(masks)]


def decode_batch(rles: list[dict]) -> np.ndarray:
    if not rles:
        return np.zeros((0, 0, 0), dtype=np.uint8)
    return np.stack([decode(r) for r in rles])
