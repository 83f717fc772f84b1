"""COCO-compatible run-length-encoding (RLE) mask codec.

The port's own copy of the JAX package's ``utils/rle.py``. Its ``counts``
bytes equal those of that package (and of pycocotools):

  * column-major (Fortran) run lengths, first run counts zeros
  * compressed "counts" string: per-count delta (vs. count[i-2]) encoded in
    5-bit groups, offset by 48 into printable ASCII

``encode``, ``decode``, ``area`` and ``iou_matrix`` run the host library's
C++ codec (``csrc_host/rle_codec.cc``, built with ``g++`` at first use by
``utils/native_lib.load_host_library``; a failed build raises). The numpy
codec stays beside it as its plain version (``encode_plain``,
``decode_plain``, ``area_plain``, ``iou_matrix_plain``), which the tests
hold it to byte for byte. Counts given as a raw list of runs, not a
compressed string, are read by numpy.
"""

from __future__ import annotations

import ctypes

import numpy as np

__all__ = [
    "encode",
    "decode",
    "area",
    "iou_matrix",
    "merge",
    "encode_batch",
    "decode_batch",
    "encode_plain",
    "decode_plain",
    "area_plain",
    "iou_matrix_plain",
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


def _lib():
    from .native_lib import load_host_library

    return load_host_library()


def _raw(counts) -> bytes:
    return counts.encode("ascii") if isinstance(counts, str) else counts


def _check_mask(mask) -> np.ndarray:
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"expected HxW mask, got shape {mask.shape}")
    return mask


def encode(mask: np.ndarray) -> dict:
    """Encode a binary HxW mask into a COCO compressed RLE dict (C++)."""
    mask = np.ascontiguousarray(_check_mask(mask), dtype=np.uint8)
    h, w = mask.shape
    cap = 16 + 3 * (h * w // 2 + 2)  # above the at most ~1 byte a pixel any mask takes
    buf = ctypes.create_string_buffer(cap)
    n = _lib().pd_rle_encode(mask.ctypes.data, h, w, buf, cap)
    if n < 0:
        raise RuntimeError(f"RLE counts of a {h}x{w} mask need {-n} bytes, over {cap}")
    return {"size": [int(h), int(w)], "counts": buf.raw[:n]}


def decode(rle: dict) -> np.ndarray:
    """Decode a COCO RLE dict (compressed bytes/str: C++; raw count list)."""
    h, w = int(rle["size"][0]), int(rle["size"][1])
    counts = rle["counts"]
    if not isinstance(counts, (bytes, str)):
        return _runs_to_mask(np.asarray(counts, dtype=np.int64), h, w)
    raw = _raw(counts)
    out = np.empty((h, w), dtype=np.uint8)
    rc = _lib().pd_rle_decode(raw, len(raw), h, w, out.ctypes.data)
    if rc == -2:
        raise ValueError(f"RLE runs do not sum to {h * w}")
    if rc != 0:
        raise ValueError(f"invalid RLE counts (rc={rc})")
    return out


def area(rle: dict) -> int:
    counts = rle["counts"]
    if not isinstance(counts, (bytes, str)):
        return int(np.sum(np.asarray(counts)[1::2]))
    raw = _raw(counts)
    a = _lib().pd_rle_area(raw, len(raw))
    if a < 0:
        raise ValueError("invalid RLE counts")
    return int(a)


def encode_plain(mask: np.ndarray) -> dict:
    """``encode`` in numpy."""
    mask = _check_mask(mask)
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": _compress_counts(_mask_to_runs(mask))}


def decode_plain(rle: dict) -> np.ndarray:
    """``decode`` in numpy."""
    h, w = int(rle["size"][0]), int(rle["size"][1])
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        runs = _decompress_counts(counts)
    else:
        runs = np.asarray(counts, dtype=np.int64)
    return _runs_to_mask(runs, h, w)


def area_plain(rle: dict) -> int:
    """``area`` in numpy."""
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
    """Pairwise mask IoU between two RLE lists -> (len(dets), len(gts)) f64,
    on the run lengths in C++ when every counts is a compressed string.

    Matches the semantics of pycocotools.mask.iou with iscrowd=0.
    """
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)), dtype=np.float64)
    if not all(isinstance(r["counts"], (bytes, str)) for r in dets + gts):
        return iou_matrix_plain(dets, gts)
    a, b = [_raw(r["counts"]) for r in dets], [_raw(r["counts"]) for r in gts]
    offa = np.zeros(len(a) + 1, np.int64)
    np.cumsum([len(c) for c in a], out=offa[1:])
    offb = np.zeros(len(b) + 1, np.int64)
    np.cumsum([len(c) for c in b], out=offb[1:])
    out = np.zeros((len(a), len(b)), np.float64)
    _lib().pd_rle_iou_matrix(b"".join(a), offa.ctypes.data, len(a), b"".join(b),
                             offb.ctypes.data, len(b), out.ctypes.data)
    return out


def iou_matrix_plain(dets: list[dict], gts: list[dict]) -> np.ndarray:
    """``iou_matrix`` in numpy (decoded masks)."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)), dtype=np.float64)
    d = np.stack([decode_plain(r).astype(bool).ravel() for r in dets])  # (D, HW)
    g = np.stack([decode_plain(r).astype(bool).ravel() for r in gts])  # (G, HW)
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
