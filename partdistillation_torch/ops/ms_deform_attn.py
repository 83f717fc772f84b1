"""Multi-scale deformable attention sampling core.

Counterpart of the JAX package's ``ops/ms_deform_attn.py``: for every
(query, head, level, point) the per-head value map is sampled bilinearly at a
fractional location (align_corners=False, so pixel = loc * size - 0.5;
corners outside the map read zero) and summed with its attention weight.

Two functions, chosen by ``mode``:

- dense (``None``, and the JAX package's ``take``, ``onehot_mxu`` and
  ``pallas_folded``, formulations of one function chosen there for the TPU's
  sake): the P-folded sampling of ``ops/msda_sampling.py``, its plain version
  for CPU tensors and its kernel (``csrc/msda_folded.cu``, one launch per
  call) for CUDA tensors;
- ``banded``, for encoder self-attention (queries = pixels, level-major and
  row-major): the same sampling in which a bilinear corner outside its
  query tile's band of the sampling level reads zero. The bands come from
  the JAX package's static plans (``_band_geometry``: row bands per tile of
  query rows; with ``band_tile_x``, ``_band_geometry_2d``: row and column
  bands per 2-D tile), copied here with their float arithmetic as written so
  that every ``floor`` lands the same. Banded equals dense while every tap
  stays within ``band_radius`` level pixels of its reference point;
  ``msda_band_oob_fraction`` measures the attention mass that does not. On
  the card the band is a variant of the same kernel, reading a per-(query,
  level) table of row and column bounds (``msda_band_table``).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .msda_sampling import msda_folded

__all__ = ["ms_deform_attn", "msda_band_oob_fraction", "msda_band_table", "DENSE_MODES"]

# the JAX package's dense formulations, all one function here
DENSE_MODES = (None, "dense", "take", "onehot_mxu", "pallas_folded")


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor,
                   mode: Optional[str] = None,
                   band_radius: int = 6,
                   band_tile_queries: int = 512,
                   band_tile_x: Optional[int] = None) -> torch.Tensor:
    """value (B, S, M, D) with S = sum of H_l * W_l; sampling_locations
    (B, Lq, M, L, P, 2) in [0, 1], last axis (x, y); attention_weights
    (B, Lq, M, L, P). Returns (B, Lq, M * D) in value's dtype. ``mode``
    "banded" needs Lq == S; the band arguments are the JAX package's."""
    if mode in DENSE_MODES:
        return msda_folded(value, spatial_shapes, sampling_locations, attention_weights)
    if mode != "banded":
        raise ValueError(f"unknown ms_deform_attn mode {mode!r} "
                         f"(banded or one of {DENSE_MODES})")
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    lq, s = sampling_locations.shape[1], value.shape[1]
    if lq != s:
        raise ValueError(f"banded mode requires queries == pixels (Lq {lq} != S {s}); "
                         "use a dense mode for decoder-style queries")
    band = msda_band_table(shapes, band_radius, band_tile_queries, band_tile_x,
                           value.device)
    return msda_folded(value, shapes, sampling_locations, attention_weights, band=band)


@functools.lru_cache(maxsize=None)
def _band_geometry(spatial_shapes: Tuple[Tuple[int, int], ...], radius: int,
                   tile_queries: int = 512):
    """Static banding plan for encoder self-attention (queries == pixels):
    {(ql, lvl): None | (tq, band_rows, starts)}. Query rows of level ql are
    tiled in runs of tq (the largest divisor of H_ql with tq * W_ql <=
    tile_queries, at least one row); tile t's taps, within ``radius`` rows
    of their reference rows and +-1 for the corners, land in rows
    [starts[t], starts[t] + band_rows) of level lvl. None: the band would
    cover the whole level."""
    plan = {}
    for ql, (hq, wq) in enumerate(spatial_shapes):
        tq = 1
        for cand in range(1, hq + 1):
            if hq % cand == 0 and cand * wq <= max(tile_queries, wq):
                tq = cand
        for lvl, (h, w) in enumerate(spatial_shapes):
            scale = h / hq
            lo_off = 0.5 * scale - 0.5 - radius
            hi_off = (tq - 0.5) * scale - 0.5 + radius
            band_rows = int(np.floor(hi_off) + 1 - np.floor(lo_off)) + 1
            if band_rows >= h:
                plan[(ql, lvl)] = None
                continue
            starts = []
            for t in range(hq // tq):
                s = int(np.floor(t * tq * scale + lo_off))
                starts.append(max(0, min(s, h - band_rows)))
            plan[(ql, lvl)] = (tq, band_rows, tuple(starts))
    return plan


def _band_axis_plan(nq_ax: int, nv_ax: int, radius: int, tile: int):
    """One axis of the 2-D plan: (t, band, starts) with t the largest divisor
    of nq_ax that is <= tile; (nq_ax, nv_ax, (0,)) when the window would
    cover the whole axis."""
    t = 1
    for cand in range(1, nq_ax + 1):
        if nq_ax % cand == 0 and cand <= max(tile, 1):
            t = cand
    scale = nv_ax / nq_ax
    lo_off = 0.5 * scale - 0.5 - radius
    hi_off = (t - 0.5) * scale - 0.5 + radius
    band = int(np.floor(hi_off) + 1 - np.floor(lo_off)) + 1
    if band >= nv_ax:
        return (nq_ax, nv_ax, (0,))
    starts = []
    for i in range(nq_ax // t):
        s = int(np.floor(i * t * scale + lo_off))
        starts.append(max(0, min(s, nv_ax - band)))
    return (t, band, tuple(starts))


@functools.lru_cache(maxsize=None)
def _band_geometry_2d(spatial_shapes: Tuple[Tuple[int, int], ...], radius: int, tile: int):
    """2-D plan: {(ql, lvl): None | (tqy, band_rows, ystarts, tqx, band_cols,
    xstarts)}; None when neither axis bands."""
    plan = {}
    for ql, (hq, wq) in enumerate(spatial_shapes):
        for lvl, (h, w) in enumerate(spatial_shapes):
            ypl = _band_axis_plan(hq, h, radius, tile)
            xpl = _band_axis_plan(wq, w, radius, tile)
            if ypl[1] >= h and xpl[1] >= w:
                plan[(ql, lvl)] = None
            else:
                plan[(ql, lvl)] = ypl + xpl
    return plan


def _plan(shapes, radius: int, tile_queries: int, tile_x: Optional[int]):
    if tile_x is None:
        return _band_geometry(shapes, int(radius), int(tile_queries))
    return _band_geometry_2d(shapes, int(radius), int(tile_x))


@functools.lru_cache(maxsize=None)
def _band_table_np(shapes: Tuple[Tuple[int, int], ...], radius: int, tile_queries: int,
                   tile_x: Optional[int]) -> np.ndarray:
    levels = len(shapes)
    table = np.zeros((sum(h * w for h, w in shapes), levels, 4), np.int32)
    plan = _plan(shapes, radius, tile_queries, tile_x)
    q0 = 0
    for ql, (hq, wq) in enumerate(shapes):
        r, c = np.arange(hq), np.arange(wq)
        for lvl, (h, w) in enumerate(shapes):
            rows = np.broadcast_to(np.array([0, h]), (hq, 2))
            cols = np.broadcast_to(np.array([0, w]), (wq, 2))
            geom = plan[(ql, lvl)]
            if geom is not None:
                tq, band, starts = geom[:3]
                lo = np.asarray(starts)[r // tq]
                rows = np.stack([lo, lo + band], -1)
                if len(geom) == 6:
                    tqx, bandx, xs = geom[3:]
                    lo = np.asarray(xs)[c // tqx]
                    cols = np.stack([lo, lo + bandx], -1)
            # query q0 + r * wq + c: its row's row bounds, its column's column bounds
            table[q0:q0 + hq * wq, lvl, :2] = np.repeat(rows, wq, axis=0)
            table[q0:q0 + hq * wq, lvl, 2:] = np.tile(cols, (hq, 1))
        q0 += hq * wq
    return table


_TABLES = {}


def msda_band_table(spatial_shapes: Sequence[Tuple[int, int]], radius: int = 6,
                    tile_queries: int = 512, tile_x: Optional[int] = None,
                    device=None) -> torch.Tensor:
    """The bands of a plan as the banded kernel reads them: int32 (S, L, 4),
    per query (a pixel of the concatenated levels, level-major, row-major)
    and sampling level the rows [lo, hi) and columns [lo, hi) its corners may
    read. Pairs the plan leaves dense, and the columns of a 1-D plan, span
    the whole level. Cached per (shapes, radius, tiles, device)."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    key = (shapes, int(radius), int(tile_queries), None if tile_x is None else int(tile_x),
           str(torch.device("cpu" if device is None else device)))
    table = _TABLES.get(key)
    if table is None:
        with torch.inference_mode(False):  # usable under autograd later
            table = torch.from_numpy(_band_table_np(*key[:4])).to(key[4])
        _TABLES[key] = table
    return table


def msda_band_oob_fraction(spatial_shapes: Sequence[Tuple[int, int]],
                           sampling_locations: torch.Tensor,
                           attention_weights: torch.Tensor,
                           radius: int = 6, tile_queries: int = 512,
                           tile_x: Optional[int] = None) -> torch.Tensor:
    """Fraction of the attention mass whose taps fall outside the banded
    mode's window (0: banded equals dense). A tap is out of band if one of
    its corner rows (with ``tile_x``, also columns) lies inside the level but
    outside its tile's band; corners off the level read zero in every mode
    and never count. sampling_locations (B, Lq, M, L, P, 2), Lq == S."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    b, lq, m, _, p, _ = sampling_locations.shape
    if lq != sum(h * w for h, w in shapes):
        raise ValueError("oob counter requires queries == pixels (Lq == S)")
    plan = _plan(shapes, radius, tile_queries, tile_x)
    dev = sampling_locations.device
    total = attention_weights.float().sum()
    oob = torch.zeros((), dtype=torch.float32, device=dev)
    q_start = 0
    for ql, (hq, wq) in enumerate(shapes):
        nq = hq * wq
        for lvl, (h, w) in enumerate(shapes):
            geom = plan[(ql, lvl)]
            if geom is None:
                continue
            aw = attention_weights[:, q_start:q_start + nq, :, lvl].float()
            locs = sampling_locations[:, q_start:q_start + nq, :, lvl].float()
            if len(geom) == 6:
                tqy, br, ys, tqx, bc, xs = geom
                n_ty, n_tx = hq // tqy, wq // tqx

                def _rt(a):  # (B, nq, M, P) -> 2-D query tiles
                    return a.reshape(b, n_ty, tqy, n_tx, tqx, m, p)

                ypix, xpix, awt = _rt(locs[..., 1] * h - 0.5), _rt(locs[..., 0] * w - 0.5), _rt(aw)
                sty = torch.tensor(ys, dtype=torch.float32, device=dev).reshape(
                    1, -1, 1, 1, 1, 1, 1)
                stx = torch.tensor(xs, dtype=torch.float32, device=dev).reshape(
                    1, 1, 1, -1, 1, 1, 1)
                bad = torch.zeros(ypix.shape, dtype=torch.bool, device=dev)
                for pix, st, band, extent in ((ypix, sty, br, h), (xpix, stx, bc, w)):
                    c0 = torch.floor(pix)
                    for corner in (c0, c0 + 1.0):
                        inside_img = (corner >= 0) & (corner <= extent - 1)
                        inside_band = (corner >= st) & (corner <= st + band - 1)
                        bad = bad | (inside_img & ~inside_band)
                oob = oob + (awt * bad).sum()
            else:
                tq, band_rows, starts = geom
                n_tiles = len(starts)
                y = (locs[..., 1] * h - 0.5).reshape(b, n_tiles, nq // n_tiles, m, p)
                awt = aw.reshape(b, n_tiles, nq // n_tiles, m, p)
                st = torch.tensor(starts, dtype=torch.float32, device=dev).reshape(
                    1, -1, 1, 1, 1)
                y0 = torch.floor(y)
                bad = torch.zeros(y.shape, dtype=torch.bool, device=dev)
                for corner in (y0, y0 + 1.0):
                    inside_img = (corner >= 0) & (corner <= h - 1)
                    inside_band = (corner >= st) & (corner <= st + band_rows - 1)
                    bad = bad | (inside_img & ~inside_band)
                oob = oob + (awt * bad).sum()
        q_start += nq
    return oob / total.clamp(min=1e-12)
