"""Slice 8's banded deformable sampling on the CPU against the JAX package.

The port's copies of the band plans (``_band_geometry``, ``_band_axis_plan``,
``_band_geometry_2d``) equal JAX's at the encoder's 640^2 geometry and at
ragged ones; the plain banded sampling (``msda_folded_banded_plain``, what
``ms_deform_attn(mode="banded")`` runs on the CPU) equals JAX's
``ms_deform_attn(mode="banded")`` in values and in the gradients with
respect to the value, the locations and the weights, with 1-D row bands and
with 2-D tiles; the banded kernel's order (``msda_folded_banded_grouped_plain``)
equals the plain banded version; ``msda_band_oob_fraction`` equals JAX's.

Every case plants sampling offsets that carry at least 10 % of the attention
mass out of band, and first asserts that banded and dense sampling differ
there by more than the case's tolerance, so a version that ignored the band
would fail. Tolerances: max |err| within 1e-5 of max |JAX| in f32 (sums in
another order; JAX's hat weights against the port's corner weights); the
counter within 1e-6; bf16 within 2^-7 of max (one bf16 rounding).
"""

import jax
import numpy as np
import pytest
import torch

from partdistillation_tpu.ops import ms_deform_attn as jm
from partdistillation_torch.ops import ms_deform_attn as pm
from partdistillation_torch.ops import msda_sampling as ms

F32, BF16, OOB = 1e-5, 2.0 ** -7, 1e-6
ENCODER = ((20, 20), (40, 40), (80, 80))
# ragged geometries: odd sides, non-square levels, a level of one row
RAGGED = [((15, 11), (8, 6), (4, 3)), ((9, 31), (5, 16), (3, 8)), ((24, 7), (12, 4), (1, 2))]

# (levels, B, M, D, P, radius, tile_queries, tile_x): small levels with
# small tiles so that every pair but the coarsest bands
CASES = [(((16, 12), (8, 6), (4, 3)), 1, 2, 8, 2, 1, 24, None),
         (((15, 11), (8, 6), (4, 3)), 2, 2, 4, 3, 2, 22, None),
         (((16, 12), (8, 6), (4, 3)), 1, 2, 8, 2, 1, 512, 4),
         (((9, 31), (5, 16), (3, 8)), 1, 3, 4, 2, 1, 512, 3)]
IDS = ["rows-r1", "rows-ragged-r2", "tiles-r1", "tiles-ragged-r1"]


def _inputs(case, seed):
    """value (B, S, M, D), locations (B, S, M, L, P, 2) around each query's
    reference point with offsets of up to six level pixels, weights
    (B, S, M, L, P); f32 numpy."""
    levels, b, m, d, p = case[:5]
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in levels)
    value = rng.normal(size=(b, s, m, d)).astype(np.float32)
    ref = []
    for h, w in levels:
        yy, xx = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij")
        ref.append(np.stack([xx.ravel(), yy.ravel()], -1))
    ref = np.concatenate(ref)[None, :, None, None, None, :]
    size = np.array([[w, h] for h, w in levels], np.float64)[None, None, None, :, None, :]
    offsets = rng.uniform(-6.0, 6.0, size=(b, s, m, len(levels), p, 2)) / size
    loc = (ref + offsets).astype(np.float32)
    logits = rng.normal(size=(b, s, m, len(levels) * p))
    attw = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).reshape(
        b, s, m, len(levels), p).astype(np.float32)
    return value, loc, attw


def _band_args(case):
    radius, tq, tx = case[5:]
    return dict(band_radius=radius, band_tile_queries=tq, band_tile_x=tx)


def _within(out, ref, rel, name=""):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert scale > 0 and np.isfinite(err) and err <= rel * scale, (name, err, scale)


def _jax_msda(levels, mode, **args):
    """JAX's sampling as one compiled function of (value, locations, weights):
    op by op, its banded mode dispatches a few operations per tile."""
    return jax.jit(lambda v, l, a: jm.ms_deform_attn(v, levels, l, a, mode=mode, **args))


def _oob(case, loc, attw):
    radius, tq, tx = case[5:]
    return float(pm.msda_band_oob_fraction(case[0], torch.from_numpy(loc),
                                           torch.from_numpy(attw), radius, tq, tx))


@pytest.mark.parametrize("tile", [None, 16])
@pytest.mark.parametrize("levels", [ENCODER] + RAGGED, ids=["encoder", "r0", "r1", "r2"])
@pytest.mark.parametrize("radius", [1, 4])
def test_band_plans_equal_jax(levels, radius, tile):
    if tile is None:
        assert pm._band_geometry(levels, radius, 512) == jm._band_geometry(levels, radius, 512)
        assert pm._band_geometry(levels, radius, 64) == jm._band_geometry(levels, radius, 64)
    else:
        assert pm._band_geometry_2d(levels, radius, tile) == jm._band_geometry_2d(
            levels, radius, tile)
        for n, v in ((20, 80), (7, 3), (31, 16)):
            assert pm._band_axis_plan(n, v, radius, tile) == jm._band_axis_plan(
                n, v, radius, tile)


def test_encoder_plan_bands_at_radius_4():
    """The CLI's default (radius 4, tile 512) at 640^2: the table holds row
    and column bounds per (query, level); the finest level's queries read a
    band of its rows (5-row tiles, 14 rows), every column; the coarsest
    level's queries read all of every level."""
    table = pm.msda_band_table(ENCODER, 4, 512).numpy()
    assert table.shape == (8400, 3, 4) and table.dtype == np.int32
    fine = table[2000:]  # the 80 x 80 level's queries
    assert ((fine[:, 2, 1] - fine[:, 2, 0]) == 14).all()
    assert (fine[:, :, 2] == 0).all() and (fine[:, :, 3] == [20, 40, 80]).all()
    assert (table[:400] == [[0, 20, 0, 20], [0, 40, 0, 40], [0, 80, 0, 80]]).all()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_banded_plain_matches_jax(case):
    levels = case[0]
    value, loc, attw = _inputs(case, seed=0 + CASES.index(case))
    assert _oob(case, loc, attw) >= 0.1
    args = _band_args(case)
    ref = np.asarray(_jax_msda(levels, "banded", **args)(value, loc, attw))
    dense = np.asarray(_jax_msda(levels, "take")(value, loc, attw))
    assert np.abs(ref - dense).max() > 100 * F32 * np.abs(ref).max()  # the band acts
    t = [torch.from_numpy(a) for a in (value, loc, attw)]
    band = pm.msda_band_table(levels, *case[5:])
    _within(ms.msda_folded_banded_plain(*t[:1], levels, *t[1:], band=band).numpy(), ref, F32)
    _within(pm.ms_deform_attn(*t[:1], levels, *t[1:], mode="banded", **args).numpy(), ref, F32)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_banded_plain_gradients_match_jax(case):
    levels = case[0]
    value, loc, attw = _inputs(case, seed=3 + CASES.index(case))
    args = _band_args(case)
    cot = np.random.default_rng(9).normal(size=(value.shape[0], value.shape[1],
                                                value.shape[2] * value.shape[3]))
    cot = cot.astype(np.float32)
    fn = _jax_msda(levels, "banded", **args)
    want = [np.asarray(g) for g in jax.jit(lambda *a: jax.vjp(fn, *a[:3])[1](a[3]))(
        value, loc, attw, cot)]
    t = [torch.from_numpy(a).requires_grad_() for a in (value, loc, attw)]
    out = pm.ms_deform_attn(t[0], levels, t[1], t[2], mode="banded", **args)
    got = torch.autograd.grad(out, t, torch.from_numpy(cot))
    for name, g, w in zip(("value", "locations", "weights"), got, want):
        _within(g.numpy(), w, F32, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_banded_grouped_plain_matches_plain(case, dtype):
    levels = case[0]
    value, loc, attw = _inputs(case, seed=5 + CASES.index(case))
    tdt, tol = (torch.float32, F32) if dtype == "float32" else (torch.bfloat16, BF16)
    v, l, a = torch.from_numpy(value).to(tdt), torch.from_numpy(loc), torch.from_numpy(attw)
    band = pm.msda_band_table(levels, *case[5:])
    plain = ms.msda_folded_banded_plain(v, levels, l, a, band).float()
    dense = ms.msda_folded_plain(v, levels, l, a).float()
    assert (plain - dense).abs().max() > 10 * tol * plain.abs().max()  # the band acts
    grouped = ms.msda_folded_banded_grouped_plain(v, levels, l, a, band)
    assert grouped.dtype == tdt
    _within(grouped.float().numpy(), plain.numpy(), tol)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_oob_fraction_matches_jax(case):
    levels = case[0]
    value, loc, attw = _inputs(case, seed=7)
    radius, tq, tx = case[5:]
    want = float(jax.jit(lambda l, a: jm.msda_band_oob_fraction(levels, l, a, radius, tq, tx))(
        loc, attw))
    got = _oob(case, loc, attw)
    assert want >= 0.1 and abs(got - want) <= OOB, (got, want)


def test_in_band_taps_make_banded_equal_dense():
    """At the deformable-DETR offset grid (at most P level pixels) with
    radius 4 the counter reads 0 and banded sampling equals dense."""
    levels = ((16, 16), (8, 8), (4, 4))
    case = (levels, 1, 2, 4, 2, 4, 32, None)
    value, loc, attw = _inputs(case, seed=11)
    ref = np.concatenate([((np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1).reshape(-1, 2)
                            + 0.5) / [w, h]) for h, w in levels])
    loc[:] = (ref[None, :, None, None, None, :]
              + np.clip(loc - ref[None, :, None, None, None, :], -1.5 / 16, 1.5 / 16))
    assert _oob(case, loc, attw) == 0.0
    t = [torch.from_numpy(a) for a in (value, loc, attw)]
    band = pm.msda_band_table(levels, 4, 32)
    assert torch.equal(ms.msda_folded_banded_plain(t[0], levels, t[1], t[2], band),
                       ms.msda_folded_plain(t[0], levels, t[1], t[2]))


def test_banded_needs_queries_equal_pixels():
    levels = ((4, 4), (2, 2))
    value = torch.zeros(1, 20, 2, 4)
    loc, attw = torch.zeros(1, 7, 2, 2, 2, 2), torch.zeros(1, 7, 2, 2, 2)
    with pytest.raises(ValueError, match="queries == pixels"):
        pm.ms_deform_attn(value, levels, loc, attw, mode="banded")
    with pytest.raises(ValueError, match="mode"):
        pm.ms_deform_attn(value, levels, loc, attw, mode="hat")
