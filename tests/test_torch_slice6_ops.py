"""Slice 6's algorithms on the CPU against the JAX package: the plain version
of the redesigned P-folded sampling kernel (``msda_folded_grouped_plain``:
per-group f32 partials over taps g, g + G, ..., then a fixed pairwise sum of
the groups) against JAX's ``ms_deform_attn`` in mode ``pallas_folded`` (its
``_forward_folded`` Pallas kernel in interpret mode, as its own tests run
it) and against the port's ``msda_folded_plain``; the fused multiply-add it
sums with (``_fmaf``, rounded once as CUDA's ``fmaf``) against exact
rational arithmetic; and the lane layout covering every channel once.

Inputs come from one numpy generator and go to both packages. Taps fall
inside, across the edge of and wholly outside each level, including x0 = -1
and x0 = W - 1. Tolerances: max |err| within 1e-5 of max |reference| in f32
(sums in another order) and 2^-7 in bf16 (one bf16 rounding of the output;
JAX rounds each level's sum to bf16 before adding the levels, the port once
at the end).
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partdistillation_tpu.ops.ms_deform_attn import ms_deform_attn as j_msda
from partdistillation_torch.ops import msda_sampling as ms
from torch_msda_cases import EIGHT, ENCODER, THREE, edge_pixels

F32, BF16 = 1e-5, 2.0 ** -7

# (levels, B, Lq, M, D, P, placement): the encoder's three levels at a
# reduced Lq; L x P of 4, 9, 12 and 40 (more than a warp's 32 lanes); D of 8
# (16 lane groups), 32 (4) and 64 (2)
CASES = [(ENCODER, 1, 37, 2, 32, 4, "spread"), (((5, 7),), 2, 29, 3, 8, 4, "edge"),
         (THREE, 2, 23, 2, 64, 3, "spread"), (THREE, 1, 19, 4, 32, 3, "edge"),
         (EIGHT, 1, 21, 2, 32, 5, "spread"), (EIGHT, 2, 13, 2, 8, 5, "edge")]
IDS = ["encoder", "lp4-d8-edge", "lp9-d64", "lp9-d32-edge", "lp40-d32", "lp40-d8-edge"]
DTYPES = {"float32": (torch.float32, F32), "bfloat16": (torch.bfloat16, BF16)}


def _inputs(case, seed):
    """value (B, S, M, D), loc (B, Lq, M, L, P, 2) in [0, 1] units, attw
    (B, Lq, M, L, P), f32 numpy."""
    levels, b, lq, m, d, p, placement = case
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in levels)
    value = rng.normal(size=(b, s, m, d)).astype(np.float32)
    logits = rng.normal(size=(b, lq, m, len(levels) * p))
    attw = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).reshape(
        b, lq, m, len(levels), p)
    shape = (b, lq, m, len(levels), p)
    if placement == "spread":  # on, across and beyond the edges
        loc = rng.uniform(-0.3, 1.3, size=shape + (2,))
    else:
        h = np.array([hh for hh, _ in levels], np.float64).reshape(1, 1, 1, -1, 1)
        w = np.array([ww for _, ww in levels], np.float64).reshape(1, 1, 1, -1, 1)
        x, y = edge_pixels(rng, shape, w, "edge"), edge_pixels(rng, shape, h, "edge")
        loc = np.stack([(x + 0.5) / w, (y + 0.5) / h], -1)
    return value, loc.astype(np.float32), attw.astype(np.float32)


def _within(out, ref, rel):
    out = np.asarray(out.float() if isinstance(out, torch.Tensor) else out, np.float64)
    ref = np.asarray(ref.float() if isinstance(ref, torch.Tensor) else ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert scale > 0 and np.isfinite(err) and err <= rel * scale, (err, scale)


def _torch(value, loc, attw, dtype, weights_dtype):
    return (torch.from_numpy(value).to(dtype), torch.from_numpy(loc),
            torch.from_numpy(attw).to(weights_dtype))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_grouped_plain_matches_jax_pallas_folded(case, dtype):
    levels, b, lq, m, d = case[:5]
    value, loc, attw = _inputs(case, seed=7 * len(levels) + d)
    ref = j_msda(jnp.asarray(value, dtype=dtype), levels, jnp.asarray(loc),
                 jnp.asarray(attw, dtype=dtype), mode="pallas_folded")
    tdt, tol = DTYPES[dtype]
    v, lc, a = _torch(value, loc, attw, tdt, tdt)
    out = ms.msda_folded_grouped_plain(v, levels, lc, a)
    assert out.dtype == tdt and out.shape == (b, lq, m * d)
    _within(out, np.asarray(ref.astype(jnp.float32)), tol)


@pytest.mark.parametrize("weights", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_grouped_plain_matches_plain(case, weights):
    """The kernel's order against the plain version's, f32 values at 1e-5
    and bf16 values at 2^-7, with f32 or bf16 weights (taken in f32)."""
    levels = case[0]
    value, loc, attw = _inputs(case, seed=3 + case[4])
    for dtype in sorted(DTYPES):
        tdt, tol = DTYPES[dtype]
        v, lc, a = _torch(value, loc, attw, tdt, DTYPES[weights][0])
        _within(ms.msda_folded_grouped_plain(v, levels, lc, a),
                ms.msda_folded_plain(v, levels, lc, a), tol)


@pytest.mark.parametrize("d", [1, 2, 6, 16, 128])
def test_grouped_plain_every_group_count_is_the_function(d):
    """D of 1, 2, 6, 16 and 128: 32, 16, 4, 8 and 1 lane groups (2-byte loads
    at D % 4 != 0)."""
    case = (EIGHT, 1, 21, 2, d, 5, "spread")
    value, loc, attw = _inputs(case, seed=d)
    v, lc, a = _torch(value, loc, attw, torch.float32, torch.float32)
    _within(ms.msda_folded_grouped_plain(v, EIGHT, lc, a),
            ms.msda_folded_plain(v, EIGHT, lc, a), F32)


def test_grouped_plain_taps_wholly_off_the_map_read_zero():
    case = (ENCODER, 2, 17, 2, 32, 4, "spread")
    value, loc, attw = _inputs(case, seed=11)
    rng = np.random.default_rng(12)
    # every tap's x two or more pixels beyond the left or right edge of its
    # level (1.5 / 20 of the width at the narrowest), y anywhere
    off = rng.uniform(0.1, 0.4, size=loc.shape[:-1])
    loc[..., 0] = np.where(rng.random(off.shape) < 0.5, -off, 1.0 + off)
    v, lc, a = _torch(value, loc.astype(np.float32), attw, torch.float32, torch.float32)
    out = ms.msda_folded_grouped_plain(v, ENCODER, lc, a)
    assert torch.equal(out, torch.zeros_like(out))
    ref = j_msda(jnp.asarray(value), ENCODER, jnp.asarray(loc, dtype=jnp.float32),
                 jnp.asarray(attw), mode="pallas_folded")
    assert not np.asarray(ref).any()


@pytest.mark.parametrize("d", [1, 2, 3, 6, 8, 16, 24, 31, 32, 33, 48, 64, 66, 100, 127, 128])
@pytest.mark.parametrize("aligned", [True, False])
def test_lane_plan_covers_every_channel_once(d, aligned):
    """The layout of csrc/msda.cuh as both kernels instantiate it (one load
    a lane at vec 4, four at vec 1): lane j of a group, load c, element e
    holds channel (c * group_lanes + j) * vec + e; each channel below D
    exactly once."""
    plan = ms.msda_lane_plan(d, aligned)
    vec, gl = plan["vec"], plan["group_lanes"]
    loads = 1 if vec == 4 else 4
    assert gl & (gl - 1) == 0 and plan["groups"] * gl == 32
    assert vec == (4 if aligned and d % 4 == 0 else 1) and d <= gl * vec * loads
    held = [(c * gl + j) * vec + e for j in range(gl) for c in range(loads) for e in range(vec)]
    held = [ch for ch in held if ch < d]
    assert sorted(held) == list(range(d))
    if vec == 4:  # 8-byte loads: whole vectors in or out
        assert all(j * vec + vec <= d or j * vec >= d for j in range(gl))


def test_lane_plan_main_path():
    """D = 32 at the main path: four groups of eight lanes, 8-byte loads."""
    assert ms.msda_lane_plan(32) == {"vec": 4, "group_lanes": 8, "groups": 4}
    with pytest.raises(ValueError):
        ms.msda_lane_plan(129)


def _exact_f32(q: Fraction) -> np.float32:
    """The rational q rounded to the nearest f32, ties to the even one."""
    near = np.float32(float(q))  # within one f32 step of the answer
    steps = [np.nextafter(near, np.float32(-np.inf)), near,
             np.nextafter(near, np.float32(np.inf))]
    return min(steps, key=lambda c: (abs(Fraction(float(c)) - q),
                                     int(np.array(c).view(np.int32)) & 1))


def _fmaf_exact(acc, a, b) -> np.ndarray:
    return np.array([_exact_f32(Fraction(float(c)) + Fraction(float(x)) * Fraction(float(y)))
                     for c, x, y in zip(acc, a, b)], np.float32)


def test_fmaf_rounds_once():
    """Random f32 triples whose product and addend lie up to 2^40 apart
    (where an f64 sum is inexact), against exact rounding."""
    rng = np.random.default_rng(0)
    n = 600
    acc = (rng.normal(size=n) * 2.0 ** rng.integers(-20, 21, n)).astype(np.float32)
    a = (rng.normal(size=n) * 2.0 ** rng.integers(-20, 21, n)).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    got = ms._fmaf(*(torch.from_numpy(t) for t in (acc, a, b))).numpy()
    assert np.array_equal(got.view(np.int32), _fmaf_exact(acc, a, b).view(np.int32))


def _product_near_two_pow_47(sign: int):
    """24-bit integers A, B with A * B = 2^47 + sign * delta, 0 < delta <
    2^18: their product lies within 2^-29 of a power of two."""
    for big in range(11863283, 11863283 + 4096):  # ~ 2^23.5
        small = -(-(1 << 47) // big) if sign > 0 else (1 << 47) // big
        delta = sign * (big * small - (1 << 47))
        if 0 < delta < (1 << 18):
            return big, small
    raise AssertionError("no factor pair found")


@pytest.mark.parametrize("sign", [1, -1])
def test_fmaf_where_an_f64_sum_rounds_twice(sign):
    """acc + a * b within 2^-47 relative of an f32 midpoint: the f64 sum
    rounds onto the midpoint, and f32 rounding of that picks the even
    neighbour, where the exact sum lies on the other side."""
    big, small = _product_near_two_pow_47(sign)
    a = np.array([big * 2.0 ** -23], np.float32)
    b = np.array([small * 2.0 ** -48], np.float32)  # a * b ~ 2^-24
    acc = np.array([1.0 if sign > 0 else 1.0 + 2.0 ** -23], np.float32)
    want = _fmaf_exact(acc, a, b)
    naive = (torch.from_numpy(acc).double()
             + torch.from_numpy(a).double() * torch.from_numpy(b).double()).float().numpy()
    assert naive[0] != want[0]  # the case this test is for
    got = ms._fmaf(*(torch.from_numpy(t) for t in (acc, a, b))).numpy()
    assert got[0] == want[0]
