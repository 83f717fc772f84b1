"""The P-folded sampling's backward algorithm (``ops/msda_sampling``'s
``msda_folded_backward_plain``, the algorithm of ``csrc/msda_folded_bwd.cu``)
on the CPU: its dvalue, dloc and dattw against autograd through
``msda_folded_plain`` in f32, dense and banded (radius 4, the 1-D plan of
query-row tiles and a 2-D plan), with taps whose corners fall off the map and
out of their band, integer-valued pixel coordinates (so that a corner of
weight 0 still has a derivative), f32 and bf16 weights and subsets of the
gradients. Three planted faults must fail the same limit: the band ignored
in the backward, one corner's d(w)/dx of the wrong sign, and the locations'
scale by the level's width dropped. A CPU tensor never reaches the backward
kernel's autograd Function.

Tolerance: each gradient within ``TOL`` = 1e-5 of its largest magnitude
(both sides are f32 sums of the same products in another order). dattw in
bf16 (bf16 weights) is the f32 sum rounded once, so it may differ by one
bf16 rounding (``BF16_TOL`` = 2^-8 of each value) where the two f32 sums lie
on either side of a rounding boundary.
"""

import numpy as np
import pytest
import torch

from partdistillation_torch.ops import autograd as ag
from partdistillation_torch.ops import msda_sampling as ms
from partdistillation_torch.ops.ms_deform_attn import msda_band_table

TOL = 1e-5
BF16_TOL = 2.0 ** -8
# power-of-two sides, so that integer pixel coordinates are exact in f32;
# query rows tiled by 64 queries, so that every level bands at radius 4
SHAPES = ((32, 16), (16, 8), (8, 4))
B, M, D, P = 2, 2, 8, 4
RADIUS, TILE_QUERIES, TILE_X = 4, 64, 4
NAMES = ("value", "loc", "attw")


def _band(mode):
    if mode == "dense":
        return None
    return msda_band_table(SHAPES, RADIUS, TILE_QUERIES, TILE_X if mode == "banded_2d" else None)


def _inputs(placement, weights, seed=0):
    """value (B, S, M, D) f32, locations around each query's pixel (its
    reference point on every level) spread to +-9 level pixels, so that taps
    leave the band and the map; ``integer``: on whole pixel coordinates."""
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in SHAPES)
    levels = len(SHAPES)
    value = rng.normal(size=(B, s, M, D)).astype(np.float32)
    ref = np.concatenate([np.stack(np.meshgrid((np.arange(w) + 0.5) / w,
                                               (np.arange(h) + 0.5) / h), -1).reshape(-1, 2)
                          for h, w in SHAPES])  # (S, 2) as (x, y)
    size = np.array([[w, h] for h, w in SHAPES], np.float32)  # (L, 2)
    off = rng.uniform(-9.0, 9.0, size=(B, s, M, levels, P, 2))
    pix = ref[None, :, None, None, None, :] * size[None, None, None, :, None, :] - 0.5 + off
    if placement == "integer":
        pix = np.round(pix)
    loc = ((pix + 0.5) / size[None, None, None, :, None, :]).astype(np.float32)
    attw = rng.random((B, s, M, levels, P)).astype(np.float32)
    out = [torch.from_numpy(value), torch.from_numpy(loc), torch.from_numpy(attw)]
    if weights == "bf16":
        out[2] = out[2].to(torch.bfloat16)
    grad = torch.from_numpy(rng.normal(size=(B, s, M * D)).astype(np.float32))
    return out, grad


def _autograd(inputs, grad, band, needs=(True, True, True)):
    leaves = [t.clone().requires_grad_(n) for t, n in zip(inputs, needs)]
    out = ms.msda_folded_plain(leaves[0], SHAPES, leaves[1], leaves[2], band)
    got = iter(torch.autograd.grad(out, [t for t in leaves if t.requires_grad], grad))
    return [next(got) if n else None for n in needs]


def _err(got, want):
    """max |got - want| over max |want|."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def _within(got, want):
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape, b.shape, a.dtype)
        if a.dtype == torch.bfloat16:
            step = BF16_TOL * b.double().abs() + TOL * b.double().abs().max()
            assert ((a.double() - b.double()).abs() <= step).all(), name
        else:
            assert _err(a, b) <= TOL, (name, _err(a, b))


@pytest.mark.parametrize("weights", ["f32", "bf16"])
@pytest.mark.parametrize("placement", ["spread", "integer"])
@pytest.mark.parametrize("mode", ["dense", "banded_1d", "banded_2d"])
def test_backward_plain_matches_autograd(mode, placement, weights):
    inputs, grad = _inputs(placement, weights)
    band = _band(mode)
    want = _autograd(inputs, grad, band)
    got = ms.msda_folded_backward_plain(*inputs[:1], SHAPES, *inputs[1:], grad, band)
    assert got[1].dtype == torch.float32 and got[2].dtype == inputs[2].dtype
    _within(got, want)


def test_inputs_reach_every_kind_of_corner():
    """The cases hold taps off the map, taps out of their band (1-D and 2-D
    plans) on the map, and whole pixel coordinates."""
    (_, loc, _), _ = _inputs("spread", "f32")
    s = sum(h * w for h, w in SHAPES)
    assert s == loc.shape[1]
    x = loc[..., 0] * torch.tensor([w for _, w in SHAPES]).view(1, 1, 1, -1, 1) - 0.5
    off = (x < -1) | (x > torch.tensor([w for _, w in SHAPES]).view(1, 1, 1, -1, 1))
    assert off.float().mean() > 0.05
    for mode in ("banded_1d", "banded_2d"):
        band = _band(mode).long()  # (S, L, 4)
        y = loc[..., 1] * torch.tensor([h for h, _ in SHAPES]).view(1, 1, 1, -1, 1) - 0.5
        y0 = torch.floor(y).long()
        hs = torch.tensor([h for h, _ in SHAPES]).view(1, 1, 1, -1, 1)
        on_map = (y0 >= 0) & (y0 < hs)
        lo, hi = band[None, :, None, :, None, 0], band[None, :, None, :, None, 1]
        assert ((on_map & ((y0 < lo) | (y0 >= hi))).float().mean() > 0.05), mode
    (_, loc_i, _), _ = _inputs("integer", "f32")
    xi = loc_i[..., 0] * torch.tensor([w for _, w in SHAPES]).view(1, 1, 1, -1, 1) - 0.5
    assert torch.equal(xi, torch.round(xi))


@pytest.mark.parametrize("needs", [(True, False, False), (False, True, True),
                                   (False, False, True)])
def test_backward_plain_takes_only_the_gradients_asked_for(needs):
    inputs, grad = _inputs("spread", "f32", seed=1)
    band = _band("banded_1d")
    want = _autograd(inputs, grad, band, needs)
    got = ms.msda_folded_backward_plain(*inputs[:1], SHAPES, *inputs[1:], grad, band,
                                        needs=needs)
    for name, a, b, need in zip(NAMES, got, want, needs):
        if not need:
            assert a is None and b is None, name
        else:
            assert _err(a, b) <= TOL, name


def _planted(monkeypatch, fault):
    inputs, grad = _inputs("spread", "f32", seed=2)
    band = _band("banded_1d")
    want = _autograd(inputs, grad, band)
    if fault == "band_ignored":
        got = ms.msda_folded_backward_plain(*inputs[:1], SHAPES, *inputs[1:], grad, None)
    elif fault == "dwdx_sign":
        terms = ms._corner_terms

        def flipped(*args, **kwargs):
            out = terms(*args, **kwargs)
            row, wgt, dwdx, dwdy = out[1]
            out[1] = (row, wgt, -dwdx, dwdy)
            return out

        monkeypatch.setattr(ms, "_corner_terms", flipped)
        got = ms.msda_folded_backward_plain(*inputs[:1], SHAPES, *inputs[1:], grad, band)
    else:  # the locations' scale by W dropped: dloc_x = attw * sum (dw/dx) dot
        got = list(ms.msda_folded_backward_plain(*inputs[:1], SHAPES, *inputs[1:], grad, band))
        widths = torch.tensor([float(w) for _, w in SHAPES]).view(1, 1, 1, -1, 1)
        got[1] = got[1].clone()
        got[1][..., 0] /= widths
    return {name: _err(a, b) for name, a, b in zip(NAMES, got, want)}


@pytest.mark.parametrize("fault,fails", [("band_ignored", ("value", "loc", "attw")),
                                         ("dwdx_sign", ("loc",)), ("loc_scale", ("loc",))])
def test_planted_faults_fail_the_limit(monkeypatch, fault, fails):
    errs = _planted(monkeypatch, fault)
    for name in fails:
        assert errs[name] > 100 * TOL, (fault, errs)


def test_cpu_tensors_never_reach_the_backward_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU msda_folded reached the kernel's autograd Function")

    monkeypatch.setattr(ag.KernelOp, "apply", refuse)
    before = ag.launch_counts("msda_folded", "msda_folded_bwd")
    inputs, grad = _inputs("spread", "f32")
    band = _band("banded_1d")
    leaves = [t.clone().requires_grad_() for t in inputs]
    out = ms.msda_folded(leaves[0], SHAPES, leaves[1], leaves[2], band=band)
    got = torch.autograd.grad(out, leaves, grad)
    _within([got[0], got[1], got[2]], _autograd(inputs, grad, band))
    assert ag.launch_counts("msda_folded", "msda_folded_bwd") == before
    with pytest.raises(ValueError, match="unsupported device"):
        ms.msda_folded_backward(*inputs[:1], SHAPES, *inputs[1:], grad, band)
