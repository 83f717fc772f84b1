"""The port's deformable sampling (``ops/msda_sampling.py``,
``ops/ms_deform_attn.py``; plain versions on the CPU) against the JAX
package's ``ops/msda_pallas.py`` kernels, run in interpret mode as its own
tests run them, and against its ``ms_deform_attn`` in each of the JAX
package's modes that compute this function exactly (the port has one
formulation of it).

Inputs come from one numpy generator and go to both packages; taps fall
inside, across the edge of and wholly outside the map, and the query counts
are not multiples of the Pallas tiles (256). Tolerances (f32): forwards
within 1e-5 of max |JAX|, gradients within 1e-4 of each gradient's max |JAX|
(the JAX gradients are its ``custom_vjp``s: the VJP of its dense-hat XLA
composition, the same function).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partdistillation_tpu.ops import msda_pallas as jmp
from partdistillation_tpu.ops.ms_deform_attn import ms_deform_attn as j_msda
from partdistillation_torch.ops import autograd as ag
from partdistillation_torch.ops import msda_sampling as ms
from partdistillation_torch.ops.ms_deform_attn import ms_deform_attn

FWD, GRAD = 1e-5, 1e-4

# (BM, P, N, H, W, D): ragged N, a 1 x 1 level, a level wider than 32
FOLDED = [(2, 3, 300, 5, 7, 8), (3, 2, 50, 1, 1, 16), (2, 4, 40, 3, 40, 8)]
TAPS = [(2, 300, 5, 7, 8), (3, 50, 1, 1, 16), (2, 40, 3, 40, 8)]


def _close(out, ref, tol, name=""):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert scale > 0 and err <= tol * scale, (name, err, scale)


def _coords(rng, shape, h, w):
    """Pixel coordinates from 2.5 pixels outside the map on each side."""
    x = rng.uniform(-2.5, w + 1.5, size=shape).astype(np.float32)
    y = rng.uniform(-2.5, h + 1.5, size=shape).astype(np.float32)
    return x, y


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _folded_inputs(case, seed=0):
    bm, p, n, h, w, d = case
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(bm, h * w, d)).astype(np.float32)
    x, y = _coords(rng, (bm, p, n), h, w)
    attw = rng.random((bm, p, n)).astype(np.float32)
    return v, x, y, attw


def _taps_inputs(case, seed=1):
    bm, n, h, w, d = case
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(bm, w, h * d)).astype(np.float32)
    x, y = _coords(rng, (bm, n), h, w)
    attw = rng.random((bm, n)).astype(np.float32)
    return v, x, y, attw


@pytest.mark.parametrize("case", FOLDED)
def test_sample_level_folded_matches_pallas_interpret(case):
    h, w = case[3], case[4]
    args = _folded_inputs(case)
    ref = jmp.sample_level_folded(*map(jnp.asarray, args), h, w)
    out = ms.sample_level_folded(*_t(*args), h, w)
    assert out.shape == (case[0], case[2], case[5])
    _close(out, ref, FWD)
    assert ag.launch_counts("msda_folded") == {"msda_folded": 0}


@pytest.mark.parametrize("variant", ["expand", "sel"])
@pytest.mark.parametrize("case", TAPS)
def test_sample_level_matches_pallas_interpret(case, variant):
    """One port function against both of the JAX package's variants."""
    h, w = case[2], case[3]
    args = _taps_inputs(case)
    ref = jmp._forward(*map(jnp.asarray, args), h, w, variant=variant)
    out = ms.sample_level(*_t(*args), h, w)
    _close(out, ref, FWD)
    assert ag.launch_counts("msda_taps") == {"msda_taps": 0}


def _grads_against_jax(jfn, pfn, args, out_shape, seed, names=("v", "x", "y", "attw")):
    g = np.random.default_rng(seed).normal(size=out_shape).astype(np.float32)
    _, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    inputs = [t.requires_grad_() for t in _t(*args)]
    pfn(*inputs).backward(torch.from_numpy(g))
    assert len(names) == len(inputs) == len(want)
    for name, t, r in zip(names, inputs, want):
        _close(t.grad, r, GRAD, name)


@pytest.mark.parametrize("case", FOLDED[::2])
def test_sample_level_folded_gradients_match_jax(case):
    bm, _, n, h, w, d = case
    _grads_against_jax(lambda *a: jmp.sample_level_folded(*a, h, w),
                       lambda *a: ms.sample_level_folded(*a, h, w),
                       _folded_inputs(case, seed=2), (bm, n, d), seed=3)


@pytest.mark.parametrize("case", TAPS[::2])
def test_sample_level_gradients_match_jax(case):
    bm, n, h, w, d = case
    _grads_against_jax(lambda *a: jmp.sample_level(*a, h, w),
                       lambda *a: ms.sample_level(*a, h, w),
                       _taps_inputs(case, seed=4), (bm, n, d), seed=5)


SHAPES = ((6, 5), (3, 3), (1, 1))


def _msda_inputs(seed, b=2, m=4, d=8, p=3, lq=23):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in SHAPES)
    levels = len(SHAPES)
    value = rng.normal(size=(b, s, m, d)).astype(np.float32)
    logits = rng.normal(size=(b, lq, m, levels * p))
    attw = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    loc = rng.uniform(-0.3, 1.3, size=(b, lq, m, levels, p, 2))  # some taps off the map
    return value, loc.astype(np.float32), attw.reshape(b, lq, m, levels, p).astype(np.float32)


@pytest.mark.parametrize("mode", [None, "take", "onehot_mxu", "pallas_folded"])
def test_ms_deform_attn_modes_match_jax(mode):
    args = _msda_inputs(6)
    ref = j_msda(jnp.asarray(args[0]), SHAPES, *map(jnp.asarray, args[1:]), mode=mode)
    value, loc, attw = _t(*args)
    out = ms_deform_attn(value, SHAPES, loc, attw)
    assert out.shape == (2, 23, 32)
    _close(out, ref, FWD, mode)


def test_ms_deform_attn_gradients_match_jax_pallas_folded():
    _grads_against_jax(
        lambda v, loc, a: j_msda(v, SHAPES, loc, a, mode="pallas_folded"),
        lambda v, loc, a: ms_deform_attn(v, SHAPES, loc, a),
        _msda_inputs(7), (2, 23, 32), seed=8, names=("value", "locations", "weights"))


def test_msda_folded_on_cpu_is_its_plain_version():
    value, loc, attw = _t(*_msda_inputs(9))
    np.testing.assert_array_equal(ms.msda_folded(value, SHAPES, loc, attw).numpy(),
                                  ms.msda_folded_plain(value, SHAPES, loc, attw).numpy())
    assert ag.launch_counts("msda_folded") == {"msda_folded": 0}


def test_mismatched_shapes_raise():
    value, loc, attw = _t(*_msda_inputs(11))
    with pytest.raises(ValueError, match="spatial shapes"):
        ms_deform_attn(value, SHAPES[:2], loc, attw)
    with pytest.raises(ValueError, match="attention_weights"):
        ms_deform_attn(value, SHAPES, loc, attw[:, :, :, :, :2])
