"""The port's ops (plain versions, CPU) against the JAX package's functions.

Inputs come from one numpy generator and go to both packages. Where the JAX
function reaches a Pallas kernel it runs in interpret mode, as the JAX
package's own tests run it. Tolerance: atol = rtol = 1e-5 in f32 unless a
test states otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partdistillation_tpu.ops import fused_attention as jfa
from partdistillation_tpu.ops import fused_mlp as jfm
from partdistillation_tpu.ops import instance_post as jip
from partdistillation_tpu.ops.layer_norm import fused_layer_norm as j_layer_norm
from partdistillation_tpu.ops.ms_deform_attn import ms_deform_attn as j_msda
from partdistillation_torch.ops import fused_attention as pfa
from partdistillation_torch.ops import fused_mlp as pfm
from partdistillation_torch.ops import instance_post as pip
from partdistillation_torch.ops.layer_norm import fused_layer_norm
from partdistillation_torch.ops.ms_deform_attn import ms_deform_attn

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else a)


@pytest.mark.parametrize("shape", [(6, 10, 48), (3, 3072)])
def test_layer_norm_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=shape[-1]).astype(np.float32)
    bias = rng.normal(size=shape[-1]).astype(np.float32)
    ref = j_layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    out = fused_layer_norm(_t(x), _t(scale), _t(bias))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


def _mlp_inputs(rng, n=24, c=32):
    f = 4 * c
    return [rng.normal(size=s).astype(np.float32) * m + o for s, m, o in (
        ((n, c), 2.0, 0.5), ((c,), 0.3, 1.0), ((c,), 0.1, 0.0),
        ((c, f), c ** -0.5, 0.0), ((f,), 0.1, 0.0), ((f, c), f ** -0.5, 0.0),
        ((c,), 0.1, 0.0))]


def _port_mlp_args(x, scale, bias, w1, b1, w2, b2):
    # the port takes nn.Linear layout: w1 (4C, C), w2 (C, 4C)
    return [_t(x), _t(scale), _t(bias), _t(w1.T), _t(b1), _t(w2.T), _t(b2)]


@pytest.mark.parametrize("add_residual", [True, False])
def test_fused_mlp_matches_pallas_interpret(add_residual):
    args = _mlp_inputs(np.random.default_rng(1))
    ref = jfm._fwd_pallas(*[jnp.asarray(a) for a in args], eps=1e-5, token_tile=16,
                          add_residual=add_residual, interpret=True)
    num = jfm.ln_mlp_kernel_numerics(*[jnp.asarray(a) for a in args],
                                     add_residual=add_residual)
    out = pfm.fused_ln_mlp(*_port_mlp_args(*args), add_residual=add_residual)
    # the Pallas kernel uses a polynomial erf (|err| <= 1.5e-7) and reassociated
    # sums over 4C = 128 products: 2e-5 absolute on outputs of magnitude ~3
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(out), np.asarray(num), **TOL)


@pytest.mark.parametrize("groups", [1, 4])
def test_window_attention_matches_pallas_interpret(groups):
    rng = np.random.default_rng(4)
    b, h, d, n = 8, 3, 16, 24
    qt, kt, vt = (rng.normal(size=(b, h, d, n)).astype(np.float32) for _ in range(3))
    bias = rng.normal(size=(groups, h, n, n)).astype(np.float32)
    bias[..., :5] -= 100.0  # shift-mask-like blocked pairs
    ref = jfa._fused_periodic_fwd_pallas(jnp.asarray(qt), jnp.asarray(kt), jnp.asarray(vt),
                                         jnp.asarray(bias), 0.25, interpret=True)
    out = pfa.fused_window_attention(_t(qt), _t(kt), _t(vt), _t(bias), scale=0.25)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


@pytest.mark.parametrize("mask_heads", [1, 4])
def test_masked_attention_matches_pallas_interpret(mask_heads):
    rng = np.random.default_rng(5)
    b, h, nq, nk, d = 2, 4, 20, 150, 32
    q = rng.normal(size=(b, h, nq, d)).astype(np.float32) * d ** -0.5
    k, v = (rng.normal(size=(b, h, nk, d)).astype(np.float32) for _ in range(2))
    mask = rng.random((b, mask_heads, nq, nk)) < 0.6
    mask[:, :, :3] = True  # all-blocked rows take the fix-up
    jm = jnp.asarray(mask)
    neg = jnp.where(jm & ~jnp.all(jm, -1, keepdims=True), jnp.float32(-1e9), 0.0)
    ref = jfa._fused_fwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), neg, 128,
                                interpret=True)
    out = pfa.fused_masked_attention(_t(q), _t(k), _t(v), _t(mask))
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)
    ref_fn = jfa.fused_masked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm)
    np.testing.assert_allclose(_np(out), np.asarray(ref_fn), **TOL)


def _msda_inputs(rng, spatial_shapes, b=2, m=4, d=8, p=3, max_offset=None):
    s = sum(h * w for h, w in spatial_shapes)
    lv = len(spatial_shapes)
    value = rng.normal(size=(b, s, m, d)).astype(np.float32)
    w = rng.normal(size=(b, s, m, lv * p))
    w = np.exp(w) / np.exp(w).sum(-1, keepdims=True)
    weights = w.reshape(b, s, m, lv, p).astype(np.float32)
    if max_offset is None:  # anywhere, including outside the map
        loc = rng.uniform(-0.2, 1.2, size=(b, s, m, lv, p, 2))
    else:  # queries are the pixels; taps within max_offset level pixels
        from partdistillation_torch.models.pixel_decoder import _reference_points
        ref = _reference_points(spatial_shapes).numpy()  # (S, L, 2)
        size = np.array([[w_, h_] for h_, w_ in spatial_shapes], np.float64)
        off = rng.uniform(-max_offset, max_offset, size=(b, s, m, lv, p, 2)) / size[:, None]
        loc = ref[None, :, None, :, None, :] + off
    return value, loc.astype(np.float32), weights


def test_msda_matches_take():
    shapes = ((6, 5), (3, 3), (2, 1))
    value, loc, weights = _msda_inputs(np.random.default_rng(6), shapes)
    ref = j_msda(jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(weights),
                 mode="take")
    out = ms_deform_attn(_t(value), shapes, _t(loc), _t(weights))
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


def test_msda_matches_banded_inside_radius():
    shapes = ((12, 4), (6, 2), (3, 1))
    value, loc, weights = _msda_inputs(np.random.default_rng(7), shapes, max_offset=1.0)
    banded = jax.jit(lambda v, l, w: j_msda(v, shapes, l, w, mode="banded", band_radius=2,
                                            band_tile_queries=8))
    ref = banded(jnp.asarray(value), jnp.asarray(loc), jnp.asarray(weights))
    out = ms_deform_attn(_t(value), shapes, _t(loc), _t(weights))
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


def test_instance_post_matches_jax():
    rng = np.random.default_rng(8)
    k, t, hw = 6, 3, (12, 10)
    logits = rng.normal(size=(k,) + hw).astype(np.float32) * 3
    scores = rng.random(k).astype(np.float32)
    valid = rng.random(k) < 0.8
    gt = rng.random((t,) + hw) < 0.4
    gt_valid = np.array([True, True, False])
    labels = np.arange(t, dtype=np.int32) + 5

    seg_j, obj_j, val_j = jip.unique_assignment(jnp.asarray(logits), jnp.asarray(scores),
                                                jnp.asarray(valid))
    seg, obj, val = pip.unique_assignment(_t(logits), _t(scores), _t(valid))
    np.testing.assert_array_equal(seg.numpy(), np.asarray(seg_j))
    np.testing.assert_array_equal(obj.numpy(), np.asarray(obj_j))
    np.testing.assert_array_equal(val.numpy(), np.asarray(val_j))
    for ratio in (0.05, 0.9):
        np.testing.assert_array_equal(
            pip.conditional_ratio_filter(seg, val, obj, ratio).numpy(),
            np.asarray(jip.conditional_ratio_filter(seg_j, val_j, obj_j, ratio)))
    for ms in (0.3, 2.0):
        np.testing.assert_array_equal(
            pip.conditional_score_filter(_t(scores), val, ms).numpy(),
            np.asarray(jip.conditional_score_filter(jnp.asarray(scores), val_j, ms)))
    np.testing.assert_allclose(pip.mask_iou_matrix(seg, _t(gt)).numpy(),
                               np.asarray(jip.mask_iou_matrix(seg_j, jnp.asarray(gt))), **TOL)
    out = pip.match_gt_top1(seg, val, _t(gt), _t(labels), _t(gt_valid))
    ref = jip.match_gt_top1(seg_j, val_j, jnp.asarray(gt), jnp.asarray(labels),
                            jnp.asarray(gt_valid))
    for a, r in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    np.testing.assert_array_equal(pip.as_bool_mask(_t(gt.astype(np.float32))).numpy(), gt)


def test_position_encoding_matches_jax():
    from partdistillation_tpu.models.position_encoding import position_embedding_sine as jpe
    from partdistillation_torch.models.position_encoding import position_embedding_sine
    np.testing.assert_allclose(position_embedding_sine(5, 7, 16).numpy(),
                               np.asarray(jpe(5, 7, 16)), **TOL)
