"""The port's dense CRF (``partdistillation_torch/ops/dense_crf.py``) against
the JAX package's on the CPU, in f32, on inputs made from numpy seeds, at the
reference parameters, the in-training variant (t = 5, bilateral sxy 5),
stride 1, the default stride (4 at sxy 20), a stride of 3 on an odd H x W
that needs padding, and the 5-D grid; with the couplings weakened so that Q
is not saturated, too.

The tolerance on Q is 1e-5 plus the f32 resolution of the logits. The logits
reach L = max |U| + w_g max G[1] + w_b max B[1] (4860 at the reference
parameters, where one f32 ulp is 4.9e-4), and a probability q moves by
q (1 - q) times a logit's error, so a pixel's allowance is
1e-5 + 4 eps L q (1 - q) (eps = 2^-23) for one mean-field step and n times
that after n steps. Measured over seeds 0-7 the port used at most a quarter
(one step) and a third (ten steps) of it; where Q saturates the allowance is
1e-5. Then:

- each of the first four mean-field steps, from JAX's Q after n - 1 steps,
  against JAX's Q after n (``mean_field_step``);
- ``dense_crf`` end to end, and its labels equal wherever JAX's top-two
  probability margin is >= 1e-5;
- ``gaussian_blur``, ``unary_from_masks``, ``bilateral_filter_conv`` and
  ``bilateral_filter`` alone (within 1e-6 of their largest value);
- a batch of two images equals the two images one at a time;
- against the f64 brute-force mean field of ``tests/test_dcrf_golden.py``
  (imported unchanged) at 48 x 48: the refined labels' IoU >= 0.9, as the
  JAX package's golden test holds its own solver.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_dcrf_golden import _scene, exact_mean_field

from partdistillation_tpu.ops import dense_crf as jcrf
from partdistillation_torch.ops import dense_crf as pcrf

WEAK = {"gauss_compat": 0.05, "bilateral_compat": 0.002}  # Q far from saturation
CASES = {
    "reference": ((48, 48), {}),
    "in_training": ((40, 40), {"iters": 5, "bilateral_sxy": 5.0}),
    "stride1": ((32, 32), {"bilateral_stride": 1, "bilateral_sxy": 8.0}),
    "default_stride_weak": ((64, 64), WEAK),
    "odd_padded_stride3": ((37, 29), {"bilateral_stride": 3, "bilateral_sxy": 8.0}),
    "odd_padded_weak": ((45, 53), WEAK),
    "grid": ((32, 32), {"bilateral_impl": "grid", "iters": 3}),
    "grid_weak": ((24, 28), {"bilateral_impl": "grid", "iters": 3, **WEAK}),
}


def _inputs(h, w, seed, t=3):
    """A noisy image with a coloured object and t random box masks, the last
    one invalid."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 255, (h, w, 3)).astype(np.float32)
    img[h // 4:3 * h // 4, w // 5:4 * w // 5] = np.clip(
        [200, 60, 40] + 12 * rng.randn(3 * h // 4 - h // 4, 4 * w // 5 - w // 5, 3), 0, 255)
    masks = np.zeros((t, h, w), bool)
    for i in range(t):
        y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        masks[i, y0:y0 + h // 2, x0:x0 + w // 3] = True
    valid = np.array([True] * (t - 1) + [False])
    return img, masks, valid


def _params(kw):
    return jcrf.DenseCRFParams(**kw), pcrf.DenseCRFParams(**kw)


EPS = 2.0 ** -23
STEPS = 4  # mean-field steps checked one at a time


def _logit_scale(img, unary, jp):
    """L: the largest logit magnitude a mean-field step can produce."""
    ones = jnp.ones(img.shape[:2] + (1,))
    if jp.bilateral_impl == "conv":
        b1 = jcrf.bilateral_filter_conv(jnp.asarray(img), ones, jp.bilateral_sxy,
                                        jp.bilateral_srgb, jp.bilateral_stride)
    else:
        b1 = jcrf.bilateral_filter(jnp.asarray(img), ones, jp.bilateral_sxy, jp.bilateral_srgb)
    g1 = jcrf.gaussian_blur(ones, jp.gauss_sxy)
    return (float(np.abs(unary).max()) + jp.gauss_compat * float(np.max(g1))
            + jp.bilateral_compat * float(np.max(b1)))


def _allowance(q, scale, steps):
    return 1e-5 + 4 * steps * EPS * scale * q * (1 - q)


def _case(case, seed):
    (h, w), kw = CASES[case]
    jp, pp = _params(kw)
    img, masks, valid = _inputs(h, w, seed)
    unary = np.array(jcrf.unary_from_masks(jnp.asarray(masks), jnp.asarray(valid), jp.gt_prob))
    return jp, pp, img, unary, _logit_scale(img, unary, jp)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_dense_crf_matches_jax(case, seed):
    jp, pp, img, unary, scale = _case(case, seed)
    want = np.asarray(jcrf.dense_crf(jnp.asarray(img), jnp.asarray(unary), jp))
    got = pcrf.dense_crf(torch.from_numpy(img)[None], torch.from_numpy(unary)[None], pp)[0]
    assert got.dtype == torch.float32 and got.shape == want.shape == img.shape[:2] + (4,)
    got = got.numpy()
    assert (np.abs(got - want) <= _allowance(want, scale, jp.iters)).all(), \
        np.abs(got - want).max()
    top2 = np.sort(want, -1)[..., -2:]
    resolved = top2[..., 1] - top2[..., 0] >= 1e-5
    np.testing.assert_array_equal(got.argmax(-1)[resolved], want.argmax(-1)[resolved])
    if "weak" in case:  # the comparison sees probabilities, not one-hots
        assert (want * (1 - want)).max() > 0.2


@pytest.mark.parametrize("case", list(CASES))
def test_mean_field_step_matches_jax(case):
    jp, pp, img, unary, scale = _case(case, 0)
    bilat = pcrf.bilateral_message_fn(torch.from_numpy(img)[None], pp)
    log_unary = -torch.from_numpy(unary)[None]
    prev = None
    for n in range(STEPS + 1):
        want = np.array(jcrf.dense_crf(jnp.asarray(img), jnp.asarray(unary),
                                       dataclasses.replace(jp, iters=n)))
        if prev is not None:
            got = pcrf.mean_field_step(torch.from_numpy(prev)[None], log_unary, bilat, pp)
            diff = np.abs(got[0].numpy() - want)
            assert (diff <= _allowance(want, scale, 1)).all(), (n, diff.max())
        prev = want


def test_dense_crf_batch_equals_single_images():
    jp, pp = _params({})
    pairs = [_inputs(40, 48, s) for s in (1, 2)]
    img = torch.from_numpy(np.stack([p[0] for p in pairs]))
    unary = pcrf.unary_from_masks(torch.from_numpy(np.stack([p[1] for p in pairs])),
                                  torch.from_numpy(np.stack([p[2] for p in pairs])), pp.gt_prob)
    both = pcrf.dense_crf(img, unary, pp)
    for i in range(2):
        one = pcrf.dense_crf(img[i:i + 1], unary[i:i + 1], pp)[0]
        np.testing.assert_allclose(both[i].numpy(), one.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_unary_from_masks_matches_jax(seed):
    _, masks, valid = _inputs(20, 24, seed, t=4)
    want = np.asarray(jcrf.unary_from_masks(jnp.asarray(masks), jnp.asarray(valid), 0.7))
    got = pcrf.unary_from_masks(torch.from_numpy(masks)[None], torch.from_numpy(valid)[None],
                                0.7)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    # float masks threshold at 0.5, as the JAX function's
    got_f = pcrf.unary_from_masks(torch.from_numpy(masks.astype(np.float32))[None],
                                  torch.from_numpy(valid)[None], 0.7)[0]
    np.testing.assert_array_equal(got_f.numpy(), got.numpy())


@pytest.mark.parametrize("sigma,normalize", [(3.0, False), (1.5, True)])
def test_gaussian_blur_matches_jax(sigma, normalize):
    v = np.random.RandomState(3).rand(23, 31, 5).astype(np.float32)
    want = np.asarray(jcrf.gaussian_blur(jnp.asarray(v), sigma, normalize))
    got = pcrf.gaussian_blur(torch.from_numpy(v)[None], sigma, normalize)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("hw,sxy,stride", [((64, 64), 20.0, None), ((45, 53), 20.0, None),
                                           ((40, 40), 5.0, 1), ((37, 29), 8.0, 3)])
def test_bilateral_filters_match_jax(hw, sxy, stride):
    rng = np.random.RandomState(4)
    img = rng.randint(0, 255, (*hw, 3)).astype(np.float32)
    v = rng.rand(*hw, 5).astype(np.float32)
    want = np.asarray(jcrf.bilateral_filter_conv(jnp.asarray(img), jnp.asarray(v), sxy, 13.0,
                                                 stride))
    got = pcrf.bilateral_filter_conv(torch.from_numpy(img)[None], torch.from_numpy(v)[None],
                                     sxy, 13.0, stride)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    want = np.asarray(jcrf.bilateral_filter(jnp.asarray(img), jnp.asarray(v), sxy, 13.0))
    got = pcrf.bilateral_filter(torch.from_numpy(img)[None], torch.from_numpy(v)[None], sxy,
                                13.0)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_default_stride_is_round_sxy_over_5():
    img = torch.zeros((1, 40, 40, 3))
    for sxy, stride in ((20.0, 4), (5.0, 1), (8.0, 2), (13.0, 3)):
        _, geom = pcrf._bilateral_conv_setup(img, sxy, 13.0)
        assert geom[4] == stride


def _iou(a, b):
    return np.logical_and(a, b).sum() / max(np.logical_or(a, b).sum(), 1)


@pytest.mark.parametrize("kw", [{}, {"iters": 5, "bilateral_sxy": 5.0}],
                         ids=["reference", "in_training"])
def test_dense_crf_near_exact_mean_field(kw):
    jp, pp = _params(kw)
    image, true_mask, noisy = _scene()
    unary = pcrf.unary_from_masks(torch.from_numpy(noisy)[None, None],
                                  torch.ones((1, 1), dtype=torch.bool), pp.gt_prob)
    q_exact = exact_mean_field(image, unary[0].numpy(), jp)
    lab_exact = q_exact.argmax(-1) == 1
    q = pcrf.dense_crf(torch.from_numpy(image)[None], unary, pp)[0].numpy()
    lab = q.argmax(-1) == 1
    assert _iou(lab_exact, true_mask) > max(_iou(noisy, true_mask), 0.95)
    assert _iou(lab, lab_exact) >= 0.9
    assert np.corrcoef(q[..., 1].ravel(), q_exact[..., 1].ravel())[0, 1] > 0.9


def test_unknown_bilateral_impl_raises():
    with pytest.raises(ValueError, match="bilateral_impl"):
        pcrf.dense_crf(torch.zeros((1, 8, 8, 3)), torch.zeros((1, 8, 8, 2)),
                       pcrf.DenseCRFParams(bilateral_impl="lattice"))
