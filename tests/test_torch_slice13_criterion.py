"""The criterion's importance-sampled point modes and the matcher's random
points on the CPU against the JAX package.

The JAX functions draw their points from keys; the port takes them as input,
so each test draws them from the same key splits (``_random_noise``) and
hands them over. Tolerances: f32; losses and gradients within 1e-5 (relative
to the largest value), assignments equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partdistillation_tpu.losses import criterion as jcrit
from partdistillation_tpu.losses import matcher as jmatch
from partdistillation_torch.losses.criterion import (CriterionConfig, importance_weights,
                                                     set_criterion, uncertain_points)
from partdistillation_torch.losses.matcher import MatcherConfig, hungarian_match, match_costs

T_ = torch.from_numpy


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-30))


def _outputs(rng, layers, b, q, k, h, w):
    outs = [{"pred_logits": rng.standard_normal((b, q, k + 1)).astype(np.float32),
             "pred_masks": (rng.standard_normal((b, q, h, w)) * 3).astype(np.float32)}
            for _ in range(layers)]
    return outs


def _targets(rng, b, t, size, k):
    masks = np.zeros((b, t, size, size), np.float32)
    for i in range(b):
        for j in range(t):
            y0, x0 = rng.integers(0, size // 2, 2)
            masks[i, j, y0:y0 + rng.integers(4, size // 2), x0:x0 + rng.integers(4, size // 2)] = 1
    valid = np.ones((b, t), bool)
    valid[0, -2:] = valid[1, -1] = False  # padded slots
    return {"labels": rng.integers(0, k, (b, t)).astype(np.int32), "masks": masks,
            "valid": valid}


def _random_noise(key, layers, b, t, cfg):
    """The points JAX's set_criterion draws in random mode: per layer
    (k_match, k_pts) = split(layer key); the matcher's points per image from
    split(k_match, B) (random matcher) or its jitter; per target key kk of
    split(k_pts, (B, T)), (k1, k2) = split(kk): the pool from k1, the fresh
    points from k2."""
    n_imp = int(cfg.importance_sample_ratio * cfg.num_points)
    n_over = int(cfg.num_points * cfg.oversample_ratio)
    match, pool, fresh = [], [], []
    for lk in jax.random.split(key, layers):
        k_match, k_pts = jax.random.split(lk)
        shape = (cfg.matcher.num_points, 2) if cfg.matcher.point_mode == "random" else (2,)
        match.append([np.asarray(jax.random.uniform(k, shape))
                      for k in jax.random.split(k_match, b)])
        keys = jax.random.split(k_pts, (b, t))
        pl, fr = [], []
        for i in range(b):
            for j in range(t):
                k1, k2 = jax.random.split(keys[i, j])
                pl.append(np.asarray(jax.random.uniform(k1, (n_over, 2))))
                fr.append(np.asarray(jax.random.uniform(k2, (cfg.num_points - n_imp, 2))))
        pool.append(np.stack(pl).reshape(b, t, n_over, 2))
        fresh.append(np.stack(fr).reshape(b, t, -1, 2))
    name = "match_points" if cfg.matcher.point_mode == "random" else "match_jitter"
    noise = {name: T_(np.asarray(match, np.float32)),
             "point_fresh": T_(np.asarray(fresh, np.float32))}
    if n_imp:
        noise["point_pool"] = T_(np.asarray(pool, np.float32))
    return noise


def _run_both(seed, jcfg, cfg, layers=3, b=2, q=10, t=4, k=3, h=12, size=24, noise_fn=None):
    """(port total, port losses, port mask-logit grads), (the same from JAX)."""
    rng = np.random.default_rng(seed)
    outs = _outputs(rng, layers, b, q, k, h, h)
    tg = _targets(rng, b, t, size, k)
    key = jax.random.PRNGKey(seed + 20)

    def jloss(masks):
        o = [{"pred_logits": jnp.asarray(x["pred_logits"]), "pred_masks": m}
             for x, m in zip(outs, masks)]
        total, losses = jcrit.set_criterion({**o[0], "aux_outputs": o[1:]},
                                            {k_: jnp.asarray(v) for k_, v in tg.items()},
                                            key, jcfg)
        return total, losses

    (jtotal, jlosses), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        [jnp.asarray(o["pred_masks"]) for o in outs])
    noise = (noise_fn or _random_noise)(key, layers, b, t, jcfg)
    masks = [T_(o["pred_masks"]).requires_grad_() for o in outs]
    po = [{"pred_logits": T_(o["pred_logits"]), "pred_masks": m} for o, m in zip(outs, masks)]
    targets = {"labels": T_(tg["labels"]).long(), "masks": T_(tg["masks"]),
               "valid": T_(tg["valid"])}
    total, losses = set_criterion({**po[0], "aux_outputs": po[1:]}, targets, noise, cfg)
    total.backward()
    return (total, losses, [m.grad.numpy() for m in masks]), (jtotal, jlosses, jgrads)


def _check(port, ref):
    total, losses, grads = port
    jtotal, jlosses, jgrads = ref
    assert set(losses) == set(jlosses)
    for name, val in losses.items():
        np.testing.assert_allclose(val.item(), float(jlosses[name]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    for g, jg in zip(grads, jgrads):
        _close(g, jg)


@pytest.mark.parametrize("seed,num_points,ratio", [(0, 64, 0.75), (1, 50, 0.75), (2, 40, 0.5)])
def test_random_point_mode_matches_jax(seed, num_points, ratio):
    jcfg = jcrit.CriterionConfig(num_classes=3, num_points=num_points,
                                 importance_sample_ratio=ratio,
                                 matcher=jmatch.MatcherConfig(num_points=num_points))
    assert jcfg.resolved_point_mode() == "random"
    cfg = CriterionConfig(num_classes=3, num_points=num_points, importance_sample_ratio=ratio,
                          matcher=MatcherConfig(num_points=num_points))
    assert cfg.resolved_point_mode() == "random"
    _check(*_run_both(seed, jcfg, cfg))


def test_random_point_mode_without_importance_matches_jax():
    """point_mode "random" at ratio 0: P fresh points, no pool."""
    jcfg = jcrit.CriterionConfig(num_classes=3, num_points=48, importance_sample_ratio=0.0,
                                 point_mode="random",
                                 matcher=jmatch.MatcherConfig(num_points=48))
    cfg = CriterionConfig(num_classes=3, num_points=48, point_mode="random",
                          matcher=MatcherConfig(num_points=48))
    port, ref = _run_both(3, jcfg, cfg)
    _check(port, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_matcher_with_random_points_matches_jax(seed):
    jcfg = jcrit.CriterionConfig(num_classes=3, num_points=64,
                                 matcher=jmatch.MatcherConfig(num_points=70,
                                                              point_mode="random"))
    cfg = CriterionConfig(num_classes=3, num_points=64, importance_sample_ratio=0.75,
                          matcher=MatcherConfig(num_points=70, point_mode="random"))
    _check(*_run_both(seed + 5, jcfg, cfg))


@pytest.mark.parametrize("seed,ratio", [(0, 0.75), (1, 0.25)])
def test_dense_importance_mode_matches_jax(seed, ratio):
    """"grid" with a ratio > 0: the weighted losses on the prediction's own
    grid, no point randomness beyond the matcher's jitter."""
    jcfg = jcrit.CriterionConfig(num_classes=3, num_points=60, importance_sample_ratio=ratio,
                                 point_mode="grid",
                                 matcher=jmatch.MatcherConfig(num_points=60))
    cfg = CriterionConfig(num_classes=3, num_points=60, importance_sample_ratio=ratio,
                          point_mode="grid", matcher=MatcherConfig(num_points=60))

    def jitter_only(key, layers, b, t, _):
        match = []
        for lk in jax.random.split(key, layers):
            k_match, _ = jax.random.split(lk)
            match.append([np.asarray(jax.random.uniform(k, (2,)))
                          for k in jax.random.split(k_match, b)])
        return {"match_jitter": T_(np.asarray(match, np.float32))}

    _check(*_run_both(seed + 7, jcfg, cfg, noise_fn=jitter_only))


def test_uncertain_points_keep_the_most_uncertain_pool_points():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 3, 9, 9)).astype(np.float32) * 4
    pool = rng.random((2, 3, 30, 2)).astype(np.float32)
    fresh = rng.random((2, 3, 5, 2)).astype(np.float32)
    got = uncertain_points(T_(logits), T_(pool), T_(fresh), 10).numpy()
    from partdistillation_tpu.ops.sampling import point_sample

    for i in range(2):
        for j in range(3):
            vals = np.asarray(point_sample(jnp.asarray(logits[i, j, ..., None]),
                                           jnp.asarray(pool[i, j])))[:, 0]
            _, idx = jax.lax.top_k(jnp.asarray(-np.abs(vals)), 10)
            np.testing.assert_array_equal(got[i, j, :10], pool[i, j][np.asarray(idx)])
            np.testing.assert_array_equal(got[i, j, 10:], fresh[i, j])


def test_importance_weights_bisection_matches_jax():
    rng = np.random.default_rng(5)
    unc = -np.abs(rng.standard_normal((4, 400)).astype(np.float32))
    unc[0, :50] = unc[0, 50]  # ties at the threshold
    got = importance_weights(T_(unc), 120, 0.1).numpy()
    for i in range(4):
        want = jcrit._importance_weights(jnp.asarray(unc[i]), 120, 0.1)
        np.testing.assert_array_equal(got[i], np.asarray(want))


def test_random_matcher_costs_and_assignment_match_jax():
    rng = np.random.default_rng(6)
    b, q, t, n_pts = 2, 12, 5, 100
    outs = _outputs(rng, 1, b, q, 3, 16, 16)[0]
    tg = _targets(rng, b, t, 32, 3)
    jcfg = jmatch.MatcherConfig(num_points=n_pts, point_mode="random")
    key = jax.random.PRNGKey(9)
    points = T_(np.stack([np.asarray(jax.random.uniform(k, (n_pts, 2)))
                          for k in jax.random.split(key, b)]))
    targets = {"labels": T_(tg["labels"]).long(), "masks": T_(tg["masks"]),
               "valid": T_(tg["valid"])}
    cfg = MatcherConfig(num_points=n_pts, point_mode="random")
    costs = match_costs(T_(outs["pred_logits"]), T_(outs["pred_masks"]), targets, points,
                        cfg).numpy()
    assert costs.shape == (b, t, q)
    ref = jmatch.hungarian_match({k: jnp.asarray(v) for k, v in outs.items()},
                                 {k: jnp.asarray(v) for k, v in tg.items()}, key, jcfg)
    idx = hungarian_match([{k: T_(v) for k, v in outs.items()}], targets, points[None], cfg)
    np.testing.assert_array_equal(idx[0].numpy()[tg["valid"]], np.asarray(ref)[tg["valid"]])
