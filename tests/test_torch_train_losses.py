"""The train step's loss stack and optimizer on the CPU against the JAX
package: grid point sampling, the matcher's costs and assignments, the set
criterion over ten supervised layers with padded targets, the LSAP solver,
and the optimizer's parameter groups and AdamW updates.

The JAX functions draw their jitter from keys; the port takes it as input,
so each test draws it from the same key splits (``_jitter``) and hands it over.
Tolerances: f32; samples, costs and losses within 1e-5 (relative to the
largest value), assignments equal, updated parameters within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from partdistillation_tpu.engine import optim as joptim
from partdistillation_tpu.losses import criterion as jcrit
from partdistillation_tpu.losses import matcher as jmatch
from partdistillation_tpu.losses.lsap import solve_lsap as j_solve
from partdistillation_tpu.models import segmenter as jseg
from partdistillation_tpu.models.pixel_decoder import PixelDecoderConfig as JPD
from partdistillation_tpu.models.swin import SwinConfig as JSwin
from partdistillation_tpu.models.transformer_decoder import TransformerDecoderConfig as JTD
from partdistillation_tpu.ops import sampling as jsamp
from partdistillation_torch.engine.optim import (AdamW, OptimizerConfig, learning_rate,
                                                 param_label)
from partdistillation_torch.losses.criterion import CriterionConfig, set_criterion
from partdistillation_torch.losses.lsap import solve_lsap, solve_lsap_batch
from partdistillation_torch.losses.matcher import (MatcherConfig, grid_axes, hungarian_match,
                                                   match_costs)
from partdistillation_torch.models import segmenter as pseg
from partdistillation_torch.models.pixel_decoder import PixelDecoderConfig
from partdistillation_torch.models.swin import SwinConfig
from partdistillation_torch.models.transformer_decoder import TransformerDecoderConfig
from partdistillation_torch.ops import sampling as psamp
from partdistillation_torch.utils.convert_weights import state_dict_from_flax

T_ = torch.from_numpy


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-30))


def _jitter(key, layers, b, t):
    """The jitter JAX's set_criterion draws: per layer (k_match, k_pts) =
    split(layer key); one uniform pair per image from split(k_match, B) and
    per target from split(k_pts, (B, T))."""
    match, pts = [], []
    for lk in jax.random.split(key, layers):
        k_match, k_pts = jax.random.split(lk)
        match.append([np.asarray(jax.random.uniform(k, (2,))) for k in jax.random.split(k_match, b)])
        keys = jax.random.split(k_pts, (b, t))
        pts.append([[np.asarray(jax.random.uniform(keys[i, j], (2,))) for j in range(t)]
                    for i in range(b)])
    return T_(np.asarray(match, np.float32)), T_(np.asarray(pts, np.float32))


# ------------------------------------------------------------------ sampling


def test_grid_point_sample_and_point_sample_match_jax():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((13, 17, 3)).astype(np.float32)
    ys, xs = rng.random(9).astype(np.float32), rng.random(11).astype(np.float32)
    ref = jsamp.grid_point_sample(jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs))
    _close(psamp.grid_point_sample(T_(img), T_(ys), T_(xs)).numpy(), ref)
    coords = np.stack(np.meshgrid(xs, ys), -1)  # (Gy, Gx, 2) as (x, y)
    _close(psamp.point_sample(T_(img), T_(coords)).numpy(),
           jsamp.point_sample(jnp.asarray(img), jnp.asarray(coords)))
    out = rng.random((40, 2)).astype(np.float32) * 1.4 - 0.2  # taps outside the image
    _close(psamp.point_sample(T_(img), T_(out)).numpy(),
           jsamp.point_sample(jnp.asarray(img), jnp.asarray(out)))
    _close(psamp.separable_interp_weights(T_(ys), 13).numpy(),
           jsamp.separable_interp_weights(jnp.asarray(ys), 13))


def test_batched_grid_point_sample_is_per_item():
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 3, 10, 12, 1)).astype(np.float32)
    ys, xs = rng.random((2, 3, 5)).astype(np.float32), rng.random((2, 3, 7)).astype(np.float32)
    got = psamp.grid_point_sample(T_(img), T_(ys), T_(xs)).numpy()
    for i in range(2):
        for j in range(3):
            _close(got[i, j], jsamp.grid_point_sample(*(jnp.asarray(a[i, j]) for a in (img, ys, xs))))


def test_grid_axes_match_jax():
    key = jax.random.PRNGKey(4)
    for n in (12544, 100, 50):
        ys, xs = jmatch._grid_axes(key, n)
        pys, pxs = grid_axes(T_(np.array(jax.random.uniform(key, (2,)))), n)
        _close(pys.numpy(), ys)
        _close(pxs.numpy(), xs)


# ------------------------------------------------------------------ matcher + criterion


def _layer_outputs(rng, b, q, h, w):
    return {"pred_logits": rng.standard_normal((b, q, 2)).astype(np.float32),
            "pred_masks": (rng.standard_normal((b, q, h, w)) * 3).astype(np.float32)}


def _targets(rng, b, t, size):
    masks = np.zeros((b, t, size, size), np.float32)
    for i in range(b):
        for j in range(t):
            y0, x0 = rng.integers(0, size // 2, 2)
            masks[i, j, y0:y0 + rng.integers(4, size // 2), x0:x0 + rng.integers(4, size // 2)] = 1
    valid = np.ones((b, t), bool)
    valid[0, -2:] = valid[1, -1] = False  # padded slots
    return {"labels": np.zeros((b, t), np.int32), "masks": masks, "valid": valid}


def _torch_targets(tg):
    return {"labels": T_(tg["labels"]).long(), "masks": T_(tg["masks"]), "valid": T_(tg["valid"])}


def test_matcher_costs_and_assignments_match_jax():
    rng = np.random.default_rng(5)
    b, q, t, n_pts = 2, 12, 5, 100
    out = _layer_outputs(rng, b, q, 16, 16)
    tg = _targets(rng, b, t, 32)
    cfg, jcfg = MatcherConfig(num_points=n_pts), jmatch.MatcherConfig(num_points=n_pts)
    key = jax.random.PRNGKey(9)
    keys = jax.random.split(key, b)
    jitter = T_(np.stack([np.asarray(jax.random.uniform(k, (2,))) for k in keys]))
    got = match_costs(T_(out["pred_logits"]), T_(out["pred_masks"]), _torch_targets(tg),
                      jitter, cfg).numpy()
    for i in range(b):  # the cost _match_one assembles, from the JAX parts
        ys, xs = jmatch._grid_axes(keys[i], n_pts)
        pm = jnp.asarray(out["pred_masks"][i])
        pred = jsamp.grid_point_sample(pm.transpose(1, 2, 0), ys, xs).reshape(-1, q).T
        tgt = jsamp.grid_point_sample(jnp.asarray(tg["masks"][i]).transpose(1, 2, 0), ys, xs)
        tgt = tgt.reshape(-1, t).T
        prob = jax.nn.softmax(jnp.asarray(out["pred_logits"][i]), -1)[:, :1]
        cost = (5.0 * jmatch.batch_sigmoid_ce_cost(pred, tgt) - 2.0 * prob
                + 5.0 * jmatch.batch_dice_cost(pred, tgt))
        cost = jnp.where(jnp.asarray(tg["valid"][i])[None], cost, 1e4)
        _close(got[i], np.asarray(cost).T)
    ref = jax.jit(lambda o, t_, k: jmatch.hungarian_match(o, t_, k, jcfg))(
        {k: jnp.asarray(v) for k, v in out.items()}, {k: jnp.asarray(v) for k, v in tg.items()},
        key)
    idx = hungarian_match([{k: T_(v) for k, v in out.items()}], _torch_targets(tg),
                          jitter[None], cfg)
    valid = tg["valid"]
    np.testing.assert_array_equal(idx[0].numpy()[valid], np.asarray(ref)[valid])


def test_set_criterion_matches_jax_over_ten_layers():
    rng = np.random.default_rng(6)
    b, q, t, n_pts, layers = 2, 10, 4, 64, 10
    outs = [_layer_outputs(rng, b, q, 12, 12) for _ in range(layers)]
    tg = _targets(rng, b, t, 24)
    key = jax.random.PRNGKey(11)
    jcfg = jcrit.CriterionConfig(num_classes=1, num_points=n_pts, importance_sample_ratio=0.0,
                                 matcher=jmatch.MatcherConfig(num_points=n_pts))
    joutputs = {**{k: jnp.asarray(v) for k, v in outs[0].items()},
                "aux_outputs": [{k: jnp.asarray(v) for k, v in o.items()} for o in outs[1:]]}
    jtotal, jlosses = jax.jit(lambda o, t, k: jcrit.set_criterion(o, t, k, jcfg))(
        joutputs, {k: jnp.asarray(v) for k, v in tg.items()}, key)
    match_j, pts_j = _jitter(key, layers, b, t)
    cfg = CriterionConfig(num_classes=1, num_points=n_pts, matcher=MatcherConfig(num_points=n_pts))
    poutputs = {**{k: T_(v) for k, v in outs[0].items()},
                "aux_outputs": [{k: T_(v) for k, v in o.items()} for o in outs[1:]]}
    total, losses = set_criterion(poutputs, _torch_targets(tg),
                                  {"match_jitter": match_j, "point_jitter": pts_j}, cfg)
    assert set(losses) == set(jlosses) and len(losses) == 3 * layers
    for name, val in losses.items():
        np.testing.assert_allclose(val.item(), float(jlosses[name]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)


# ------------------------------------------------------------------ LSAP


@pytest.mark.parametrize("shape", [(1, 7), (5, 5), (8, 20), (8, 200)])
def test_lsap_matches_jax_and_scipy(shape):
    rng = np.random.default_rng(sum(shape))
    for _ in range(3):
        cost = rng.random(shape).astype(np.float32)  # continuous: tie-free
        got = solve_lsap(cost)
        np.testing.assert_array_equal(got, np.asarray(j_solve(jnp.asarray(cost))))
        rows, cols = linear_sum_assignment(cost)
        assert len(set(got.tolist())) == shape[0]
        np.testing.assert_allclose(cost[np.arange(shape[0]), got].sum(), cost[rows, cols].sum(),
                                   rtol=1e-6)


def test_lsap_with_constant_padded_rows():
    rng = np.random.default_rng(3)
    cost = rng.random((8, 30)).astype(np.float32)
    cost[5:] = 1e4  # padded targets
    got = solve_lsap_batch(cost[None])[0]
    np.testing.assert_array_equal(got[:5], np.asarray(j_solve(jnp.asarray(cost)))[:5])
    rows, cols = linear_sum_assignment(cost[:5])
    np.testing.assert_allclose(cost[np.arange(5), got[:5]].sum(), cost[rows, cols].sum(),
                               rtol=1e-6)
    with pytest.raises(ValueError):
        solve_lsap(cost.T)


# ------------------------------------------------------------------ optimizer

SW = dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), window_size=4)
PD = dict(conv_dim=32, mask_dim=32, transformer_layers=1, transformer_ffn_dim=64, n_heads=4,
          n_points=2)
TD = dict(num_classes=1, hidden_dim=32, num_queries=8, num_heads=4, dim_feedforward=64,
          dec_layers=2, mask_dim=32)


@pytest.fixture(scope="module")
def flax_params():
    model = jseg.MaskFormerSegmenter(jseg.SegmenterConfig(
        swin=JSwin(**SW), pixel_decoder=JPD(**PD), decoder=JTD(**TD)))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(params):
    model = pseg.MaskFormerSegmenter(pseg.SegmenterConfig(
        swin=SwinConfig(**SW), pixel_decoder=PixelDecoderConfig(**PD),
        decoder=TransformerDecoderConfig(**TD)), device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model


@pytest.mark.parametrize("freeze_keys", [(), ("backbone", "pixel_decoder")])
def test_parameter_groups_match_jax(flax_params, monkeypatch, freeze_keys):
    captured = {}
    real = optax.multi_transform

    def spy(transforms, labels, *args, **kwargs):
        captured["labels"] = labels
        return real(transforms, labels, *args, **kwargs)

    monkeypatch.setattr(optax, "multi_transform", spy)
    joptim.build_optimizer(joptim.OptimizerConfig(freeze_keys=freeze_keys), flax_params)
    # tag every flax leaf with its index, carry the tags across, read them back
    leaves, tree = jax.tree_util.tree_flatten(flax_params)
    tags = jax.tree_util.tree_unflatten(
        tree, [np.full(leaf.shape, i, np.float32) for i, leaf in enumerate(leaves)])
    jlabels = jax.tree_util.tree_leaves(captured["labels"])
    cfg = OptimizerConfig(freeze_keys=freeze_keys)
    model = _port_model(flax_params)
    seen = set()
    for name, tag in state_dict_from_flax(tags).items():
        ids = set(np.unique(tag.numpy()).astype(int).tolist())
        seen |= ids
        want = {jlabels[i] for i in ids}
        assert want == {param_label(name, model.get_parameter(name), cfg)}, name
    assert seen == set(range(len(leaves)))


@pytest.mark.parametrize("step", [0, 9, 10, 39999, 40000, 44999, 45000, 50000])
def test_learning_rate_matches_jax_schedule(step):
    want = float(joptim.build_schedule(joptim.OptimizerConfig())(step))
    np.testing.assert_allclose(learning_rate(step), want, rtol=1e-6)


def test_adamw_two_steps_match_optax(flax_params):
    """Two clipped AdamW updates over frozen, backbone and head parameters
    (one Swin block, one pixel-decoder projection, one decoder layer and the
    query / level embeddings): the first with gradients above the clip norm,
    the second below it."""
    p = flax_params["params"]
    pred = p["predictor"]
    sub = {"params": {"backbone": {"stage0_block0": p["backbone"]["stage0_block0"]},
                      "pixel_decoder": {"input_proj0": p["pixel_decoder"]["input_proj0"]},
                      "predictor": {k: pred[k] for k in ("layer0", "query_feat", "query_embed",
                                                         "level_embed", "class_embed")}}}
    tx = joptim.build_optimizer(joptim.OptimizerConfig(freeze_keys=("pixel_decoder",)), sub)
    state, update = tx.init(sub), jax.jit(tx.update)
    params = {n: torch.nn.Parameter(t) for n, t in state_dict_from_flax(sub).items()}
    opt = AdamW(params.items(), OptimizerConfig(freeze_keys=("pixel_decoder",)))
    assert set(opt.labels.values()) == {"frozen", "backbone_decay", "backbone_nodecay",
                                        "head_decay", "head_nodecay"}
    rng = np.random.default_rng(8)
    jparams = sub
    for scale in (1.0, 1e-5):
        grads = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32), sub)
        updates, state = update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, g in state_dict_from_flax(grads).items():
            params[name].grad = g
        norm = opt.step()
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)), rtol=1e-6)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    start = state_dict_from_flax(sub)
    for name, w in want.items():
        np.testing.assert_allclose(params[name].detach().numpy(), w.numpy(), rtol=0, atol=1e-6)
        moved = not torch.equal(params[name].detach(), start[name])
        assert moved == (opt.labels[name] != "frozen"), name
