"""The supervised ablation's model on the CPU against the JAX package: the
train step's loss (the criterion's random point mode at the JAX default
ratio 0.75) with and without ``class_agnostic_learning``, and inference with
and without ``class_agnostic_inference`` and the unique per-pixel
assignment, on the tiny segmenter of ``--tiny`` with the JAX package's
initialisation carried across by ``state_dict_from_flax``.

The JAX loss draws its points from a key; the port takes them as input, from
the same key splits (``_random_noise`` of the criterion tests). Tolerances:
f32; losses within 1e-5 relative; masks, labels and validity equal, scores
within 1e-5.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice13_criterion import _random_noise

from partdistillation_tpu import run as jcli
from partdistillation_tpu.losses.criterion import CriterionConfig as JCrit
from partdistillation_tpu.losses.matcher import MatcherConfig as JMatch
from partdistillation_tpu.models.meta_arch import supervised as jsup
from partdistillation_tpu.models.meta_arch.proposal import normalize_images
from partdistillation_tpu.models.segmenter import MaskFormerSegmenter as JSeg
from partdistillation_torch import run as pcli
from partdistillation_torch.losses.criterion import CriterionConfig
from partdistillation_torch.losses.matcher import MatcherConfig
from partdistillation_torch.models.meta_arch import supervised as psup
from partdistillation_torch.models.segmenter import MaskFormerSegmenter
from partdistillation_torch.utils.convert_weights import state_dict_from_flax

N_CLS, Q, B, T, SIZE, POINTS = 5, 8, 2, 5, 64, 256


@functools.lru_cache(maxsize=None)
def _models(classes):
    """(JAX config, JAX params, port config, port model) for a head of
    ``classes`` classes."""
    jseg = jcli._segmenter_cfg(True, num_classes=classes, num_queries=Q)
    params = jax.jit(JSeg(jseg).init)(jax.random.PRNGKey(0),
                                      normalize_images(jnp.zeros((1, SIZE, SIZE, 3))))
    params = jax.tree_util.tree_map(np.asarray, params)
    pseg = pcli._segmenter_cfg(True, num_classes=classes, num_queries=Q)
    model = MaskFormerSegmenter(pseg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    jcfg = jsup.SupervisedModelConfig(
        segmenter=jseg, num_part_classes=N_CLS, test_topk=Q,
        criterion=JCrit(num_classes=classes, num_points=POINTS,
                        matcher=JMatch(num_points=POINTS)))
    pcfg = psup.SupervisedModelConfig(
        segmenter=pseg, num_part_classes=N_CLS, test_topk=Q,
        criterion=CriterionConfig(num_classes=classes, num_points=POINTS,
                                  importance_sample_ratio=0.75,
                                  matcher=MatcherConfig(num_points=POINTS)))
    return jcfg, params, pcfg, model


def _batch(seed):
    rng = np.random.default_rng(seed)
    image = rng.uniform(0, 255, (B, SIZE, SIZE, 3)).astype(np.float32)
    masks = np.zeros((B, T, SIZE, SIZE), bool)
    for b in range(B):
        for t in range(T):
            y, x = rng.integers(0, SIZE - 20, 2)
            masks[b, t, y:y + rng.integers(8, 20), x:x + rng.integers(8, 20)] = True
    valid = np.ones((B, T), bool)
    valid[1, 3:] = False
    object_mask = masks.any(1)
    return {"image": image, "masks": masks, "labels": rng.integers(0, N_CLS, (B, T)),
            "valid": valid, "object_mask": object_mask}


@pytest.mark.parametrize("classes,agnostic", [(N_CLS, False), (N_CLS, True), (1, True)],
                         ids=["5-class", "5-class-agnostic", "1-class-agnostic"])
def test_supervised_loss_matches_jax(classes, agnostic):
    jcfg, params, pcfg, model = _models(classes)
    jcfg = dataclasses.replace(jcfg, class_agnostic_learning=agnostic)
    pcfg = dataclasses.replace(pcfg, class_agnostic_learning=agnostic)
    batch = _batch(1)
    key = jax.random.PRNGKey(5)
    jtotal, jlosses = jax.jit(jsup.make_loss_fn(jcfg))(
        params, {k: jnp.asarray(batch[k]) for k in ("image", "masks", "labels", "valid")}, key)
    _, k_crit = jax.random.split(key)
    layers = pcfg.segmenter.supervised_layers
    noise = _random_noise(k_crit, layers, B, T, jcfg.criterion)
    loss_fn = psup.make_loss_fn(pcfg, model, device="cpu")
    noise["drop_keep"] = loss_fn.draw_noise(batch, torch.Generator().manual_seed(0))["drop_keep"]
    assert noise["drop_keep"].all()  # the tiny trunk has no DropPath
    assert noise["point_pool"].shape == (layers, B, T, 3 * POINTS, 2)
    total, losses = loss_fn(batch, noise)
    assert set(losses) == set(jlosses) and len(losses) == 3 * layers
    for name, val in losses.items():
        np.testing.assert_allclose(val.item(), float(jlosses[name]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)


def test_draw_noise_follows_the_point_modes():
    _, _, pcfg, model = _models(N_CLS)
    batch = _batch(2)
    g = torch.Generator().manual_seed(0)
    layers = pcfg.segmenter.supervised_layers
    for ratio, mode, keys in ((0.75, "auto", {"point_pool", "point_fresh"}),
                              (0.0, "auto", {"point_jitter"}),
                              (0.0, "random", {"point_fresh"}),
                              (0.5, "grid", set())):
        cfg = dataclasses.replace(pcfg, criterion=dataclasses.replace(
            pcfg.criterion, importance_sample_ratio=ratio, point_mode=mode,
            matcher=MatcherConfig(num_points=64, point_mode="random")))
        noise = psup.make_loss_fn(cfg, model, device="cpu").draw_noise(batch, g)
        assert set(noise) == {"drop_keep", "match_points"} | keys
        assert noise["match_points"].shape == (layers, B, 64, 2)
        if "point_fresh" in keys:
            assert noise["point_fresh"].shape == (layers, B, T, POINTS - int(ratio * POINTS), 2)


@pytest.mark.parametrize("classes", [N_CLS, 1], ids=["5-class", "1-class"])
@pytest.mark.parametrize("agnostic,unique", [(False, True), (False, False), (True, True),
                                             (True, False)])
def test_supervised_inference_matches_jax(classes, agnostic, unique):
    jcfg, params, pcfg, model = _models(classes)
    changes = dict(class_agnostic_inference=agnostic, use_unique_per_pixel_label=unique)
    jcfg, pcfg = (dataclasses.replace(c, **changes) for c in (jcfg, pcfg))
    batch = _batch(3)
    want = jax.jit(jsup.make_inference_fn(jcfg))(
        params, {"image": jnp.asarray(batch["image"]),
                 "object_mask": jnp.asarray(batch["object_mask"])})
    got = psup.make_inference_fn(pcfg, model, device="cpu")(
        {"image": batch["image"], "object_mask": batch["object_mask"]})
    assert got.keys() == want.keys()
    width = N_CLS if unique else min(Q, Q * jcfg.criterion.num_classes if not agnostic else Q)
    assert got["pred_masks"].shape == (B, width, SIZE, SIZE)
    for key in ("pred_masks", "pred_labels", "valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0,
                               atol=1e-5)
    assert got["valid"].any()


def test_supervised_entry_points_default_to_cuda(monkeypatch):
    """Without a card, the loss, the inference function and the CLIs raise
    unless told ``cpu``; the CLIs' ``--device`` defaults to ``cuda``."""
    _, _, pcfg, model = _models(N_CLS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        psup.make_loss_fn(pcfg, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        psup.make_inference_fn(pcfg, model)
    for cmd in ("train-supervised", "eval-supervised"):
        args = pcli.build_parser().parse_args([cmd])
        assert args.device == "cuda" and args.eval_dataset == "part_imagenet"
        assert (args.pixel_decoder, args.decoder, args.num_part_classes) == \
            ("msdeform", "multi_scale", 40)
