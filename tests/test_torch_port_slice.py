"""The slice end to end on the CPU: the JAX ProposalModel inference and the
port's ``make_inference_fn`` on a tiny configuration, same weights (JAX init
carried by ``state_dict_from_flax``), same batch.

Tolerances: pred_logits / pred_masks before post-processing 1e-4; scores
1e-5; boolean pred_masks agree on >= 99.9% of pixels; valid and matched_gt
equal on this seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partdistillation_tpu.models import segmenter as jseg
from partdistillation_tpu.models.meta_arch import proposal as jprop
from partdistillation_tpu.models.pixel_decoder import PixelDecoderConfig as JPD
from partdistillation_tpu.models.swin import SwinConfig as JSwin
from partdistillation_tpu.models.transformer_decoder import TransformerDecoderConfig as JTD
from partdistillation_torch.evaluation.proposal_evaluator import ProposalEvaluator
from partdistillation_torch.models import segmenter as pseg
from partdistillation_torch.models.meta_arch import proposal as pprop
from partdistillation_torch.models.pixel_decoder import PixelDecoderConfig
from partdistillation_torch.models.swin import SwinConfig
from partdistillation_torch.models.transformer_decoder import TransformerDecoderConfig
from partdistillation_torch.utils.convert_weights import state_dict_from_flax

SW = dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), window_size=4)
PD = dict(conv_dim=32, mask_dim=32, transformer_layers=1, transformer_ffn_dim=64, n_heads=4,
          n_points=2)
TD = dict(num_classes=1, hidden_dim=32, num_queries=8, num_heads=4, dim_feedforward=64,
          dec_layers=2, mask_dim=32)


def _batch(rng, b=2, size=64, parts=4):
    images = rng.integers(0, 256, (b, size, size, 3)).astype(np.uint8)
    part_masks = np.zeros((b, parts, size, size), bool)
    object_masks = np.zeros((b, 1, size, size), bool)
    for i in range(b):
        y0, x0 = rng.integers(0, 16, 2)
        object_masks[i, 0, y0:y0 + 40, x0:x0 + 44] = True
        for k in range(parts):
            part_masks[i, k, y0 + 10 * k:y0 + 10 * (k + 1), x0:x0 + 44] = True
    return {"image": images, "part_masks": part_masks,
            "part_labels": np.arange(parts, dtype=np.int32)[None].repeat(b, 0),
            "part_valid": np.array([[True] * (parts - 1) + [False]] * b),
            "object_masks": object_masks, "object_valid": np.ones((b, 1), bool)}


@pytest.fixture(scope="module")
def case():
    jcfg = jprop.ProposalModelConfig(
        segmenter=jseg.SegmenterConfig(
            swin=JSwin(**SW, drop_path_rate=0.0),
            pixel_decoder=JPD(**PD, msda_mode="banded", msda_band_radius=4),
            decoder=JTD(**TD)),
        test_topk=8)
    rng = np.random.default_rng(0)
    batch = _batch(rng)
    jmodel = jseg.MaskFormerSegmenter(jcfg.segmenter)
    images = jprop.normalize_images(jnp.asarray(batch["image"]))
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0), images))
    # random sampling-offset kernels so the deformable gather moves off the grid
    leaf = params["params"]["pixel_decoder"]["layer0"]["self_attn"]["sampling_offsets"]
    leaf["kernel"] = (rng.normal(size=leaf["kernel"].shape) * 0.05).astype(np.float32)

    raw = jax.jit(jmodel.apply)(params, images)
    jout = jax.jit(jprop.make_inference_fn(jcfg))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})

    pcfg = pprop.ProposalModelConfig(
        segmenter=pseg.SegmenterConfig(swin=SwinConfig(**SW),
                                       pixel_decoder=PixelDecoderConfig(**PD),
                                       decoder=TransformerDecoderConfig(**TD)),
        test_topk=8)
    model = pseg.MaskFormerSegmenter(pcfg.segmenter, device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    infer = pprop.make_inference_fn(pcfg, model, device="cpu")
    pout = infer(batch)
    with torch.no_grad():
        praw = model(pprop.normalize_images(torch.from_numpy(batch["image"])))
    return batch, raw, jout, praw, pout, pcfg, jcfg, params, model


def test_segmenter_outputs_match(case):
    _, raw, _, praw, *_ = case
    for key in ("pred_logits", "pred_masks", "mask_features"):
        np.testing.assert_allclose(praw[key].numpy(), np.asarray(raw[key]),
                                   atol=1e-4, rtol=1e-4)
    for key, ref in raw["backbone_features"].items():
        np.testing.assert_allclose(praw["backbone_features"][key].numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=1e-4)


def test_inference_scores_and_masks_match(case):
    _, _, jout, _, pout, *_ = case
    assert set(pout) == set(jout)
    np.testing.assert_allclose(pout["scores"].numpy(), np.asarray(jout["scores"]),
                               atol=1e-5, rtol=1e-5)
    pm, jm = pout["pred_masks"].numpy(), np.asarray(jout["pred_masks"])
    assert pm.shape == jm.shape and pm.dtype == bool
    assert (pm == jm).mean() >= 0.999


def test_inference_valid_and_matches_equal(case):
    _, _, jout, _, pout, *_ = case
    for key in ("valid", "matched_gt", "pred_labels"):
        np.testing.assert_array_equal(pout[key].numpy(), np.asarray(jout[key]))
    assert pout["valid"].any()


def test_evaluator_matches_jax_evaluator(case):
    from partdistillation_tpu.evaluation.proposal_evaluator import (
        ProposalEvaluator as JEvaluator)

    batch, _, jout, _, pout, *_ = case
    ours, ref = ProposalEvaluator(limits=(1, 4, 8)), JEvaluator(limits=(1, 4, 8))
    ours.process({k: pout[k].numpy() for k in ("pred_masks", "scores", "valid")},
                 batch["part_masks"], batch["part_valid"])
    ref.process({k: np.asarray(jout[k]) for k in ("pred_masks", "scores", "valid")},
                batch["part_masks"], batch["part_valid"])
    assert ours.evaluate() == pytest.approx(ref.evaluate())


def test_inference_without_unique_assignment(case):
    batch, _, _, _, _, pcfg, *_ = case
    model = pseg.MaskFormerSegmenter(pcfg.segmenter, device="cpu", seed=1)
    cfg = dataclasses.replace(pcfg, use_unique_per_pixel_label=False, min_score=0.2)
    out = pprop.make_inference_fn(cfg, model, device="cpu")(batch)
    assert out["pred_masks"].shape == (2, 8, 64, 64)
    assert torch.isfinite(out["scores"]).all()


@pytest.mark.parametrize("options", [
    dict(use_unique_per_pixel_label=False, min_score=0.5),
    dict(apply_object_masking=False),
    dict(min_ratio=0.05, min_score=0.5),
], ids=["no_unique", "no_object_masking", "ratio_and_score_filters"])
def test_inference_options_match_jax(case, options):
    """The post-processing options off their defaults, JAX against port on
    the same weights and batch."""
    batch, _, _, _, _, pcfg, jcfg, params, model = case
    jout = jax.jit(jprop.make_inference_fn(dataclasses.replace(jcfg, **options)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    pout = pprop.make_inference_fn(dataclasses.replace(pcfg, **options), model,
                                   device="cpu")(batch)
    np.testing.assert_allclose(pout["scores"].numpy(), np.asarray(jout["scores"]),
                               atol=1e-5, rtol=1e-5)
    assert (pout["pred_masks"].numpy() == np.asarray(jout["pred_masks"])).mean() >= 0.999
    for key in ("valid", "matched_gt", "pred_labels"):
        np.testing.assert_array_equal(pout[key].numpy(), np.asarray(jout[key]))
