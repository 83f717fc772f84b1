"""Stage 5 on the CPU: the port's part-distillation head, loss, train step
and inference against the JAX package's, at a tiny size (hidden 32, two
decoder layers, 16 object classes x 4 parts), weights carried by
``state_dict_from_flax`` (one way: the JAX package's own bridge,
``convert_mask2former_state_dict``, does not map the part head).

- The head against both of JAX's ``head_slice`` forms ("gather" and
  "onehot"), logits and every gradient, at B = 3 with two images of one
  class (the gather's backward adds into shared rows);
- the stage-5 loss and one ``Trainer.train_step`` with the trunk frozen and
  DropPath 0.3 against JAX's on the same weights, batch and randomness (the
  noise as ``tests/test_torch_train_step.py`` draws it from JAX's key);
- ``make_inference_fn`` in ``save`` mode, and in ``eval`` mode with a
  mapping whose ids stay below num_parts, against JAX, once per off-default
  ``PartDistillationConfig`` option;
- eval mode with mapped ids >= num_parts, where JAX merges over
  [0, num_parts) and drops them and the port merges over the GT label space
  and keeps them (the repair);
- ``merge_by_class`` against JAX's.

Tolerances (f32): values within 1e-5 of max |JAX|, gradients within 1e-4
of max |JAX grad|; losses 1e-5 relative; updated parameters 1e-6; boolean
masks on >= 99.9 % of pixels; labels and validity equal on these seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import _drop_keep, _jitter

from partdistillation_tpu.engine.optim import OptimizerConfig as JOpt
from partdistillation_tpu.engine.trainer import Trainer as JTrainer
from partdistillation_tpu.losses.criterion import CriterionConfig as JCrit
from partdistillation_tpu.losses.matcher import MatcherConfig as JMatch
from partdistillation_tpu.models import segmenter as jseg
from partdistillation_tpu.models.meta_arch import part_distillation as jpd
from partdistillation_tpu.models.meta_arch.proposal import normalize_images as jnorm
from partdistillation_tpu.models.pixel_decoder import PixelDecoderConfig as JPDC
from partdistillation_tpu.models.swin import SwinConfig as JSwin
from partdistillation_tpu.models.transformer_decoder import (
    PartDistillationTransformerDecoder as JDecoder,
)
from partdistillation_tpu.models.transformer_decoder import TransformerDecoderConfig as JTD
from partdistillation_tpu.ops import instance_post as jpost
from partdistillation_torch.engine.optim import OptimizerConfig
from partdistillation_torch.engine.trainer import Trainer
from partdistillation_torch.losses.criterion import CriterionConfig
from partdistillation_torch.losses.matcher import MatcherConfig
from partdistillation_torch.models import segmenter as pseg
from partdistillation_torch.models.meta_arch import part_distillation as ppd
from partdistillation_torch.models.pixel_decoder import PixelDecoderConfig
from partdistillation_torch.models.swin import SwinConfig
from partdistillation_torch.models.transformer_decoder import (
    PartDistillationTransformerDecoder,
    TransformerDecoderConfig,
)
from partdistillation_torch.ops import instance_post as ppost
from partdistillation_torch.utils.convert_weights import state_dict_from_flax

NUM_OBJ, P = 16, 4
SW = dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), window_size=4)
PD = dict(conv_dim=32, mask_dim=32, transformer_layers=1, transformer_ffn_dim=64, n_heads=4,
          n_points=2)
TD = dict(num_classes=P, hidden_dim=32, num_queries=8, num_heads=4, dim_feedforward=64,
          dec_layers=2, mask_dim=32, num_object_classes=NUM_OBJ, num_parts=P)
POINTS, SEED = 64, 3
FREEZE_KEYS = ("backbone", "pixel_decoder")
HEAD = "sem_seg_head.predictor.part_class_embed."


def _close(got, want, rel, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale, err_msg=msg)


# ---------------------------------------------------------------- the head


def _decoder_inputs(b=3):
    rng = np.random.RandomState(0)
    ms = [rng.randn(b, 8, 8, 32).astype(np.float32), rng.randn(b, 4, 4, 32).astype(np.float32),
          rng.randn(b, 2, 2, 32).astype(np.float32)]
    mf = rng.randn(b, 16, 16, 32).astype(np.float32)
    goc = np.array([3, NUM_OBJ - 1, 3][:b], np.int32)  # two images of one class, the last class
    return ms, mf, goc, rng.randn(b, 8, 16, 16).astype(np.float32)


def _decoder_loss_terms(out, mask_weight):
    """Every layer's logits squared and its mask logits against a fixed
    weight, so that every parameter gets a gradient."""
    layers = [out] + list(out["aux_outputs"])
    return [(o["pred_logits"] ** 2).sum() + (o["pred_masks"] * mask_weight).sum()
            for o in layers]


@pytest.fixture(scope="module")
def head_case():
    ms, mf, goc, mw = _decoder_inputs()
    jms = [jnp.asarray(x) for x in ms]
    params = JDecoder(JTD(**TD)).init(jax.random.PRNGKey(0), jms, jnp.asarray(mf),
                                      gt_object_class=jnp.asarray(goc))
    params = jax.tree_util.tree_map(np.asarray, params)
    sd = state_dict_from_flax({"predictor": params["params"]})
    model = PartDistillationTransformerDecoder(TransformerDecoderConfig(**TD), 32)
    model.load_state_dict({k[len("sem_seg_head.predictor."):]: v for k, v in sd.items()},
                          strict=True)
    out = model([torch.from_numpy(x) for x in ms], torch.from_numpy(mf), torch.from_numpy(goc))
    sum(_decoder_loss_terms(out, torch.from_numpy(mw))).backward()
    grads = {f"sem_seg_head.predictor.{n}": p.grad.detach().clone()
             for n, p in model.named_parameters()}
    return dict(ms=jms, mf=jnp.asarray(mf), goc=jnp.asarray(goc), mw=jnp.asarray(mw),
                params=params, out=out, grads=grads, model=model)


@pytest.mark.parametrize("form", ["gather", "onehot"])
def test_head_matches_both_jax_forms(head_case, form, monkeypatch):
    monkeypatch.delenv("PD_HEAD_SLICE", raising=False)
    c = head_case
    jmodel = JDecoder(JTD(**TD, head_slice=form))

    def loss(p):
        out = jmodel.apply(p, c["ms"], c["mf"], gt_object_class=c["goc"])
        return sum(_decoder_loss_terms(out, c["mw"])), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(c["params"])
    for got, want in zip([c["out"]] + c["out"]["aux_outputs"],
                         [jout] + list(jout["aux_outputs"])):
        _close(got["pred_logits"].detach().numpy(), want["pred_logits"], 1e-5, "logits")
        _close(got["pred_masks"].detach().numpy(), want["pred_masks"], 1e-5, "masks")
    jgrads = state_dict_from_flax({"predictor": jax.tree_util.tree_map(
        np.asarray, jgrads)["params"]})
    assert set(jgrads) == set(c["grads"])
    for name, want in jgrads.items():
        _close(c["grads"][name].numpy(), want.numpy(), 1e-4, name)


def test_head_gradient_lives_in_the_batch_columns(head_case):
    """Rows of the batch's classes and the no-object row get a gradient,
    every other row none."""
    g = head_case["grads"][HEAD + "weight"]
    cols = head_case["model"].live_columns(torch.tensor(np.asarray(head_case["goc"])))
    live = torch.zeros(NUM_OBJ * P + 1, dtype=torch.bool)
    live[cols.flatten()] = True
    assert cols.tolist()[0] == [12, 13, 14, 15, NUM_OBJ * P]
    assert (g[live].abs().sum(1) > 0).all() and not g[~live].any()
    assert not head_case["grads"][HEAD + "bias"][~live].any()


def test_head_requires_the_object_class():
    ms, mf, _, _ = _decoder_inputs(2)
    model = PartDistillationTransformerDecoder(TransformerDecoderConfig(**TD), 32)
    with pytest.raises(ValueError, match="gt_object_class"):
        model([torch.from_numpy(x) for x in ms], torch.from_numpy(mf))
    with pytest.raises(ValueError, match="gt_object_class"):
        JDecoder(JTD(**TD)).init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in ms],
                                 jnp.asarray(mf))


def test_bridge_maps_the_head_transposed(head_case):
    p = head_case["params"]["params"]
    sd = state_dict_from_flax({"predictor": p})
    np.testing.assert_array_equal(sd[HEAD + "weight"].numpy(), p["part_class_kernel"].T)
    np.testing.assert_array_equal(sd[HEAD + "bias"].numpy(), p["part_class_bias"])
    assert not any("class_embed." in k and "part_class" not in k for k in sd)


@pytest.mark.parametrize("labels,num_classes", [([2, 11, 30, 2], 8), ([2, 11, 30, 2], 40),
                                                ([0, 1, 1, 3], 4)], ids=["8", "40", "dup"])
def test_merge_by_class_matches_jax(labels, num_classes):
    rng = np.random.default_rng(1)
    masks = rng.random((4, 12, 10)) > 0.6
    scores = rng.random(4).astype(np.float32)
    labels = np.array(labels, np.int32)
    valid = np.array([True, True, True, False])
    want = jpost.merge_by_class(jnp.asarray(masks), jnp.asarray(scores), jnp.asarray(labels),
                                jnp.asarray(valid), num_classes)
    got = ppost.merge_by_class(torch.from_numpy(masks), torch.from_numpy(scores),
                               torch.from_numpy(labels), torch.from_numpy(valid), num_classes)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[2].sum()) == len({l for l, v in zip(labels, valid) if v and l < num_classes})


# ---------------------------------------------------------------- loss and train step


def _train_batch(rng, b=3, t=4, size=64):
    masks = np.zeros((b, t, size, size), bool)
    for i in range(b):
        for j in range(t):
            y0, x0 = rng.integers(0, size // 2, 2)
            masks[i, j, y0:y0 + rng.integers(8, size // 2),
                  x0:x0 + rng.integers(8, size // 2)] = True
    valid = np.ones((b, t), bool)
    valid[0, -1] = valid[1, -2:] = False
    return {"image": rng.integers(0, 256, (b, size, size, 3)).astype(np.uint8),
            "masks": masks, "labels": rng.integers(0, P, (b, t)).astype(np.int32),
            "valid": valid, "gt_object_class": np.array([5, NUM_OBJ - 1, 5], np.int32)}


def _segmenter_cfgs(frozen=True, drop_path=0.3):
    j = jseg.SegmenterConfig(
        swin=JSwin(**SW, drop_path_rate=drop_path),
        pixel_decoder=JPDC(**PD, msda_mode="banded", msda_band_radius=4),
        decoder=JTD(**TD), freeze_backbone=frozen, freeze_pixel_decoder=frozen)
    p = pseg.SegmenterConfig(swin=SwinConfig(**SW, drop_path_rate=drop_path),
                             pixel_decoder=PixelDecoderConfig(**PD),
                             decoder=TransformerDecoderConfig(**TD), freeze_backbone=frozen,
                             freeze_pixel_decoder=frozen)
    return j, p


def _jax_params(jseg_cfg, images, goc, rng):
    jmodel = jseg.MaskFormerSegmenter(jseg_cfg)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), images, gt_object_class=jnp.asarray(goc)))
    # random sampling-offset kernels so the deformable gather moves off the grid
    leaf = params["params"]["pixel_decoder"]["layer0"]["self_attn"]["sampling_offsets"]
    leaf["kernel"] = (rng.normal(size=leaf["kernel"].shape) * 0.05).astype(np.float32)
    return jmodel, params


class _WithObjectClass:
    """The JAX segmenter with ``gt_object_class`` bound, for ``_drop_keep``."""

    def __init__(self, model, gt_object_class):
        self.model, self.gt_object_class = model, gt_object_class

    def apply(self, params, images, **kwargs):
        return self.model.apply(params, images, gt_object_class=self.gt_object_class, **kwargs)


@pytest.fixture(scope="module")
def step():
    rng = np.random.default_rng(0)
    batch = _train_batch(rng)
    jseg_cfg, pseg_cfg = _segmenter_cfgs()
    jcfg = jpd.PartDistillationConfig(
        segmenter=jseg_cfg, num_parts=P,
        criterion=JCrit(num_classes=P, num_points=POINTS, importance_sample_ratio=0.0,
                        matcher=JMatch(num_points=POINTS)))
    images = jnorm(jnp.asarray(batch["image"]))
    jmodel, params = _jax_params(jseg_cfg, images, batch["gt_object_class"], rng)
    init = state_dict_from_flax(params)

    loss_fn = jpd.make_loss_fn(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    trainer = JTrainer(loss_fn=loss_fn, init_params=params,
                       optimizer_cfg=JOpt(freeze_keys=FREEZE_KEYS), seed=SEED, donate=False)
    _, key = jax.random.split(trainer.state.rng)
    k_drop, k_crit = jax.random.split(key)
    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jbatch, key)
    jmetrics = trainer.train_step(jbatch)

    layers, (b, t) = 1 + TD["dec_layers"], batch["valid"].shape
    match_j, pts_j = _jitter(k_crit, layers, b, t)
    noise = {"drop_keep": torch.from_numpy(_drop_keep(
                 _WithObjectClass(jmodel, jbatch["gt_object_class"]), params, images, k_drop,
                 SW["depths"])),
             "match_jitter": match_j, "point_jitter": pts_j}

    pcfg = ppd.PartDistillationConfig(
        segmenter=pseg_cfg, num_parts=P,
        criterion=CriterionConfig(num_classes=P, num_points=POINTS,
                                  matcher=MatcherConfig(num_points=POINTS)))
    model = pseg.MaskFormerSegmenter(pcfg.segmenter, device="cpu")
    model.load_state_dict(init, strict=True)
    ptrainer = Trainer(ppd.make_loss_fn(pcfg, model, device="cpu"), model,
                       OptimizerConfig(freeze_keys=FREEZE_KEYS), device="cpu")
    grads, apply = {}, ptrainer.apply_gradients

    def apply_after_snapshot():  # the update clips the gradients in place
        grads.update({n: None if p.grad is None else p.grad.clone()
                      for n, p in model.named_parameters()})
        return apply()

    ptrainer.apply_gradients = apply_after_snapshot
    pmetrics = ptrainer.train_step(batch, noise)
    return dict(jmetrics=jmetrics, jlosses=jlosses, jgrads=state_dict_from_flax(jgrads),
                jparams=state_dict_from_flax(jax.tree_util.tree_map(
                    np.asarray, trainer.state.params)),
                pmetrics=pmetrics, model=model, grads=grads, init=init, noise=noise,
                batch=batch)


def test_stage5_losses_match_jax(step):
    assert not step["noise"]["drop_keep"].all()  # DropPath acts
    names = set(step["jlosses"]) | {"total_loss"}
    assert set(step["pmetrics"]) == names | {"grad_norm"} and len(step["jlosses"]) == 9
    for name in names:
        np.testing.assert_allclose(step["pmetrics"][name], float(step["jmetrics"][name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(step["pmetrics"]["grad_norm"],
                               float(step["jmetrics"]["grad_norm"]), rtol=1e-5)


def test_stage5_gradients_match_jax(step):
    for name, want in step["jgrads"].items():
        got = step["grads"][name]
        if name.startswith(("backbone.", "sem_seg_head.pixel_decoder.")):
            assert got is None and not want.any(), name
            continue
        _close(got.numpy(), want.numpy(), 1e-4, name)
    head = step["grads"][HEAD + "weight"]
    live = step["model"].sem_seg_head.predictor.live_columns(
        torch.from_numpy(step["batch"]["gt_object_class"])).unique()
    assert head.abs().sum(1).nonzero().flatten().tolist() == live.tolist()


def test_stage5_updated_parameters_match_jax(step):
    for name, p in step["model"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), step["jparams"][name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
        frozen = name.startswith(("backbone.", "sem_seg_head.pixel_decoder."))
        assert torch.equal(p.detach(), step["init"][name]) == frozen, name
    # weight decay moves every column of the head, live or not
    w = step["model"].get_parameter(HEAD + "weight").detach()
    assert (w != step["init"][HEAD + "weight"]).all(dim=1).all()


# ---------------------------------------------------------------- inference


def _infer_batch(rng, b=2, size=64, parts=4):
    images = rng.integers(0, 256, (b, size, size, 3)).astype(np.uint8)
    part_masks = np.zeros((b, parts, size, size), bool)
    object_masks = np.zeros((b, 1, size, size), bool)
    for i in range(b):
        y0, x0 = rng.integers(0, 16, 2)
        object_masks[i, 0, y0:y0 + 40, x0:x0 + 44] = True
        for k in range(parts):
            part_masks[i, k, y0 + 10 * k:y0 + 10 * (k + 1), x0:x0 + 44] = True
    return {"image": images, "gt_object_class": np.array([2, NUM_OBJ - 1], np.int32),
            "part_masks": part_masks,
            "part_labels": np.arange(parts, dtype=np.int32)[None].repeat(b, 0),
            "part_valid": np.array([[True] * (parts - 1) + [False]] * b),
            "object_masks": object_masks, "object_valid": np.ones((b, 1), bool)}


@pytest.fixture(scope="module")
def infer_case():
    rng = np.random.default_rng(0)
    batch = _infer_batch(rng)
    jseg_cfg, pseg_cfg = _segmenter_cfgs(frozen=False, drop_path=0.0)
    images = jnorm(jnp.asarray(batch["image"]))
    _, params = _jax_params(jseg_cfg, images, batch["gt_object_class"], rng)
    model = pseg.MaskFormerSegmenter(pseg_cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return dict(batch=batch, params=params, model=model, jseg=jseg_cfg, pseg=pseg_cfg)


def _both(c, options, mode, mapping=None, num_label_space=None):
    jcfg = jpd.PartDistillationConfig(segmenter=c["jseg"], num_parts=P, **options)
    pcfg = ppd.PartDistillationConfig(segmenter=c["pseg"], num_parts=P, **options)
    jfn = jax.jit(jpd.make_inference_fn(jcfg, mode=mode))
    jout = jfn(c["params"], {k: jnp.asarray(v) for k, v in c["batch"].items()},
               None if mapping is None else jnp.asarray(mapping))
    pfn = ppd.make_inference_fn(pcfg, c["model"], mode=mode, num_label_space=num_label_space,
                                device="cpu")
    pout = pfn(c["batch"], mapping)
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.float().numpy() if v.is_floating_point() else v.numpy()
             for k, v in pout.items()})


def _assert_outputs_match(jout, pout):
    assert set(jout) == set(pout)
    assert pout["pred_masks"].shape == jout["pred_masks"].shape
    assert (pout["pred_masks"] == jout["pred_masks"]).mean() >= 0.999
    _close(pout["scores"], jout["scores"], 1e-5, "scores")
    for key in ("pred_labels", "gt_matched_labels", "valid"):
        np.testing.assert_array_equal(pout[key], jout[key], err_msg=key)


TOPK = 16
OPTIONS = {"default": {}, "no_unique": dict(use_unique_per_pixel_label=False),
           "min_score": dict(min_score=0.22), "min_ratio": dict(min_ratio=0.2),
           "no_object_masking": dict(apply_object_masking=False),
           "iou_threshold": dict(match_iou_threshold=0.2),
           "oracle": dict(use_oracle_classifier=True)}


@pytest.mark.parametrize("options", list(OPTIONS.values()), ids=list(OPTIONS))
@pytest.mark.parametrize("mode", ["save", "eval"])
def test_inference_matches_jax(infer_case, mode, options):
    """``eval`` with a mapping whose ids stay below num_parts, where the
    JAX package's merge over [0, num_parts) loses nothing."""
    mapping = None
    if mode == "eval":
        mapping = np.random.default_rng(2).integers(0, P, (NUM_OBJ, P)).astype(np.int32)
    jout, pout = _both(infer_case, dict(options, test_topk=TOPK), mode, mapping,
                       P if mode == "eval" else None)
    _assert_outputs_match(jout, pout)
    assert pout["valid"].any()


def test_eval_keeps_mapped_labels_beyond_num_parts_where_jax_drops_them(infer_case):
    """The repair: mapped GT ids 5, 9, 13 >= num_parts. JAX merges over
    [0, num_parts) and keeps only the parts mapped to 1; the port merges
    over the 40 GT labels, keeps the rest, and agrees with JAX on [0, P)."""
    n_gt = 40
    mapping = np.tile(np.array([1, 5, 9, 13], np.int32), (NUM_OBJ, 1))
    jout, pout = _both(infer_case, dict(test_topk=TOPK), "eval", mapping, n_gt)
    assert jout["pred_masks"].shape[1] == P and pout["pred_masks"].shape[1] == n_gt
    jl = {int(l) for l, v in zip(jout["pred_labels"].ravel(), jout["valid"].ravel()) if v}
    pl = {int(l) for l, v in zip(pout["pred_labels"].ravel(), pout["valid"].ravel()) if v}
    assert jl <= {1} and pl - {1} and pl <= {1, 5, 9, 13}
    assert pout["pred_masks"].any(axis=(2, 3))[:, [5, 9, 13]].any()
    assert not jout["pred_masks"][:, [0, 2, 3]].any()
    assert pout["pred_masks"].any(1).sum() > jout["pred_masks"].any(1).sum()
    _assert_outputs_match(jout, {k: v[:, :P] for k, v in pout.items()})


def test_eval_mode_needs_the_label_space(infer_case):
    cfg = ppd.PartDistillationConfig(segmenter=infer_case["pseg"], num_parts=P)
    with pytest.raises(ValueError, match="num_label_space"):
        ppd.make_inference_fn(cfg, infer_case["model"], mode="eval", device="cpu")
    with pytest.raises(ValueError, match="mapping"):
        ppd.make_inference_fn(cfg, infer_case["model"], mode="eval", num_label_space=40,
                              device="cpu")(infer_case["batch"])
