"""Stage 4's and stage 2's models on the CPU: the port's ``part_ranking`` and
``proposal_generation`` against the JAX package's, at a tiny size (Swin of
width 16, hidden 32, two decoder layers, 16 queries), in f32, weights carried
by ``state_dict_from_flax``.

- ``make_cluster_fn`` with unique clustering on and off, with and without
  the object gate: features and scores within 1e-5 of max |JAX|, ``valid``
  and masks equal;
- ``classifier_scores`` 'l2' and 'dot';
- ``make_label_fn`` in SAVE, MATCH and EVAL modes (EVAL through a mapping
  into a 5-part label space), with the defaults, without unique labeling,
  and with 'dot' scores: masks, labels and ``valid`` equal, scores within
  1e-5;
- ``make_generation_fn`` for 'dot' and 'l2' with both packages seeded alike
  (the first k valid rows, patched into each): part masks, valid flags and
  object ratios equal; the object mask's 1/8 resize equals JAX's
  ``nearest`` with torch's ``nearest-exact``, where torch's ``nearest``
  picks other pixels;
- torch ``pack_bits`` equals ``np.packbits``.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partdistillation_tpu.models import segmenter as jseg
from partdistillation_tpu.models.meta_arch import part_ranking as jpr
from partdistillation_tpu.models.meta_arch import proposal_generation as jpg
from partdistillation_tpu.models.pixel_decoder import PixelDecoderConfig as JPDC
from partdistillation_tpu.models.swin import SwinConfig as JSwin
from partdistillation_tpu.models.swin import SwinTransformer as JSwinT
from partdistillation_tpu.models.transformer_decoder import TransformerDecoderConfig as JTD
from partdistillation_tpu.ops import kmeans as jkm
from partdistillation_torch.models import segmenter as pseg
from partdistillation_torch.models.meta_arch import part_ranking as ppr
from partdistillation_torch.models.meta_arch import proposal_generation as ppg
from partdistillation_torch.models.pixel_decoder import PixelDecoderConfig
from partdistillation_torch.models.swin import SwinConfig
from partdistillation_torch.models.transformer_decoder import TransformerDecoderConfig
from partdistillation_torch.ops import kmeans as pkm
from partdistillation_torch.utils.bitpack import pack_bits
from partdistillation_torch.utils.convert_weights import state_dict_from_flax

NUM_OBJ, K, Q, GT_PARTS = 6, 4, 16, 5
SW = dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), window_size=4,
          drop_path_rate=0.0)
PD = dict(conv_dim=32, mask_dim=32, transformer_layers=1, transformer_ffn_dim=64, n_heads=4,
          n_points=2)
TD = dict(num_classes=1, hidden_dim=32, num_queries=Q, num_heads=4, dim_feedforward=64,
          dec_layers=2, mask_dim=32)


def _close(got, want, rel, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=msg)


def _host(out):
    return {k: v.float().numpy() if v.is_floating_point() else v.numpy() for k, v in out.items()}


def _batch(rng, b=2, size=64, parts=4):
    images = rng.integers(0, 256, (b, size, size, 3)).astype(np.uint8)
    masks = np.zeros((b, parts, size, size), bool)
    obj = np.zeros((b, size, size), bool)
    for i in range(b):
        y0, x0 = rng.integers(0, 16, 2)
        obj[i, y0:y0 + 40, x0:x0 + 44] = True
        for k in range(parts):
            masks[i, k, y0 + 10 * k:y0 + 10 * (k + 1), x0:x0 + 44] = True
    return {"image": images, "masks": masks,
            "mask_labels": np.arange(parts, dtype=np.int32)[None].repeat(b, 0) % GT_PARTS,
            "mask_valid": np.array([[True] * (parts - 1) + [False]] * b),
            "object_mask": obj, "object_label": np.array([2, NUM_OBJ - 1], np.int32)}


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    batch = _batch(rng)
    jcfg = jseg.SegmenterConfig(swin=JSwin(**SW), pixel_decoder=JPDC(**PD), decoder=JTD(**TD))
    pcfg = pseg.SegmenterConfig(swin=SwinConfig(**SW), pixel_decoder=PixelDecoderConfig(**PD),
                                decoder=TransformerDecoderConfig(**TD))
    images = jpr.normalize_images(jnp.asarray(batch["image"]))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jseg.MaskFormerSegmenter(jcfg).init)(
        jax.random.PRNGKey(0), images))
    # random sampling-offset kernels so the deformable gather moves off the grid
    leaf = params["params"]["pixel_decoder"]["layer0"]["self_attn"]["sampling_offsets"]
    leaf["kernel"] = (rng.normal(size=leaf["kernel"].shape) * 0.05).astype(np.float32)
    model = pseg.MaskFormerSegmenter(pcfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    cents = rng.normal(size=(NUM_OBJ, K, 32)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=-1, keepdims=True)
    mapping = rng.integers(0, GT_PARTS, (NUM_OBJ, K)).astype(np.int32)
    return dict(batch=batch, params=params, model=model, jseg=jcfg, pseg=pcfg, cents=cents,
                mapping=mapping)


def _configs(c, **options):
    return (jpr.PartRankingConfig(segmenter=c["jseg"], num_clusters=K, test_topk=Q, **options),
            ppr.PartRankingConfig(segmenter=c["pseg"], num_clusters=K, test_topk=Q, **options))


def _assert_masks(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)


CLUSTER_OPTIONS = {"default": {}, "no_unique": dict(use_unique_clustering=False),
                   "no_gate": dict(apply_object_masking=False),
                   "no_unique_no_gate": dict(use_unique_clustering=False,
                                             apply_object_masking=False)}


@pytest.mark.parametrize("options", list(CLUSTER_OPTIONS.values()), ids=list(CLUSTER_OPTIONS))
def test_cluster_fn_matches_jax(case, options):
    jcfg, pcfg = _configs(case, **options)
    jb = {k: jnp.asarray(case["batch"][k]) for k in ("image", "masks", "mask_valid",
                                                     "object_mask")}
    jout = {k: np.asarray(v) for k, v in
            jax.jit(jpr.make_cluster_fn(jcfg))(case["params"], jb).items()}
    pout = _host(ppr.make_cluster_fn(pcfg, case["model"], device="cpu")(case["batch"]))
    assert set(pout) == set(jout)
    _close(pout["feats"], jout["feats"], 1e-5, "feats")
    _close(pout["scores"], jout["scores"], 1e-5, "scores")
    np.testing.assert_array_equal(pout["valid"], jout["valid"])
    _assert_masks(pout["pred_masks"], jout["pred_masks"])
    assert pout["valid"].any()
    np.testing.assert_allclose(np.linalg.norm(pout["feats"], axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_classifier_scores_match_jax(metric):
    rng = np.random.RandomState(1)
    feats, cents = rng.randn(Q, 32).astype(np.float32), rng.randn(K, 32).astype(np.float32)
    want = np.asarray(jpr.classifier_scores(jnp.asarray(feats), jnp.asarray(cents), metric))
    got = ppr.classifier_scores(torch.from_numpy(feats), torch.from_numpy(cents), metric)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, 1e-6, metric)


LABEL_OPTIONS = {"default": {}, "no_unique": dict(use_unique_labeling=False),
                 "dot": dict(classifier_metric="dot")}


@pytest.mark.parametrize("options", list(LABEL_OPTIONS.values()), ids=list(LABEL_OPTIONS))
@pytest.mark.parametrize("mode", ["save", "match", "eval"])
def test_label_fn_matches_jax(case, mode, options):
    jcfg, pcfg = _configs(case, **options)
    space = GT_PARTS if mode == "eval" else None
    mapping = case["mapping"] if mode == "eval" else None
    jfn = jax.jit(jpr.make_label_fn(jcfg, jpr.RankingMode(mode), num_label_space=space))
    jout = {k: np.asarray(v) for k, v in jfn(
        case["params"], {k: jnp.asarray(v) for k, v in case["batch"].items()},
        jnp.asarray(case["cents"]), None if mapping is None else jnp.asarray(mapping)).items()}
    pfn = ppr.make_label_fn(pcfg, case["model"], mode, num_label_space=space, device="cpu")
    pout = _host(pfn(case["batch"], case["cents"], mapping))
    assert set(pout) == set(jout)
    _assert_masks(pout["pred_masks"], jout["pred_masks"])
    _close(pout["scores"], jout["scores"], 1e-5, "scores")
    for key in ("pred_labels", "gt_matched_labels", "valid"):
        np.testing.assert_array_equal(pout[key], jout[key], err_msg=key)
    assert pout["valid"].any()


# ---------------------------------------------------------------- stage 2


@pytest.fixture(scope="module")
def backbone():
    jsw = JSwin(**SW)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(JSwinT(jsw).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    model = ppg.make_backbone(SwinConfig(**SW), device="cpu")
    sd = state_dict_from_flax({"backbone": params["params"]})
    model.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()}, strict=True)
    return jsw, params, model


def first_valid_rows_port(x, mask, u):
    """A deterministic seeding: the first k valid rows (the port's signature)."""
    idx = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)[:, :u.shape[1]]
    return x[torch.arange(x.shape[0])[:, None], idx]


def first_valid_rows_jax(x, mask, k, key):
    """The same seeding in ``_kmeans_pp_init``'s signature."""
    return x[jnp.argsort(~mask, stable=True)[:k]]


@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_generation_matches_jax_given_the_same_seeding(backbone, metric, monkeypatch):
    monkeypatch.setattr(jkm, "_kmeans_pp_init", first_valid_rows_jax)
    monkeypatch.setattr(pkm, "kmeans_pp_init", first_valid_rows_port)
    jsw, params, model = backbone
    rng = np.random.default_rng(4)
    batch = _batch(rng, b=3)
    batch = {"image": batch["image"].astype(np.float32), "object_mask": batch["object_mask"]}
    batch["object_mask"][2] = False
    batch["object_mask"][2, 5:12, 5:12] = True  # one pixel at 1/8: too few for k-means
    jout = jax.jit(jpg.make_generation_fn(jpg.ProposalGenerationConfig(
        swin=jsw, distance_metric=metric)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    pout = _host(ppg.make_generation_fn(ppg.ProposalGenerationConfig(
        swin=SwinConfig(**SW), distance_metric=metric), model, device="cpu")(
        batch, np.zeros((3, 4), np.float32)))
    np.testing.assert_array_equal(pout["part_masks"], np.asarray(jout["part_masks"]))
    np.testing.assert_array_equal(pout["part_valid"], np.asarray(jout["part_valid"]))
    np.testing.assert_array_equal(pout["object_ratio"], np.asarray(jout["object_ratio"]))
    assert pout["part_valid"][:2].sum(1).min() >= 2 and not pout["part_valid"][2].any()
    # the parts tile the object mask, disjoint
    masks = pout["part_masks"][:2]
    assert masks.sum(1).max() == 1
    np.testing.assert_array_equal(masks.any(1), batch["object_mask"][:2])


def test_object_mask_resize_is_nearest_exact():
    mask = np.random.default_rng(5).random((2, 64, 64)) < 0.5
    want = np.asarray(jax.image.resize(jnp.asarray(mask, jnp.float32), (2, 8, 8),
                                       "nearest") > 0.5)
    got = ppg.downsample_mask(torch.from_numpy(mask), 8, 8).numpy()
    np.testing.assert_array_equal(got, want)
    plain = torch.nn.functional.interpolate(torch.from_numpy(mask).float()[:, None],
                                            size=(8, 8), mode="nearest")[:, 0] > 0.5
    assert not np.array_equal(plain.numpy(), want)


def test_bilinear_resize_matches_jax():
    x = np.random.default_rng(6).normal(size=(2, 4, 5, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 8, 10, 3), "linear"))
    _close(ppg.resize_bilinear(torch.from_numpy(x), 8, 10).numpy(), want, 1e-6)


@pytest.mark.parametrize("width", [1, 8, 13, 64, 640])
def test_pack_bits_matches_numpy(width):
    x = np.random.default_rng(width).random((3, 2, width)) < 0.4
    got = pack_bits(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.packbits(x, axis=-1))


def test_dataclass_defaults_match_jax():
    """The port's fields default as JAX's do; the JAX fields the port fixes
    (its CLI never sets them) hold the port's constants as their defaults."""
    from partdistillation_tpu.data.mappers import ProposalGenerationMapper as JMapper
    from partdistillation_tpu.evaluation.clustering import ClusteringModule as JClustering
    from partdistillation_torch.evaluation import clustering as pcl

    fixed = {
        jpr.PartRankingConfig: dict(
            proposal_feature_norm=True, min_ratio_1=ppr.MIN_RATIO, min_ratio_2=ppr.MIN_RATIO,
            min_score_1=ppr.MIN_SCORE, min_score_2=ppr.MIN_SCORE,
            fg_iou_threshold=ppr.FG_IOU_THRESHOLD),
        jpg.ProposalGenerationConfig: dict(
            feature_keys=ppg.FEATURE_KEYS, feature_normalize=False,
            kmeans_iters=ppg.KMEANS_ITERS),
    }
    for jcls, pcls in ((jpr.PartRankingConfig, ppr.PartRankingConfig),
                       (jpg.ProposalGenerationConfig, ppg.ProposalGenerationConfig)):
        skip = {"segmenter", "swin"}
        want = {f.name: f.default for f in dataclasses.fields(jcls) if f.name not in skip}
        got = {f.name: f.default for f in dataclasses.fields(pcls) if f.name not in skip}
        assert got == {k: v for k, v in want.items() if k not in fixed[jcls]}, pcls
        assert {k: want[k] for k in fixed[jcls]} == fixed[jcls], jcls
    assert inspect.signature(JClustering).parameters["seed"].default == pcl.SEED
    assert {f.name: f.default for f in dataclasses.fields(JMapper)}["object_mask_index"] == 0
