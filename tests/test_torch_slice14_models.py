"""The port's remaining model options and helpers against the JAX package on
the CPU, f32, weights from the JAX init carried across by the port's
converters, inputs from numpy.

- the ViTDet helpers: ``window_partition`` / ``window_unpartition`` with H,
  W off the window (zero padding, cropped back), ``get_rel_pos`` with the
  table at its length, shrunk and grown (JAX's linear resize) and with
  q != k grids, ``add_decomposed_rel_pos``: all at 1e-6;
- ``TransformerDecoderConfig.query_feature_normalize`` through the masked
  decoder (both attention-mask constructions): every output at 1e-5;
- ``SwinConfig``'s ``qkv_bias=False``, ``qk_scale``, ``patch_norm=False``
  and a reduced ``out_features``: the backbone's outputs at 1e-4 (the
  tolerance ``tests/test_torch_port_modules.py`` holds the backbone to) and
  the same parameter set as JAX's tree;
- the CLIP scorer with host crops (PIL, ``crop_backend="host"``) against
  ``clip_region_scorer_jax(crop_backend="host")`` on the vision tower of a
  tiny transformers checkpoint (slice 11's CLI tests' configuration):
  class ids equal, probabilities at 1e-5; the host crops themselves equal
  JAX's PIL crops bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partdistillation_torch.models import swin as pswin
from partdistillation_torch.models import transformer_decoder as ptd
from partdistillation_torch.models import vit_utils as pvit
from partdistillation_torch.utils.convert_weights import state_dict_from_flax
from partdistillation_tpu.models import swin as jswin
from partdistillation_tpu.models import transformer_decoder as jtd
from partdistillation_tpu.models import vit_utils as jvit

HELPER_TOL = dict(atol=1e-6, rtol=0)


def _init(module, *inputs):
    params = jax.jit(module.init)(jax.random.PRNGKey(0), *inputs)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("hw,ws", [((8, 8), 4), ((10, 13), 4), ((7, 5), 3), ((3, 3), 4)])
def test_window_partition_roundtrip_matches_jax(hw, ws):
    x = np.random.default_rng(sum(hw)).normal(size=(2, *hw, 5)).astype(np.float32)
    jw, jpad = jvit.window_partition(jnp.asarray(x), ws)
    pw, ppad = pvit.window_partition(torch.from_numpy(x), ws)
    assert ppad == tuple(jpad)
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    back = pvit.window_unpartition(pw, ws, ppad, hw)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jvit.window_unpartition(jw, ws, jpad, hw)))


@pytest.mark.parametrize("q,k,length", [(7, 7, 13), (7, 7, 27), (7, 7, 9), (4, 8, 15),
                                        (8, 4, 11), (5, 5, 30), (6, 3, 7)],
                         ids=["exact", "shrink", "grow", "q<k", "q>k-grow", "shrink-even",
                              "q>k-shrink"])
def test_get_rel_pos_matches_jax(q, k, length):
    table = np.random.default_rng(length).normal(size=(length, 6)).astype(np.float32)
    want = np.asarray(jvit.get_rel_pos(q, k, jnp.asarray(table)))
    got = pvit.get_rel_pos(q, k, torch.from_numpy(table)).numpy()
    assert got.shape == want.shape == (q, k, 6)
    np.testing.assert_allclose(got, want, **HELPER_TOL)


@pytest.mark.parametrize("qs,ks,table", [((4, 4), (4, 4), 7), ((4, 6), (8, 3), 11),
                                         ((5, 5), (5, 5), 14)])
def test_add_decomposed_rel_pos_matches_jax(qs, ks, table):
    rng = np.random.default_rng(table)
    b, c = 2, 8
    attn = rng.normal(size=(b, qs[0] * qs[1], ks[0] * ks[1])).astype(np.float32)
    q = rng.normal(size=(b, qs[0] * qs[1], c)).astype(np.float32)
    rh = rng.normal(size=(table, c)).astype(np.float32)
    rw = rng.normal(size=(table + 2, c)).astype(np.float32)
    want = np.asarray(jvit.add_decomposed_rel_pos(*map(jnp.asarray, (attn, q, rh, rw)), qs, ks))
    got = pvit.add_decomposed_rel_pos(*map(torch.from_numpy, (attn, q, rh, rw)), qs, ks).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("from_features", [True, False])
def test_query_feature_normalize_matches_jax(from_features):
    td = dict(num_classes=3, hidden_dim=32, num_queries=8, num_heads=4, dim_feedforward=64,
              dec_layers=3, mask_dim=32, query_feature_normalize=True,
              attn_mask_from_features=from_features)
    rng = np.random.default_rng(2)
    ms = [rng.normal(size=(2, s, s, 32)).astype(np.float32) for s in (2, 4, 8)]
    mf = rng.normal(size=(2, 16, 16, 32)).astype(np.float32)
    jm = jtd.MultiScaleMaskedTransformerDecoder(jtd.TransformerDecoderConfig(**td))
    params = _init(jm, [jnp.asarray(m) for m in ms], jnp.asarray(mf))
    ref = jax.jit(jm.apply)(params, [jnp.asarray(m) for m in ms], jnp.asarray(mf))
    pm = ptd.MultiScaleMaskedTransformerDecoder(ptd.TransformerDecoderConfig(**td), 32)
    sd = state_dict_from_flax({"predictor": params["params"]})
    pm.load_state_dict({k[len("sem_seg_head.predictor."):]: v for k, v in sd.items()},
                       strict=True)
    with torch.no_grad():
        out = pm([torch.from_numpy(m) for m in ms], torch.from_numpy(mf))
    for key in ("pred_logits", "pred_masks", "decoder_output"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-5, rtol=1e-5)
    for a, r in zip(out["aux_outputs"], ref["aux_outputs"]):
        for key in ("pred_logits", "pred_masks"):
            np.testing.assert_allclose(a[key].numpy(), np.asarray(r[key]), atol=1e-5, rtol=1e-5)
    # the normalised embeddings bound every mask logit by |mask feature|
    bound = np.linalg.norm(mf, axis=-1).max() * (1 + 1e-5)
    assert np.abs(out["pred_masks"].numpy()).max() <= bound


@pytest.mark.parametrize("opts", [
    {"qkv_bias": False},
    {"qk_scale": 0.3},
    {"patch_norm": False},
    {"out_features": ("res3", "res5")},
    {"qkv_bias": False, "qk_scale": 0.25, "patch_norm": False, "out_features": ("res2",)},
], ids=["no-qkv-bias", "qk-scale", "no-patch-norm", "out-features", "all"])
def test_swin_options_match_jax(opts):
    sw = dict(embed_dim=8, depths=(2, 2, 1, 1), num_heads=(1, 2, 4, 8), window_size=4)
    jm = jswin.SwinTransformer(jswin.SwinConfig(**sw, drop_path_rate=0.0, **opts))
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32)
    params = _init(jm, jnp.asarray(x))
    ref = jax.jit(jm.apply)(params, jnp.asarray(x))
    pm = pswin.SwinTransformer(pswin.SwinConfig(**sw, **opts))
    sd = state_dict_from_flax({"backbone": params["params"]})
    sd = {k[len("backbone."):]: v for k, v in sd.items()}
    assert set(sd) == set(pm.state_dict())
    pm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = pm.eval()(torch.from_numpy(x))
    assert set(out) == set(ref) == set(opts.get("out_features", set(ref)))
    for key in ref:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-4, rtol=1e-4)


CROP = 32


@pytest.fixture(scope="module")
def clip_vision(tmp_path_factory):
    """The vision tower of slice 11's tiny transformers CLIP checkpoint,
    written and read back, in both packages."""
    transformers = pytest.importorskip("transformers")
    from partdistillation_torch.models import clip_vit as pclip
    from partdistillation_tpu.models import clip_vit as jclip

    cfg = transformers.CLIPConfig(
        text_config={"vocab_size": 99, "hidden_size": 32, "intermediate_size": 64,
                     "num_hidden_layers": 2, "num_attention_heads": 2,
                     "max_position_embeddings": 12, "eos_token_id": 98, "bos_token_id": 97,
                     "pad_token_id": 0},
        vision_config={"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
                       "num_attention_heads": 2, "image_size": CROP, "patch_size": 8},
        projection_dim=16)
    torch.manual_seed(2)
    path = tmp_path_factory.mktemp("tiny_clip")
    transformers.CLIPModel(cfg).eval().save_pretrained(str(path))
    model = transformers.CLIPModel.from_pretrained(str(path)).eval()
    sd = model.state_dict()
    jcfg = jclip.config_from_hf(model.config.vision_config)
    jcfg = jcfg.__class__(**{**jcfg.__dict__,
                             "projection_dim": sd["visual_projection.weight"].shape[0]})
    params = jclip.convert_clip_vision_state_dict(sd, jcfg)
    pcfg = pclip.config_from_hf(model.config.vision_config)
    pcfg = pcfg.__class__(**{**pcfg.__dict__,
                             "projection_dim": sd["visual_projection.weight"].shape[0]})
    tower = pclip.CLIPVisionTower(pcfg, device="cpu")
    tower.load_state_dict(sd, strict=False)
    temb = np.random.RandomState(2).randn(5, 16).astype(np.float32)
    temb /= np.linalg.norm(temb, axis=-1, keepdims=True)
    return {"jtower": jclip.CLIPVisionTower(jcfg), "params": params, "tower": tower,
            "temb": temb}


def _masks(rng, k=5, size=64):
    masks = np.zeros((k, size, size), bool)
    for i in range(k):
        y0, x0 = rng.randint(0, size - 8, 2)
        masks[i, y0:y0 + rng.randint(3, size - y0), x0:x0 + rng.randint(2, size - x0)] = True
        masks[i] &= rng.rand(size, size) < 0.8  # ragged, its box still the outer one
    return masks


def test_host_crop_scorer_matches_jax(clip_vision):
    from partdistillation_torch.models.meta_arch import labeling as plab
    from partdistillation_tpu.models.meta_arch import labeling as jlab

    jscorer = jlab.clip_region_scorer_jax(
        clip_vision["jtower"].apply, clip_vision["temb"], crop_size=CROP, capacity=4,
        vision_params=clip_vision["params"], crop_backend="host")
    scorer = plab.clip_region_scorer_device(clip_vision["tower"], clip_vision["temb"],
                                            crop_backend="host")
    rng = np.random.RandomState(3)
    images = rng.randint(0, 255, (2, 64, 64, 3)).astype(np.uint8)
    masks = np.stack([_masks(rng) for _ in range(2)])
    got_ids, got_p = scorer.batched(images, masks)
    for b in range(2):
        want_ids, want_p = jscorer(images[b], masks[b])
        np.testing.assert_array_equal(got_ids[b], want_ids)
        np.testing.assert_allclose(got_p[b], want_p, rtol=0, atol=1e-5)
        ids, p = scorer(images[b], masks[b])
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_allclose(p, want_p, rtol=0, atol=1e-5)
    # the crops: JAX's host loop (a box crop, PIL's bilinear resize)
    from partdistillation_tpu.data.transforms import resize_image

    crops = plab.crop_regions_host(images, masks, CROP)
    for b in range(2):
        for k, m in enumerate(masks[b]):
            ys, xs = np.nonzero(m)
            want = resize_image(images[b][ys.min():ys.max() + 1, xs.min():xs.max() + 1],
                                (CROP, CROP))
            np.testing.assert_array_equal(crops[b, k], want.astype(np.float32))
    with pytest.raises(ValueError, match="crop_backend"):
        plab.clip_region_scorer_device(clip_vision["tower"], clip_vision["temb"],
                                       crop_backend="tpu")
