"""The MaskFormer-v1 heads on the CPU against the JAX package: the FPN and
transformer-FPN pixel decoders, the DETR transformer (key padding mask
included), the standard decoder (pre- and post-norm) and the segmenter with
the v1 heads, at sizes whose levels do not halve evenly.

Weights are the JAX package's seeded initialisation carried across by
``state_dict_from_flax`` (every port parameter filled: ``strict=True``).
Tolerance: f32, outputs within 1e-5 of the largest reference value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partdistillation_tpu.models import detr_transformer as jdetr
from partdistillation_tpu.models import fpn as jfpn
from partdistillation_tpu.models import maskformer_decoder as jstd
from partdistillation_tpu.models import segmenter as jseg
from partdistillation_tpu.models.swin import SwinConfig as JSwin
from partdistillation_tpu.models.transformer_decoder import TransformerDecoderConfig as JTD
from partdistillation_tpu.utils.convert_weights import convert_mask2former_state_dict
from partdistillation_torch.models import detr_transformer as pdetr
from partdistillation_torch.models import fpn as pfpn
from partdistillation_torch.models import maskformer_decoder as pstd
from partdistillation_torch.models import segmenter as pseg
from partdistillation_torch.models.swin import SwinConfig
from partdistillation_torch.models.transformer_decoder import TransformerDecoderConfig
from partdistillation_torch.utils.convert_weights import state_dict_from_flax

T_ = torch.from_numpy
FP = dict(conv_dim=32, mask_dim=24, transformer_enc_layers=2, n_heads=4, transformer_ffn_dim=64)
SW = dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), window_size=4,
          drop_path_rate=0.0)


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-30))


def _init(module, *args):
    params = jax.jit(module.init)(jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map(np.asarray, params)


def _load(port, params, scope: str, prefix: str):
    """Load the port module from a flax subtree placed at ``scope`` of a
    segmenter tree, its keys read under ``prefix``."""
    tree = {scope: params["params"]} if "/" not in scope else \
        {scope.split("/")[0]: {scope.split("/")[1]: params["params"]}}
    sd = {k[len(prefix):]: v for k, v in state_dict_from_flax(tree).items()}
    port.load_state_dict(sd, strict=True)
    return port.eval()


def _features(seed, b=2, sizes=((17, 15), (9, 8), (5, 4), (3, 2)), c0=16):
    """Backbone-like features whose levels do not halve evenly."""
    rng = np.random.default_rng(seed)
    return {f"res{i + 2}": rng.standard_normal((b, h, w, c0 * 2 ** i)).astype(np.float32)
            for i, (h, w) in enumerate(sizes)}


@pytest.mark.parametrize("kind", ["fpn", "transformer_fpn"])
def test_fpn_pixel_decoders_match_jax(kind):
    jcls = jfpn.BasePixelDecoder if kind == "fpn" else jfpn.TransformerEncoderPixelDecoder
    pcls = pfpn.BasePixelDecoder if kind == "fpn" else pfpn.TransformerEncoderPixelDecoder
    feats = _features(1)
    jmod = jcls(jfpn.FPNPixelDecoderConfig(**FP))
    params = _init(jmod, {k: jnp.asarray(v) for k, v in feats.items()})
    ref = jax.jit(jmod.apply)(params, {k: jnp.asarray(v) for k, v in feats.items()})
    channels = {k: v.shape[-1] for k, v in feats.items()}
    port = _load(pcls(pfpn.FPNPixelDecoderConfig(**FP), channels), params, "pixel_decoder",
                 "sem_seg_head.pixel_decoder.")
    with torch.no_grad():
        mask_features, enc, ms = port({k: T_(v) for k, v in feats.items()})
    _close(mask_features.numpy(), ref[0])
    assert [m.shape[1:3] for m in ms] == [(3, 2), (5, 4), (9, 8)]
    for got, want in zip(ms, ref[2]):
        _close(got.numpy(), want)
    if kind == "fpn":
        assert enc is None and ref[1] is None
    else:
        _close(enc.numpy(), ref[1])


def test_nearest_upsample_takes_half_pixel_centres():
    x = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    for h, w in ((5, 7), (6, 8), (7, 9)):
        got = pfpn.upsample_nearest(T_(x), h, w).numpy()
        want = jfpn._upsample_nearest(jnp.asarray(x), h, w)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("pre_norm", [False, True])
def test_detr_transformer_with_padding_mask_matches_jax(pre_norm):
    cfg = dict(d_model=32, num_heads=4, dim_feedforward=64, num_encoder_layers=2,
               num_decoder_layers=3, pre_norm=pre_norm)
    rng = np.random.default_rng(2)
    src = rng.standard_normal((2, 21, 32)).astype(np.float32)
    pos = rng.standard_normal((2, 21, 32)).astype(np.float32)
    query = rng.standard_normal((7, 32)).astype(np.float32)
    pad = np.zeros((2, 21), bool)
    pad[1, 15:] = True  # the second image's last keys are padding
    jmod = jdetr.Transformer(jdetr.DETRTransformerConfig(**cfg))
    args = [jnp.asarray(a) for a in (src, query, pos, pad)]
    params = _init(jmod, *args)
    hs, mem = jax.jit(jmod.apply)(params, *args)
    port = _load(pdetr.Transformer(pdetr.DETRTransformerConfig(**cfg)), params,
                 "predictor/transformer", "sem_seg_head.predictor.transformer.")
    with torch.no_grad():
        got_hs, got_mem = port(T_(src), T_(query), T_(pos), T_(pad))
    assert got_hs.shape == (3, 2, 7, 32)
    _close(got_hs.numpy(), hs)
    _close(got_mem.numpy(), mem)
    # the padded keys are read by no query: changing them changes nothing
    src2 = src.copy()
    src2[1, 15:] += 100.0
    with torch.no_grad():
        again, _ = port(T_(src2), T_(query), T_(pos), T_(pad))
    _close(again[:, 1].numpy(), got_hs[:, 1].numpy())


@pytest.mark.parametrize("pre_norm", [False, True])
def test_standard_decoder_matches_jax(pre_norm):
    cfg = dict(num_classes=3, hidden_dim=32, num_queries=9, num_heads=4, dim_feedforward=64,
               enc_layers=1, dec_layers=3, mask_dim=24, pre_norm=pre_norm)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 48)).astype(np.float32)  # in channels != hidden: projected
    mf = rng.standard_normal((2, 19, 13, 24)).astype(np.float32)
    jmod = jstd.StandardTransformerDecoder(jstd.StandardDecoderConfig(**cfg))
    params = _init(jmod, jnp.asarray(x), jnp.asarray(mf))
    ref = jax.jit(jmod.apply)(params, jnp.asarray(x), jnp.asarray(mf))
    port = _load(pstd.StandardTransformerDecoder(pstd.StandardDecoderConfig(**cfg), 48), params,
                 "predictor", "sem_seg_head.predictor.")
    with torch.no_grad():
        out = port(T_(x), T_(mf))
    for key in ("pred_logits", "pred_masks", "decoder_output"):
        _close(out[key].numpy(), ref[key])
    assert len(out["aux_outputs"]) == len(ref["aux_outputs"]) == 2
    for got, want in zip(out["aux_outputs"], ref["aux_outputs"]):
        for key in ("pred_logits", "pred_masks"):
            _close(got[key].numpy(), want[key])


HEADS = [("fpn", "standard"), ("transformer_fpn", "standard"), ("fpn", "multi_scale"),
         ("msdeform", "standard")]


def _segmenters(pixel_decoder, decoder):
    fp = dict(FP, transformer_enc_layers=1)
    sd = dict(num_classes=3, hidden_dim=32, num_queries=9, num_heads=4, dim_feedforward=64,
              dec_layers=2, mask_dim=24)
    td = dict(num_classes=3, hidden_dim=32, num_queries=9, num_heads=4, dim_feedforward=64,
              dec_layers=2, mask_dim=24)
    from partdistillation_tpu.models.pixel_decoder import PixelDecoderConfig as JPD
    from partdistillation_torch.models.pixel_decoder import PixelDecoderConfig

    pd = dict(conv_dim=32, mask_dim=24, transformer_layers=1, transformer_ffn_dim=64, n_heads=4,
              n_points=2)
    jcfg = jseg.SegmenterConfig(swin=JSwin(**SW), pixel_decoder=JPD(**pd),
                                pixel_decoder_type=pixel_decoder,
                                fpn=jfpn.FPNPixelDecoderConfig(**fp),
                                decoder_type=decoder,
                                standard_decoder=jstd.StandardDecoderConfig(**sd),
                                decoder=JTD(**td))
    pcfg = pseg.SegmenterConfig(swin=SwinConfig(**SW), pixel_decoder=PixelDecoderConfig(**pd),
                                pixel_decoder_type=pixel_decoder,
                                fpn=pfpn.FPNPixelDecoderConfig(**fp), decoder_type=decoder,
                                standard_decoder=pstd.StandardDecoderConfig(**sd),
                                decoder=TransformerDecoderConfig(**td))
    return jcfg, pcfg


@pytest.mark.parametrize("pixel_decoder,decoder", HEADS)
def test_segmenter_with_v1_heads_matches_jax(pixel_decoder, decoder):
    """An odd input (76^2: levels 19, 10, 5, 3), every output compared."""
    jcfg, pcfg = _segmenters(pixel_decoder, decoder)
    jmodel = jseg.MaskFormerSegmenter(jcfg)
    x = np.random.default_rng(4).standard_normal((2, 76, 76, 3)).astype(np.float32)
    params = _init(jmodel, jnp.asarray(x))
    ref = jax.jit(jmodel.apply)(params, jnp.asarray(x))
    model = pseg.MaskFormerSegmenter(pcfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    assert pcfg.supervised_layers == 1 + len(ref["aux_outputs"])
    with torch.no_grad():
        out = model.eval()(T_(x))
    for key in ("pred_logits", "pred_masks"):
        _close(out[key].numpy(), ref[key])
    for got, want in zip(out["aux_outputs"], ref["aux_outputs"]):
        _close(got["pred_masks"].numpy(), want["pred_masks"])
    _close(out["mask_features"].numpy(), ref["mask_features"])


@pytest.mark.parametrize("pixel_decoder", ["fpn", "transformer_fpn"])
def test_v1_state_dict_round_trip_through_the_jax_converter(pixel_decoder):
    """The port's keys are the reference's, so the JAX package's
    ``convert_mask2former_state_dict`` reads them: every leaf it places in
    the segmenter's tree is the original. Its rules know the mask features,
    the query embedding, the class head and the mask MLP of these heads; the
    numbered FPN convolutions it folds onto the deformable decoder's one
    FPN level (leaves this tree lacks) and the DETR layers it leaves
    unmatched."""
    jcfg, _ = _segmenters(pixel_decoder, "standard")
    params = _init(jseg.MaskFormerSegmenter(jcfg), jnp.zeros((1, 64, 64, 3)))
    sd = {k: v.numpy() for k, v in state_dict_from_flax(params).items()}
    back, unmatched = convert_mask2former_state_dict(sd)

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if hasattr(v, "items") else {prefix + k: v})
        return out

    orig, got = flat(params["params"]), flat(back["params"])
    placed = [p for p in got if p in orig]
    for p in placed:
        np.testing.assert_array_equal(got[p], orig[p], err_msg=p)
    assert {"pixel_decoder/mask_features/kernel", "predictor/query_embed",
            "predictor/class_embed/kernel", "predictor/mask_embed/fc2/kernel"} <= set(placed)
    assert all(p.startswith("backbone/") or p.startswith("pixel_decoder/mask_features")
               or p.startswith("predictor/") for p in placed)
    assert set(got) - set(orig) <= {f"pixel_decoder/fpn_{n}/{leaf}" for n in (
        "lateral", "output") for leaf in ("kernel",)} | {
        f"pixel_decoder/fpn_{n}_norm/{leaf}" for n in ("lateral", "output")
        for leaf in ("scale", "bias")} | {p for p in got if p.startswith("pixel_decoder/layer")}
    assert all(".transformer." in k or k.startswith("sem_seg_head.predictor.input_proj")
               or k.startswith("sem_seg_head.pixel_decoder.input_proj") for k in unmatched)
