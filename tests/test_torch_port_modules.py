"""The port's modules (CPU, f32) against the JAX package's, with weights from
the JAX init carried across by ``state_dict_from_flax``.

Inputs come from numpy generators and go to both packages. Tolerance: atol =
rtol = 1e-4, the tolerance ``test_torch_parity.py`` holds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partdistillation_tpu.models import pixel_decoder as jpd
from partdistillation_tpu.models import swin as jswin
from partdistillation_tpu.models import transformer_decoder as jtd
from partdistillation_torch.models import pixel_decoder as ppd
from partdistillation_torch.models import swin as pswin
from partdistillation_torch.models import transformer_decoder as ptd
from partdistillation_torch.utils.convert_weights import state_dict_from_flax

TOL = dict(atol=1e-4, rtol=1e-4)
FEATS = {"res2": (16, 16), "res3": (32, 8), "res4": (64, 4), "res5": (128, 2)}


def _init(module, *inputs):
    params = jax.jit(module.init)(jax.random.PRNGKey(0), *inputs)
    return jax.tree_util.tree_map(np.asarray, params)


def _load(port_module, flax_params, scope: str, prefix: str):
    sd = state_dict_from_flax({scope: flax_params["params"]})
    port_module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return port_module.eval()


def test_swin_matches_jax_with_shift():
    sw = dict(embed_dim=8, depths=(2, 2, 1, 1), num_heads=(1, 2, 4, 8), window_size=4)
    jm = jswin.SwinTransformer(jswin.SwinConfig(**sw, drop_path_rate=0.0))
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32)
    params = _init(jm, jnp.asarray(x))
    ref = jax.jit(jm.apply)(params, jnp.asarray(x))
    pm = _load(pswin.SwinTransformer(pswin.SwinConfig(**sw)), params, "backbone", "backbone.")
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    assert set(out) == set(ref)
    for key in ref:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL)


def test_swin_shift_is_active_at_64px():
    """The 64^2 / ws 4 config takes the shifted-window branch at res2 and res3
    (min(h, w) > ws) and the unshifted one at res4 / res5."""
    blk = pswin.SwinBlock(16, 1, 4, 2)
    assert min(16, 16) > blk.window_size and blk.shift_size == 2
    mask = pswin._shift_attn_mask(16, 16, 4, 2, torch.device("cpu"))
    assert mask.shape == (16, 16, 16) and (mask == -100.0).any()


def _features(rng, b=2):
    return {k: rng.normal(size=(b, s, s, c)).astype(np.float32) for k, (c, s) in FEATS.items()}


def test_pixel_decoder_matches_jax():
    pd = dict(conv_dim=32, mask_dim=32, transformer_layers=2, transformer_ffn_dim=64,
              n_heads=4, n_points=2)
    jm = jpd.MSDeformAttnPixelDecoder(jpd.PixelDecoderConfig(**pd, msda_mode="banded",
                                                             msda_band_radius=4))
    rng = np.random.default_rng(1)
    feats = _features(rng)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    params = _init(jm, jfeats)
    # the JAX init zeroes the sampling-offset kernel; random offsets exercise
    # the bilinear gather
    for i in range(pd["transformer_layers"]):
        leaf = params["params"][f"layer{i}"]["self_attn"]["sampling_offsets"]
        leaf["kernel"] = (rng.normal(size=leaf["kernel"].shape) * 0.05).astype(np.float32)
    mf, enc, ms = jax.jit(jm.apply)(params, jfeats)
    pm = _load(ppd.MSDeformAttnPixelDecoder(ppd.PixelDecoderConfig(**pd),
                                            {k: c for k, (c, _) in FEATS.items()}),
               params, "pixel_decoder", "sem_seg_head.pixel_decoder.")
    with torch.no_grad():
        pmf, penc, pms = pm({k: torch.from_numpy(v) for k, v in feats.items()})
    np.testing.assert_allclose(pmf.numpy(), np.asarray(mf), **TOL)
    np.testing.assert_allclose(penc.numpy(), np.asarray(enc), **TOL)
    for a, r in zip(pms, ms):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)


@pytest.fixture(scope="module")
def decoder_case():
    td = dict(num_classes=3, hidden_dim=32, num_queries=8, num_heads=4, dim_feedforward=64,
              dec_layers=3, mask_dim=32)
    rng = np.random.default_rng(2)
    ms = [rng.normal(size=(2, s, s, 32)).astype(np.float32) for s in (2, 4, 8)]
    mf = rng.normal(size=(2, 16, 16, 32)).astype(np.float32)
    jm = jtd.MultiScaleMaskedTransformerDecoder(jtd.TransformerDecoderConfig(**td))
    params = _init(jm, [jnp.asarray(m) for m in ms], jnp.asarray(mf))
    return td, ms, mf, params


@pytest.mark.parametrize("from_features", [True, False])
def test_decoder_matches_jax(decoder_case, from_features):
    td, ms, mf, params = decoder_case
    jm = jtd.MultiScaleMaskedTransformerDecoder(
        jtd.TransformerDecoderConfig(**td, attn_mask_from_features=from_features))
    ref = jax.jit(jm.apply)(params, [jnp.asarray(m) for m in ms], jnp.asarray(mf))
    pm = _load(ptd.MultiScaleMaskedTransformerDecoder(
        ptd.TransformerDecoderConfig(**td, attn_mask_from_features=from_features), 32),
        params, "predictor", "sem_seg_head.predictor.")
    with torch.no_grad():
        out = pm([torch.from_numpy(m) for m in ms], torch.from_numpy(mf))
    for key in ("pred_logits", "pred_masks", "decoder_output"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL)
    assert len(out["aux_outputs"]) == len(ref["aux_outputs"]) == td["dec_layers"]
    for a, r in zip(out["aux_outputs"], ref["aux_outputs"]):
        for key in ("pred_logits", "pred_masks"):
            np.testing.assert_allclose(a[key].numpy(), np.asarray(r[key]), **TOL)


def test_resize_matches_jax_linear():
    """F.interpolate(bilinear, align_corners=False, antialias=False) equals
    jax.image.resize(linear): the 4x upsample of proposal inference and the
    antialias-free 2x/4x/8x downsamples of the decoder's attention masks."""
    x = np.random.default_rng(3).normal(size=(2, 3, 16, 16)).astype(np.float32)
    up = jax.image.resize(jnp.asarray(x), (2, 3, 64, 64), method="linear")
    np.testing.assert_allclose(ptd._resize(torch.from_numpy(x), 64, 64).numpy(),
                               np.asarray(up), atol=1e-5, rtol=1e-5)
    for s in (8, 4, 2):
        down = jax.image.resize(jnp.asarray(x), (2, 3, s, s), method="linear",
                                antialias=False)
        np.testing.assert_allclose(ptd._resize(torch.from_numpy(x), s, s).numpy(),
                                   np.asarray(down), atol=1e-5, rtol=1e-5)
