"""Weights carried across: ``state_dict_from_flax`` maps every parameter of the
JAX proposal segmenter onto the port, and the JAX package's own detectron2
converter maps the port's state dict back onto the same flax tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partdistillation_tpu.models import segmenter as jseg
from partdistillation_tpu.models.pixel_decoder import PixelDecoderConfig as JPD
from partdistillation_tpu.models.swin import SwinConfig as JSwin
from partdistillation_tpu.models.transformer_decoder import TransformerDecoderConfig as JTD
from partdistillation_tpu.utils.convert_weights import convert_mask2former_state_dict
from partdistillation_torch.models import segmenter as pseg
from partdistillation_torch.models.pixel_decoder import PixelDecoderConfig
from partdistillation_torch.models.swin import SwinConfig
from partdistillation_torch.models.transformer_decoder import TransformerDecoderConfig
from partdistillation_torch.utils.convert_weights import state_dict_from_flax

SW = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8), window_size=4)
PD = dict(conv_dim=32, mask_dim=32, transformer_layers=2, transformer_ffn_dim=64, n_heads=4,
          n_points=2)


def _flax_tree(hidden_dim: int):
    """The JAX proposal segmenter's param tree (shapes from its init), filled
    with distinct seeded values."""
    td = dict(num_classes=1, hidden_dim=hidden_dim, num_queries=8, num_heads=4,
              dim_feedforward=64, dec_layers=3, mask_dim=32)
    model = jseg.MaskFormerSegmenter(jseg.SegmenterConfig(
        swin=JSwin(**SW), pixel_decoder=JPD(**PD), decoder=JTD(**td)))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(hidden_dim)
    tree = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    return tree, td


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


# hidden 32 == conv_dim: no decoder input_proj (Mask2Former's production
# layout); hidden 48: the decoder's 1x1 input projections exist
@pytest.mark.parametrize("hidden_dim", [32, 48])
def test_round_trip_through_jax_converter(hidden_dim):
    tree, _ = _flax_tree(hidden_dim)
    sd = state_dict_from_flax(tree)
    back, unmatched = convert_mask2former_state_dict({k: v.numpy() for k, v in sd.items()})
    assert unmatched == []
    want, got = _leaves(tree), _leaves(back)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("hidden_dim", [32, 48])
def test_state_dict_loads_strict(hidden_dim):
    tree, td = _flax_tree(hidden_dim)
    sd = state_dict_from_flax(tree)
    model = pseg.MaskFormerSegmenter(pseg.SegmenterConfig(
        swin=SwinConfig(**SW), pixel_decoder=PixelDecoderConfig(**PD),
        decoder=TransformerDecoderConfig(**td)), device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    # Dense (in, out) -> Linear (out, in); Conv HWIO -> OIHW; scale -> weight;
    # q/k/v packed into in_proj_weight
    p = tree["params"]
    np.testing.assert_array_equal(
        model.backbone.layers[0].blocks[1].mlp.fc1.weight.detach().numpy(),
        p["backbone"]["stage0_block1"]["mlp_fc1"]["kernel"].T)
    np.testing.assert_array_equal(
        model.backbone.patch_embed.proj.weight.detach().numpy(),
        p["backbone"]["patch_embed"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        model.backbone.layers[0].blocks[0].norm2.weight.detach().numpy(),
        p["backbone"]["stage0_block0"]["norm2"]["scale"])
    ca = model.sem_seg_head.predictor.transformer_cross_attention_layers[2].multihead_attn
    q = p["predictor"]["layer2"]["cross_attn"]
    np.testing.assert_array_equal(
        ca.in_proj_weight.detach().numpy(),
        np.concatenate([q[f"{w}_proj"]["kernel"].T for w in "qkv"], axis=0))


def test_unknown_flax_leaf_raises():
    with pytest.raises(KeyError):
        state_dict_from_flax({"params": {"backbone": {"mystery": {"kernel": np.zeros((2, 2))}}}})


def test_tensors_are_f32_and_writable():
    tree, _ = _flax_tree(32)
    sd = state_dict_from_flax(tree)
    assert all(v.dtype == torch.float32 for v in sd.values())
    first = next(iter(sd.values()))
    first.add_(0.0)  # owns its memory
