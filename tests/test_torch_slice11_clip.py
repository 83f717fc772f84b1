"""The port's CLIP towers (``models/clip_vit.py``, ``models/clip_text.py``)
and ViT helpers (``models/vit_utils.py``, ``ops/resize.py``) on the CPU, in
f32, against the JAX package's and against transformers.

- JAX's towers at tiny widths, initialised by flax and carried across with
  ``utils.convert_weights.clip_state_dict_from_flax``: the embeddings within
  1e-5 of their scale, at the pretraining size and at resized position grids
  (up and down: JAX's bicubic Keys resize); the text tower on prompts of
  several lengths with padding after the end-of-text token;
- transformers' ``CLIPVisionModelWithProjection`` / ``CLIPTextModelWithProjection``
  (tiny random configs, their state_dicts loaded as they are): within 2e-4
  (the port's LayerNorm takes flax's fast variance, HF the exact one); the
  padding does not leak into the pooled text embedding;
- ``get_abs_pos`` and the linear / cubic resizes against ``jax.image``;
  ``PatchEmbed`` against JAX's; ``config_from_hf``, ``text_config_from_hf``,
  ``normalize_clip_pixels``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from partdistillation_tpu.models import clip_text as jtext
from partdistillation_tpu.models import clip_vit as jvit
from partdistillation_tpu.models import vit_utils as jvu
from partdistillation_torch.models import clip_text as ptext
from partdistillation_torch.models import clip_vit as pvit
from partdistillation_torch.models import vit_utils as pvu
from partdistillation_torch.ops import resize as presize
from partdistillation_torch.utils.convert_weights import clip_state_dict_from_flax

VISION = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=2, num_heads=2,
              intermediate_size=64, projection_dim=16)
TEXT = dict(vocab_size=99, max_positions=12, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, projection_dim=16, eos_token_id=98)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def vision_pair():
    jcfg = jvit.CLIPVisionTowerConfig(**VISION)
    params = _np(jax.jit(jvit.CLIPVisionTower(jcfg).init)(jax.random.PRNGKey(0),
                                                           jnp.zeros((1, 32, 32, 3))))
    tower = pvit.CLIPVisionTower(pvit.CLIPVisionTowerConfig(**VISION), device="cpu", seed=3)
    missing, unexpected = tower.load_state_dict(clip_state_dict_from_flax(params, "vision"))
    assert not missing and not unexpected
    return jvit.CLIPVisionTower(jcfg), params, tower


@pytest.mark.parametrize("size", [32, 48, 24, 40])
def test_vision_tower_matches_jax(vision_pair, size):
    jtower, params, tower = vision_pair
    pixels = np.random.RandomState(size).randn(3, size, size, 3).astype(np.float32)
    want = np.asarray(jtower.apply(params, jnp.asarray(pixels)))
    with torch.no_grad():
        got = tower(torch.from_numpy(pixels)).numpy()
    assert got.shape == want.shape == (3, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def text_pair():
    jcfg = jtext.CLIPTextTowerConfig(**TEXT)
    params = _np(jax.jit(jtext.CLIPTextTower(jcfg).init)(jax.random.PRNGKey(1),
                                                          jnp.zeros((1, 12), jnp.int32)))
    tower = ptext.CLIPTextTower(ptext.CLIPTextTowerConfig(**TEXT), device="cpu", seed=4)
    missing, unexpected = tower.load_state_dict(clip_state_dict_from_flax(params, "text"))
    assert not missing and not unexpected
    return jtext.CLIPTextTower(jcfg), params, tower


def _prompts(rng, lengths, t=12, eos=98, pad=0):
    """Token rows: random ids, the end-of-text token, then padding."""
    ids = np.full((len(lengths), t), pad, np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n - 1] = rng.randint(1, 97, n - 1)
        ids[i, n - 1] = eos
    return ids


@pytest.mark.parametrize("t", [12, 7])
def test_text_tower_matches_jax(text_pair, t):
    jtower, params, tower = text_pair
    ids = _prompts(np.random.RandomState(t), [2, 5, t], t=t)
    want = np.asarray(jtower.apply(params, jnp.asarray(ids)))
    with torch.no_grad():
        got = tower(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_text_padding_does_not_leak(text_pair):
    _, _, tower = text_pair
    rng = np.random.RandomState(0)
    ids = _prompts(rng, [3, 6, 9])
    other = ids.copy()
    for i, n in enumerate([3, 6, 9]):
        other[i, n:] = rng.randint(1, 97, 12 - n)
    with torch.no_grad():
        a, b = tower(torch.from_numpy(ids)), tower(torch.from_numpy(other))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_vision_tower_matches_transformers():
    hcfg = transformers.CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                                         num_hidden_layers=2, num_attention_heads=2,
                                         image_size=32, patch_size=8, projection_dim=16)
    torch.manual_seed(0)
    hf = transformers.CLIPVisionModelWithProjection(hcfg).eval()
    cfg = pvit.config_from_hf(hcfg)
    assert cfg == pvit.CLIPVisionTowerConfig(**VISION)
    tower = pvit.CLIPVisionTower(cfg, device="cpu")
    tower.load_state_dict(hf.state_dict(), strict=False)
    pixels = np.random.RandomState(0).randn(3, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        want = hf(torch.from_numpy(pixels).permute(0, 3, 1, 2)).image_embeds.numpy()
        got = tower(torch.from_numpy(pixels)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_text_tower_matches_transformers():
    hcfg = transformers.CLIPTextConfig(vocab_size=99, hidden_size=32, intermediate_size=64,
                                       num_hidden_layers=2, num_attention_heads=4,
                                       max_position_embeddings=12, projection_dim=16,
                                       eos_token_id=98, pad_token_id=0)
    torch.manual_seed(1)
    hf = transformers.CLIPTextModelWithProjection(hcfg).eval()
    cfg = ptext.text_config_from_hf(hcfg)
    assert cfg == ptext.CLIPTextTowerConfig(**TEXT)
    tower = ptext.CLIPTextTower(cfg, device="cpu")
    tower.load_state_dict(hf.state_dict(), strict=False)
    rng = np.random.RandomState(2)
    ids = _prompts(rng, [3, 8, 12])
    other = ids.copy()
    other[0, 3:] = rng.randint(1, 97, 9)  # other padding after the end-of-text token
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids).long()).text_embeds.numpy()
        got = tower(torch.from_numpy(ids)).numpy()
        got_other = tower(torch.from_numpy(other)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    np.testing.assert_array_equal(got_other, got)


@pytest.mark.parametrize("hw", [(6, 6), (3, 5), (4, 4), (9, 2)])
def test_get_abs_pos_matches_jax(hw):
    pos = np.random.RandomState(5).randn(1, 17, 8).astype(np.float32)
    want = np.asarray(jvu.get_abs_pos(jnp.asarray(pos), True, hw))
    got = pvu.get_abs_pos(torch.from_numpy(pos), True, hw).numpy()
    assert got.shape == want.shape == (1, *hw, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("method,kernel", [("linear", presize.triangle_kernel),
                                           ("bicubic", presize.keys_cubic_kernel)])
@pytest.mark.parametrize("hw", [(10, 12), (4, 5), (7, 3)])
def test_resize_matches_jax_image_resize(method, kernel, hw):
    x = np.random.RandomState(6).randn(7, 7, 5).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (*hw, 5), method))
    got = presize.resize(torch.from_numpy(x), *hw, kernel).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(want).max())


def test_patch_embed_matches_jax():
    x = np.random.RandomState(7).randn(2, 24, 16, 3).astype(np.float32)
    jpe = jvu.PatchEmbed(embed_dim=8, patch_size=(8, 8), stride=(8, 8))
    params = _np(jpe.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jpe.apply(params, jnp.asarray(x)))
    pe = pvu.PatchEmbed(3, 8, (8, 8), (8, 8))
    with torch.no_grad():
        pe.weight.copy_(torch.from_numpy(params["params"]["proj"]["kernel"].transpose(3, 2, 0, 1)))
        pe.bias.copy_(torch.from_numpy(params["params"]["proj"]["bias"]))
        got = pe(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 3, 2, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_normalize_clip_pixels_matches_jax():
    x = np.random.RandomState(8).rand(2, 4, 4, 3).astype(np.float32)
    want = np.asarray(jvit.normalize_clip_pixels(jnp.asarray(x)))
    got = pvit.normalize_clip_pixels(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_clip_state_dict_from_flax_refuses_unknown_leaves():
    with pytest.raises(KeyError, match="no port key"):
        clip_state_dict_from_flax({"params": {"mystery": {"kernel": np.zeros((2, 2))}}}, "text")
    with pytest.raises(ValueError, match="tower"):
        clip_state_dict_from_flax({}, "audio")
