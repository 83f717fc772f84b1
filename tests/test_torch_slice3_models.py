"""The port's modules in their kernel configuration (CPU, f32) against the
JAX package's: ``MSDeformAttn`` and the pixel decoder against JAX's with
``msda_mode="pallas_folded"`` (the JAX side runs its P-folded Pallas kernel
in interpret mode; the port's one sampling formulation is that function),
Swin with ``fused_proj=True``, forward and gradients, and the weight bridge,
which needs no new keys for either option.

Weights come from the JAX init (random sampling-offset kernels, so that the
taps leave the grid) and cross with ``state_dict_from_flax``; inputs come
from numpy generators. Tolerances (f32): forwards within 1e-5 of max |JAX|,
each gradient within 1e-4 of its max |JAX|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partdistillation_tpu.models import attention as jatt
from partdistillation_tpu.models import pixel_decoder as jpd
from partdistillation_tpu.models import segmenter as jseg
from partdistillation_tpu.models import swin as jswin
from partdistillation_tpu.models.transformer_decoder import TransformerDecoderConfig as JTD
from partdistillation_torch.models import attention as patt
from partdistillation_torch.models import pixel_decoder as ppd
from partdistillation_torch.models import segmenter as pseg
from partdistillation_torch.models import swin as pswin
from partdistillation_torch.models.transformer_decoder import TransformerDecoderConfig
from partdistillation_torch.utils.convert_weights import state_dict_from_flax

FWD, GRAD = 1e-5, 1e-4
FEATS = {"res2": (16, 16), "res3": (32, 8), "res4": (64, 4), "res5": (128, 2)}
SW = dict(embed_dim=16, depths=(2, 2, 1, 1), num_heads=(1, 2, 4, 8), window_size=4)
PD = dict(conv_dim=32, mask_dim=32, transformer_layers=2, transformer_ffn_dim=64, n_heads=4,
          n_points=2)


def _close(out, ref, tol, name=""):
    out = np.asarray(out.detach() if isinstance(out, torch.Tensor) else out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert scale > 0 and err <= tol * scale, (name, err, scale)


def _init(module, *inputs):
    params = jax.jit(module.init)(jax.random.PRNGKey(0), *inputs)
    return jax.tree_util.tree_map(np.asarray, params)


def _load(port_module, params, scope, prefix):
    sd = state_dict_from_flax({scope: params})
    port_module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return port_module


def _random_offsets(rng, tree):
    """The JAX init zeroes the sampling-offset kernels; random ones move the
    taps off the grid and give them gradients."""
    stack = [tree]
    while stack:
        node = stack.pop()
        for key, sub in node.items():
            if key == "sampling_offsets":
                sub["kernel"] = (rng.normal(size=sub["kernel"].shape) * 0.3).astype(np.float32)
            elif isinstance(sub, dict):
                stack.append(sub)


def _param_grads(module):
    return {n: p.grad for n, p in module.named_parameters()}


def _compare_grads(port_grads, jax_grads, scope, prefix):
    want = state_dict_from_flax({scope: jax_grads})
    assert set(want) == {prefix + n for n in port_grads}
    for name, g in port_grads.items():
        w = want[prefix + name]
        if not w.abs().max() > 0:  # no gradient in exact arithmetic
            assert g is None or g.abs().max() <= 1e-6, name
            continue
        _close(g, w.numpy(), GRAD, name)


@pytest.mark.parametrize("mode", ["pallas_folded", None])
def test_msdeform_attn_matches_jax(mode):
    """One MSDeformAttn layer, forward and parameter gradients, against JAX's
    in ``pallas_folded`` mode and in its default one (the same function)."""
    rng = np.random.default_rng(0)
    shapes = ((2, 3), (4, 6), (1, 1))
    s, b, c = sum(h * w for h, w in shapes), 2, 32
    query = rng.normal(size=(b, s, c)).astype(np.float32)
    value = rng.normal(size=(b, s, c)).astype(np.float32)
    ref_pts = rng.uniform(0.0, 1.0, size=(b, s, len(shapes), 2)).astype(np.float32)
    g = rng.normal(size=(b, s, c)).astype(np.float32)
    jm = jatt.MSDeformAttn(dim=c, n_levels=3, n_heads=4, n_points=2, msda_mode=mode)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: jm.init(key, query, ref_pts, value, shapes))(jax.random.PRNGKey(0)))
    _random_offsets(rng, params["params"])

    def loss(p):
        out = jm.apply(p, query, ref_pts, value, shapes)
        return jnp.sum(out * g), out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    pm = patt.MSDeformAttn(c, 3, 4, 2)
    prefix = "sem_seg_head.pixel_decoder.transformer.encoder.layers.0.self_attn."
    _load(pm, {"layer0": {"self_attn": params["params"]}}, "pixel_decoder", prefix)
    out = pm(torch.from_numpy(query), torch.from_numpy(ref_pts), torch.from_numpy(value), shapes)
    _close(out, ref, FWD)
    out.backward(torch.from_numpy(g))
    _compare_grads(_param_grads(pm), {"layer0": {"self_attn": jgrads["params"]}},
                   "pixel_decoder", prefix)


def test_pixel_decoder_pallas_folded_matches_jax():
    rng = np.random.default_rng(1)
    feats = {k: rng.normal(size=(2, s, s, c)).astype(np.float32) for k, (c, s) in FEATS.items()}
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    jm = jpd.MSDeformAttnPixelDecoder(jpd.PixelDecoderConfig(**PD, msda_mode="pallas_folded"))
    params = _init(jm, jfeats)
    _random_offsets(rng, params["params"])
    mf, enc, ms = jax.jit(jm.apply)(params, jfeats)
    pm = _load(ppd.MSDeformAttnPixelDecoder(ppd.PixelDecoderConfig(**PD),
                                            {k: c for k, (c, _) in FEATS.items()}),
               params["params"], "pixel_decoder", "sem_seg_head.pixel_decoder.")
    with torch.no_grad():
        pmf, penc, pms = pm({k: torch.from_numpy(v) for k, v in feats.items()})
    _close(pmf, mf, FWD, "mask_features")
    _close(penc, enc, FWD, "encoder_feature")
    for i, (a, r) in enumerate(zip(pms, ms)):
        _close(a, r, FWD, f"level {i}")


@pytest.fixture(scope="module")
def swin_case():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    jm = jswin.SwinTransformer(jswin.SwinConfig(**SW, drop_path_rate=0.0, fused_proj=True))
    params = _init(jm, jnp.asarray(x))
    projections = {k: rng.normal(size=(2, 64 // s, 64 // s, c)).astype(np.float32)
                   for k, (c, s) in zip(("res2", "res3", "res4", "res5"),
                                        ((16, 4), (32, 8), (64, 16), (128, 32)))}

    def loss(p):
        outs = jm.apply(p, jnp.asarray(x))
        return sum(jnp.sum(outs[k] * projections[k]) for k in outs), outs

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    pm = _load(pswin.SwinTransformer(pswin.SwinConfig(**SW, fused_proj=True)),
               params["params"], "backbone", "backbone.")
    out = pm(torch.from_numpy(x))
    sum((out[k] * torch.from_numpy(projections[k])).sum() for k in out).backward()
    return ref, grads, out, pm


def test_swin_fused_proj_matches_jax(swin_case):
    ref, _, out, _ = swin_case
    assert set(out) == set(ref)
    for key in ref:
        _close(out[key], ref[key], FWD, key)


def test_swin_fused_proj_gradients_match_jax(swin_case):
    _, grads, _, pm = swin_case
    _compare_grads(_param_grads(pm), grads["params"], "backbone", "backbone.")


def test_fused_proj_runs_the_fused_op_at_every_stage(monkeypatch):
    """With ``fused_proj`` every block, res5 included, calls the fused
    attention + projection op and never the two-step window attention."""
    calls = {"fused": 0, "two_step": 0}
    real = pswin.fused_window_attention_proj

    def fused(*a, **k):
        calls["fused"] += 1
        return real(*a, **k)

    def two_step(*a, **k):
        calls["two_step"] += 1
        raise AssertionError("two-step window attention called")

    monkeypatch.setattr(pswin, "fused_window_attention_proj", fused)
    monkeypatch.setattr(pswin, "fused_window_attention", two_step)
    model = pswin.SwinTransformer(pswin.SwinConfig(**SW, fused_proj=True))
    with torch.no_grad():
        model(torch.zeros(1, 64, 64, 3))
    assert calls == {"fused": sum(SW["depths"]), "two_step": 0}


def test_weight_bridge_needs_no_new_keys():
    """The kernel options leave the parameter tree as it was: the JAX tree of
    the kernel configuration maps onto the port's state dict with the same
    keys as the default configuration's."""
    td = dict(num_classes=1, hidden_dim=32, num_queries=8, num_heads=4, dim_feedforward=64,
              dec_layers=2, mask_dim=32)

    def flax_keys(fused_proj, mode):
        model = jseg.MaskFormerSegmenter(jseg.SegmenterConfig(
            swin=jswin.SwinConfig(**SW, fused_proj=fused_proj),
            pixel_decoder=jpd.PixelDecoderConfig(**PD, msda_mode=mode), decoder=JTD(**td)))
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
        tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
        return set(state_dict_from_flax(tree))

    port = pseg.MaskFormerSegmenter(pseg.SegmenterConfig(
        swin=pswin.SwinConfig(**SW, fused_proj=True),
        pixel_decoder=ppd.PixelDecoderConfig(**PD),
        decoder=TransformerDecoderConfig(**td)), device="cpu")
    keys = flax_keys(True, "pallas_folded")
    assert keys == flax_keys(False, None) == set(port.state_dict())
