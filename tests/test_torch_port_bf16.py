"""bf16 at Swin-L res5 width: the port runs its LN->MLP kernel numerics (f32
LayerNorm statistics) at every stage, where the JAX package falls back to
``ln_mlp_reference`` (bf16 statistics) at res5 because the weight pair
exceeds the TPU's VMEM. These tests hold the two within a stated bf16
tolerance and show that they differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from partdistillation_tpu.ops import fused_mlp as jfm
from partdistillation_torch.ops import fused_mlp as pfm


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a.detach().float())


def _mlp_inputs(rng, n, c):
    f = 4 * c
    return [rng.normal(size=s).astype(np.float32) * m + o for s, m, o in (
        ((n, c), 2.0, 0.5), ((c,), 0.3, 1.0), ((c,), 0.1, 0.0),
        ((c, f), c ** -0.5, 0.0), ((f,), 0.1, 0.0), ((f, c), f ** -0.5, 0.0),
        ((c,), 0.1, 0.0))]


def _port_mlp_args(x, scale, bias, w1, b1, w2, b2):
    return [_t(x), _t(scale), _t(bias), _t(w1.T), _t(b1), _t(w2.T), _t(b2)]


def test_fused_mlp_res5_bf16_statistics_note():
    """bf16 at a res5-like width: the port's kernel numerics (f32 LayerNorm
    statistics) against the JAX package's res5 path ``ln_mlp_reference``
    (bf16 statistics). They agree to bf16 tolerance, not exactly."""
    rng = np.random.default_rng(2)
    args = _mlp_inputs(rng, n=16, c=1536)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in args]
    ref_bf16_stats = np.asarray(jfm.ln_mlp_reference(*jb, dtype=jnp.bfloat16), np.float32)
    ref_f32_stats = np.asarray(jfm.ln_mlp_kernel_numerics(*jb), np.float32)
    out = pfm.fused_ln_mlp(*[a.to(torch.bfloat16) for a in _port_mlp_args(*args)])
    assert out.dtype == torch.bfloat16
    out = _np(out)
    scale = np.abs(ref_f32_stats).max()
    # same numerics as the JAX kernel path: a few bf16 roundings apart
    assert np.abs(out - ref_f32_stats).max() <= 2 ** -6 * scale
    # bf16 statistics (JAX res5 path): within a bf16 tolerance of 3% of the
    # output scale, and measurably different
    diff = np.abs(out - ref_bf16_stats)
    assert diff.max() <= 0.03 * scale
    assert diff.max() > 0


def test_swin_block_res5_bf16_statistics_note():
    """One Swin block at res5 width (C = 1536, 48 heads) in bf16, port vs JAX
    with the same weights: the JAX block runs ``ln_mlp_reference`` (bf16
    statistics) off-TPU and at res5 on TPU; the port runs its kernel numerics.
    The outputs agree to a bf16 tolerance of 3% of the output scale."""
    from partdistillation_tpu.models import swin as jswin
    from partdistillation_torch.models import swin as pswin
    from partdistillation_torch.utils.convert_weights import state_dict_from_flax

    c, heads, ws = 1536, 48, 4
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 4, 4, c)).astype(np.float32)
    jblk = jswin.SwinBlock(dim=c, num_heads=heads, window_size=ws, shift_size=0,
                           mlp_ratio=4.0, qkv_bias=True, qk_scale=None, drop_path=0.0,
                           dtype=jnp.bfloat16, fused_layernorm=True, fused_mlp=True,
                           qkv_layout="bfn")
    shapes = jax.eval_shape(lambda: jblk.init(jax.random.PRNGKey(0), jnp.asarray(x), True))
    params = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) * (0.02 if s.ndim == 2 else 0.1)
                   + (1.0 if s.ndim == 1 else 0.0)).astype(np.float32), shapes)
    ref = np.asarray(jblk.apply(params, jnp.asarray(x), True), np.float32)

    pblk = pswin.SwinBlock(c, heads, ws, 0, dtype=torch.bfloat16)
    sd = state_dict_from_flax({"backbone": {"stage0_block0": params["params"]}})
    pblk.load_state_dict({k.replace("backbone.layers.0.blocks.0.", ""): v
                          for k, v in sd.items()})
    with torch.no_grad():
        out = _np(pblk(_t(x)))
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 0.03 * scale
    assert np.abs(out - ref).max() > 0
