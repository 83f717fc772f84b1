"""The train step's ops on the CPU against the JAX package: the
masked-attention backward (the plain version of kernel #5 against the Pallas
``_bwd_kernel`` in interpret mode, and autograd through the port's wrapper
against ``jax.vjp`` of the JAX wrapper), the plain-version VJP that the three
forward-only trunk kernels take on CUDA, and DropPath in a Swin block fed the
JAX block's own keep decisions.

Tolerances: f32 throughout; gradients within 1e-5 of each tensor's max |ref|
(products summed in another order), the Swin block within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from partdistillation_tpu.ops.fused_attention import _fused_bwd_pallas
from partdistillation_tpu.ops.fused_attention import fused_masked_attention as j_masked
from partdistillation_tpu.models import swin as jswin
from partdistillation_torch.models.swin import SwinBlock
from partdistillation_torch.ops import fused_attention as fa
from partdistillation_torch.ops import fused_mlp as fm
from partdistillation_torch.ops import layer_norm as ln
from partdistillation_torch.ops.autograd import kernel_op
from partdistillation_torch.utils.convert_weights import state_dict_from_flax


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def _attn_inputs(seed, b=2, h=3, nq=37, nk=300, d=32, mask_heads=1, blocked_rows=3,
                 with_mask=True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, nq, d)).astype(np.float32) * d ** -0.5
    k, v = (rng.standard_normal((b, h, nk, d)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((b, h, nq, d)).astype(np.float32)
    mask = None
    if with_mask:
        mask = rng.random((b, mask_heads, nq, nk)) < 0.6
        mask[:, :, :blocked_rows] = True  # all-blocked rows take the fix-up
    return q, k, v, mask, g


CASES = {"shared_mask": {}, "per_head_mask": dict(mask_heads=3),
         "ragged_small": dict(nq=5, nk=3, d=16, blocked_rows=1),
         "no_mask": dict(nq=64, nk=128, with_mask=False)}


@pytest.mark.parametrize("case", CASES)
def test_masked_attention_bwd_plain_matches_pallas_bwd_kernel(case):
    q, k, v, mask, g = _attn_inputs(0, **CASES[case])
    neg = None
    if mask is not None:
        eff = mask & ~mask.all(-1, keepdims=True)
        neg = jnp.asarray(np.where(eff, np.float32(-1e9), np.float32(0.0)))
    ref = _fused_bwd_pallas(*(jnp.asarray(a) for a in (q, k, v)), neg, jnp.asarray(g),
                            interpret=True)
    got = fa.masked_attention_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask), torch.from_numpy(g))
    for a, r in zip(got, ref):
        _close(a.numpy(), r)


@pytest.mark.parametrize("case", ["shared_mask", "per_head_mask", "no_mask"])
def test_masked_attention_autograd_matches_jax_vjp(case):
    q, k, v, mask, g = _attn_inputs(1, **CASES[case])
    jm = None if mask is None else jnp.asarray(mask)
    out, vjp = jax.vjp(lambda a, b, c: j_masked(a, b, c, jm), *(jnp.asarray(a) for a in (q, k, v)))
    ref = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    pout = fa.fused_masked_attention(*leaves, None if mask is None else torch.from_numpy(mask))
    _close(pout.detach().numpy(), out)
    got = torch.autograd.grad(pout, leaves, torch.from_numpy(g))
    for a, r in zip(got, ref):
        _close(a.numpy(), r)
    plain = fa.masked_attention_bwd_plain(*(t.detach() for t in leaves),
                                          None if mask is None else torch.from_numpy(mask),
                                          torch.from_numpy(g))
    for a, p in zip(got, plain):
        _close(a.numpy(), p.numpy())


def _randn(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _plain_vjp_cases(rng):
    n, c = 12, 16
    mlp = (_randn(rng, n, c), _randn(rng, c) + 1.0, _randn(rng, c), _randn(rng, 4 * c, c),
           _randn(rng, 4 * c), _randn(rng, c, 4 * c), _randn(rng, c))
    win = (_randn(rng, 6, 2, 8, 9), _randn(rng, 6, 2, 8, 9), _randn(rng, 6, 2, 8, 9),
           _randn(rng, 3, 2, 9, 9))
    return {
        "layer_norm": (ln.layer_norm_plain, (_randn(rng, n, c, scale=3.0), _randn(rng, c),
                                             _randn(rng, c))),
        "mlp_residual": (fm.ln_mlp_kernel_numerics, mlp),
        "mlp_branch": (lambda *a: fm.ln_mlp_kernel_numerics(*a, add_residual=False), mlp),
        "window_grouped_bias": (lambda *a: fa.window_attention_plain(*a, scale=8 ** -0.5), win),
    }


@pytest.mark.parametrize("name", ["layer_norm", "mlp_residual", "mlp_branch",
                                  "window_grouped_bias"])
def test_plain_vjp_gives_the_plain_versions_gradients(name):
    """What the forward-only kernels' route runs on CUDA: the forward from a
    'kernel' (here the plain version), the backward from the plain version's
    VJP (``KernelOp`` with no backward launcher); gradients must equal the
    plain version's autograd, the grouped window bias's summed over its
    group."""
    plain, inputs = _plain_vjp_cases(np.random.default_rng(2))[name]
    leaves = [t.clone().requires_grad_() for t in inputs]
    out = kernel_op(name, plain, plain, *leaves)
    assert out.grad_fn is not None
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [t.clone().requires_grad_() for t in inputs]
    ref = torch.autograd.grad(plain(*ref_leaves), ref_leaves, g)
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        _close(a.numpy(), r.numpy(), 1e-6)
    with torch.no_grad():
        assert kernel_op(name, plain, plain, *leaves).grad_fn is None


def _record_drop_path(store):
    """flax interceptor: records each active DropPath's per-image keep
    decisions (kept images come out non-zero) under (block, which)."""

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        mod = context.module
        deterministic = args[1] if len(args) > 1 else kwargs.get("deterministic")
        if isinstance(mod, jswin.DropPath) and not deterministic and mod.rate > 0:
            kept = np.asarray(jnp.any(out != 0, axis=tuple(range(1, out.ndim))))
            store[(mod.parent.name, mod.name)] = kept
        return out

    return interceptor


@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block_drop_path_matches_jax(shift):
    dim, heads, ws, rate = 16, 2, 4, 0.3
    jblock = jswin.SwinBlock(dim=dim, num_heads=heads, window_size=ws, shift_size=shift,
                             mlp_ratio=4.0, qkv_bias=True, qk_scale=None, drop_path=rate,
                             fused_layernorm=True, fused_mlp=True, qkv_layout="bfn",
                             name="stage0_block0")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 8, 8, dim)).astype(np.float32)
    params = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x), deterministic=True)
    key = jax.random.PRNGKey(7)
    store = {}
    with nn.intercept_methods(_record_drop_path(store)):
        ref = jblock.apply(params, jnp.asarray(x), deterministic=False, rngs={"dropout": key})
    keep = np.stack([store[("stage0_block0", "drop_path1")],
                     store[("stage0_block0", "drop_path2")]])
    assert not keep.all() and keep.any()  # this key drops some images and keeps others

    sd = state_dict_from_flax({"backbone": {"stage0_block0": params["params"]}})
    block = SwinBlock(dim, heads, ws, shift, drop_path=rate).train()
    block.load_state_dict({k.removeprefix("backbone.layers.0.blocks.0."): v
                           for k, v in sd.items()})
    with torch.no_grad():
        out = block(torch.from_numpy(x), torch.from_numpy(keep))
        det = block(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    jdet = jblock.apply(params, jnp.asarray(x), deterministic=True)
    np.testing.assert_allclose(det.numpy(), np.asarray(jdet), atol=1e-4, rtol=1e-4)


def test_training_after_inference_mode():
    """Swin's cached relative-position index and shift mask, first built under
    ``torch.inference_mode`` (an evaluation pass), still serve autograd: the
    train step's evaluation hook runs inference between steps."""
    from partdistillation_torch.models import swin

    swin._relative_position_index.cache_clear()
    swin._shift_attn_mask.cache_clear()
    block = SwinBlock(16, 2, 4, 2, drop_path=0.2).train()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 12, 12, 16),
                                                                  ).astype(np.float32))
    with torch.inference_mode():
        block(x)
    out = block(x, torch.tensor([[True, False], [True, True]]))
    out.square().mean().backward()
    assert block.attn.relative_position_bias_table.grad.abs().max() > 0
