"""The port's window attention fused with the output projection
(``ops/fused_attention.fused_window_attention_proj``; its plain version on
the CPU) against the JAX package: the Pallas ``_fwd_kernel_attn_proj`` in
interpret mode for the forward, its ``custom_vjp`` backward
(``_fused_attn_proj_bwd``, grouped bias reduced over its group) for the
gradients, for both forms of the grouped bias (one block for every window;
one per window position, as the shift mask gives).

Inputs come from one numpy generator and go to both packages. The port takes
the projection weight in ``nn.Linear`` layout (C, H*D); the JAX package in
flax layout (H*D, C). Tolerances (f32): the forward within 1e-5 of max |JAX|,
each gradient within 1e-4 of its max |JAX|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partdistillation_tpu.ops import fused_attention as jfa
from partdistillation_torch.ops import autograd as ag
from partdistillation_torch.ops import fused_attention as pfa

FWD, GRAD = 1e-5, 1e-4
B, H, D, N, SCALE = 8, 3, 16, 24, 0.25


def _close(out, ref, tol, name=""):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert scale > 0 and err <= tol * scale, (name, err, scale)


def _inputs(groups, c, seed=0):
    rng = np.random.default_rng(seed)
    qt, kt, vt = (rng.normal(size=(B, H, D, N)).astype(np.float32) for _ in range(3))
    bias = rng.normal(size=(groups, H, N, N)).astype(np.float32)
    bias[..., :5] -= 100.0  # shift-mask-like blocked pairs
    w = (rng.normal(size=(H * D, c)) * (H * D) ** -0.5).astype(np.float32)  # flax layout
    b = rng.normal(size=(c,)).astype(np.float32) * 0.1
    return qt, kt, vt, bias, w, b


def _port(qt, kt, vt, bias, w, b):
    """The port's arguments: torch tensors, w transposed to (C, H*D)."""
    return [torch.from_numpy(np.array(a)) for a in (qt, kt, vt, bias, w.T, b)]


@pytest.mark.parametrize("c", [H * D, 40])
@pytest.mark.parametrize("groups", [1, 4])
def test_window_attention_proj_matches_pallas_interpret(groups, c):
    args = _inputs(groups, c)
    ref = jfa._attn_proj_fwd_pallas(*map(jnp.asarray, args), SCALE, interpret=True)
    out = pfa.fused_window_attention_proj(*_port(*args), scale=SCALE)
    assert out.shape == (B, N, c)
    _close(out, ref, FWD)
    _close(out, jfa.window_attention_proj_reference(*map(jnp.asarray, args), SCALE), FWD)
    assert ag.launch_counts("window_attention_proj") == {"window_attention_proj": 0}


@pytest.mark.parametrize("groups", [1, 4])
def test_window_attention_proj_gradients_match_jax(groups):
    args = _inputs(groups, H * D, seed=1)
    g = np.random.default_rng(2).normal(size=(B, N, H * D)).astype(np.float32)
    want = jfa._fused_attn_proj_bwd(SCALE, tuple(map(jnp.asarray, args)), jnp.asarray(g))
    inputs = [t.requires_grad_() for t in _port(*args)]
    pfa.fused_window_attention_proj(*inputs, scale=SCALE).backward(torch.from_numpy(g))
    for name, t, r in zip(("qt", "kt", "vt", "bias", "w", "b"), inputs, want):
        got = t.grad.T if name == "w" else t.grad
        _close(got, r, GRAD, name)


def test_window_attention_proj_without_bias_vector():
    qt, kt, vt, bias, w, _ = _inputs(4, H * D, seed=3)
    ref = jfa.window_attention_proj_reference(*map(jnp.asarray, (qt, kt, vt, bias, w)), None,
                                              SCALE)
    port = _port(qt, kt, vt, bias, w, np.zeros(1, np.float32))[:5]
    _close(pfa.fused_window_attention_proj(*port, None, scale=SCALE), ref, FWD)
