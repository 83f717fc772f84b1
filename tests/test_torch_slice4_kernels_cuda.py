"""The redesigned kernels of slice 4 on the card: the LN -> MLP GEMM kernel
(``csrc/fused_mlp.cu``: wgmma on TMA-fed stages) at every main-path shape
and at ragged token counts, and the key-split masked-attention forward
(``csrc/masked_attention.cu``) at every main-path key count, a key count
below one tile, per-head masks and all-blocked rows, its log-sum-exp, and the
backward kernel fed by it.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false. On a machine with a card and no JAX (the tests' conftest imports JAX):
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_slice4_kernels_cuda.py``.

Tolerances: bf16 kernel vs plain version on the same inputs, max |err|
within 2^-6 of max |plain| (the MLP: bf16 hidden and output roundings; the
attention: bf16 probabilities before P.V and the output rounding, the f32
sums in another order); the log-sum-exp within 1e-4 x max(1, |lse|) of the
f32 log-sum-exp of the same scores (only the order of f32 sums differs).
"""

import numpy as np
import pytest
import torch

from partdistillation_torch.ops import autograd as ag
from partdistillation_torch.ops import fused_attention as fa
from partdistillation_torch.ops import fused_mlp as fm

pytestmark = pytest.mark.cuda
BF = torch.bfloat16
TOL = 2.0 ** -6


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _randn(g, *shape, dtype=BF, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def _close(out, ref, rel):
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert np.isfinite(err) and err <= rel * ref.float().abs().max().item(), err


def _mlp_args(g, n, c):
    f = 4 * c
    return (_randn(g, n, c), _randn(g, c, scale=0.5) + 1.0, _randn(g, c, scale=0.1),
            _randn(g, f, c, scale=c ** -0.5), _randn(g, f, scale=0.1),
            _randn(g, c, f, scale=f ** -0.5), _randn(g, c, scale=0.1))


# the four main-path shapes (B=2 at 640^2: res2..res5), then token counts off
# the 128-row tile (3001 and 12801 take the 96- and 128-column tiles, the
# others the 64), a width below one 64-column K tile and one that is not a
# multiple of 64
MLP_SHAPES = [(51200, 192), (12800, 384), (3200, 768), (800, 1536),
              (37, 32), (130, 96), (3001, 768), (12801, 384), (17, 1536), (333, 400)]


@pytest.mark.parametrize("add_residual", [True, False])
@pytest.mark.parametrize("n,c", MLP_SHAPES)
def test_mlp_kernel_matches_plain(gen, n, c, add_residual):
    args = _mlp_args(gen, n, c)
    ag.reset_launches()
    out = fm.fused_ln_mlp(*args, add_residual=add_residual)
    assert ag.launch_counts("fused_ln_mlp") == {"fused_ln_mlp": 1} and out.shape == (n, c)
    _close(out, fm.ln_mlp_kernel_numerics(*args, add_residual=add_residual), TOL)


def test_mlp_kernel_refuses_misaligned_weights(gen):
    args = list(_mlp_args(gen, 64, 32))
    args[3] = torch.empty(128 * 32 + 1, dtype=BF, device="cuda")[1:].view(128, 32)
    with pytest.raises(ValueError):
        fm.fused_ln_mlp(*args)


def _attn_inputs(g, nq, nk, d, mh, h=8, blocked=0.6):
    q = _randn(g, 2, h, nq, d, scale=d ** -0.5)
    k, v = _randn(g, 2, h, nk, d), _randn(g, 2, h, nk, d)
    mask = torch.rand((2, mh, nq, nk), generator=g, device="cuda") < blocked
    mask[:, :, : max(nq // 8, 1)] = True  # all-blocked rows take the fix-up
    return q, k, v, mask


def _lse_ref(q, k, mask):
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    eff = mask & ~mask.all(-1, keepdim=True)
    return torch.logsumexp(logits.masked_fill(eff, float("-inf")), -1)


# (Q, K, D, mask heads): the main path's three key counts with the shared
# mask, each with per-head masks too, K below one 32-key tile, a ragged K
ATTN = [(200, 400, 32, 1), (200, 1600, 32, 1), (200, 6400, 32, 1),
        (200, 400, 32, 8), (200, 1600, 32, 8), (200, 6400, 32, 8),
        (37, 20, 32, 1), (70, 129, 64, 8), (5, 3, 16, 1), (200, 1000, 128, 1)]


@pytest.mark.parametrize("nq,nk,d,mh", ATTN)
def test_masked_attention_kernel_matches_split_plain(gen, nq, nk, d, mh):
    q, k, v, mask = _attn_inputs(gen, nq, nk, d, mh)
    ag.reset_launches()
    out, lse, _ = fa.masked_attention_fwd_lse(q, k, v, mask)
    assert ag.launch_counts("fused_masked_attention") == {"fused_masked_attention": 1}
    n_split = fa.masked_attention_plan(2, 8, nq, nk, d)["n_split"]
    out_s, lse_s = fa.masked_attention_split_plain(q, k, v, mask, n_split)
    _close(out, out_s, TOL)
    _close(out, fa.masked_attention_plain(q, k, v, mask), TOL)
    ref = _lse_ref(q, k, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(lse).all()
    assert ((lse - ref).abs() <= 1e-4 * ref.abs().clamp(min=1.0)).all()
    assert ((lse_s - ref).abs() <= 1e-4 * ref.abs().clamp(min=1.0)).all()
    # the inference entry point (no lse) gives the same output
    _close(fa.fused_masked_attention(q, k, v, mask), out, 0.0)


def test_masked_attention_split_wholly_blocked(gen):
    """Rows whose unblocked keys all lie in one split: every other split
    sees none (m = -inf, l = 0) and must weigh nothing, with no NaN."""
    nq, nk = 64, 6400
    q, k, v, _ = _attn_inputs(gen, nq, nk, 32, 1)
    mask = torch.ones((2, 1, nq, nk), dtype=torch.bool, device="cuda")
    mask[:, :, :, 5000:5010] = False
    mask[:, :, :3] = True  # and all-blocked rows
    out, lse, _ = fa.masked_attention_fwd_lse(q, k, v, mask)
    _close(out, fa.masked_attention_plain(q, k, v, mask), TOL)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    ref = _lse_ref(q, k, mask)
    assert ((lse - ref).abs() <= 1e-4 * ref.abs().clamp(min=1.0)).all()


@pytest.mark.parametrize("nk,mh", [(400, 1), (1600, 8), (6400, 1), (129, 8)])
def test_backward_kernel_on_the_split_forward(gen, nk, mh):
    q, k, v, mask = _attn_inputs(gen, 200, nk, 32, mh)
    g_out = _randn(gen, 2, 8, 200, 32)
    out, lse, emask = fa.masked_attention_fwd_lse(q, k, v, mask)
    got = fa.fused_masked_attention_bwd(q, k, v, emask, out, lse, g_out)
    want = fa.masked_attention_bwd_plain(q, k, v, mask, g_out)
    for a, b in zip(got, want):
        _close(a, b, TOL)
