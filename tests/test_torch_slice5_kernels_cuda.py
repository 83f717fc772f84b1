"""The redesigned kernels of slice 5 on the card: the one-pass masked-attention
backward (``csrc/masked_attention_bwd.cu``) against its algorithm in PyTorch
(``masked_attention_bwd_split_plain``) and the plain backward at every
main-path key count and at ragged shapes, and bitwise the same from run to
run; the register-resident window attention (``csrc/window_attention.cu``)
against ``window_attention_plain`` at its eight main-path shapes and at
ragged ones.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false. On a machine with a card and no JAX (the tests' conftest imports JAX):
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_slice5_kernels_cuda.py``.

Tolerances: bf16 kernel vs plain version on the same inputs, max |err|
within 2^-6 of max |plain| (bf16 P, dS, probabilities and output roundings,
f32 sums in another order).
"""

import numpy as np
import pytest
import torch

from partdistillation_torch.ops import autograd as ag
from partdistillation_torch.ops import fused_attention as fa

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


def _bwd_inputs(g, b, h, nq, nk, d, mh):
    q = _randn(g, b, h, nq, d, scale=d ** -0.5)
    k, v, g_out = _randn(g, b, h, nk, d), _randn(g, b, h, nk, d), _randn(g, b, h, nq, d)
    mask = torch.rand((b, mh, nq, nk), generator=g, device="cuda") < 0.6
    mask[:, :, : max(nq // 8, 1)] = True  # all-blocked rows take the fix-up
    out, lse, emask = fa.masked_attention_fwd_lse(q, k, v, mask)
    return q, k, v, g_out, mask, out, lse, emask


# (B, H, Q, K, D, mask heads): the main path's three key counts with the shared
# mask and a per-head one, then ragged queries and keys, wider heads, one key,
# fewer heads than a full group
BWD_CASES = [(2, 8, 200, 400, 32, 1), (2, 8, 200, 1600, 32, 1), (2, 8, 200, 6400, 32, 1),
             (2, 8, 200, 400, 32, 8), (2, 8, 200, 1600, 32, 8), (2, 8, 200, 6400, 32, 8),
             (2, 8, 37, 129, 32, 1), (2, 8, 200, 129, 64, 8), (1, 2, 70, 1000, 16, 1),
             (2, 8, 5, 3, 32, 8), (1, 4, 33, 1, 128, 1)]


@pytest.mark.parametrize("b,h,nq,nk,d,mh", BWD_CASES)
def test_bwd_kernel_matches_split_plain_and_plain(gen, b, h, nq, nk, d, mh):
    q, k, v, g_out, mask, out, lse, emask = _bwd_inputs(gen, b, h, nq, nk, d, mh)
    ag.reset_launches()
    got = fa.fused_masked_attention_bwd(q, k, v, emask, out, lse, g_out)
    assert ag.launch_counts("fused_masked_attention_bwd") == {"fused_masked_attention_bwd": 1}
    split = fa.masked_attention_bwd_split_plain(q, k, v, emask, out, lse, g_out)
    plain = fa.masked_attention_bwd_plain(q, k, v, mask, g_out)
    for a, s, p in zip(got, split, plain):
        assert a.dtype == BF and a.shape == p.shape
        if nk == 1 and a is not got[2]:
            continue  # one key: dq and dk are rounding noise (dS = 0 exactly)
        _close(a, s, TOL)
        _close(a, p, TOL)


@pytest.mark.parametrize("nk,mh", [(400, 1), (1600, 8), (6400, 1)])
def test_bwd_kernel_is_reproducible(gen, nk, mh):
    """No atomics: the partials are summed in a fixed order."""
    q, k, v, g_out, _, out, lse, emask = _bwd_inputs(gen, 2, 8, 200, nk, 32, mh)
    first = fa.fused_masked_attention_bwd(q, k, v, emask, out, lse, g_out)
    second = fa.fused_masked_attention_bwd(q, k, v, emask, out, lse, g_out)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# window attention (Bw, H, D, N, P): Swin-L's eight main-path shapes at B=2,
# 640^2 (each stage unshifted and shifted), then ragged N (49: byte-wise
# copies), head widths off 16 and odd group counts
WINDOW_CASES = [(392, 6, 32, 144, 1), (392, 6, 32, 144, 196), (98, 12, 32, 144, 1),
                (98, 12, 32, 144, 49), (32, 24, 32, 144, 1), (32, 24, 32, 144, 16),
                (8, 48, 32, 144, 1), (8, 48, 32, 144, 4), (6, 3, 32, 49, 3), (4, 2, 8, 16, 1),
                (8, 4, 24, 144, 2), (21, 3, 64, 144, 3), (10, 5, 48, 100, 5)]


@pytest.mark.parametrize("bw,h,d,n,p", WINDOW_CASES)
def test_window_kernel_matches_plain(gen, bw, h, d, n, p):
    qt, kt, vt = (_randn(gen, bw, h, d, n) for _ in range(3))
    bias = torch.randn((p, h, n, n), generator=gen, device="cuda")
    bias[..., : n // 3] -= 100.0  # shift-mask-like blocked pairs
    ag.reset_launches()
    out = fa.fused_window_attention(qt, kt, vt, bias, scale=d ** -0.5)
    assert ag.launch_counts("fused_window_attention") == {"fused_window_attention": 1}
    _close(out, fa.window_attention_plain(qt, kt, vt, bias, d ** -0.5), TOL)


def test_window_kernel_refuses_what_it_does_not_take(gen):
    qt = _randn(gen, 2, 1, 16, 160)
    bias = torch.zeros((1, 1, 160, 160), device="cuda")
    with pytest.raises(ValueError):  # N > 144
        fa.fused_window_attention(qt, qt, qt, bias)
