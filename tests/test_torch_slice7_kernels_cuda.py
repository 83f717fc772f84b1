"""The redesigned kernels of slice 7 on the card: the window attention +
output projection (``csrc/window_attention_proj.cu``: the attention launch,
then the TMA + wgmma GEMM of ``csrc/gemm.cuh``) and the LayerNorm
(``csrc/layer_norm.cu``: 16-byte vector loads with the row in registers, or
the scalar variant), each against its plain version at every main-path shape
(B=2, 640^2) and at ragged cases; the projection kernel's attention launch
bit for bit against the window attention kernel (``csrc/window_attention.cu``)
after a transpose; the projection kernel's gradients against its plain
version's.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false. On the card:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_slice7_kernels_cuda.py``.
Tolerances, relative to max |plain|: 2^-6 for the window kernel (bf16
probabilities, attention output and output roundings), 2^-7 for the bf16
LayerNorm (one rounding of the output), 1e-5 for the f32 LayerNorm (f32
sums in another order).
"""

import numpy as np
import pytest
import torch

from partdistillation_torch.ops import autograd as ag
from partdistillation_torch.ops import fused_attention as fa
from partdistillation_torch.ops import layer_norm as ln

pytestmark = pytest.mark.cuda
BF = torch.bfloat16
WINDOW, LN_BF16, LN_F32 = 2.0 ** -6, 2.0 ** -7, 1e-5

# (Bw, H, D, N, P, C): the eight main-path shapes (res2..res5, unshifted and
# shifted, C = H x D), then N = 49 and 16 (scalar copies), D = 16 and 24,
# C = 48 and 80
WINDOW_PROJ = [(392, 6, 32, 144, 1, 192), (392, 6, 32, 144, 196, 192),
               (98, 12, 32, 144, 1, 384), (98, 12, 32, 144, 49, 384),
               (32, 24, 32, 144, 1, 768), (32, 24, 32, 144, 16, 768),
               (8, 48, 32, 144, 1, 1536), (8, 48, 32, 144, 4, 1536),
               (6, 3, 16, 49, 3, 48), (4, 3, 16, 16, 1, 48), (4, 2, 24, 16, 1, 80),
               (3, 6, 16, 144, 3, 96)]
# LayerNorm rows x C on the main path, then ragged widths: C = 196 (bf16: not
# a multiple of 8, the scalar variant), 8, 40 and 8192 (beyond the registers:
# the scalar variant)
LN_SHAPES = [(51200, 192), (12800, 384), (12800, 768), (3200, 768), (3200, 1536),
             (800, 1536), (800, 3072), (333, 196), (77, 8), (1001, 40), (9, 8192)]


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


def _proj_inputs(g, bw, h, d, n, p, c):
    qt, kt, vt = (_randn(g, bw, h, d, n) for _ in range(3))
    bias = _randn(g, p, h, n, n, dtype=torch.float32)
    bias[..., : n // 3] -= 100.0  # shift-mask-like blocked pairs
    return qt, kt, vt, bias, _randn(g, c, h * d, scale=(h * d) ** -0.5), _randn(g, c, scale=0.1)


@pytest.mark.parametrize("case", WINDOW_PROJ)
def test_window_attention_proj_matches_plain(gen, case):
    args = _proj_inputs(gen, *case)
    bw, _, d, n, _, c = case
    ag.reset_launches()
    out = fa.fused_window_attention_proj(*args, scale=d ** -0.5)
    assert ag.launch_counts("window_attention_proj") == {"window_attention_proj": 1}
    assert out.shape == (bw, n, c)
    _close(out, fa.window_attention_proj_plain(*args, scale=d ** -0.5), WINDOW)
    _close(out, fa.window_attention_proj_split_plain(*args, scale=d ** -0.5), WINDOW)


@pytest.mark.parametrize("case", WINDOW_PROJ)
def test_window_attention_proj_attention_is_the_window_kernel(gen, case):
    """The attention launch writes, token-major, exactly the bits that the
    window attention kernel writes feature-major."""
    qt, kt, vt, bias, _, _ = _proj_inputs(gen, *case)
    bw, h, d, n, p, c = case
    plan = fa.window_attention_proj_plan(bw, h, d, n, c, p)
    a = fa._window_proj_attention(qt, kt, vt, bias, d ** -0.5, plan["ctas"])
    ref = fa.fused_window_attention(qt, kt, vt, bias, d ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(a, ref.permute(0, 3, 1, 2).reshape(bw * n, h * d))
    _close(a, fa.window_attention_tokens_plain(qt, kt, vt, bias, d ** -0.5), WINDOW)


def test_window_attention_proj_gradients_are_the_plain_versions(gen):
    args = _proj_inputs(gen, 6, 3, 16, 49, 3, 48)
    g = _randn(gen, 6, 49, 48)
    inputs = [t.clone().requires_grad_() for t in args]
    plain = [t.clone().requires_grad_() for t in args]
    fa.fused_window_attention_proj(*inputs, scale=0.25).backward(g)
    fa.window_attention_proj_plain(*plain, scale=0.25).backward(g)
    for a, b_ in zip(inputs, plain):
        _close(a.grad, b_.grad, WINDOW)


def test_window_attention_proj_raises_beyond_the_kernel(gen):
    args = list(_proj_inputs(gen, 2, 1, 80, 16, 1, 80))
    with pytest.raises(ValueError):  # D = 80 > 64
        fa.fused_window_attention_proj(*args, scale=1.0)
    args = list(_proj_inputs(gen, 2, 1, 16, 160, 1, 16))
    with pytest.raises(ValueError):  # N = 160 > 144
        fa.fused_window_attention_proj(*args, scale=1.0)


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("rows,c", LN_SHAPES)
def test_layer_norm_matches_plain(gen, rows, c, dtype):
    x = _randn(gen, rows, c, dtype=dtype, scale=2.0) + 0.5
    sc, bi = _randn(gen, c, dtype=torch.float32), _randn(gen, c, dtype=torch.float32)
    ag.reset_launches()
    out = ln.fused_layer_norm(x, sc, bi)
    assert ag.launch_counts("layer_norm") == {"layer_norm": 1}
    assert out.dtype == dtype and out.shape == x.shape
    _close(out, ln.layer_norm_plain(x, sc, bi), LN_BF16 if dtype == BF else LN_F32)


@pytest.mark.parametrize("dtype", [BF, torch.float32])
def test_layer_norm_offset_base_takes_the_scalar_variant(gen, dtype):
    """x one element past a 16-byte boundary: the plan picks the scalar
    variant, which must agree with the plain version too."""
    rows, c = 3200, 768
    buf = _randn(gen, rows * c + 1, dtype=dtype)
    x = buf[1:].view(rows, c)
    assert x.data_ptr() % 16 != 0
    assert ln.layer_norm_plan(rows, c, dtype, False)["loads"] == 0
    sc, bi = _randn(gen, c, dtype=torch.float32), _randn(gen, c, dtype=torch.float32)
    _close(ln.fused_layer_norm(x, sc, bi), ln.layer_norm_plain(x, sc, bi),
           LN_BF16 if dtype == BF else LN_F32)
