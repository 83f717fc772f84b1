"""The deformable-sampling kernels (``csrc/msda_folded.cu``,
``csrc/msda_taps.cu``) and the fused window attention + projection kernel
(``csrc/window_attention_proj.cu``) against their plain versions on the card,
at ragged shapes the full-size smoke run (``chip_smoke.py``) does not reach:
query and tap counts off every tile, levels wider than a warp, a 1 x 1
level, taps wholly outside the map, head widths other than 32, token counts
off 16; their gradients; and a tiny segmenter in the kernel configuration.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false. On a machine with a card and no JAX (the tests' conftest imports JAX):
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_slice3_kernels_cuda.py``.

Tolerances: bf16 kernel vs plain version on the same inputs, max |err|
within 2^-7 of max |plain| for the sampling kernels (one bf16 rounding of
the output; the f32 sums run in another order) and 2^-6 for the window
kernel (bf16 probabilities and attention output as well).
"""

import numpy as np
import pytest
import torch

from partdistillation_torch.ops import autograd as ag
from partdistillation_torch.ops import fused_attention as fa
from partdistillation_torch.ops import msda_sampling as ms

pytestmark = pytest.mark.cuda
BF = torch.bfloat16
SAMPLING, WINDOW = 2.0 ** -7, 2.0 ** -6


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


def _rand(g, *shape, lo=0.0, hi=1.0):
    return torch.rand(shape, generator=g, device="cuda") * (hi - lo) + lo


def _close(out, ref, rel):
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert np.isfinite(err) and err <= rel * ref.float().abs().max().item(), err


def _msda_inputs(g, levels, b, lq, m, d, p, spread, weights_dtype):
    s = sum(h * w for h, w in levels)
    value = _randn(g, b, s, m, d)
    loc = _rand(g, b, lq, m, len(levels), p, 2, lo=-spread, hi=1.0 + spread)
    attw = torch.softmax(_randn(g, b, lq, m, len(levels) * p, dtype=torch.float32), -1)
    return value, loc, attw.reshape(b, lq, m, len(levels), p).to(weights_dtype)


# (levels, B, Lq, M, D, P): ragged Lq, a level wider than 32, a 1 x 1 level,
# head widths 16 / 32 / 64 (one, one and two channels per lane)
MSDA = [(((20, 20), (40, 40), (80, 80)), 2, 333, 8, 32, 4),
        (((3, 37), (1, 1), (7, 5)), 1, 45, 3, 16, 2),
        (((9, 70),), 3, 17, 2, 64, 3)]


@pytest.mark.parametrize("weights_dtype", [BF, torch.float32])
@pytest.mark.parametrize("case", MSDA)
def test_msda_folded_kernel(gen, case, weights_dtype):
    levels, b, lq, m, d, p = case
    value, loc, attw = _msda_inputs(gen, levels, b, lq, m, d, p, 0.2, weights_dtype)
    ag.reset_launches()
    out = ms.msda_folded(value, levels, loc, attw)
    assert ag.launch_counts("msda_folded") == {"msda_folded": 1} and out.shape == (b, lq, m * d)
    _close(out, ms.msda_folded_plain(value, levels, loc, attw), SAMPLING)


def test_msda_folded_taps_off_the_map_read_zero(gen):
    levels = ((4, 6), (2, 3))
    value, loc, attw = _msda_inputs(gen, levels, 2, 50, 4, 32, 2, 0.0, BF)
    loc = torch.where(torch.rand(loc.shape[:-1], generator=gen, device="cuda")[..., None] < 0.5,
                      loc + 3.0, loc - 3.0)  # every corner outside its level
    out = ms.msda_folded(value, levels, loc, attw)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("hw", [(1, 1), (5, 40), (80, 80)])
def test_sample_level_folded_kernel(gen, hw):
    h, w = hw
    bm, p, n, d = 5, 3, 301, 32
    v = _randn(gen, bm, h * w, d)
    x, y = _rand(gen, bm, p, n, lo=-2.0, hi=w + 1.0), _rand(gen, bm, p, n, lo=-2.0, hi=h + 1.0)
    a = _rand(gen, bm, p, n)
    _close(ms.sample_level_folded(v, x, y, a, h, w),
           ms.sample_level_folded_plain(v, x, y, a, h, w), SAMPLING)


@pytest.mark.parametrize("hwd", [(1, 1, 32), (6, 45, 16), (80, 80, 32), (7, 3, 64)])
def test_sample_level_kernel(gen, hwd):
    h, w, d = hwd
    bm, n = 3, 1001
    v = _randn(gen, bm, w, h * d)
    x, y = _rand(gen, bm, n, lo=-2.0, hi=w + 1.0), _rand(gen, bm, n, lo=-2.0, hi=h + 1.0)
    a = _rand(gen, bm, n)
    ag.reset_launches()
    out = ms.sample_level(v, x, y, a, h, w)
    assert ag.launch_counts("msda_taps") == {"msda_taps": 1}
    _close(out, ms.sample_level_plain(v, x, y, a, h, w), SAMPLING)
    far = ms.sample_level(v, x + 2.0 * w + 4.0, y, a, h, w)
    torch.cuda.synchronize()
    assert torch.equal(far, torch.zeros_like(far))


def test_msda_gradients_are_the_plain_versions(gen):
    """On the card the gradient of every sampling wrapper is its plain
    version's VJP at the same inputs; the forward launches the kernel."""
    levels = ((3, 37), (1, 1), (7, 5))
    value, loc, attw = _msda_inputs(gen, levels, 2, 45, 4, 32, 2, 0.2, BF)
    g = _randn(gen, 2, 45, 4 * 32)
    inputs = [t.clone().requires_grad_() for t in (value, loc, attw)]
    plain = [t.clone().requires_grad_() for t in (value, loc, attw)]
    ag.reset_launches()
    ms.msda_folded(inputs[0], levels, *inputs[1:]).backward(g)
    assert ag.launch_counts("msda_folded") == {"msda_folded": 1}
    ms.msda_folded_plain(plain[0], levels, *plain[1:]).backward(g)
    # f32 sums in no fixed order (the value gradient's scatter-add), one
    # rounding to bf16
    for a, b_ in zip(inputs, plain):
        _close(a.grad, b_.grad, SAMPLING)


# (Bw, H, D, N, P, C): ragged N, D 16 / 24 / 32, C other than H*D, both bias
# forms, the res5 width
WINDOW_PROJ = [(6, 3, 16, 49, 3, 48), (4, 2, 24, 16, 1, 80), (8, 4, 32, 144, 2, 128),
               (2, 48, 32, 144, 1, 1536), (3, 6, 32, 144, 3, 192)]


def _window_proj_inputs(g, bw, h, d, n, p, c):
    qt, kt, vt = (_randn(g, bw, h, d, n) for _ in range(3))
    bias = _randn(g, p, h, n, n, dtype=torch.float32)
    bias[..., : n // 3] -= 100.0  # shift-mask-like blocked pairs
    return qt, kt, vt, bias, _randn(g, c, h * d, scale=(h * d) ** -0.5), _randn(g, c, scale=0.1)


@pytest.mark.parametrize("case", WINDOW_PROJ)
def test_window_attention_proj_kernel(gen, case):
    args = _window_proj_inputs(gen, *case)
    d = case[2]
    ag.reset_launches()
    out = fa.fused_window_attention_proj(*args, scale=d ** -0.5)
    assert ag.launch_counts("window_attention_proj") == {"window_attention_proj": 1}
    assert out.shape == (case[0], case[3], case[5])
    _close(out, fa.window_attention_proj_plain(*args, scale=d ** -0.5), WINDOW)


def test_window_attention_proj_gradients_are_the_plain_versions(gen):
    args = _window_proj_inputs(gen, 6, 3, 16, 49, 3, 48)
    g = _randn(gen, 6, 49, 48)
    inputs = [t.clone().requires_grad_() for t in args]
    plain = [t.clone().requires_grad_() for t in args]
    fa.fused_window_attention_proj(*inputs, scale=0.25).backward(g)
    fa.window_attention_proj_plain(*plain, scale=0.25).backward(g)
    for a, b_ in zip(inputs, plain):
        _close(a.grad, b_.grad, WINDOW)


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    levels = ((4, 6),)
    value, loc, attw = _msda_inputs(gen, levels, 1, 8, 2, 32, 2, 0.0, BF)
    with pytest.raises(ValueError):  # the kernel takes bf16 values
        ms.msda_folded(value.float(), levels, loc, attw)
    with pytest.raises(ValueError):  # head width above 128
        ms.msda_folded(_randn(gen, 1, 24, 1, 160), levels, loc[:, :, :1], attw[:, :, :1])
    args = list(_window_proj_inputs(gen, 2, 3, 8, 16, 1, 48))
    with pytest.raises(ValueError):  # H * D = 24, not a multiple of 16
        fa.fused_window_attention_proj(*args, scale=1.0)
    args = list(_window_proj_inputs(gen, 2, 2, 16, 16, 1, 40))
    with pytest.raises(ValueError):  # C = 40, not a multiple of 16
        fa.fused_window_attention_proj(*args, scale=1.0)


def test_tiny_segmenter_kernel_config_matches_plain_versions(gen):
    """A tiny bf16 segmenter with ``fused_proj`` on the card: exact launches of the fused window kernel and the deformable
    sampling, and the outputs against the same model with every kernel
    wrapper swapped for its plain version."""
    from partdistillation_torch.models.pixel_decoder import PixelDecoderConfig
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter, SegmenterConfig
    from partdistillation_torch.models.swin import SwinConfig
    from partdistillation_torch.models.transformer_decoder import TransformerDecoderConfig

    cfg = SegmenterConfig(
        swin=SwinConfig(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16),
                        window_size=4, dtype=BF, fused_proj=True),
        pixel_decoder=PixelDecoderConfig(conv_dim=32, mask_dim=32, transformer_layers=2,
                                         transformer_ffn_dim=64, n_heads=4, n_points=2,
                                         dtype=BF),
        decoder=TransformerDecoderConfig(hidden_dim=32, num_queries=8, num_heads=2,
                                         dim_feedforward=64, dec_layers=3, mask_dim=32,
                                         dtype=BF))
    model = MaskFormerSegmenter(cfg, device="cuda", seed=3)
    x = _randn(gen, 2, 64, 64, 3, dtype=torch.float32)
    kernels = ("fused_window_attention", "window_attention_proj", "msda_folded")
    ag.reset_launches()
    with torch.inference_mode():
        out = model(x)
    torch.cuda.synchronize()
    assert list(ag.launch_counts(*kernels).values()) == [0, 8, 2]

    ag.reset_launches()
    with torch.inference_mode(), ag.plain_versions():
        ref = model(x)
    assert set(ag.launch_counts().values()) == {0}
    for key in ("pred_logits", "pred_masks"):
        a, r = out[key].float(), ref[key].float()
        assert torch.isfinite(a).all()
        assert (a - r).abs().mean() <= 0.05 * r.abs().mean()
    signs = (torch.sign(out["pred_masks"]) == torch.sign(ref["pred_masks"])).float().mean()
    assert signs >= 0.98
