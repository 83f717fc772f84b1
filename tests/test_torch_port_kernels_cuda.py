"""The hand-written CUDA kernels against their plain versions on the card, at
small and ragged shapes that the full-size smoke run (``chip_smoke.py``) does
not reach: token counts off the tile, window sizes with N and D off 16,
query and key counts off 64, per-head masks, and a tiny segmenter end to end.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false. On a machine with a card and no JAX (the tests' conftest imports JAX):
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_kernels_cuda.py``.

Tolerance: bf16 kernel vs plain version on the same inputs, max |err| within
2^-6 of max |plain| (a few bf16 roundings of the output), 2^-7 for LayerNorm,
1e-5 for LayerNorm in f32.
"""

import numpy as np
import pytest
import torch

from partdistillation_torch.ops import autograd as ag
from partdistillation_torch.ops import fused_attention as fa
from partdistillation_torch.ops import fused_mlp as fm
from partdistillation_torch.ops import layer_norm as ln

pytestmark = pytest.mark.cuda
BF = torch.bfloat16


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


@pytest.mark.parametrize("shape,dtype", [((7, 48), BF), ((5, 3, 3072), BF),
                                         ((9, 100), torch.float32)])
def test_layer_norm_kernel(gen, shape, dtype):
    x = _randn(gen, *shape, dtype=dtype, scale=3.0)
    s, b = _randn(gen, shape[-1], dtype=torch.float32), _randn(gen, shape[-1], dtype=torch.float32)
    ag.reset_launches()
    out = ln.fused_layer_norm(x, s, b)
    assert ag.launch_counts("layer_norm") == {"layer_norm": 1} and out.dtype == dtype
    _close(out, ln.layer_norm_plain(x, s, b), 2.0 ** -7 if dtype == BF else 1e-5)


@pytest.mark.parametrize("n,c", [(37, 32), (130, 96), (50, 384), (17, 1536)])
@pytest.mark.parametrize("add_residual", [True, False])
def test_fused_mlp_kernel(gen, n, c, add_residual):
    f = 4 * c
    args = (_randn(gen, n, c), _randn(gen, c, scale=0.5) + 1.0, _randn(gen, c, scale=0.1),
            _randn(gen, f, c, scale=c ** -0.5), _randn(gen, f, scale=0.1),
            _randn(gen, c, f, scale=f ** -0.5), _randn(gen, c, scale=0.1))
    out = fm.fused_ln_mlp(*args, add_residual=add_residual)
    _close(out, fm.ln_mlp_kernel_numerics(*args, add_residual=add_residual), 2.0 ** -6)


@pytest.mark.parametrize("bw,h,d,n,p", [(6, 3, 32, 49, 3), (4, 2, 8, 16, 1),
                                        (8, 4, 24, 144, 2)])
def test_window_attention_kernel(gen, bw, h, d, n, p):
    qt, kt, vt = (_randn(gen, bw, h, d, n) for _ in range(3))
    bias = _randn(gen, p, h, n, n, dtype=torch.float32)
    bias[..., : n // 3] -= 100.0  # shift-mask-like blocked pairs
    out = fa.fused_window_attention(qt, kt, vt, bias, scale=d ** -0.5)
    _close(out, fa.window_attention_plain(qt, kt, vt, bias, d ** -0.5), 2.0 ** -6)


@pytest.mark.parametrize("nq,nk,d,mh", [(37, 100, 32, 1), (200, 400, 32, 8),
                                        (70, 129, 64, 1), (5, 3, 16, 8)])
def test_masked_attention_kernel(gen, nq, nk, d, mh):
    q = _randn(gen, 2, 8, nq, d, scale=d ** -0.5)
    k, v = _randn(gen, 2, 8, nk, d), _randn(gen, 2, 8, nk, d)
    mask = torch.rand((2, mh, nq, nk), generator=gen, device="cuda") < 0.6
    mask[:, :, :2] = True  # all-blocked rows take the fix-up
    out = fa.fused_masked_attention(q, k, v, mask)
    _close(out, fa.masked_attention_plain(q, k, v, mask), 2.0 ** -6)
    _close(fa.fused_masked_attention(q, k, v, None), fa.masked_attention_plain(q, k, v, None),
           2.0 ** -6)


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    x = _randn(gen, 4, 32, dtype=torch.float16)
    with pytest.raises(TypeError):
        ln.fused_layer_norm(x, torch.ones(32, device="cuda"), torch.zeros(32, device="cuda"))
    with pytest.raises(ValueError):  # non-contiguous
        ln.fused_layer_norm(_randn(gen, 32, 4).t(), torch.ones(4, device="cuda"),
                            torch.zeros(4, device="cuda"))
    w = _randn(gen, 128, 32, dtype=torch.float32)
    with pytest.raises(TypeError):  # the MLP kernel takes bf16 only
        fm.fused_ln_mlp(_randn(gen, 4, 32, dtype=torch.float32), *[torch.ones(32, device="cuda")] * 2,
                        w, torch.ones(128, device="cuda"), w.t().contiguous(),
                        torch.ones(32, device="cuda"))
    q = _randn(gen, 1, 1, 4, 20)
    with pytest.raises(ValueError):  # head dim not a multiple of 16
        fa.fused_masked_attention(q, q, q)


def test_tiny_segmenter_kernels_match_plain_versions(gen):
    """A tiny bf16 segmenter on the card through the kernels against the same
    model, weights and input with every kernel wrapper swapped for its plain
    version (the arithmetic the CPU tests hold against the JAX package)."""
    from partdistillation_torch.models.pixel_decoder import PixelDecoderConfig
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter, SegmenterConfig
    from partdistillation_torch.models.swin import SwinConfig
    from partdistillation_torch.models.transformer_decoder import TransformerDecoderConfig

    def cfg(dtype):
        return SegmenterConfig(
            swin=SwinConfig(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16),
                            window_size=4, dtype=dtype),
            pixel_decoder=PixelDecoderConfig(conv_dim=32, mask_dim=32, transformer_layers=1,
                                             transformer_ffn_dim=64, n_heads=4, n_points=2,
                                             dtype=dtype),
            decoder=TransformerDecoderConfig(hidden_dim=32, num_queries=8, num_heads=2,
                                             dim_feedforward=64, dec_layers=3, mask_dim=32,
                                             dtype=dtype))

    model = MaskFormerSegmenter(cfg(BF), device="cuda", seed=3)
    x = _randn(gen, 2, 64, 64, 3, dtype=torch.float32)
    kernels = ("layer_norm", "fused_ln_mlp", "fused_window_attention", "fused_masked_attention")
    ag.reset_launches()
    with torch.inference_mode():
        out = model(x)
    torch.cuda.synchronize()
    # 8 blocks: 8 norm1 + patch norm + 3 merging norms + 4 output norms; 3 layers
    assert list(ag.launch_counts(*kernels).values()) == [16, 8, 8, 3]

    ag.reset_launches()
    with torch.inference_mode(), ag.plain_versions(("layer_norm", "ln_mlp", "window_attn",
                                                     "masked_attn")):
        ref = model(x)
    assert set(ag.launch_counts(*kernels).values()) == {0}
    for key in ("pred_logits", "pred_masks"):
        a, r = out[key].float(), ref[key].float()
        assert torch.isfinite(a).all()
        # the same bf16 roundings in another summation order, through 8 blocks,
        # 1 encoder and 3 decoder layers whose attention masks are thresholded
        assert (a - r).abs().mean() <= 0.05 * r.abs().mean()
    signs = (torch.sign(out["pred_masks"]) == torch.sign(ref["pred_masks"])).float().mean()
    assert signs >= 0.98
