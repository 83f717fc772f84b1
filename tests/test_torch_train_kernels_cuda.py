"""The training path's kernels on the card: the masked-attention backward
kernel against its plain version at ragged shapes, the gradients of the three
trunk kernels (LayerNorm and window attention through their plain-version
VJPs, the fused LN->MLP through its backward kernels), and a tiny bf16 train
step through the kernels against the same step through the plain versions.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false. On a machine with a card and no JAX (the tests' conftest imports JAX):
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_kernels_cuda.py``.

Tolerances: the backward kernel against ``masked_attention_bwd_plain`` on the
same bf16 inputs, max |err| of each of dq, dk, dv within 2^-6 of its max
|plain| (bf16 roundings of P, dS and the outputs, and D = rowsum(g o o) from
the bf16 output where the plain version sums P o dP). The LayerNorm's and the
window attention's gradients come from the plain version's VJP at the same
saved inputs, so they match the plain version's autograd to 1e-6 of max
|plain|; the fused LN -> MLP's come from its backward kernels, each within a
relative Frobenius gap of 1e-2 of that autograd, and within ``PLAIN_GAP`` of
``ln_mlp_bwd_plain``, which rounds where the kernels do
(``tests/test_torch_mlp_bwd_cuda.py``).
"""

import numpy as np
import pytest
import torch

from partdistillation_torch.ops import autograd as ag
from partdistillation_torch.ops import fused_attention as fa
from partdistillation_torch.ops import fused_mlp as fm
from partdistillation_torch.ops import layer_norm as ln
from test_torch_mlp_bwd_cuda import PLAIN_GAP

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


@pytest.mark.parametrize("nq", [1, 37, 200])
@pytest.mark.parametrize("nk", [1, 300, 1000, 6400])  # 1, 1, 2 and 13 dQ key chunks
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("mh", [1, 8])
def test_masked_attention_bwd_kernel(gen, nq, nk, d, mh):
    q = _randn(gen, 2, 8, nq, d, scale=d ** -0.5).requires_grad_()
    k, v = _randn(gen, 2, 8, nk, d).requires_grad_(), _randn(gen, 2, 8, nk, d).requires_grad_()
    mask = torch.rand((2, mh, nq, nk), generator=gen, device="cuda") < 0.6
    mask[:, :, : max(nq // 8, 1)] = True  # all-blocked rows take the fix-up
    g = _randn(gen, 2, 8, nq, d)
    ag.reset_launches()
    out = fa.fused_masked_attention(q, k, v, mask)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), g)
    assert ag.launch_counts("fused_masked_attention", "fused_masked_attention_bwd") == {
        "fused_masked_attention": 1, "fused_masked_attention_bwd": 1}
    plain = fa.masked_attention_bwd_plain(q.detach(), k.detach(), v.detach(), mask, g)
    for got, want in zip(grads, plain):
        assert got.dtype == BF and got.shape == want.shape
    if nk == 1:
        # one key: P = 1 and dS = 0 in exact arithmetic, so dq and dk are
        # rounding noise, held to f32 rounding of |g| |v| |k or q| instead
        gv = g.float().abs().max() * v.detach().float().abs().max()
        for got, other in zip(grads[:2], (k, q)):
            assert got.float().abs().max() <= 2.0 ** -16 * gv * other.detach().float().abs().max()
        _close(grads[2], plain[2], 2.0 ** -6)
    else:
        for got, want in zip(grads, plain):
            _close(got, want, 2.0 ** -6)
    _close(out, fa.masked_attention_plain(q.detach(), k.detach(), v.detach(), mask), 2.0 ** -6)


def test_masked_attention_bwd_without_mask(gen):
    q = _randn(gen, 1, 2, 70, 32, scale=32 ** -0.5)
    k, v, g = _randn(gen, 1, 2, 129, 32), _randn(gen, 1, 2, 129, 32), _randn(gen, 1, 2, 70, 32)
    out, lse, mask = fa.masked_attention_fwd_lse(q, k, v, None)
    logits = q.float() @ k.float().transpose(-1, -2)
    _close(lse, torch.logsumexp(logits, -1), 1e-5)
    grads = fa.fused_masked_attention_bwd(q, k, v, mask, out, lse, g)
    for got, want in zip(grads, fa.masked_attention_bwd_plain(q, k, v, None, g)):
        _close(got, want, 2.0 ** -6)


def _grads_match(kernel, plain, inputs, g, frobenius=None):
    """Gradients of the kernel wrapper against the plain version's autograd:
    max |err| within 1e-6 of max |plain|, or with ``frobenius`` the relative
    Frobenius gap of each gradient within it."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = kernel(*leaves)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [t.detach().clone().requires_grad_() for t in inputs]
    want = torch.autograd.grad(plain(*ref_leaves), ref_leaves, g)
    for a, b in zip(got, want):
        assert a is not None and a.dtype == b.dtype
        if frobenius is None:
            _close(a, b, 1e-6)
        else:
            torch.cuda.synchronize()
            assert (a.float() - b.float()).norm() <= frobenius * b.float().norm()


def test_layer_norm_gradients(gen):
    x = _randn(gen, 300, 192, scale=2.0)
    s, b = _randn(gen, 192, dtype=torch.float32), _randn(gen, 192, dtype=torch.float32)
    ag.reset_launches()
    _grads_match(ln.fused_layer_norm, ln.layer_norm_plain, (x, s, b), _randn(gen, 300, 192))
    assert ag.launch_counts("layer_norm") == {"layer_norm": 1}


@pytest.mark.parametrize("add_residual", [True, False])
def test_fused_mlp_gradients(gen, add_residual):
    n, c = 130, 96
    f = 4 * c
    args = (_randn(gen, n, c), _randn(gen, c, scale=0.5) + 1.0, _randn(gen, c, scale=0.1),
            _randn(gen, f, c, scale=c ** -0.5), _randn(gen, f, scale=0.1),
            _randn(gen, c, f, scale=f ** -0.5), _randn(gen, c, scale=0.1))
    ag.reset_launches()
    g = _randn(gen, n, c)
    # the backward kernels round their product operands to bf16: the relative
    # Frobenius gap of each gradient (tests/test_torch_mlp_bwd_cuda.py's limit)
    _grads_match(lambda *a: fm.fused_ln_mlp(*a, add_residual=add_residual),
                 lambda *a: fm.ln_mlp_kernel_numerics(*a, add_residual=add_residual),
                 args, g, frobenius=1e-2)
    assert ag.launch_counts("fused_ln_mlp", "fused_ln_mlp_backward") == {
        "fused_ln_mlp": 1, "fused_ln_mlp_backward": 1}
    # and against their algorithm in PyTorch, which rounds where they do
    # (tests/test_torch_mlp_bwd_cuda.py's PLAIN_GAP)
    got = fm.fused_ln_mlp_backward(g, *args[:6], add_residual=add_residual)
    want = fm.ln_mlp_bwd_plain(g, *args[:6], add_residual=add_residual)
    for name, a, b in zip(PLAIN_GAP, got, want):
        assert (a.float() - b.float()).norm() <= PLAIN_GAP[name] * b.float().norm(), name


def test_window_attention_gradients(gen):
    bw, h, d, n, p = 8, 3, 32, 49, 4
    qt, kt, vt = (_randn(gen, bw, h, d, n) for _ in range(3))
    bias = _randn(gen, p, h, n, n, dtype=torch.float32)
    ag.reset_launches()
    _grads_match(lambda *a: fa.fused_window_attention(*a, scale=d ** -0.5),
                 lambda *a: fa.window_attention_plain(*a, scale=d ** -0.5),
                 (qt, kt, vt, bias), _randn(gen, bw, h, d, n))
    assert ag.launch_counts("fused_window_attention") == {"fused_window_attention": 1}


def _plain_versions():
    """Swin's kernels and the masked attention sent to their plain versions."""
    return ag.plain_versions(("layer_norm", "ln_mlp", "window_attn", "masked_attn"))


def test_unfrozen_swin_gradients_reach_every_parameter(gen):
    """A tiny bf16 Swin in train mode with DropPath active: every trunk
    parameter gets a gradient through the kernels, close to the gradient of
    the same model through the plain versions."""
    from partdistillation_torch.models.layers import init_weights
    from partdistillation_torch.models.swin import SwinConfig, SwinTransformer

    cfg = SwinConfig(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16),
                     window_size=4, drop_path_rate=0.3, dtype=BF)
    model = init_weights(SwinTransformer(cfg).cuda().train(), seed=1)
    x = _randn(gen, 2, 64, 64, 3, dtype=torch.float32)
    keep = torch.ones((8, 2, 2), dtype=torch.bool, device="cuda")
    keep[3, 0, 1] = keep[5, 1, 0] = False
    # a fixed random projection of every output (a sum of squares of the
    # LayerNormed outputs would be flat in the features)
    proj = {f"res{i + 2}": _randn(gen, 2, 16 // 2 ** i, 16 // 2 ** i, 32 * 2 ** i,
                                  dtype=torch.float32) for i in range(4)}

    def grads():
        model.zero_grad(set_to_none=True)
        out = model(x, drop_keep=keep)
        sum((o.float() * proj[k]).sum() for k, o in out.items()).backward()
        return {n: p.grad for n, p in model.named_parameters()}

    keys = ("layer_norm", "fused_ln_mlp", "fused_window_attention")
    ag.reset_launches()
    got = grads()
    assert list(ag.launch_counts(*keys).values()) == [16, 8, 8]
    with _plain_versions():
        want = grads()
    for name, g in got.items():
        assert g is not None and torch.isfinite(g).all() and g.abs().max() > 0, name
        cos = torch.nn.functional.cosine_similarity(g.flatten(), want[name].flatten(), dim=0)
        # the same bf16 roundings in another order through 8 blocks
        assert cos >= 0.99, (name, cos.item())


def test_tiny_train_step_kernels_match_plain_versions(gen):
    """A tiny bf16 stage-3 train step (trunk frozen, DropPath active) through
    the kernels, with its launch counts, against the same loss and gradients
    through the plain versions on the same weights, batch, noise and
    matching."""
    from partdistillation_torch.engine.optim import OptimizerConfig
    from partdistillation_torch.engine.trainer import Trainer
    from partdistillation_torch.losses.criterion import CriterionConfig
    from partdistillation_torch.losses.matcher import MatcherConfig
    from partdistillation_torch.models.meta_arch.proposal import ProposalModelConfig, make_loss_fn
    from partdistillation_torch.models.pixel_decoder import PixelDecoderConfig
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter, SegmenterConfig
    from partdistillation_torch.models.swin import SwinConfig
    from partdistillation_torch.models.transformer_decoder import TransformerDecoderConfig

    seg = SegmenterConfig(
        swin=SwinConfig(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16),
                        window_size=4, drop_path_rate=0.3, dtype=BF),
        pixel_decoder=PixelDecoderConfig(conv_dim=32, mask_dim=32, transformer_layers=1,
                                         transformer_ffn_dim=64, n_heads=4, n_points=2, dtype=BF),
        decoder=TransformerDecoderConfig(hidden_dim=32, num_queries=16, num_heads=2,
                                         dim_feedforward=64, dec_layers=3, mask_dim=32, dtype=BF),
        freeze_backbone=True, freeze_pixel_decoder=True)
    cfg = ProposalModelConfig(segmenter=seg, criterion=CriterionConfig(
        num_classes=1, num_points=256, matcher=MatcherConfig(num_points=256)))
    model = MaskFormerSegmenter(cfg.segmenter, device="cuda", seed=3)
    loss_fn = make_loss_fn(cfg, model)
    trainer = Trainer(loss_fn, model, OptimizerConfig(freeze_keys=("backbone", "pixel_decoder")))
    rng = np.random.default_rng(0)
    masks = np.zeros((2, 4, 64, 64), bool)
    for i in range(2):
        for j in range(3):
            masks[i, j, 10 * j:10 * j + 20, 5 + 8 * i:40 + 8 * i] = True
    batch = {"image": rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8), "masks": masks,
             "valid": np.array([[True] * 3 + [False]] * 2)}
    kernels = ("layer_norm", "fused_ln_mlp", "fused_window_attention",
               "fused_masked_attention", "fused_masked_attention_bwd")
    ag.reset_launches()
    metrics = trainer.train_step(batch)
    assert all(np.isfinite(v) for v in metrics.values())
    # 8 blocks: 8 norm1 + patch norm + 3 merging norms + 4 output norms; 3 layers
    assert list(ag.launch_counts(*kernels).values()) == [16, 8, 8, 3, 3]

    noise = loss_fn.draw_noise(batch, trainer.generator)
    assert not noise["drop_keep"].all()
    t = loss_fn.device_batch(batch)
    with torch.no_grad():
        noise["indices"] = loss_fn.match(loss_fn.forward(t, noise), t, noise)
    head = [n for n, _ in model.named_parameters() if n.startswith("sem_seg_head.predictor.")]

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        total, _ = loss_fn(batch, noise)
        total.backward()
        return total.item(), {n: model.get_parameter(n).grad.float() for n in head}

    loss_k, grads_k = loss_and_grads()
    counts = ag.launch_counts(*kernels)
    with _plain_versions():
        loss_p, grads_p = loss_and_grads()
    assert ag.launch_counts(*kernels) == counts
    # bf16 through 8 blocks, 1 encoder and 3 decoder layers; the whole
    # decoder's gradient (chip_smoke.py holds the full-width step per group)
    assert abs(loss_k - loss_p) <= 0.02 * abs(loss_p)
    gk = torch.cat([grads_k[n].flatten() for n in head])
    gp = torch.cat([grads_p[n].flatten() for n in head])
    assert torch.nn.functional.cosine_similarity(gk, gp, dim=0) >= 0.98
    assert (gk - gp).norm() <= 0.2 * gp.norm()
