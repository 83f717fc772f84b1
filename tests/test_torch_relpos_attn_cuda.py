"""The decomposed-relative-position attention kernels
(``ops/relpos_attention``, Triton) on the card, against the plain version
at ViTDet-L's published shapes at B = 4: a global block (B x 16 heads, 4,096
tokens of a 64 x 64 grid, D = 64) and a window block (B x 25 windows x 16
heads, 196 tokens of a 14 x 14 window). The output and dq, dk, dv and the
gradients of rel_h / rel_w (the kernels' outputs) and of both tables
(through the whole op); two planted faults; the launch counters; the
memory of one global block's forward and backward.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false. On a machine with a card and no JAX (the tests' conftest imports JAX):
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_relpos_attn_cuda.py``.

Tolerances, each a relative Frobenius gap on the same bf16 inputs, from the
readings on an H100 80GB HBM3 at 700 W (seeds 1-4, both shapes):
  * ``out`` 5e-3 (read 2.95e-3 to 3.07e-3): the kernel rounds the
    unnormalised probabilities to bf16 for P.V and divides after, the plain
    version rounds the normalised ones; then the bf16 output;
  * dq and dk 6e-3 (3.17e-3 to 3.25e-3; dq through the whole op 3.64e-3):
    dS rounded to bf16 as the products' operand, then the bf16 result;
  * dv 1e-3 (0.9e-4 to 2.4e-4): only P's bf16 rounding and the result's;
  * rel_h / rel_w and both tables 4e-3 (1.66e-3 to 1.84e-3): sums of f32 dS
    over P recomputed from bf16 products in another order.
The controls: the stored log-sum-exp rounded to bf16 (the row statistics
kept in bf16) reads 1.25e-2 to 1.30e-2 in every gradient, above each limit;
rel_w left out of the forward moves the output by 0.36 to 0.39.
"""

import pytest
import torch

from partdistillation_torch.ops import autograd as ag
from partdistillation_torch.ops import relpos_attention as ra

OUT_GAP, QK_GAP, V_GAP, TABLE_GAP = 5e-3, 6e-3, 1e-3, 4e-3
SHAPES = {"global": (4 * 16, 64), "window": (4 * 25 * 16, 14)}  # (BH, grid side)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Triton kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gap(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _case(dev, bh, s, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    n, d = s * s, 64
    q, k, v, do = (torch.randn(bh, n, d, device=dev, generator=g).to(torch.bfloat16)
                   for _ in range(4))
    th, tw = (torch.randn(2 * s - 1, d, device=dev, generator=g) * 0.05 for _ in range(2))
    return q, k, v, do, th, tw


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernels_against_plain(card, shape):
    bh, s = SHAPES[shape]
    q, k, v, do, th, tw = _case(card, bh, s, 1)
    scale = 64 ** -0.5
    with torch.no_grad():
        rel_h, rel_w = ra.decomposed_rel_pos(q, th, tw, (s, s))
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v, rel_h, rel_w)]
    ref = ra.relpos_attention_core_plain(*leaves, scale)
    ref.backward(do)
    ag.reset_launches()
    out, lse = ra._forward(q, k, v, rel_h, rel_w, scale)
    grads = ra.relpos_attention_backward(q, k, v, rel_h, rel_w, out, lse, do, scale)
    assert ag.launch_counts("relpos_attention", "relpos_attention_bwd") == {
        "relpos_attention": 1, "relpos_attention_bwd": 1}
    limits = (QK_GAP, QK_GAP, V_GAP, TABLE_GAP, TABLE_GAP)
    assert _gap(out, ref) < OUT_GAP
    for name, gk, leaf, limit in zip(("dq", "dk", "dv", "rel_h", "rel_w"), grads, leaves,
                                     limits):
        assert _gap(gk, leaf.grad) < limit, name
    # planted: the row statistics rounded to bf16 must fail every gradient
    _, lse_bf16 = ra._forward(q, k, v, rel_h, rel_w, scale, round_lse=True)
    planted = ra.relpos_attention_backward(q, k, v, rel_h, rel_w, out, lse_bf16, do, scale)
    for name, gk, leaf, limit in zip(("dq", "dk", "dv", "rel_h", "rel_w"), planted, leaves,
                                     limits):
        assert _gap(gk, leaf.grad) > limit, name
    # planted: one table dropped must fail the output
    dropped, _ = ra._forward(q, k, v, rel_h, torch.zeros_like(rel_w), scale)
    assert _gap(dropped, ref) > 10 * OUT_GAP


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_op_gradients_reach_the_tables(card, shape):
    """The whole op through autograd (tables -> rel_h / rel_w -> kernels)
    against the plain op: every leaf, the tables included."""
    bh, s = SHAPES[shape]
    q, k, v, do, th, tw = _case(card, bh, s, 3)
    runs = []
    for fn in (ra.relpos_attention, ra.relpos_attention_plain):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v, th, tw)]
        fn(*leaves, (s, s), 64 ** -0.5).backward(do)
        runs.append([t.grad for t in leaves])
    for name, a, b, limit in zip(("q", "k", "v", "rel_pos_h", "rel_pos_w"), *runs,
                                 (QK_GAP, QK_GAP, V_GAP, TABLE_GAP, TABLE_GAP)):
        assert _gap(a, b) < limit, name


@pytest.mark.cuda
def test_global_block_memory(card):
    """One global block at B = 4, forward and backward through the op,
    allocates less than one f32 (B x 16, 4096, 4096) tensor (4.3 GB): no
    (BH, N, N) tensor is written or saved."""
    bh, s = SHAPES["global"]
    q, k, v, do, th, tw = _case(card, bh, s, 2)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v, th, tw)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ra.relpos_attention(*leaves, (s, s), 64 ** -0.5).backward(do)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < bh * (s * s) ** 2 * 4
