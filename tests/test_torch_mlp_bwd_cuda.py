"""The fused LN -> MLP's backward kernels (``csrc/fused_mlp_bwd.cu``) on the
card: every gradient against autograd through ``ln_mlp_kernel_numerics`` and
against ``ln_mlp_bwd_plain`` (their algorithm in PyTorch) at each Swin-L
stage's widths with a token count off the 128-row tile (split-K engaged at
the first two), two small widths, both residual forms and three patterns of
inputs that require a gradient; the launch counters; no CUDA call through
the plain VJP; gradients that repeat bit for bit.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false. On a machine with a card and no JAX (the tests' conftest imports JAX):
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mlp_bwd_cuda.py``.

Tolerances, each a relative Frobenius gap per gradient on the same bf16
inputs:
  * against autograd's f32 products, at most ``GAP`` = 1e-2. The kernels
    round xn, h, g and dpre to bf16 as product operands, as
    ``ln_mlp_bwd_plain`` does; that algorithm reads 2.1e-3 to 4.0e-3 against
    autograd on the CPU (``tests/test_torch_mlp_bwd.py``), and the kernels
    here on an H100 80GB HBM3 at 700 W read 2.2e-3 to 4.4e-3 (the largest
    dbias at 130 x 96), dw2 at most 4.1e-4 and db2 0 (autograd's own bf16
    operands);
  * against ``ln_mlp_bwd_plain``, which rounds where the kernels do, so that
    only the order of the f32 sums differs: ``PLAIN_GAP``, 8e-4 for dx, dw1
    and dw2, 2e-3 for the per-channel sums. That order flips a bf16 rounding
    now and then, in an intermediate (xn, h, dpre) or in a gradient whose
    column sum cancels, and each flip is a whole bf16 step: on the H100 the
    kernels read at most 4.9e-4 in dx, 3.8e-4 in dw1, 4.1e-4 in dw2 and
    6.9e-4 in dscale (chip_smoke's phase 8 at B = 2: 5.0e-4 in dx). The
    control: the same function with pre or dxn also rounded to bf16, as a
    kernel that stored them so would give, reads 1.27e-3 to 2.8e-3 in dx and
    2.2e-3 in dw1 (pre) on the card, 1.1e-3 and more on the CPU, above the
    limit; in the per-channel sums it reads 0.9e-3 to 2.4e-3, which that
    limit does not separate from the order's readings.
"""

import pytest
import torch

from partdistillation_torch.ops import autograd as ag
from partdistillation_torch.ops import fused_mlp as fm

pytestmark = pytest.mark.cuda
BF = torch.bfloat16
GAP = 1e-2
NAMES = ("x", "scale", "bias", "w1", "b1", "w2", "b2")
# in the gradients' order
PLAIN_GAP = {"x": 8e-4, "scale": 2e-3, "bias": 2e-3, "w1": 8e-4, "b1": 2e-3, "w2": 8e-4,
             "b2": 2e-3}
# each stage's C (F = 4C) at a token count off the 128-row tile, then a width
# below one 64-column tile and one off it
SHAPES = [(25601, 192), (6401, 384), (3001, 768), (801, 1536), (37, 32), (130, 96)]
PATTERNS = {"all": (True,) * 7, "x": (True,) + (False,) * 6,
            "weights": (False,) + (True,) * 6}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _randn(g, *shape, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(BF)


def _args(g, n, c):
    f = 4 * c
    return (_randn(g, n, c, scale=2.0), _randn(g, c, scale=0.5) + 1.0, _randn(g, c, scale=0.1),
            _randn(g, f, c, scale=c ** -0.5), _randn(g, f, scale=0.1),
            _randn(g, c, f, scale=f ** -0.5), _randn(g, c, scale=0.1))


def _grads(fn, args, needs, grad, add_residual):
    leaves = [a.clone().requires_grad_(need) for a, need in zip(args, needs)]
    out = fn(*leaves, add_residual=add_residual)
    got = iter(torch.autograd.grad(out, [t for t in leaves if t.requires_grad], grad))
    return out, [next(got) if need else None for need in needs]


def _gap(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("add_residual", [True, False])
@pytest.mark.parametrize("n,c", SHAPES)
def test_mlp_backward_kernels_match_autograd(gen, n, c, add_residual, pattern):
    args, grad = _args(gen, n, c), _randn(gen, n, c)
    needs = PATTERNS[pattern]
    ag.reset_launches()
    out, got = _grads(fm.fused_ln_mlp, args, needs, grad, add_residual)
    assert type(out.grad_fn).__name__ == "KernelOpBackward"
    assert ag.launch_counts("fused_ln_mlp_backward") == {"fused_ln_mlp_backward": 1}
    _, want = _grads(fm.ln_mlp_kernel_numerics, args, needs, grad, add_residual)
    torch.cuda.synchronize()
    gaps = {}
    for name, a, b in zip(NAMES, got, want):
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == BF and a.shape == b.shape and torch.isfinite(a).all(), name
        gaps[name] = _gap(a, b)
    print({"shape": [n, c], "add_residual": add_residual, "pattern": pattern,
           "plan": fm.mlp_bwd_plan(n, c, 4 * c), "gaps": gaps})
    assert all(v <= GAP for v in gaps.values()), gaps


@pytest.mark.parametrize("add_residual", [True, False])
@pytest.mark.parametrize("n,c", SHAPES)
def test_mlp_backward_kernels_match_their_plain_algorithm(gen, n, c, add_residual):
    args, grad = _args(gen, n, c), _randn(gen, n, c)
    got = fm.fused_ln_mlp_backward(grad, *args[:6], add_residual=add_residual)
    want = fm.ln_mlp_bwd_plain(grad, *args[:6], add_residual=add_residual)
    gaps = {name: _gap(a, b) for name, a, b in zip(NAMES, got, want)}
    planted = {r: {name: _gap(a, b) for name, a, b in zip(
        NAMES, fm.ln_mlp_bwd_plain(grad, *args[:6], add_residual=add_residual, rounded=(r,)),
        want)} for r in ("pre", "dxn")}
    print({"shape": [n, c], "add_residual": add_residual, "plain_gaps": gaps,
           "planted_gaps": planted})
    assert all(gaps[k] <= PLAIN_GAP[k] for k in NAMES), gaps
    # the control: pre or dxn stored in bf16 would not pass
    assert planted["pre"]["x"] > PLAIN_GAP["x"] and planted["pre"]["w1"] > PLAIN_GAP["w1"]
    assert planted["dxn"]["x"] > PLAIN_GAP["x"], planted


def test_mlp_backward_counts_one_launch_per_call(gen):
    args, grad = _args(gen, 300, 192), _randn(gen, 300, 192)
    ag.reset_launches()
    for i in range(3):
        leaves = [a.clone().requires_grad_() for a in args]
        torch.autograd.grad(fm.fused_ln_mlp(*leaves), leaves, grad)
        assert ag.launch_counts("fused_ln_mlp", "fused_ln_mlp_backward") == {
            "fused_ln_mlp": i + 1, "fused_ln_mlp_backward": i + 1}
    # no gradient asked for: the forward kernel alone, no autograd node
    with torch.no_grad():
        assert fm.fused_ln_mlp(*args).grad_fn is None
    assert ag.launch_counts("fused_ln_mlp_backward") == {"fused_ln_mlp_backward": 3}


def test_mlp_backward_never_takes_the_plain_vjp(gen, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA fused_ln_mlp reached the plain version's VJP")

    monkeypatch.setattr(ag, "_plain_vjp", refuse)
    args, grad = _args(gen, 130, 96), _randn(gen, 130, 96)
    for add_residual in (True, False):
        _, got = _grads(fm.fused_ln_mlp, args, (True,) * 7, grad, add_residual)
        assert all(g is not None for g in got)


def test_mlp_backward_repeats_bit_for_bit(gen):
    """No atomics: the split-K slices and the column sums add up in a fixed
    order (stage 1's widths, 11 and 7 splits)."""
    args, grad = _args(gen, 25601, 192), _randn(gen, 25601, 192)
    first = fm.fused_ln_mlp_backward(grad, *args[:6])
    second = fm.fused_ln_mlp_backward(grad, *args[:6])
    for name, a, b in zip(NAMES, first, second):
        assert torch.equal(a, b), name
