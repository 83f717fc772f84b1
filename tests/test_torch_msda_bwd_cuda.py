"""The P-folded sampling's backward kernel (``csrc/msda_folded_bwd.cu``) on
the card: dvalue, dloc and dattw against ``msda_folded_backward_plain`` (its
algorithm in PyTorch) on the same bf16 inputs, at the encoder's level shapes
of both training cells (640^2: 20^2, 40^2, 80^2; 1024^2: 32^2, 64^2, 128^2;
B = 4, M = 8, D = 32, L = 3, P = 4), banded (radius 4, the cells' plan) and
dense, value 8-byte aligned and not (the 2-byte lane layout), bf16 and f32
weights; a planted fault (the band ignored) beyond every limit; one backward
launch a call, the counters, the ``bwd.msda`` span; no CUDA call through the
plain VJP; dloc and dattw repeat bit for bit.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false. On a machine with a card and no JAX (the tests' conftest imports JAX):
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_msda_bwd_cuda.py``.

Tolerances, each a relative Frobenius gap ``GAP`` per gradient. Both sides
form every product in f32 from the same bf16 values and differ only in the
order of f32 sums: the kernel's dot products by lanes and shuffles, and
dvalue's sum over queries by atomic adds in an order that changes from run
to run (the CUDA scatter-add of the plain VJP has the same freedom). dloc
stays in f32, so its gap is a few f32 roundings. dvalue and bf16 dattw are
rounded once to bf16 at the end on both sides, and where the two f32 sums
straddle a rounding boundary the results differ by one bf16 step (2^-8
relative): the gap is that step times the root of the share of such flips.
On an H100 80GB HBM3 (700 W), over both shapes and every case of
``test_backward_kernel_matches_its_plain_algorithm`` (seed 0), the gaps read
at most 3.7e-5 in dvalue, 6.5e-8 in dloc, 2.1e-5 in bf16 dattw and 5.5e-8
in f32 dattw; the limits ``GAP`` (``GAP_F32_WEIGHTS`` with f32 weights) lie
5 to 18 times above. The planted fault (the plain backward with the band
ignored, against the banded kernel) reads 0.22 to 0.30 in every gradient,
over a thousand times the largest limit.
"""

import pytest
import torch

from partdistillation_torch.ops import autograd as ag
from partdistillation_torch.ops import msda_sampling as ms
from partdistillation_torch.ops.ms_deform_attn import msda_band_table

pytestmark = pytest.mark.cuda
BF = torch.bfloat16
NAMES = ("value", "loc", "attw")
GAP = {"value": 2e-4, "loc": 1e-6, "attw": 2e-4}
# f32 weights: dattw is not rounded, so it is held as dloc is
GAP_F32_WEIGHTS = {**GAP, "attw": GAP["loc"]}
CELLS = {"640": ((20, 20), (40, 40), (80, 80)), "1024": ((32, 32), (64, 64), (128, 128))}
B, M, D, P = 4, 8, 32, 4


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernels have no CPU mode)")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _inputs(g, shapes, weights="bf16", aligned=True):
    """The encoder's inputs: taps within 4 level pixels of each query's
    reference point, one in eight moved 12 pixels further (out of band,
    some off the map); softmax weights; a bf16 output gradient."""
    dev = "cuda"
    s = sum(h * w for h, w in shapes)
    levels = len(shapes)
    value = torch.randn(B * s * M * D + 1, generator=g, device=dev).to(BF)
    value = (value[1:] if not aligned else value[:-1]).view(B, s, M, D)
    ref = torch.cat([torch.stack(torch.meshgrid((torch.arange(w, device=dev) + 0.5) / w,
                                                (torch.arange(h, device=dev) + 0.5) / h,
                                                indexing="xy"), -1).reshape(-1, 2)
                     for h, w in shapes])
    size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=dev)
    off = torch.rand((B, s, M, levels, P, 2), generator=g, device=dev) * 8.0 - 4.0
    far = torch.rand((B, s, M, levels, P, 1), generator=g, device=dev) < 0.125
    off = torch.where(far, off + 12.0 * torch.sign(off), off)
    loc = (ref[None, :, None, None, None, :]
           + off / size[None, None, None, :, None, :]).contiguous()
    attw = torch.softmax(torch.randn((B, s, M, levels * P), generator=g, device=dev), -1)
    attw = attw.reshape(B, s, M, levels, P).to(BF if weights == "bf16" else torch.float32)
    grad = torch.randn((B, s, M * D), generator=g, device=dev).to(BF)
    return value, loc, attw, grad


def _gap(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("weights", ["bf16", "f32"])
@pytest.mark.parametrize("mode", ["banded", "dense"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_backward_kernel_matches_its_plain_algorithm(gen, cell, mode, weights, aligned):
    shapes = CELLS[cell]
    value, loc, attw, grad = _inputs(gen, shapes, weights, aligned)
    band = msda_band_table(shapes, 4, 512, None, "cuda") if mode == "banded" else None
    got = ms.msda_folded_backward(value, shapes, loc, attw, grad, band)
    want = ms.msda_folded_backward_plain(value, shapes, loc, attw, grad, band)
    torch.cuda.synchronize()
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.isfinite(a).all(), name
    gaps = {name: _gap(a, b) for name, a, b in zip(NAMES, got, want)}
    planted = None
    if mode == "banded":
        ignored = ms.msda_folded_backward_plain(value, shapes, loc, attw, grad, None)
        planted = {name: _gap(a, b) for name, a, b in zip(NAMES, got, ignored)}
    print({"cell": cell, "mode": mode, "weights": weights, "aligned": aligned,
           "plan": ms.msda_lane_plan(D, value.data_ptr() % 8 == 0), "gaps": gaps,
           "band_ignored_gaps": planted})
    limits = GAP_F32_WEIGHTS if weights == "f32" else GAP
    assert all(gaps[k] <= limits[k] for k in NAMES), gaps
    if planted is not None:
        assert all(planted[k] > 10 * GAP[k] for k in NAMES), planted


def test_backward_counts_one_launch_per_call_in_its_span(gen):
    shapes = CELLS["640"]
    value, loc, attw, grad = _inputs(gen, shapes)
    band = msda_band_table(shapes, 4, 512, None, "cuda")
    keys = ("msda_folded", "msda_folded_bwd", "msda_folded_bwd_banded")
    ag.reset_launches()
    leaves = [t.clone().requires_grad_() for t in (value, loc, attw)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = ms.msda_folded(*leaves[:1], shapes, *leaves[1:], band=band)
        assert type(out.grad_fn).__name__ == "KernelOpBackward"
        torch.autograd.grad(out, leaves, grad)
        torch.cuda.synchronize()
    assert list(ag.launch_counts(*keys).values()) == [1, 1, 1]
    names = [ev.name for ev in prof.events()]
    assert "bwd.msda" in names
    kernels = {n for n in names if "msda_folded_bwd" in n}
    assert any("msda_folded_bwd_kernel" in n for n in kernels), kernels
    # the dense form counts no banded backward
    ag.reset_launches()
    leaves = [t.clone().requires_grad_() for t in (value, loc, attw)]
    torch.autograd.grad(ms.msda_folded(*leaves[:1], shapes, *leaves[1:]), leaves, grad)
    assert list(ag.launch_counts(*keys[1:]).values()) == [1, 0]
    # no gradient asked for: the forward kernel alone, no autograd node
    with torch.no_grad():
        assert ms.msda_folded(value, shapes, loc, attw, band=band).grad_fn is None


def test_backward_never_takes_the_plain_vjp(gen, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA msda_folded reached the plain version's VJP")

    monkeypatch.setattr(ag, "_plain_vjp", refuse)
    shapes = CELLS["640"]
    value, loc, attw, grad = _inputs(gen, shapes)
    for needs in ((True, True, True), (True, False, False), (False, True, True)):
        leaves = [t.clone().requires_grad_(n) for t, n in zip((value, loc, attw), needs)]
        out = ms.msda_folded(*leaves[:1], shapes, *leaves[1:],
                             band=msda_band_table(shapes, 4, 512, None, "cuda"))
        got = torch.autograd.grad(out, [t for t in leaves if t.requires_grad], grad)
        assert all(t is not None and torch.isfinite(t).all() for t in got)


def test_backward_location_and_weight_gradients_repeat_bit_for_bit(gen):
    """dloc and dattw are written once per tap, without atomics; dvalue's
    f32 adds meet in an order of the card's choosing."""
    shapes = CELLS["1024"]
    value, loc, attw, grad = _inputs(gen, shapes)
    band = msda_band_table(shapes, 4, 512, None, "cuda")
    first = ms.msda_folded_backward(value, shapes, loc, attw, grad, band)
    second = ms.msda_folded_backward(value, shapes, loc, attw, grad, band)
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])
    assert _gap(first[0], second[0]) <= GAP["value"]
