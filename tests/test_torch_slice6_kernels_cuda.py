"""The redesigned deformable-sampling kernels (``csrc/msda_folded.cu``,
``csrc/msda_taps.cu``) against their plain versions on the card: the
P-folded kernel also against its summation order in PyTorch
(``msda_folded_grouped_plain``), at the main path's shapes and at the CPU
tests' cases (L x P of 4, 9, 12 and 40, D of 8, 32 and 64, taps at x0 = -1
and x0 = W - 1 and wholly off the map, f32 and bf16 weights), plus the
narrow layouts (D % 4 != 0, a map at an address off 8 bytes) and ragged tap
counts for the per-tap kernel; two calls bitwise equal.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false. On a machine with a card and no JAX (the tests' conftest imports JAX):
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_slice6_kernels_cuda.py``.

Tolerance: bf16 kernel vs plain version on the same inputs, max |err| within
2^-7 of max |plain| (one bf16 rounding of the output; the f32 sums run in
another order, fused multiply-adds in the kernel). Against its summation
order the P-folded kernel is held bit for bit: the grouped plain version
sums in the kernel's order with the kernel's fused multiply-add.
"""

import numpy as np
import pytest
import torch

from partdistillation_torch.ops import autograd as ag
from partdistillation_torch.ops import msda_sampling as ms
from torch_msda_cases import EIGHT, ENCODER, THREE, edge_pixels

pytestmark = pytest.mark.cuda
BF = torch.bfloat16
TOL = 2.0 ** -7


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernels have no CPU mode)")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _pixels(rng, shape, size, placement):
    """``edge_pixels`` on the card; ``size`` an int or a numpy array."""
    return torch.from_numpy(edge_pixels(rng, shape, size, placement)).cuda()


def _close(out, ref):
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    assert scale > 0 and err <= TOL * scale, (err, scale)


def _msda_inputs(g, rng, levels, b, lq, m, d, p, placement, weights_dtype):
    s = sum(h * w for h, w in levels)
    value = torch.randn((b, s, m, d), generator=g, device="cuda").to(BF)
    shape = (b, lq, m, len(levels), p)
    hw = np.array(levels, np.float32)
    w, h = hw[:, 1].reshape(1, 1, 1, -1, 1), hw[:, 0].reshape(1, 1, 1, -1, 1)
    px, py = _pixels(rng, shape, w, placement), _pixels(rng, shape, h, placement)
    loc = torch.stack([(px + 0.5) / torch.from_numpy(w).cuda(),
                       (py + 0.5) / torch.from_numpy(h).cuda()], -1)
    attw = torch.softmax(torch.randn((b, lq, m, len(levels) * p), generator=g, device="cuda"),
                         -1)
    return value, loc, attw.reshape(shape).to(weights_dtype)


# (levels, B, Lq, M, D, P, placement): the main path's encoder call, then the
# CPU tests' cases, a D % 4 != 0 head (2-byte loads) and D = 128 (one group)
FOLDED = [(ENCODER, 2, 8400, 8, 32, 4, "spread"), (ENCODER, 1, 37, 2, 32, 4, "spread"),
          (((5, 7),), 2, 29, 3, 8, 4, "edge"), (THREE, 2, 23, 2, 64, 3, "spread"),
          (THREE, 1, 19, 4, 32, 3, "edge"), (EIGHT, 1, 21, 2, 32, 5, "spread"),
          (EIGHT, 2, 13, 2, 8, 5, "edge"), (THREE, 2, 33, 2, 6, 2, "spread"),
          (THREE, 1, 50, 2, 128, 2, "edge")]


@pytest.mark.parametrize("weights_dtype", [BF, torch.float32])
@pytest.mark.parametrize("case", FOLDED)
def test_msda_folded_kernel_matches_plain_and_its_order(gen, rng, case, weights_dtype):
    levels, b, lq, m, d, p, placement = case
    value, loc, attw = _msda_inputs(gen, rng, levels, b, lq, m, d, p, placement, weights_dtype)
    ag.reset_launches()
    out = ms.msda_folded(value, levels, loc, attw)
    assert ag.launch_counts("msda_folded") == {"msda_folded": 1} and out.shape == (b, lq, m * d)
    _close(out, ms.msda_folded_plain(value, levels, loc, attw))
    grouped = ms.msda_folded_grouped_plain(value, levels, loc, attw)
    torch.cuda.synchronize()
    assert torch.equal(out, grouped)  # the kernel's order and rounding, bit for bit
    again = ms.msda_folded(value, levels, loc, attw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)  # no atomics: a fixed order of sums


@pytest.mark.parametrize("change", ["multiply then add", "two groups"])
def test_msda_folded_order_check_sees_a_change(gen, rng, monkeypatch, change):
    """The bitwise check against the grouped order is not met by chance: the
    same taps with each corner multiplied and then added, or summed in two
    groups in place of four, differ from the kernel at the encoder's shape."""
    value, loc, attw = _msda_inputs(gen, rng, *FOLDED[0], BF)
    out = ms.msda_folded(value, ENCODER, loc, attw)
    if change == "multiply then add":
        monkeypatch.setattr(ms, "_fmaf", lambda acc, a, b: acc + a * b)
    else:
        monkeypatch.setattr(ms, "msda_lane_plan",
                            lambda d, aligned=True: {"vec": 4, "group_lanes": 16, "groups": 2})
    changed = ms.msda_folded_grouped_plain(value, ENCODER, loc, attw)
    torch.cuda.synchronize()
    assert not torch.equal(out, changed)


@pytest.mark.parametrize("case", [FOLDED[1], FOLDED[6], FOLDED[7]])
def test_msda_folded_taps_wholly_off_the_map_read_zero(gen, rng, case):
    levels, b, lq, m, d, p, _ = case
    value, loc, attw = _msda_inputs(gen, rng, levels, b, lq, m, d, p, "off", BF)
    out = ms.msda_folded(value, levels, loc, attw)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))


def test_msda_folded_misaligned_value_takes_the_narrow_path(gen, rng):
    levels = THREE
    value, loc, attw = _msda_inputs(gen, rng, levels, 2, 41, 2, 32, 3, "edge", BF)
    buf = torch.empty(value.numel() + 1, dtype=BF, device="cuda")
    buf[1:].copy_(value.flatten())
    shifted = buf[1:].view(value.shape)  # contiguous, 2 bytes past 8-byte alignment
    assert ms.msda_lane_plan(32, aligned=shifted.data_ptr() % 8 == 0)["vec"] == 1
    _close(ms.msda_folded(shifted, levels, loc, attw),
           ms.msda_folded_plain(value, levels, loc, attw))


@pytest.mark.parametrize("hw", [(20, 20), (40, 40), (80, 80), (1, 1), (5, 40)])
def test_sample_level_folded_kernel(gen, rng, hw):
    """The one-level wrapper (pixel coordinates, M = 1, L x P = P) at the
    bench's shape for each encoder level and at ragged ones."""
    h, w = hw
    bm, p, n = (16, 4, 8400) if h == w and h >= 20 else (5, 3, 301)
    v = torch.randn((bm, h * w, 32), generator=gen, device="cuda").to(BF)
    x, y = _pixels(rng, (bm, p, n), w, "edge"), _pixels(rng, (bm, p, n), h, "edge")
    a = torch.rand((bm, p, n), generator=gen, device="cuda")
    out = ms.sample_level_folded(v, x, y, a, h, w)
    _close(out, ms.sample_level_folded_plain(v, x, y, a, h, w))
    torch.cuda.synchronize()
    assert torch.equal(out, ms.sample_level_folded(v, x, y, a, h, w))


# (BM, N, H, W, D, placement): the bench's three levels (N = 8400 x 4), then
# ragged N, N below a warp, a 1 x 1 map, D of 16, 64, 128 and 6
TAPS = [(16, 33600, 80, 80, 32, "spread"), (16, 33600, 40, 40, 32, "spread"),
        (16, 33600, 20, 20, 32, "spread"), (3, 1001, 6, 45, 16, "edge"),
        (5, 7, 1, 1, 32, "spread"), (2, 333, 7, 3, 64, "edge"), (2, 100, 5, 9, 128, "edge"),
        (3, 250, 4, 4, 6, "spread")]


@pytest.mark.parametrize("case", TAPS)
def test_sample_level_kernel(gen, rng, case):
    bm, n, h, w, d, placement = case
    v = torch.randn((bm, w, h * d), generator=gen, device="cuda").to(BF)
    x, y = _pixels(rng, (bm, n), w, placement), _pixels(rng, (bm, n), h, placement)
    a = torch.rand((bm, n), generator=gen, device="cuda")
    ag.reset_launches()
    out = ms.sample_level(v, x, y, a, h, w)
    assert ag.launch_counts("msda_taps") == {"msda_taps": 1} and out.shape == (bm, n, d)
    _close(out, ms.sample_level_plain(v, x, y, a, h, w))
    torch.cuda.synchronize()
    assert torch.equal(out, ms.sample_level(v, x, y, a, h, w))
    off_x = _pixels(rng, (bm, n), w, "off")
    far = ms.sample_level(v, off_x, y, a, h, w)
    torch.cuda.synchronize()
    assert torch.equal(far, torch.zeros_like(far))


def test_sample_level_misaligned_map_takes_the_narrow_path(gen, rng):
    bm, n, h, w, d = 2, 301, 80, 80, 32
    v = torch.randn((bm, w, h * d), generator=gen, device="cuda").to(BF)
    buf = torch.empty(v.numel() + 1, dtype=BF, device="cuda")
    buf[1:].copy_(v.flatten())
    shifted = buf[1:].view(v.shape)
    x, y = _pixels(rng, (bm, n), w, "edge"), _pixels(rng, (bm, n), h, "edge")
    a = torch.rand((bm, n), generator=gen, device="cuda")
    _close(ms.sample_level(shifted, x, y, a, h, w), ms.sample_level_plain(v, x, y, a, h, w))
