"""The banded variant of the P-folded sampling kernel (``csrc/msda_folded.cu``
with a band table) on the card, and the stage-3 CLI at full width.

- Banded #7 equals its grouped plain form (``msda_folded_banded_grouped_plain``:
  the kernel's order and fused multiply-adds with the band) bit for bit at
  the encoder's shape (the CLI's radius 4, 512-query tiles), at ragged
  levels, with 2-D tiles and at a value base off 8 bytes (2-byte loads);
  within 2^-7 of max |plain| of ``msda_folded_banded_plain``.
- Every case plants offsets that carry at least 10 % of the attention mass
  out of band and first asserts that the dense kernel's output differs from
  the banded plain version by more than that tolerance: a kernel that
  ignored the band would fail the bitwise check.
- Dense #7 is unchanged: still bit for bit its grouped plain form.
- ``train-proposal`` at full width for one step through ``run.main``, every
  sampling launch banded.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false. On the card: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_slice8_kernels_cuda.py``.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

from partdistillation_torch.models.pixel_decoder import _reference_points
from partdistillation_torch.ops import autograd as ag
from partdistillation_torch.ops import ms_deform_attn as msda
from partdistillation_torch.ops import msda_sampling as ms

pytestmark = pytest.mark.cuda
BF = torch.bfloat16
TOL = 2.0 ** -7
ENCODER = ((20, 20), (40, 40), (80, 80))


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernels have no CPU mode)")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _inputs(g, levels, b, m, d, p, spread=12.0, misaligned=False):
    """value (B, S, M, D) bf16, locations around each query's reference
    point with offsets uniform in +-spread level pixels, bf16 weights."""
    s = sum(h * w for h, w in levels)
    value = torch.randn((b, s, m, d), generator=g, device="cuda").to(BF)
    if misaligned:
        buf = torch.empty(value.numel() + 1, dtype=BF, device="cuda")
        buf[1:].copy_(value.flatten())
        value = buf[1:].view(value.shape)
    ref = _reference_points(levels, "cuda")[None, :, None, :, None, :]
    size = torch.tensor([[w, h] for h, w in levels], dtype=torch.float32, device="cuda")
    u = torch.rand((b, s, m, len(levels), p, 2), generator=g, device="cuda")
    loc = ref + (u * 2 * spread - spread) / size[None, None, None, :, None, :]
    attw = torch.softmax(torch.randn((b, s, m, len(levels) * p), generator=g, device="cuda"),
                         -1).reshape(b, s, m, len(levels), p).to(BF)
    return value, loc, attw


# (levels, B, M, D, P, radius, tile_queries, tile_x, misaligned value)
CASES = [(ENCODER, 2, 8, 32, 4, 4, 512, None, False),
         (((15, 11), (8, 6), (4, 3)), 2, 3, 16, 3, 1, 22, None, False),
         (((16, 12), (8, 6), (4, 3)), 1, 2, 32, 2, 1, 512, 4, False),
         (((9, 31), (5, 16), (3, 8)), 2, 2, 6, 2, 1, 512, 3, False),
         (((40, 40), (20, 20), (10, 10)), 1, 8, 32, 4, 2, 128, None, True)]
IDS = ["encoder-r4", "ragged-rows", "tiles-2d", "tiles-2d-d6", "misaligned"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_banded_kernel_bitwise_and_the_band_acts(gen, case):
    levels, b, m, d, p, radius, tq, tx, misaligned = case
    value, loc, attw = _inputs(gen, levels, b, m, d, p, misaligned=misaligned)
    assert (value.data_ptr() % 8 != 0) == misaligned
    band = msda.msda_band_table(levels, radius, tq, tx, "cuda")
    assert float(msda.msda_band_oob_fraction(levels, loc, attw, radius, tq, tx)) >= 0.1
    plain = ms.msda_folded_banded_plain(value, levels, loc, attw, band).float()
    dense = ms.msda_folded(value, levels, loc, attw).float()
    scale = plain.abs().max().item()
    assert (dense - plain).abs().max().item() > 10 * TOL * scale  # ignoring the band fails
    ag.reset_launches()
    out = ms.msda_folded(value, levels, loc, attw, band=band)
    assert ag.launch_counts("msda_folded_banded") == {"msda_folded_banded": 1}
    want = ms.msda_folded_banded_grouped_plain(value, levels, loc, attw, band,
                                               aligned=not misaligned)
    torch.cuda.synchronize()
    assert torch.equal(out, want), (out.float() - want.float()).abs().max().item()
    assert (out.float() - plain).abs().max().item() <= TOL * scale
    assert torch.equal(out, ms.msda_folded(value, levels, loc, attw, band=band))


def test_banded_through_ms_deform_attn(gen):
    value, loc, attw = _inputs(gen, ENCODER, 2, 8, 32, 4)
    band = msda.msda_band_table(ENCODER, 4, 512, None, "cuda")
    out = msda.ms_deform_attn(value, ENCODER, loc, attw, mode="banded", band_radius=4)
    torch.cuda.synchronize()
    assert torch.equal(out, ms.msda_folded_banded_grouped_plain(value, ENCODER, loc, attw, band))


def test_dense_kernel_unchanged(gen):
    value, loc, attw = _inputs(gen, ENCODER, 2, 8, 32, 4)
    ag.reset_launches()
    out = ms.msda_folded(value, ENCODER, loc, attw)
    assert ag.launch_counts("msda_folded_banded") == {"msda_folded_banded": 0}
    torch.cuda.synchronize()
    assert torch.equal(out, ms.msda_folded_grouped_plain(value, ENCODER, loc, attw))


def test_banded_gradients_are_the_plain_vjp(gen):
    """Gradients through the banded kernel (its backward kernel, #7') are
    the plain banded version's under autograd (within 2^-7 of max: both add
    dvalue's f32 terms in no fixed order, and round it and dattw to bf16)."""
    levels = ((15, 11), (8, 6), (4, 3))
    value, loc, attw = _inputs(gen, levels, 1, 2, 16, 3)
    band = msda.msda_band_table(levels, 1, 22, None, "cuda")
    cot = torch.randn((1, value.shape[1], 32), generator=gen, device="cuda").to(BF)
    got_in = [t.clone().requires_grad_() for t in (value, loc, attw)]
    want_in = [t.clone().requires_grad_() for t in (value, loc, attw)]
    got = torch.autograd.grad(ms.msda_folded(got_in[0], levels, got_in[1], got_in[2],
                                             band=band), got_in, cot)
    want = torch.autograd.grad(ms.msda_folded_banded_plain(want_in[0], levels, want_in[1],
                                                           want_in[2], band), want_in, cot)
    for a, b in zip(got, want):  # the same gradients; both add dvalue by atomics
        err = (a.float() - b.float()).abs().max().item()
        assert err <= TOL * b.float().abs().max().item(), err


def test_train_proposal_full_width_one_step(gen, tmp_path, capsys):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs
    from partdistillation_torch import run

    ov = cs.cli_dataset(str(tmp_path), 0)
    cs.reset_launches()
    run.main(["train-proposal", "--set", *ov, "data.batch_size=2", "max_iters=1",
              "log_every=1"])
    res = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")][-1]
    assert res["stage"] == "train-proposal" and res["steps"] == 1
    assert cs.launch_counts() == cs.PER_TRAIN_STEP
    assert cs.banded_launches() == cs.PER_TRAIN_STEP["msda_folded"] == 6
