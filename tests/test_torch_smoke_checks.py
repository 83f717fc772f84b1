"""The verdicts of ``chip_smoke.py``'s train-step comparisons (phases 7 and 8),
on readings of the kind the card gives: a group passes on its kernel-vs-plain
limits or, where the two bf16 paths part, by being no further from the f32
step than the plain path; a planted fault fails either way."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def _group(rel, cos):
    return {"rel_err": rel, "cosine": cos}


# (groups, f32 distance ratios, verdict): a sound run within the limits; the
# bf16 paths parting with the kernel path the closer to f32; the same parting
# with the kernel path further off than the limits allow; a score group
# beyond its own limits; seed 5's readings before the kernels' redesign and
# seed 4's after (sound: no kernel carries them); a non-score group beyond
# its cosine limit with the kernel path the further from f32
CASES = [
    ({"ffn": _group(0.07, 0.9976), "cross_attention_q": _group(0.129, 0.9917)},
     {"ffn": 1.065, "cross_attention_q": 1.292}, True),
    ({"ffn": _group(0.179, 0.9839), "cross_attention_q": _group(0.417, 0.9178)},
     {"ffn": 0.577, "cross_attention_q": 0.584}, True),
    ({"ffn": _group(0.31, 0.9839), "cross_attention_q": _group(0.129, 0.9917)},
     {"ffn": 1.02, "cross_attention_q": 0.9}, False),
    ({"cross_attention_k": _group(0.48, 0.94)}, {"cross_attention_k": 1.2}, False),
    ({"cross_attention_norm": _group(0.1014, 0.9949), "cross_attention_q": _group(0.2299, 0.9746),
      "cross_attention_k": _group(0.2152, 0.9776)},
     {"cross_attention_norm": 1.3525, "cross_attention_q": 1.2617, "cross_attention_k": 1.2931},
     True),
    ({"ffn": _group(0.1497, 0.9893), "cross_attention_k": _group(0.1999, 0.9808)},
     {"ffn": 1.686, "cross_attention_k": 1.6}, True),
    ({"self_attention": _group(0.15, 0.975)}, {"self_attention": 1.1}, False),
]


@pytest.mark.parametrize("groups,ratios,verdict", CASES)
def test_frozen_step_verdict(groups, ratios, verdict):
    assert cs.within_limits(groups, ratios) is verdict


def test_sound_ratios_within_the_f32_limit():
    # the largest readings of seeds 0-6, before (seed 5) and after (seed 4)
    # the redesign of the masked-attention forward and the LN -> MLP kernel
    assert max(1.3525, 1.686) <= cs.F32_DISTANCE_RATIO_LIMIT


def test_planted_dk_zero_fails_the_frozen_step():
    planted = {"cross_attention_k": _group(1.0, 0.0), "ffn": _group(0.07, 0.9976)}
    ratios = {"cross_attention_k": 3.58, "ffn": 1.0}  # the smallest of seeds 0-6
    assert not cs.within_limits(planted, ratios)
    assert max(ratios.values()) > cs.F32_DISTANCE_RATIO_LIMIT


@pytest.mark.parametrize("rel,cos,verdict", [(0.195, 0.9843, True), (0.0696, 0.9976, True),
                                             (1.0, 0.0, False), (0.40, 0.99, False),
                                             (0.1, 0.96, False)])
def test_unfrozen_step_verdict(rel, cos, verdict):
    assert cs.unfrozen_within_limits({"msda0.sampling_offsets": _group(rel, cos)}) is verdict
