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


def test_vitdet_step_launch_counts_follow_the_model(monkeypatch):
    """Phase 14b's ViTDet-L launches a step, counted on the CPU: a ViTDet of
    ViTDet-L's 24 blocks and global block indexes at toy widths calls the
    LayerNorm (#1), the fused LN -> MLP (#2) and the relative-position
    attention (#10) as often a forward as PER_VITDET_STEP expects of them."""
    import torch

    from partdistillation_torch.models import swin, vitdet
    from partdistillation_torch.ops.autograd import LAUNCHES

    calls = {"layer_norm": 0, "fused_ln_mlp": 0, "relpos_attention": 0}

    def counted(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(swin, "fused_layer_norm", counted("layer_norm", swin.fused_layer_norm))
    monkeypatch.setattr(vitdet, "fused_ln_mlp", counted("fused_ln_mlp", vitdet.fused_ln_mlp))
    monkeypatch.setattr(vitdet, "relpos_attention",
                        counted("relpos_attention", vitdet.relpos_attention))
    large = vitdet.vitdet_large_config()
    cfg = vitdet.ViTDetConfig(img_size=64, embed_dim=32, depth=large.depth, num_heads=2,
                              window_size=3, global_block_indexes=large.global_block_indexes,
                              pretrain_img_size=32, out_dim=16)
    model = vitdet.ViTDet(cfg).train()
    keep = torch.ones(cfg.depth, 2, 1, dtype=torch.bool)
    with torch.no_grad():
        model(torch.zeros(1, 64, 64, 3), keep)
    assert calls == {k: cs.PER_VITDET_STEP[k] for k in calls}
    assert cs.PER_VITDET_STEP["relpos_attention_bwd"] == calls["relpos_attention"]
    assert set(cs.PER_VITDET_STEP) == set(cs.PER_FORWARD) <= set(LAUNCHES)
