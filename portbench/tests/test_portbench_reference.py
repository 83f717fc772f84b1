"""The plain reference computes the program's function: at a tiny size on
the CPU, in float32, its forward equals the program's on the same weights
and images, and a run's checked steps agree with it."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import check, program, train
from portbench.reference.model import Segmenter
from portbench.tests.tiny import tiny_config, tiny_traffic
from portbench.weights import make_weights

CELLS = [("m2f-swinL-proposal", "stage3_train"), ("m2f-swinL-supervised", "supervised_train")]


def rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("config", [c for c, _ in CELLS])
def test_forward_equals_the_programs(config):
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter

    cfg = tiny_config(config)
    weights = make_weights(cfg["model"], 123, "cpu")
    prog = MaskFormerSegmenter(program.segmenter_config(cfg), device="cpu", seed=0)
    prog.load_state_dict(weights)
    ref = Segmenter(cfg["model"])
    ref.load_state_dict(weights)
    images = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0)) * 255
    keep = torch.rand(5, 2, 2, generator=torch.Generator().manual_seed(1)) < 0.7
    from partdistillation_torch.models.meta_arch.proposal import normalize_images

    prog.train()
    with torch.no_grad():
        a = prog(normalize_images(images), drop_keep=keep)
        b = ref(images, keep)
    for key in ("pred_logits", "pred_masks", "mask_features"):
        assert rel(a[key], b[key]) < 1e-4, key
    for i in range(len(b["aux_outputs"])):
        assert rel(a["aux_outputs"][i]["pred_masks"], b["aux_outputs"][i]["pred_masks"]) < 1e-4


def test_weights_follow_the_seed_and_the_programs_names():
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter

    cfg = tiny_config("m2f-swinL-proposal")
    w1, w2 = make_weights(cfg["model"], 9, "cpu"), make_weights(cfg["model"], 9, "cpu")
    w3 = make_weights(cfg["model"], 10, "cpu")
    prog = MaskFormerSegmenter(program.segmenter_config(cfg), device="cpu", seed=0)
    own = prog.state_dict()
    assert set(w1) == set(own) and all(w1[k].shape == own[k].shape for k in own)
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert any(not torch.equal(w1[k], w3[k]) for k in w1)
    off = [k for k in w1 if k.endswith("sampling_offsets.bias")]
    assert off and float(w1[off[0]].abs().max()) == cfg["model"]["pixel_decoder"]["n_points"]


@pytest.mark.parametrize("config,traffic", CELLS)
def test_checked_steps_agree_with_the_reference(tmp_path, config, traffic):
    cfg, t = tiny_config(config), tiny_traffic(traffic)
    limits = {"feature_gap": 1e-4, "mask_gap": 1e-4, "mask_gap_first_layer": 1e-4,
              "image_coef_gap": 1e-4, "grad_diff": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2}
    rec = train.run(cfg, t, 4_000_000_007, 0.5, False, "cpu", time.perf_counter(), limits,
                    str(tmp_path))
    assert rec["correct"], rec["checks"]
    assert rec["steps"] >= 1 and rec["failed"] == 0


def test_unpacking_inverts_the_wire_format():
    masks = np.random.default_rng(0).random((2, 3, 20, 20)) < 0.5
    packed = program.pack({"masks": masks.astype(np.float32), "image": np.zeros((2, 20, 20, 3))})
    assert np.array_equal(check.unpack_masks(packed["masks"], 20), masks.astype(np.float32))
