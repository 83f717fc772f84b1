"""The ViTDet-L configuration (``m2f-vitdetL-supervised``, backbone
``backbones/vitdet.py``) through the harness at its ``TINY`` widths on the
CPU: the program built by ``program.build_trainer`` computes the reference's
forward, a run's checked steps agree with ``check.run_reference``, and
``flops.train_step_flops`` counts each product once (the reference's
recomputed blocks are not counted). A tree without the backbone fails at
once: an unknown backbone group, or a program without ``models/vitdet``,
raises before any step."""

from __future__ import annotations

import sys
import time

import pytest
import torch

from portbench import backbones, check, flops, program, run, train
from portbench.reference.model import Segmenter
from portbench.tests.tiny import load, tiny_config, tiny_traffic
from portbench.weights import make_weights

CONFIG, TRAFFIC = "m2f-vitdetL-supervised", "supervised_train"


def rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def test_forward_equals_the_programs():
    from partdistillation_torch.models.meta_arch.proposal import normalize_images
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter

    cfg = tiny_config(CONFIG)
    weights = make_weights(cfg["model"], 123, "cpu")
    prog = MaskFormerSegmenter(program.segmenter_config(cfg), device="cpu", seed=0)
    assert type(prog.backbone).__name__ == "ViTDet"
    assert set(weights) == set(prog.state_dict())
    prog.load_state_dict(weights)
    ref = Segmenter(cfg["model"])
    ref.load_state_dict(weights)
    images = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0)) * 255
    depth = cfg["model"]["vitdet"]["depth"]
    keep = torch.rand(depth, 2, 2, generator=torch.Generator().manual_seed(1)) < 0.7
    prog.train()
    with torch.no_grad():
        a = prog(normalize_images(images), drop_keep=keep)
        b = ref(images, keep)
    for key in ("res2", "res3", "res4", "res5"):
        assert rel(a["backbone_features"][key], b["backbone_features"][key]) < 1e-4, key
    for key in ("pred_logits", "pred_masks", "mask_features"):
        assert rel(a[key], b[key]) < 1e-4, key


def test_position_tables_are_drawn_nonzero():
    cfg = tiny_config(CONFIG)
    w = make_weights(cfg["model"], 5, "cpu")
    tables = [k for k in w if k.endswith(("rel_pos_h", "rel_pos_w", "pos_embed"))]
    assert len(tables) == 1 + 2 * cfg["model"]["vitdet"]["depth"]
    for k in tables:
        assert 0.005 < float(w[k].std()) < 0.03 and float(w[k].abs().max()) <= 0.04 + 1e-6, k


def test_checked_steps_agree_with_the_reference(tmp_path):
    cfg, t = tiny_config(CONFIG), tiny_traffic(TRAFFIC)
    limits = {"feature_gap": 1e-4, "mask_gap": 1e-4, "mask_gap_first_layer": 1e-4,
              "image_coef_gap": 1e-4, "grad_diff": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2}
    rec = train.run(cfg, t, 4_000_000_011, 0.5, False, "cpu", time.perf_counter(), limits,
                    str(tmp_path))
    assert rec["correct"], rec["checks"]
    assert rec["steps"] >= 1 and rec["failed"] == 0


def test_flops_count_each_product_once():
    """The tiny step's count against a direct count of the same forward and
    backward without recomputation; the full size near the reckoning from
    the widths (a ViT-L block at 4,096 tokens: 24 N C^2 + the attention's
    4 N^2 C in a global block, 4 N 196 C in a window block, three times
    forward for a step)."""
    cfg = tiny_config(CONFIG)
    count = flops.train_step_flops(cfg, 2)
    assert count > 0
    full = flops.train_step_flops(load("configs", CONFIG), load("traffic", TRAFFIC)["batch"])
    n, c, b = 4096, 1024, 4
    vit = 20 * (24 * n * c * c + 4 * n * 196 * c) + 4 * (24 * n * c * c + 4 * n * n * c)
    assert 3 * b * vit < full < 3 * b * vit * 1.4


def test_a_tree_without_the_backbone_fails_at_once(monkeypatch):
    cfg = tiny_config(CONFIG)
    other = dict(cfg, model={("vitdet_x" if k == "vitdet" else k): v
                             for k, v in cfg["model"].items()})
    t0 = time.perf_counter()
    with pytest.raises(ModuleNotFoundError):
        backbones.load(other["model"])
    # the parent's program: no models/vitdet
    monkeypatch.setitem(sys.modules, "partdistillation_torch.models.vitdet", None)
    with pytest.raises(ImportError):
        program.segmenter_config(cfg)
    assert time.perf_counter() - t0 < 5.0


@pytest.mark.parametrize("key,value", [("use_rel_pos", False), ("use_abs_pos", False),
                                       ("qkv_bias", False), ("residual_block_indexes", [2]),
                                       ("norm", "BN"), ("scale_factors", [2.0, 1.0])])
def test_descriptive_keys_hold_their_published_values(key, value):
    """Keys that the program and the reference build in are refused unless
    they hold their published values: a group that says otherwise would
    describe a model that neither computes."""
    cfg = tiny_config(CONFIG)
    cfg["model"]["vitdet"][key] = value
    with pytest.raises(ValueError, match=key):
        program.segmenter_config(cfg)
    with pytest.raises(ValueError, match=key):
        Segmenter(cfg["model"])


def test_program_reads_the_mlp_ratio_and_norm_eps():
    cfg = tiny_config(CONFIG)
    cfg["model"]["vitdet"].update(mlp_ratio=2.0, norm_eps=1e-5)
    vit = program.segmenter_config(cfg).vitdet
    assert (vit.mlp_ratio, vit.norm_eps) == (2.0, 1e-5)
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter

    prog = MaskFormerSegmenter(program.segmenter_config(cfg), device="cpu", seed=0)
    block = prog.backbone.net.blocks[0]
    assert block.mlp.fc1.weight.shape[0] == 2 * cfg["model"]["vitdet"]["embed_dim"]
    assert block.norm1.eps == block.norm2.eps == prog.backbone.simfp_2[1].eps == 1e-5
    assert prog.cfg.swin is None


def test_the_cell_resolves():
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    wl, cfg, traffic, limits = run.cell(bench, "vitdet.train")
    assert cfg["name"] == CONFIG and traffic["batch"] == 4 and cfg["image_size"] == 1024
    assert set(limits) == {"input_gap", "feature_gap", "mask_gap_first_layer",
                           "mask_gap_image_median", "image_coef_gap", "change_gap"}
    group = cfg["model"]["vitdet"]
    assert len(group["window_block_indexes"]) == 20 and cfg["reduced"] == []
    assert check.verdict({k: 0.0 for k in limits}, limits)
