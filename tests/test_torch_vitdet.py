"""The port's ViTDet backbone and simple feature pyramid
(``models/vitdet.py``, plain versions on the CPU) against the benchmark's
plain float32 reference (``portbench/backbones/vitdet.py``), from the same
seeded weights under detectron2's parameter names: a tiny ViTDet whose
first block attends in windows of 4 over a 10 x 10 grid (padded to 12, the
padded tokens keys) and whose second attends globally, the position table
of a 2 x 2 pretraining grid resized bicubically to 10 x 10. The four
pyramid levels and the gradient of every leaf, the position and both
relative tables included, with DropPath keep decisions that drop a branch;
then the same comparison with the relative tables zeroed in the port alone,
which must fail it.

Tolerances: a relative Frobenius gap of 1e-5 per level and per leaf's
gradient (both sides compute in float32 in another order: the port's
two-pass LayerNorm and transposed convolution by a product, the
reference's ``F.layer_norm`` and ``F.conv_transpose2d``); zeroing the tables
moves the levels by 1e-2 or more.
"""

import copy

import pytest
import torch

from partdistillation_torch.models.vitdet import ViTDet, ViTDetConfig
from portbench.backbones import vitdet as ref_vitdet
from portbench.reference.model import Rounding

GROUP = {"img_size": 160, "patch_size": 16, "embed_dim": 32, "depth": 2, "num_heads": 2,
         "mlp_ratio": 4.0, "qkv_bias": True, "drop_path_rate": 0.4, "window_size": 4,
         "window_block_indexes": [0], "residual_block_indexes": [], "use_rel_pos": True,
         "use_abs_pos": True, "pretrain_img_size": 32, "pretrain_use_cls_token": True,
         "norm_eps": 1e-6, "out_channels": 16, "scale_factors": [4.0, 2.0, 1.0, 0.5],
         "norm": "LN"}
GAP = 1e-5


def _models(seed: int = 0):
    ref = ref_vitdet.ViTDet(Rounding("f32"), GROUP)
    g = torch.Generator().manual_seed(seed)
    state = {}
    for name, p in ref.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        std = 0.02 if leaf in ("pos_embed", "rel_pos_h", "rel_pos_w") else 0.3
        base = 1.0 if leaf == "weight" and p.dim() == 1 else 0.0
        state[name] = base + std * torch.randn(p.shape, generator=g)
    ref.load_state_dict(state)
    cfg = ref_vitdet.program_config(GROUP, torch.float32)["vitdet"]
    port = ViTDet(cfg)
    port.load_state_dict(state)
    return ref, port, state


def _run(model, x, keep):
    model.zero_grad(set_to_none=True)
    out = model(x, keep)
    loss = sum((v * (i + 1.0)).sin().sum() for i, v in enumerate(out.values()))
    loss.backward()
    return ({k: v.detach() for k, v in out.items()},
            {n: p.grad for n, p in model.named_parameters()})


def _gap(a, b) -> float:
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def inputs():
    g = torch.Generator().manual_seed(11)
    x = torch.randn(2, GROUP["img_size"], GROUP["img_size"], 3, generator=g)
    keep = torch.ones(GROUP["depth"], 2, 2, dtype=torch.bool)
    keep[1, 0, 1] = False  # image 1's attention branch dropped in the global block
    keep[0, 1, 0] = False  # image 0's MLP branch dropped in the window block
    return x, keep


def test_config_follows_the_group():
    cfg = ref_vitdet.program_config(GROUP, torch.float32)["vitdet"]
    assert isinstance(cfg, ViTDetConfig)
    assert cfg.global_block_indexes == (1,) and cfg.num_blocks == 2
    assert cfg.out_channels == {f"res{i}": 16 for i in (2, 3, 4, 5)}
    # the window grid pads: 10 tokens a side into windows of 4
    assert (GROUP["img_size"] // GROUP["patch_size"]) % GROUP["window_size"]


def test_backbone_matches_reference(inputs):
    x, keep = inputs
    ref, port, _ = _models()
    ref.train(), port.train()
    feats_r, grads_r = _run(ref, x, keep)
    feats_p, grads_p = _run(port, x, keep)
    assert set(feats_p) == set(feats_r) == {"res2", "res3", "res4", "res5"}
    g = GROUP["img_size"] // GROUP["patch_size"]
    for k, side in (("res2", 4 * g), ("res3", 2 * g), ("res4", g), ("res5", g // 2)):
        assert tuple(feats_p[k].shape) == (2, side, side, GROUP["out_channels"])
        assert _gap(feats_p[k], feats_r[k]) < GAP, k
    assert set(grads_p) == set(grads_r)
    for name, gr in grads_r.items():
        assert gr is not None and grads_p[name] is not None, name
        assert _gap(grads_p[name], gr) < GAP, name
    for leaf in ("net.pos_embed", "net.blocks.0.attn.rel_pos_h", "net.blocks.1.attn.rel_pos_w"):
        assert float(grads_p[leaf].norm()) > 0.0, leaf


def test_zeroed_tables_fail_the_comparison(inputs):
    x, keep = inputs
    ref, port, state = _models()
    zeroed = copy.deepcopy(state)
    for name in zeroed:
        if name.endswith(("rel_pos_h", "rel_pos_w")):
            zeroed[name].zero_()
    port.load_state_dict(zeroed)
    ref.train(), port.train()
    feats_r, _ = _run(ref, x, keep)
    feats_p, _ = _run(port, x, keep)
    assert min(_gap(feats_p[k], feats_r[k]) for k in feats_r) > 1e-2
