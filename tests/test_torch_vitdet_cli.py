"""ViTDet-L on the port's entry points, on the CPU (``--tiny --device cpu``,
the plain versions): ``train-supervised --backbone vitdet-l`` trains through
the same ``Trainer``, ``DataLoader`` and wire format as Swin and checkpoints
the backbone under detectron2's names; ``profile --backbone vitdet-l``
traces its steps and the trace holds the ViT's spans; the benchmark
configuration's loop (``tools/torch_train_profile.py --loop``) reads them
and counts the op's launches; the optimizer leaves ``pos_embed`` undecayed.
On the CPU the attention takes its plain version, so its backward span
(``bwd.relpos_attn``, the kernels') and its counters stay at zero here."""

import json

import pytest
import torch

from test_torch_slice13_data import pascal_dir  # noqa: F401 (fixture)

from partdistillation_torch import run as pcli
from partdistillation_torch.engine.optim import OptimizerConfig, param_label
from partdistillation_torch.utils.profiling import summarize_trace

VIT = ["--backbone", "vitdet-l"]  # with data.image_size=64 below: a 4 x 4 token grid


def _run(argv, capsys):
    capsys.readouterr()
    pcli.main(argv)
    return [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]


def test_train_supervised_takes_vitdet_steps(pascal_dir, capsys, tmp_path):  # noqa: F811
    ov = [f"data.pascal_parts_annotations={pascal_dir / 'Annotations_Part'}",
          f"data.pascal_parts_images={pascal_dir / 'JPEGImages'}", "data.batch_size=2",
          "data.mask_capacity=8", "data.num_workers=2", "data.image_size=64",
          f"checkpoint_dir={tmp_path}",
          "log_every=1", "checkpoint_every=1000", "max_iters=2"]
    res = _run(["train-supervised", "--tiny", "--device", "cpu", "--num-queries", "8",
                "--eval-dataset", "pascal", *VIT, "--set", *ov], capsys)[-1]
    assert res["stage"] == "train-supervised" and res["steps"] == 2
    state = torch.load(next((tmp_path / "supervised").glob("*.pt")), weights_only=True)["model"]
    for key in ("backbone.net.pos_embed", "backbone.net.blocks.0.attn.rel_pos_h",
                "backbone.net.blocks.1.attn.rel_pos_w", "backbone.net.patch_embed.proj.weight",
                "backbone.simfp_2.0.weight", "backbone.simfp_5.2.norm.weight"):
        assert key in state, key
    assert not any(k.startswith("backbone.layers.") for k in state)
    # the global block's tables span the 4 x 4 token grid of a 64 x 64 image
    assert state["backbone.net.blocks.1.attn.rel_pos_h"].shape == (7, 16)
    assert state["backbone.net.blocks.0.attn.rel_pos_h"].shape == (5, 16)


def test_profile_traces_the_vit_spans(capsys, tmp_path):
    res = _run(["profile", "--tiny", "--device", "cpu", "--steps", "1", "--num-queries", "8",
                *VIT, "--set", "data.batch_size=2", "data.mask_capacity=8", "data.image_size=64",
                f"checkpoint_dir={tmp_path}/ckpt"], capsys)[-1]
    assert res["stage"] == "profile" and "backward_by_scope" in res
    assert res["backward_by_scope"]["backbone"] > 0
    _, detail = summarize_trace(res["trace_dir"], steps=1, return_detail=True)
    assert {"vit.window_attn", "vit.global_attn", "vit.sfp"} <= set(detail["host_by_span"])


def test_loop_tool_reads_the_vitdet_cell(tmp_path):
    from portbench.tests.tiny import tiny_config, tiny_traffic
    from tools.torch_train_profile import profile_loop

    loop, step_ms, host, trace = profile_loop(
        tiny_config("m2f-vitdetL-supervised"), tiny_traffic("supervised_train"), 2 ** 31 + 9,
        "cpu", 1, 1, tmp_path / "trace", "tiny", "cpu")
    assert loop["relpos_attn_forward_backward_launches"] == [[0, 0]]
    assert {"vit.window_attn", "vit.global_attn", "vit.sfp"} <= set(host)
    assert step_ms["backbone"] > 0 and step_ms["backward"] > 0


@pytest.mark.parametrize("name,label", [
    ("backbone.net.pos_embed", "backbone_nodecay"),
    ("backbone.net.blocks.3.attn.rel_pos_h", "backbone_decay"),
    ("backbone.net.blocks.3.attn.qkv.weight", "backbone_decay"),
    ("backbone.absolute_pos_embed", "backbone_nodecay"),
    ("backbone.layers.0.blocks.0.attn.relative_position_bias_table", "backbone_nodecay"),
])
def test_position_table_is_not_decayed(name, label):
    assert param_label(name, torch.zeros(3, 4), OptimizerConfig()) == label
