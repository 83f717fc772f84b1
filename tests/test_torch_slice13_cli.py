"""The supervised CLIs and the Pascal-Parts / Cityscapes-Part eval sets in the
port's CLIs, on the CPU (``--tiny --device cpu``), against the JAX CLI.

The sets are those of the data tests (``test_torch_slice13_data``). On
weights written from a JAX initialisation (``--torch-params``, which the JAX
CLI reads as well and, where its converter has no rule for a key, keeps its
own identical initialisation):

- ``eval-supervised`` on pascal and cityscapes, class-agnostic too, and with
  the v1 heads (``--pixel-decoder fpn --decoder standard``,
  ``transformer_fpn``) gives the JAX CLI's six metrics within 1e-6;
- ``rank --eval-dataset pascal``: the cluster phase writes
  ``rank_centroids_pascal.npz`` over the two object classes, and match and
  eval on the JAX CLI's bank give its ``rank_mapping_pascal.npz`` and
  metrics;
- ``distill-eval --eval-dataset cityscapes`` gives the JAX CLI's mapping and
  metrics (24 parts, so that no mapped label falls outside the JAX merge);
- ``train-supervised`` takes two steps into ``<checkpoint_dir>/supervised``,
  resumes to three, refuses a checkpoint of the other ``--class-agnostic``
  width with a message, evaluates from its checkpoint; with
  ``--label-percentage 50`` it takes the items the JAX CLI takes; the v1
  heads train a step.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice10_models import first_valid_rows_jax, first_valid_rows_port
from test_torch_slice13_data import cityscapes_dir, pascal_dir  # noqa: F401 (fixtures)

from partdistillation_tpu import run as jcli
from partdistillation_torch import run as pcli

METRICS = ("C-mIoU", "A-mIoU", "C-mACC", "A-mACC", "C-mIoPred", "A-mIoPred")
Q = ["--num-queries", "8"]


@pytest.fixture(scope="module")
def overrides(pascal_dir, cityscapes_dir, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("supervised_cli")
    return [f"data.pascal_parts_annotations={pascal_dir / 'Annotations_Part'}",
            f"data.pascal_parts_images={pascal_dir / 'JPEGImages'}",
            f"data.cityscapes_part_labels={cityscapes_dir / 'gtFinePanopticParts'}",
            f"data.cityscapes_images={cityscapes_dir / 'leftImg8bit'}",
            "data.image_size=64", "data.batch_size=2", "data.mask_capacity=8",
            "data.num_workers=2", f"checkpoint_dir={tmp}/ckpt", "log_every=1",
            "checkpoint_every=1000"]


@pytest.fixture
def jax_cache_dir_kept():
    """The JAX CLI's setup points JAX's compilation cache at the repository;
    put the tests' cache back afterwards."""
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def _run(main, argv, capsys):
    """Run a CLI's ``main``; return its JSON lines."""
    capsys.readouterr()
    main(argv)
    return [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]


def _weights(tmp_path, seg, **init_kw) -> str:
    """The JAX initialisation at seed 0 of segmenter config ``seg`` as a
    port state_dict file."""
    from partdistillation_tpu.models.meta_arch.proposal import normalize_images
    from partdistillation_tpu.models.segmenter import MaskFormerSegmenter as JSeg
    from partdistillation_torch.utils.convert_weights import state_dict_from_flax

    params = jax.jit(JSeg(seg).init)(jax.random.PRNGKey(0),
                                     normalize_images(jnp.zeros((1, 64, 64, 3))), **init_kw)
    path = tmp_path / "weights.pth"
    torch.save(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)), path)
    return str(path)


def _v1(seg, pixel_decoder, decoder, classes):
    """The JAX CLI's tiny v1 heads (``_supervised_setup``)."""
    import dataclasses

    from partdistillation_tpu.models.fpn import FPNPixelDecoderConfig
    from partdistillation_tpu.models.maskformer_decoder import StandardDecoderConfig

    return dataclasses.replace(
        seg, pixel_decoder_type=pixel_decoder, decoder_type=decoder,
        fpn=FPNPixelDecoderConfig(conv_dim=32, mask_dim=32, transformer_enc_layers=1,
                                  n_heads=4, transformer_ffn_dim=64),
        standard_decoder=StandardDecoderConfig(num_classes=classes, hidden_dim=32,
                                               num_queries=8, num_heads=4, dim_feedforward=64,
                                               dec_layers=2, mask_dim=32))


def _equal_metrics(got, want):
    for k in METRICS:
        assert 0.0 <= got[k] <= 100.0 or np.isnan(got[k]), (k, got[k])
        assert (np.isnan(got[k]) and np.isnan(want[k])) or abs(got[k] - want[k]) <= 1e-6, (
            k, got[k], want[k])


@pytest.mark.parametrize("dataset,flags", [
    ("pascal", []), ("cityscapes", []), ("pascal", ["--class-agnostic"]),
    ("pascal", ["--pixel-decoder", "fpn", "--decoder", "standard"]),
    ("cityscapes", ["--pixel-decoder", "transformer_fpn", "--decoder", "standard"]),
], ids=["pascal", "cityscapes", "pascal-agnostic", "pascal-fpn-standard",
        "cityscapes-transformer_fpn-standard"])
def test_eval_supervised_equals_jax_cli(dataset, flags, overrides, capsys, tmp_path,
                                        jax_cache_dir_kept):
    classes = 1 if "--class-agnostic" in flags else {"pascal": 6, "cityscapes": 23}[dataset]
    seg = jcli._segmenter_cfg(True, num_classes=classes, num_queries=8)
    if "--decoder" in flags:
        seg = _v1(seg, flags[1], flags[3], classes)
    weights = _weights(tmp_path, seg)
    argv = ["eval-supervised", "--tiny", *Q, "--eval-dataset", dataset, *flags,
            "--torch-params", weights, "--set", *overrides]
    want = _run(jcli.main, argv, capsys)[-1]
    got = _run(pcli.main, [argv[0], "--device", "cpu", *argv[1:]], capsys)[-1]
    assert got["stage"] == "eval-supervised" and got["dataset"] == dataset
    assert got["images_per_sec"] > 0
    _equal_metrics(got, want)
    assert np.isfinite(got["C-mIoU"])


def test_rank_on_pascal_equals_jax_cli(overrides, capsys, tmp_path, monkeypatch,
                                       jax_cache_dir_kept):
    from partdistillation_tpu.ops import kmeans as jkm
    from partdistillation_torch.ops import kmeans as pkm

    monkeypatch.setattr(jkm, "_kmeans_pp_init", first_valid_rows_jax)
    monkeypatch.setattr(pkm, "kmeans_pp_init", first_valid_rows_port)
    weights = _weights(tmp_path, jcli._segmenter_cfg(True, num_classes=1, num_queries=8))
    argv = ["--tiny", *Q, "--num-clusters", "2", "--eval-dataset", "pascal",
            "--torch-params", weights]
    ov = [o for o in overrides if not o.startswith("checkpoint_dir")]
    jax_ckpt, port_ckpt = tmp_path / "jax", tmp_path / "port"
    jres = _run(jcli.main, ["rank", *argv, "--phases", "cluster,match,eval", "--set", *ov,
                            f"checkpoint_dir={jax_ckpt}"], capsys)
    # the port's own cluster phase over the GT parts
    pres = _run(pcli.main, ["rank", "--device", "cpu", *argv, "--phases", "cluster", "--set",
                            *ov, f"checkpoint_dir={port_ckpt}"], capsys)[-1]
    assert pres["dataset"] == "pascal" and pres["cluster"]["classes_seen"] == 2
    bank = np.load(port_ckpt / "rank_centroids_pascal.npz")["centroids"]
    assert bank.shape == (2, 2, 32) and np.isfinite(bank).all()
    # match and eval on the JAX CLI's bank
    (port_ckpt / "rank_centroids_pascal.npz").unlink()
    (port_ckpt / "rank_centroids_pascal.npz").symlink_to(jax_ckpt / "rank_centroids_pascal.npz")
    got = _run(pcli.main, ["rank", "--device", "cpu", *argv, "--phases", "match,eval", "--set",
                           *ov, f"checkpoint_dir={port_ckpt}"], capsys)
    mapping = np.load(port_ckpt / "rank_mapping_pascal.npz")["mapping"]
    want_mapping = np.load(jax_ckpt / "rank_mapping_pascal.npz")["mapping"]
    np.testing.assert_array_equal(mapping, want_mapping)
    assert mapping.shape == (2, 2) and ((mapping >= 0) & (mapping < 6)).all()
    want = [x for x in jres if x["stage"] == "rank-eval"][-1]
    _equal_metrics([x for x in got if x["stage"] == "rank-eval"][-1], want)


def test_distill_eval_on_cityscapes_equals_jax_cli(overrides, capsys, tmp_path,
                                                  jax_cache_dir_kept):
    parts, num_obj = 24, 8
    head = ["--num-object-classes", str(num_obj), "--num-parts", str(parts)]
    seg = jcli._segmenter_cfg(True, num_classes=parts, num_queries=8, num_object_classes=num_obj,
                              num_parts=parts)
    weights = _weights(tmp_path, seg, gt_object_class=jnp.zeros((1,), jnp.int32))
    ov = [o for o in overrides if not o.startswith("checkpoint_dir")]
    results, mappings = {}, {}
    for name, main, dev in (("jax", jcli.main, []), ("port", pcli.main, ["--device", "cpu"])):
        results[name] = _run(main, ["distill-eval", "--tiny", *dev, *Q, *head, "--eval-dataset",
                                    "cityscapes", "--torch-params", weights, "--set", *ov,
                                    f"checkpoint_dir={tmp_path / name}"], capsys)[-1]
        mappings[name] = np.load(tmp_path / name / "distill_mapping_cityscapes.npz")["mapping"]
    np.testing.assert_array_equal(mappings["port"], mappings["jax"])
    assert mappings["port"].shape == (num_obj, parts) and mappings["port"].max() < 23
    assert results["port"]["dataset"] == "cityscapes"
    _equal_metrics(results["port"], results["jax"])


def _setup_items(pkg_cli, pkg_config, argv):
    """The items ``_supervised_setup`` of a package keeps for ``argv``."""
    args = pkg_cli.build_parser().parse_args(argv)
    cfg = pkg_config.load_config(pkg_config.PipelineConfig, None, args.set)
    extra = (torch.device("cpu"),) if pkg_cli is pcli else ()
    return pkg_cli._supervised_setup(cfg, args, *extra)[0]


def test_fewshot_subset_equals_jax(overrides):
    from partdistillation_torch import config as pconfig
    from partdistillation_tpu import config as jconfig

    for pct in ("50", "34", "100"):
        argv = ["train-supervised", "--tiny", *Q, "--eval-dataset", "cityscapes",
                "--label-percentage", pct, "--set", *overrides]
        got = _setup_items(pcli, pconfig, ["train-supervised", "--device", "cpu", *argv[1:]])
        want = _setup_items(jcli, jconfig, argv)
        assert [it["image_id"] for it in got] == [it["image_id"] for it in want]
        assert len(got) == {"50": 5, "34": 3, "100": 10}[pct]


def test_train_supervised_resume_refuse_and_eval(overrides, capsys, tmp_path):
    ov = [o for o in overrides if not o.startswith("checkpoint_dir")]
    ov.append(f"checkpoint_dir={tmp_path}")
    train = ["train-supervised", "--tiny", "--device", "cpu", *Q, "--eval-dataset", "pascal"]
    res = _run(pcli.main, [*train, "--set", *ov, "max_iters=2"], capsys)[-1]
    assert res["stage"] == "train-supervised" and res["steps"] == 2
    assert sorted(p.name for p in (tmp_path / "supervised").glob("*.pt")) == ["model_00000002.pt"]
    logged = [json.loads(x) for x in
              (tmp_path / "logs" / "train-supervised" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in logged] == [1, 2]
    assert all(np.isfinite(r["total_loss"]) and "loss_mask_1" in r for r in logged)
    assert _run(pcli.main, [*train, "--set", *ov, "max_iters=3"], capsys)[-1]["steps"] == 3
    # a checkpoint of the 6-class head refused by the 1-class (agnostic) run
    with pytest.raises(SystemExit, match="other shapes"):
        pcli.main([*train, "--class-agnostic", "--set", *ov, "max_iters=4"])
    with pytest.raises(SystemExit, match="other shapes"):
        pcli.main(["eval-supervised", "--tiny", "--device", "cpu", *Q, "--eval-dataset", "pascal",
                   "--class-agnostic", "--trainer-checkpoint", str(tmp_path / "supervised"),
                   "--set", *ov])
    ev = _run(pcli.main, ["eval-supervised", "--tiny", "--device", "cpu", *Q, "--eval-dataset",
                          "pascal", "--trainer-checkpoint", str(tmp_path / "supervised"),
                          "--set", *ov], capsys)[-1]
    assert all(0.0 <= ev[k] <= 100.0 or np.isnan(ev[k]) for k in METRICS)


@pytest.mark.parametrize("pixel_decoder", ["fpn", "transformer_fpn"])
def test_train_supervised_v1_heads_take_a_step(pixel_decoder, overrides, capsys, tmp_path):
    ov = [o for o in overrides if not o.startswith("checkpoint_dir")]
    res = _run(pcli.main, ["train-supervised", "--tiny", "--device", "cpu", *Q,
                           "--eval-dataset", "pascal", "--label-percentage", "50",
                           "--class-agnostic", "--pixel-decoder", pixel_decoder, "--decoder",
                           "standard", "--set", *ov, f"checkpoint_dir={tmp_path}", "max_iters=1"],
               capsys)[-1]
    assert res["steps"] == 1
    state = torch.load(next((tmp_path / "supervised").glob("*.pt")), weights_only=True)["model"]
    assert state["sem_seg_head.predictor.class_embed.weight"].shape == (2, 32)
    assert "sem_seg_head.pixel_decoder.adapter_3.weight" in state
    assert ("sem_seg_head.pixel_decoder.transformer.encoder.layers.0.self_attn.in_proj_weight"
            in state) == (pixel_decoder == "transformer_fpn")


def test_eval_sets_need_their_directories(overrides):
    ov = [o for o in overrides if not o.startswith("data.pascal_parts_annotations")]
    with pytest.raises(SystemExit, match="data.pascal_parts_annotations"):
        pcli.main(["eval-supervised", "--tiny", "--device", "cpu", *Q, "--eval-dataset", "pascal",
                   "--allow-random-init", "--set", *ov,
                   "data.pascal_parts_annotations=/nonexistent"])
    args = argparse.Namespace(eval_dataset="part_imagenet", num_gt_parts=40)
    assert pcli._eval_catalog(None, args).names() == ["cityscapes", "part_imagenet", "pascal"]
