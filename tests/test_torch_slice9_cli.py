"""The port's stage-5 CLIs (``python -m partdistillation_torch.run
train-distillation / distill-save / distill-eval``) on the CPU.

A synthetic ImageNet split (two classes of four 64 x 64 JPEGs), a stage-4
store written by the port's ``ShardWriter`` (three part masks an image with
cluster labels, scores and object classes spread over the 16-class head,
two images sharing a class and one of the last class), a stage-2b store
over the same masks and a PartImageNet-style GT json. Then, with
``--tiny --device cpu --num-object-classes 16 --num-parts 4``:

- ``train-distillation`` takes two steps, writes ``metrics.jsonl`` and a
  checkpoint holding the head and its AdamW moments, and resumes;
- a round trip train -> ``distill-save --trainer-checkpoint`` ->
  ``distill-eval --trainer-checkpoint``: the JAX package's
  ``PseudoLabelStore`` reads the port's predictions store, ``np.load`` its
  ``distill_mapping.npz``; the six metrics are present;
- on weights written from a JAX initialisation (``--torch-params``), the
  port's ``distill-save`` store holds the JAX CLI's records (labels and
  object classes equal, scores to 1e-5, masks on >= 99.9 % of pixels) and
  ``distill-eval`` gives the JAX CLI's mapping and metrics to 1e-6 (its
  mapped ids stay below num_parts here, where the JAX merge loses nothing);
- a warm start from a port stage-3 checkpoint takes every stage-3 tensor
  and keeps the part head's initial weights, also where the head has the
  shape of the stage-3 class head (one class of one part);
- ``eval_every`` runs the match and eval phases inside the train loop;
- ``n_model_shards`` that does not divide the world (2 in one process),
  ``--tiny`` on cuda, ``--params`` and ``vis_every > 0`` raise SystemExit in
  the three commands before any device is touched.
"""

import argparse
import json

import numpy as np
import pytest
import torch

from partdistillation_torch import run as pcli
from partdistillation_torch.data.pseudo_store import PseudoLabelStore, ShardWriter
from partdistillation_torch.models.segmenter import MaskFormerSegmenter
from partdistillation_torch.utils import rle

CODES = ["n01440764", "n01443537"]
NUM_OBJ, P = 16, 4
HEAD = ["--num-object-classes", str(NUM_OBJ), "--num-parts", str(P)]
OBJECT_CLASS = [3, 15, 7, 0, 3, 11, 9, 5]  # two images of class 3, one of the last class
METRICS = ("C-mIoU", "A-mIoU", "C-mACC", "A-mACC", "C-mIoPred", "A-mIoPred")


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    from PIL import Image

    tmp = tmp_path_factory.mktemp("torch_stage5_cli")
    root = tmp / "imagenet"
    rng = np.random.RandomState(0)
    with ShardWriter(str(tmp / "pseudo_labels" / "part_masks_with_class"), 0, 1) as stage4, \
            ShardWriter(str(tmp / "pseudo_labels" / "proposals_dcrf"), 0, 1) as dcrf:
        for ci, code in enumerate(CODES):
            d = root / code
            d.mkdir(parents=True)
            for j in range(4):
                img = rng.randint(0, 255, (64, 64, 3), np.uint8)
                img[16:52, 12:48] = [60 + 80 * ci, 160, 220 - 60 * ci]
                Image.fromarray(img).save(str(d / f"{code}_{j}.JPEG"))
                parts = []
                for p in range(3):
                    m = np.zeros((64, 64), bool)
                    m[16:52, 12 + 12 * p:24 + 12 * p] = True
                    parts.append(rle.encode(m))
                image_id = f"{code}_{j}"
                stage4.write({"image_id": image_id, "part_masks": parts,
                              "part_labels": [(p + j) % P for p in range(3)],
                              "part_scores": [0.9, 0.7, 0.5],
                              "object_class": OBJECT_CLASS[ci * 4 + j]})
                dcrf.write({"image_id": image_id, "part_masks": parts, "object_ratio": 0.3})
    (root / "labels.txt").write_text("n01440764 tench\nn01443537 goldfish\n")

    images, annotations, aid = [], [], 0
    for ci, code in enumerate(CODES):
        for j in range(4):
            iid = ci * 4 + j
            images.append({"id": iid, "file_name": f"{code}/{code}_{j}.JPEG",
                           "height": 64, "width": 64})
            for p in range(2):
                annotations.append({
                    "id": aid, "image_id": iid, "category_id": (ci + p) % 3,
                    "segmentation": [[12.0 + 18 * p, 16.0, 30.0 + 18 * p, 16.0,
                                      30.0 + 18 * p, 52.0, 12.0 + 18 * p, 52.0]]})
                aid += 1
    part_json = tmp / "part_imagenet.json"
    part_json.write_text(json.dumps({
        "images": images, "annotations": annotations,
        "categories": [{"id": c, "name": f"part{c}"} for c in range(3)]}))
    overrides = [
        f"data.imagenet_root={root}", f"data.part_imagenet_json={part_json}",
        f"data.part_imagenet_images={root}", "data.image_size=64", "data.batch_size=4",
        "data.mask_capacity=8", "data.num_workers=2", f"paths.root={tmp}/pseudo_labels",
        f"checkpoint_dir={tmp}/ckpt", "log_every=1", "checkpoint_every=1000"]
    return {"tmp": tmp, "overrides": overrides}


def _run(main, argv, capsys):
    """Run a CLI's ``main``; return the last JSON line it printed."""
    capsys.readouterr()
    main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return [json.loads(line) for line in out if line.startswith("{")][-1]


def _cpu(cmd, *rest):
    return [cmd, "--tiny", "--device", "cpu", *HEAD, *rest]


def _train(cli_env, capsys, steps):
    return _run(pcli.main, _cpu("train-distillation", "--set", *cli_env["overrides"],
                                f"max_iters={steps}"), capsys)


def _check_metrics(res):
    assert set(METRICS) <= set(res)
    for k in METRICS:
        assert np.isnan(res[k]) or 0.0 <= res[k] <= 100.0, (k, res[k])


def test_train_distillation_tiny_cpu_then_resume(cli_env, capsys):
    res = _train(cli_env, capsys, 2)
    assert res["stage"] == "train-distillation" and res["steps"] == 2
    assert {"images_per_sec", "first_batch_s", "loader_wait_s", "step_s",
            "checkpoint_s"} <= set(res)
    log = cli_env["tmp"] / "ckpt" / "logs" / "train-distillation" / "metrics.jsonl"
    lines = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["total_loss"]) for r in lines)
    ckpt = cli_env["tmp"] / "ckpt" / "part_distillation"
    state = torch.load(ckpt / "model_00000002.pt", weights_only=True)
    head = state["model"]["sem_seg_head.predictor.part_class_embed.weight"]
    assert tuple(head.shape) == (NUM_OBJ * P + 1, 32)
    moments = [s for s in state["optimizer"]["adam"]["state"].values()
               if tuple(s["exp_avg"].shape) == tuple(head.shape)]
    assert len(moments) == 1 and moments[0]["exp_avg_sq"].any()

    res = _train(cli_env, capsys, 3)
    assert res["steps"] == 3
    lines = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2, 3]


def test_round_trip_train_save_eval(cli_env, capsys):
    from partdistillation_tpu.data.pseudo_store import PseudoLabelStore as JStore

    ckpt = cli_env["tmp"] / "ckpt" / "part_distillation"
    if not ckpt.exists():
        _train(cli_env, capsys, 2)
    ov = cli_env["overrides"]
    res = _run(pcli.main, _cpu("distill-save", "--trainer-checkpoint", str(ckpt), "--set",
                               *ov), capsys)
    assert res["stage"] == "distill-save" and res["saved"] == 8
    predictions = cli_env["tmp"] / "pseudo_labels" / "part_distillation_predictions"
    port, jax_store = PseudoLabelStore(str(predictions)), JStore(str(predictions))
    assert len(jax_store) == len(port) == 8
    for want, got in zip(port, jax_store):
        assert set(got) == {"image_id", "part_masks", "part_labels", "part_scores",
                            "object_class"}
        assert got["image_id"] == want["image_id"] and got["part_labels"] == want["part_labels"]
        assert all(0 <= label < P for label in got["part_labels"])
        assert all(0.0 <= s <= 1.0 for s in got["part_scores"])
        assert got["object_class"] in OBJECT_CLASS
        assert all(rle.decode(m).shape == (64, 64) for m in got["part_masks"])
    # a rerun skips the images already saved
    assert _run(pcli.main, _cpu("distill-save", "--trainer-checkpoint", str(ckpt), "--set",
                                *ov), capsys)["saved"] == 0

    res = _run(pcli.main, _cpu("distill-eval", "--trainer-checkpoint", str(ckpt), "--set",
                               *ov), capsys)
    assert res["stage"] == "distill-eval" and res["phases"] == ["match", "eval"]
    _check_metrics(res)
    mapping = np.load(cli_env["tmp"] / "ckpt" / "distill_mapping.npz")["mapping"]
    assert mapping.shape == (NUM_OBJ, P) and mapping.dtype == np.int32
    # the eval phase alone reads the mapping the match phase wrote
    again = _run(pcli.main, _cpu("distill-eval", "--trainer-checkpoint", str(ckpt),
                                 "--phases", "eval", "--set", *ov), capsys)
    assert again["phases"] == ["eval"]
    for k in METRICS:
        assert again[k] == res[k] or (np.isnan(again[k]) and np.isnan(res[k]))


@pytest.fixture
def jax_cache_dir_kept():
    """The JAX CLI's setup points JAX's compilation cache at the repository;
    put the tests' cache back afterwards."""
    import jax

    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


@pytest.fixture
def jax_weights(tmp_path):
    """The JAX CLI's own initialisation at seed 0 as a port state_dict: the
    JAX CLI loading it keeps exactly these weights (its bridge skips the part
    head, which keeps the same initialisation)."""
    import jax
    import jax.numpy as jnp

    from partdistillation_tpu import run as jcli
    from partdistillation_tpu.models.meta_arch.proposal import normalize_images
    from partdistillation_tpu.models.segmenter import MaskFormerSegmenter as JSeg
    from partdistillation_torch.utils.convert_weights import state_dict_from_flax

    seg = jcli._segmenter_cfg(True, num_classes=P, num_queries=200,
                              num_object_classes=NUM_OBJ, num_parts=P)
    params = jax.jit(JSeg(seg).init)(jax.random.PRNGKey(0),
                                     normalize_images(jnp.zeros((1, 64, 64, 3))),
                                     gt_object_class=jnp.zeros((1,), jnp.int32))
    path = tmp_path / "weights.pth"
    torch.save(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)), path)
    return str(path)


def test_distill_save_store_equals_jax_cli(cli_env, capsys, tmp_path, jax_weights,
                                           jax_cache_dir_kept):
    from partdistillation_tpu import run as jcli

    ov = [o for o in cli_env["overrides"] if not o.startswith("paths.root")]
    stores = {}
    for name, main, device in (("jax", jcli.main, []), ("port", pcli.main, ["--device", "cpu"])):
        root = tmp_path / name
        root.mkdir()
        (root / "part_masks_with_class").symlink_to(
            cli_env["tmp"] / "pseudo_labels" / "part_masks_with_class")
        res = _run(main, ["distill-save", "--tiny", *device, *HEAD, "--torch-params",
                          jax_weights, "--set", *ov, f"paths.root={root}"], capsys)
        assert res["saved"] == 8
        stores[name] = PseudoLabelStore(str(root / "part_distillation_predictions"))
    want = {r["image_id"]: r for r in stores["jax"]}
    got = {r["image_id"]: r for r in stores["port"]}
    assert got.keys() == want.keys()
    agree, pixels = 0, 0
    for k, g in got.items():
        w = want[k]
        assert g.keys() == w.keys()
        assert g["part_labels"] == w["part_labels"] and g["object_class"] == w["object_class"]
        np.testing.assert_allclose(g["part_scores"], w["part_scores"], rtol=0, atol=1e-5)
        for a, b in zip(g["part_masks"], w["part_masks"]):
            agree += int((rle.decode(a) == rle.decode(b)).sum())
            pixels += 64 * 64
    assert agree >= 0.999 * pixels


def test_distill_eval_equals_jax_cli(cli_env, capsys, tmp_path, jax_weights,
                                     jax_cache_dir_kept):
    from partdistillation_tpu import run as jcli

    ov = [o for o in cli_env["overrides"] if not o.startswith("checkpoint_dir")]
    results, mappings = {}, {}
    for name, main, device in (("jax", jcli.main, []), ("port", pcli.main, ["--device", "cpu"])):
        results[name] = _run(main, ["distill-eval", "--tiny", *device, *HEAD, "--torch-params",
                                    jax_weights, "--set", *ov,
                                    f"checkpoint_dir={tmp_path / name}"], capsys)
        mappings[name] = np.load(tmp_path / name / "distill_mapping.npz")["mapping"]
    np.testing.assert_array_equal(mappings["port"], mappings["jax"])
    assert mappings["port"].shape == (NUM_OBJ, P) and mappings["port"].max() < P
    _check_metrics(results["port"])
    for k in METRICS:
        got, want = results["port"][k], results["jax"][k]
        assert (np.isnan(got) and np.isnan(want)) or abs(got - want) <= 1e-6, (k, got, want)
    assert results["jax"]["C-mIoU"] > 0  # the predictions do overlap the GT parts


@pytest.mark.parametrize("num_obj,parts", [(NUM_OBJ, P), (1, 1)], ids=["16x4", "1x1"])
def test_warm_start_from_stage3_keeps_the_head_init(cli_env, capsys, num_obj, parts):
    """The 1 x 1 head has 2 x hidden columns, the shape of the stage-3 class
    head: only its name keeps it from loading."""
    ov = cli_env["overrides"]
    ckpt = cli_env["tmp"] / "ckpt" / "proposal"
    if not ckpt.exists():
        _run(pcli.main, ["train-proposal", "--tiny", "--device", "cpu", "--set", *ov,
                         "max_iters=1"], capsys)
    stage3 = torch.load(sorted(ckpt.glob("model_*.pt"))[-1], weights_only=True)["model"]
    seg = pcli._segmenter_cfg(True, num_classes=parts, num_queries=200,
                              num_object_classes=num_obj, num_parts=parts)
    model = MaskFormerSegmenter(seg, device="cpu", seed=0)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    assert tuple(init["sem_seg_head.predictor.part_class_embed.weight"].shape) == (
        num_obj * parts + 1, 32)
    args = argparse.Namespace(params=None, torch_params=None, trainer_checkpoint=str(ckpt),
                              allow_random_init=False)
    pcli._load_weights(model, args)
    got = model.state_dict()
    head = [k for k in got if "part_class_embed" in k]
    assert len(head) == 2 and "sem_seg_head.predictor.class_embed.weight" in stage3
    for k, v in got.items():
        want = init[k] if k in head else stage3[k]
        assert torch.equal(v, want), k
    same_shape = (stage3["sem_seg_head.predictor.class_embed.weight"].shape
                  == got["sem_seg_head.predictor.part_class_embed.weight"].shape)
    assert same_shape == (num_obj * parts == 1)


@pytest.mark.parametrize("cmd", ["train-distillation", "distill-save", "distill-eval"])
def test_model_shards_raise_system_exit(cli_env, cmd, monkeypatch):
    def no_device(*a, **k):
        raise AssertionError("a device was touched")

    monkeypatch.setattr(torch.cuda, "is_available", no_device)
    with pytest.raises(SystemExit, match="not divisible by n_model_shards=2"):
        pcli.main(_cpu(cmd, "--allow-random-init", "--set", *cli_env["overrides"],
                       "n_model_shards=2"))


@pytest.mark.parametrize("cmd", ["train-distillation", "distill-save", "distill-eval"])
@pytest.mark.parametrize("flags,reason", [(["--tiny"], "--device cpu"),
                                          (["--tiny", "--device", "cpu", "--params", "p"],
                                           "--torch-params"),
                                          (["--tiny", "--device", "cpu", "--set",
                                            "vis_every=5"], "ROADMAP")],
                         ids=["tiny-cuda", "params", "vis_every"])
def test_refused_flags_raise_before_any_device(cli_env, cmd, flags, reason, monkeypatch):
    def no_device(*a, **k):
        raise AssertionError("a device was touched")

    monkeypatch.setattr(torch.cuda, "is_available", no_device)
    sets = flags[flags.index("--set") + 1:] if "--set" in flags else []
    flags = flags[:flags.index("--set")] if "--set" in flags else flags
    with pytest.raises(SystemExit, match=reason):
        pcli.main([cmd, *flags, *HEAD, "--allow-random-init", "--set",
                   *cli_env["overrides"], *sets])


def test_train_distillation_evaluates_every_n_steps(cli_env, capsys, tmp_path):
    """``eval_every``: the match and eval phases inside the train loop, the
    mIoU logged beside the losses, the model back in training mode."""
    ov = [o for o in cli_env["overrides"] if not o.startswith("checkpoint_dir")]
    res = _run(pcli.main, _cpu("train-distillation", "--set", *ov, "max_iters=2",
                               "eval_every=2", f"checkpoint_dir={tmp_path}"), capsys)
    assert res["steps"] == 2
    log = tmp_path / "logs" / "train-distillation" / "metrics.jsonl"
    lines = [json.loads(line) for line in log.read_text().splitlines()]
    evals = [r for r in lines if "eval/C-mIoU" in r]
    assert [r["step"] for r in evals] == [2]
    assert set(f"eval/{k}" for k in METRICS) <= set(evals[0])
    assert np.load(tmp_path / "distill_mapping.npz")["mapping"].shape == (NUM_OBJ, P)
