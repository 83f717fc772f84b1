"""The port's overlays (``utils/visualize.py``), its ``visualize`` command
and the train commands' ``vis_every`` snapshots, against the JAX package on
the CPU.

- ``color_palette``, ``overlay_masks`` and ``make_collage`` equal the JAX
  module's bit for bit (valid slots, label-keyed colours, [0, 1] images, no
  contours, other alphas, ragged panels);
- ``visualize`` over a store the port's ``ShardWriter`` wrote writes the
  JAX CLI's PNG bit for bit (``tests/test_visualize.py``'s fixture shape:
  three 32 x 32 JPEGs, one part each);
- ``train-proposal --tiny --device cpu --set vis_every=1`` for two steps:
  each snapshot against JAX's ``_make_vis_fn`` fed the same host batch and
  the port's weights of that step (through JAX's converter). The files
  written and every GT panel are equal; the predicted panels agree on at
  least 99.9 % of their pixels (each mask thresholds f32 logits at 0, so a
  logit within float error of 0 may flip a pixel; read 100 % here);
- the same comparison with the stage-5 head (``gt_object_class`` picks each
  image's part columns), the port's vis function called directly on
  JAX-initialised weights;
- ``train-distillation --set n_model_shards=2 vis_every=1`` on two gloo
  ranks (``tests/test_torch_slice9_cli.py``'s set): every rank runs the
  snapshot's forward through the head split over both, so neither waits on
  the other, and the snapshots of both steps are written.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_slice9_cli import HEAD, cli_env  # noqa: F401 (fixture)
from torch_dist_worker import free_port, spawn, torchrun_env

from partdistillation_torch import run as pcli
from partdistillation_torch.data.pseudo_store import ShardWriter
from partdistillation_torch.utils import rle
from partdistillation_torch.utils import visualize as pvis
from partdistillation_tpu.utils import visualize as jvis

PRED_PIXEL_AGREEMENT = 0.999


@pytest.fixture
def jax_cache_dir_kept():
    """The JAX CLI's setup points JAX's compilation cache at the repository;
    put the tests' cache back afterwards."""
    import jax

    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


@pytest.mark.parametrize("n,seed", [(1, 7), (16, 7), (40, 3)])
def test_color_palette_equals_jax(n, seed):
    np.testing.assert_array_equal(pvis.color_palette(n, seed), jvis.color_palette(n, seed))


def _overlay_case(case):
    rng = np.random.RandomState(case)
    img = rng.randint(0, 256, (24, 20, 3)).astype(np.uint8)
    masks = rng.rand(5, 24, 20) < 0.3
    masks[3] = False  # an empty mask is skipped
    return img, masks, rng


@pytest.mark.parametrize("kw", [
    {},
    {"valid": np.array([True, False, True, True, False])},
    {"labels": [3, 0, 11, 3, 5]},
    {"draw_contours": False, "alpha": 0.3},
    {"unit_image": True},
], ids=["plain", "valid", "labels", "no-contours", "unit-image"])
def test_overlay_masks_equals_jax(kw):
    img, masks, _ = _overlay_case(len(kw))
    kw = dict(kw)
    if kw.pop("unit_image", False):
        img = img.astype(np.float32) / 255.0
    got = pvis.overlay_masks(img, masks, **kw)
    want = jvis.overlay_masks(img, masks, **kw)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cols,pad", [(2, 2), (3, 0), (4, 5)])
def test_make_collage_equals_jax(cols, pad):
    rng = np.random.RandomState(cols)
    panels = [rng.randint(0, 256, (10 + i, 12 - i, 3)).astype(np.uint8) for i in range(5)]
    np.testing.assert_array_equal(pvis.make_collage(panels, cols=cols, pad=pad),
                                  jvis.make_collage(panels, cols=cols, pad=pad))
    with pytest.raises(ValueError):
        pvis.make_collage([])


def test_visualize_cli_png_equals_jax(tmp_path, capsys, jax_cache_dir_kept):
    from partdistillation_tpu import run as jcli

    root = tmp_path / "imagenet" / "n01440764"
    root.mkdir(parents=True)
    rng = np.random.RandomState(0)
    store_dir = tmp_path / "store"
    with ShardWriter(str(store_dir), 0, 1) as w:
        for j in range(3):
            Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(
                str(root / f"n01440764_{j}.JPEG"))
            m = np.zeros((32, 32), bool)
            m[4:20, 4 + j:20] = True
            w.write({"image_id": f"n01440764_{j}", "part_masks": [rle.encode(m)],
                     "part_labels": [j]})
    outs = {}
    for name, main in (("port", pcli.main), ("jax", jcli.main)):
        outs[name] = tmp_path / f"collage_{name}.png"
        capsys.readouterr()
        main(["visualize", "--store", str(store_dir), "--output", str(outs[name]), "--cols",
              "2", "--set", f"data.imagenet_root={tmp_path}/imagenet", "data.image_size=32"])
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert res == {"stage": "visualize", "panels": 3, "output": str(outs[name])}
    got, want = (np.asarray(Image.open(outs[k])) for k in ("port", "jax"))
    assert got.shape == (2 * 32 + 2, 2 * 32 + 2, 3)
    np.testing.assert_array_equal(got, want)
    assert outs["port"].read_bytes() == outs["jax"].read_bytes()


def _panels(png: str, n: int, size: int):
    """(pred, gt) panels of a two-column vis collage of n images."""
    grid = np.asarray(Image.open(png))
    assert grid.shape == (n * (size + 2) - 2, 2 * size + 2, 3)
    cut = [grid[i * (size + 2): i * (size + 2) + size] for i in range(n)]
    return [c[:, :size] for c in cut], [c[:, size + 2:] for c in cut]


def _compare_snapshots(port_png, jax_png, n, size):
    pred_p, gt_p = _panels(port_png, n, size)
    pred_j, gt_j = _panels(jax_png, n, size)
    for a, b in zip(gt_p, gt_j):
        np.testing.assert_array_equal(a, b)
    same = np.mean([np.all(a == b, axis=-1).mean() for a, b in zip(pred_p, pred_j)])
    assert same >= PRED_PIXEL_AGREEMENT, same
    return same


@pytest.fixture(scope="module")
def vis_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vis_cli")
    root = tmp / "imagenet"
    rng = np.random.RandomState(0)
    codes = ["n01440764", "n01443537"]
    with ShardWriter(str(tmp / "pseudo_labels" / "proposals_dcrf"), 0, 1) as writer:
        for ci, code in enumerate(codes):
            (root / code).mkdir(parents=True)
            for j in range(4):
                img = rng.randint(0, 255, (64, 64, 3), np.uint8)
                img[16:52, 12:48] = [60 + 80 * ci, 160, 220 - 60 * ci]
                Image.fromarray(img).save(str(root / code / f"{code}_{j}.JPEG"))
                parts = []
                for p in range(3):
                    m = np.zeros((64, 64), bool)
                    m[16:52, 12 + 12 * p:24 + 12 * p] = True
                    parts.append(rle.encode(m))
                writer.write({"image_id": f"{code}_{j}", "part_masks": parts,
                              "object_ratio": 0.3})
    (root / "labels.txt").write_text("n01440764 tench\nn01443537 goldfish\n")
    return {"tmp": tmp, "overrides": [
        f"data.imagenet_root={root}", "data.image_size=64", "data.batch_size=4",
        "data.mask_capacity=8", "data.num_workers=2", f"paths.root={tmp}/pseudo_labels",
        "log_every=1", "checkpoint_every=1000"]}


def test_train_proposal_vis_every_matches_jax(vis_env, tmp_path, capsys, monkeypatch,
                                              jax_cache_dir_kept):
    from partdistillation_tpu import run as jcli
    from partdistillation_tpu.models.segmenter import MaskFormerSegmenter as JSeg
    from partdistillation_tpu.utils.convert_weights import convert_mask2former_state_dict

    calls, real = [], pcli._make_vis_fn

    def spy(model, vis_dir, device, **kw):
        fn = real(model, vis_dir, device, **kw)

        def recorded(batch, step):
            calls.append(({k: np.array(v) for k, v in batch.items() if k != "image_id"}, step,
                          {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}))
            fn(batch, step)

        return recorded

    monkeypatch.setattr(pcli, "_make_vis_fn", spy)
    ckpt = tmp_path / "ckpt"
    pcli.main(["train-proposal", "--tiny", "--device", "cpu", "--num-queries", "8", "--set",
               *vis_env["overrides"], f"checkpoint_dir={ckpt}", "max_iters=2", "vis_every=1"])
    port_dir = ckpt / "logs" / "train-proposal" / "vis"
    assert [step for _, step, _ in calls] == [1, 2]
    assert sorted(os.listdir(port_dir)) == ["step_000001.png", "step_000002.png"]

    jmodel = JSeg(jcli._segmenter_cfg(True, num_classes=1, num_queries=8))
    jax_dir = tmp_path / "jax_vis"
    jax_vis = jcli._make_vis_fn(jmodel, str(jax_dir))
    for batch, step, state in calls:
        params, unmatched = convert_mask2former_state_dict(state)
        assert unmatched == []
        # the batch as the JAX CLI hands it over: the wire's uint8 image as f32
        jax_vis(params, {"image": batch["image"].astype(np.float32),
                         "masks": batch["masks"], "valid": batch["valid"]}, step)
    assert sorted(os.listdir(jax_dir)) == sorted(os.listdir(port_dir))
    for name in os.listdir(port_dir):
        _compare_snapshots(str(port_dir / name), str(jax_dir / name), 4, 64)


def test_part_head_vis_fn_matches_jax(tmp_path, jax_cache_dir_kept):
    """The stage-5 head's snapshot: ``gt_object_class`` picks each image's
    part columns in both packages."""
    import jax
    import jax.numpy as jnp

    from partdistillation_tpu import run as jcli
    from partdistillation_tpu.models.segmenter import MaskFormerSegmenter as JSeg
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter
    from partdistillation_torch.utils.convert_weights import state_dict_from_flax

    kw = dict(num_classes=4, num_queries=8, num_object_classes=16, num_parts=4)
    jmodel = JSeg(jcli._segmenter_cfg(True, **kw))
    params = jax.jit(lambda x: jmodel.init(jax.random.PRNGKey(3), x,
                                           gt_object_class=jnp.zeros((1,), jnp.int32)))(
        jnp.zeros((1, 64, 64, 3)))
    params = jax.tree_util.tree_map(np.asarray, params)
    model = MaskFormerSegmenter(pcli._segmenter_cfg(True, **kw), device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)

    rng = np.random.RandomState(5)
    batch = {"image": rng.randint(0, 256, (3, 64, 64, 3)).astype(np.float32),
             "masks": rng.rand(3, 6, 64, 64) < 0.3,
             "valid": np.array([[True] * 4 + [False] * 2] * 3),
             "gt_object_class": np.array([3, 15, 3], np.int32)}
    pcli._make_vis_fn(model, str(tmp_path / "port"), torch.device("cpu"),
                      needs_object_class=True)(batch, 7)
    jcli._make_vis_fn(jmodel, str(tmp_path / "jax"), needs_object_class=True)(params, batch, 7)
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax") == ["step_000007.png"]
    _compare_snapshots(str(tmp_path / "port" / "step_000007.png"),
                       str(tmp_path / "jax" / "step_000007.png"), 3, 64)


def test_snapshots_with_the_head_split_over_two_ranks(cli_env, tmp_path):  # noqa: F811
    ov = [o for o in cli_env["overrides"] if not o.startswith("checkpoint_dir")]
    argv = [sys.executable, "-m", "partdistillation_torch.run", "train-distillation", "--tiny",
            "--device", "cpu", *HEAD, "--set", *ov, f"checkpoint_dir={tmp_path}",
            "data.batch_size=2", "max_iters=2", "n_model_shards=2", "vis_every=1"]
    port = free_port()
    outs = spawn([argv] * 2, [torchrun_env(r, 2, port) for r in range(2)])
    results = [json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
               for out in outs]
    assert all(r["stage"] == "train-distillation" and r["steps"] == 2 for r in results)
    vis = tmp_path / "logs" / "train-distillation" / "vis"
    assert sorted(os.listdir(vis)) == ["step_000001.png", "step_000002.png"]
    for name in os.listdir(vis):
        assert np.asarray(Image.open(vis / name)).shape == (2 * 66 - 2, 2 * 64 + 2, 3)
