"""The port's stage-1 labelling (``models/meta_arch/labeling.py``) on the CPU,
in f32, against the JAX package's, on inputs made from numpy seeds and
weights carried across with ``utils.convert_weights``.

- ``crop_regions`` against JAX's crop (``jax.image.scale_and_translate``,
  "linear", antialiased, as ``clip_region_scorer_jax`` builds it) for boxes
  that shrink, boxes that grow, a one-pixel box and an empty mask (the whole
  image): within 2e-6 of 255;
- ``clip_region_scorer_device`` on a tiny CLIP vision tower against JAX's
  ``clip_region_scorer_jax(crop_backend="device")`` on the same weights:
  class ids equal, probabilities within 1e-5, one image at a time and
  batched;
- ``make_proposal_detection_fn`` at the tiny segmenter config against JAX's:
  masks, packed masks and validity equal, scores within 1e-6;
- ``run_labeling_batched`` over 11 images in 3 chunks (batch 4, a ragged
  tail) with the tiny tower's scorer, as the JAX package's
  ``tests/test_labeling_pipeline.py`` fixture builds it: its store against
  the JAX function's (masks, classes equal, scores within 1e-5), the
  per-image scorer path equal to the batched one, and a rerun skips all 11;
- ``select_class_matched_topk`` against JAX's; ``_save_detection``'s class
  match and keep-all fallback;
- importing every port module imports neither JAX nor transformers.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partdistillation_torch.data.pseudo_store import PseudoLabelStore, ShardWriter
from partdistillation_torch.models.meta_arch import labeling as plab
from partdistillation_torch.utils import rle
from partdistillation_torch.utils.convert_weights import (clip_state_dict_from_flax,
                                                          state_dict_from_flax)
from partdistillation_tpu.models.meta_arch import labeling as jlab

ROOT = Path(__file__).resolve().parent.parent
CROP = 32


def _jax_crop(image, m, crop_size=CROP):
    """JAX's device crop, as ``clip_region_scorer_jax._crop`` computes it."""
    h, w = image.shape[:2]
    ys, xs = jnp.any(m, axis=1), jnp.any(m, axis=0)
    empty = ~jnp.any(ys)
    y0 = jnp.where(empty, 0, jnp.argmax(ys)).astype(jnp.float32)
    y1 = jnp.where(empty, h, h - jnp.argmax(ys[::-1])).astype(jnp.float32)
    x0 = jnp.where(empty, 0, jnp.argmax(xs)).astype(jnp.float32)
    x1 = jnp.where(empty, w, w - jnp.argmax(xs[::-1])).astype(jnp.float32)
    sy, sx = crop_size / (y1 - y0), crop_size / (x1 - x0)
    return jax.image.scale_and_translate(image, (crop_size, crop_size, 3), (0, 1),
                                         jnp.stack([sy, sx]), jnp.stack([-y0 * sy, -x0 * sx]),
                                         method="linear")


def _box(h, w, y0, y1, x0, x1):
    m = np.zeros((h, w), bool)
    m[y0:y1, x0:x1] = True
    return m


def test_crops_match_jax_scale_and_translate():
    rng = np.random.RandomState(0)
    h, w = 64, 48
    images = rng.randint(0, 255, (2, h, w, 3)).astype(np.float32)
    masks = np.stack([
        np.stack([_box(h, w, 3, 60, 2, 46),   # shrinks in both axes
                  _box(h, w, 10, 15, 20, 27),  # grows
                  _box(h, w, 0, 40, 30, 37),   # shrinks in y, grows in x
                  np.zeros((h, w), bool)]),    # empty: the whole image
        np.stack([_box(h, w, 5, 6, 5, 6),     # one pixel
                  rng.rand(h, w) < 0.02,       # scattered pixels
                  _box(h, w, 20, 64, 0, 48),
                  np.zeros((h, w), bool)])])
    got = plab.crop_regions(torch.from_numpy(images), torch.from_numpy(masks), CROP).numpy()
    assert got.shape == (2, 4, CROP, CROP, 3)
    for b in range(2):
        for k in range(4):
            want = np.asarray(_jax_crop(jnp.asarray(images[b]), jnp.asarray(masks[b, k])))
            np.testing.assert_allclose(got[b, k], want, rtol=0, atol=2e-6 * 255,
                                       err_msg=f"crop {b},{k}")


@pytest.fixture(scope="module")
def towers():
    from partdistillation_tpu.models.clip_vit import CLIPVisionTower, CLIPVisionTowerConfig
    from partdistillation_torch.models import clip_vit as pvit

    kw = dict(image_size=CROP, patch_size=8, hidden_size=32, num_layers=1, num_heads=2,
              intermediate_size=64, projection_dim=16)
    jtower = CLIPVisionTower(CLIPVisionTowerConfig(**kw))
    params = jax.tree_util.tree_map(np.array, jax.jit(jtower.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, CROP, CROP, 3))))
    tower = pvit.CLIPVisionTower(pvit.CLIPVisionTowerConfig(**kw), device="cpu")
    tower.load_state_dict(clip_state_dict_from_flax(params, "vision"))
    temb = np.random.RandomState(2).randn(5, 16).astype(np.float32)
    temb /= np.linalg.norm(temb, axis=-1, keepdims=True)
    jscorer = jlab.clip_region_scorer_jax(jtower.apply, temb, crop_size=CROP, capacity=4,
                                          vision_params=params, crop_backend="device")
    return {"jax": jscorer, "port": plab.clip_region_scorer_device(tower, temb),
            "jtower": jtower, "params": params}


def test_region_scorer_matches_jax(towers):
    rng = np.random.RandomState(3)
    images = rng.randint(0, 255, (2, 64, 64, 3)).astype(np.uint8)
    masks = np.stack([np.stack([_box(64, 64, 8 * i, 8 * i + 20 + 4 * i, 3 * i, 30 + 5 * i)
                                for i in range(5)] + [np.zeros((64, 64), bool)])
                      for _ in range(2)])
    masks[1] = masks[1][::-1]
    want_ids, want_p = towers["jax"].batched(jnp.asarray(images, jnp.float32),
                                             jnp.asarray(masks))
    got_ids, got_p = towers["port"].batched(images, masks)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-5)
    ids, p = towers["port"](images[1], masks[1])
    np.testing.assert_array_equal(ids, got_ids[1])
    np.testing.assert_allclose(p, got_p[1], rtol=0, atol=1e-6)
    ids, p = towers["port"](images[0], masks[0, :0])
    assert ids.shape == p.shape == (0,)


@pytest.fixture(scope="module")
def detection():
    from partdistillation_tpu import run as jcli
    from partdistillation_tpu.models.meta_arch.proposal import (ProposalModelConfig as JCfg,
                                                                normalize_images)
    from partdistillation_tpu.models.segmenter import MaskFormerSegmenter as JSeg
    from partdistillation_torch import run as pcli
    from partdistillation_torch.models.meta_arch.proposal import ProposalModelConfig
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter

    jseg = jcli._segmenter_cfg(True, num_classes=1, num_queries=8)
    params = jax.jit(JSeg(jseg).init)(jax.random.PRNGKey(0),
                                      normalize_images(jnp.zeros((1, 64, 64, 3))))
    jfn = jax.jit(jlab.make_proposal_detection_fn(JCfg(segmenter=jseg, test_topk=4)))
    pseg = pcli._segmenter_cfg(True, num_classes=1, num_queries=8)
    model = MaskFormerSegmenter(pseg, device="cpu", seed=5)
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.array, params)))
    pfn = plab.make_proposal_detection_fn(ProposalModelConfig(segmenter=pseg, test_topk=4),
                                          model, device="cpu")
    return {"jfn": jfn, "params": params, "pfn": pfn}


def test_detection_fn_matches_jax(detection):
    images = np.random.RandomState(4).randint(0, 255, (3, 64, 64, 3)).astype(np.uint8)
    want = {k: np.asarray(v) for k, v in detection["jfn"](detection["params"],
                                                          jnp.asarray(images)).items()}
    got = {k: v.numpy() for k, v in detection["pfn"](images).items()}
    assert got.keys() == want.keys()
    assert got["masks"].shape == (3, 4, 64, 64) and got["masks_packed"].shape == (3, 4, 64, 8)
    for k in ("masks", "masks_packed", "valid"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-6)
    assert got["valid"].any()


@pytest.fixture(scope="module")
def label_items(tmp_path_factory):
    from PIL import Image

    tmp = tmp_path_factory.mktemp("torch_labelpipe")
    rng = np.random.RandomState(0)
    items = []
    # 11 images, batch 4: 3 chunks with a ragged tail
    for i in range(11):
        img = rng.randint(0, 255, (64, 64, 3), np.uint8)
        img[16:48, 8 + 2 * i:40 + 2 * i] = [200, 50, 50]
        p = str(tmp / f"im{i:02d}.jpg")
        Image.fromarray(img).save(p, quality=95)
        items.append({"image_id": f"im{i:02d}", "file_name": p, "class_id": i % 3,
                      "class_code": "n0"})
    return tmp, items


def _records(store_dir):
    return {r["image_id"]: r for r in PseudoLabelStore(str(store_dir))}


def test_run_labeling_batched_store_equals_jax(detection, towers, label_items, tmp_path):
    from partdistillation_tpu.data.pseudo_store import ShardWriter as JWriter

    _, items = label_items
    with JWriter(str(tmp_path / "jax"), 0, 1) as w:
        want_stats = jlab.run_labeling_batched(
            detection["jfn"], detection["params"], items, w, jlab.LabelingConfig(topk=4),
            region_scorer=towers["jax"], image_size=64, batch_size=4, num_workers=2)
    with ShardWriter(str(tmp_path / "port"), 0, 1) as w:
        stats = plab.run_labeling_batched(detection["pfn"], items, w,
                                          plab.LabelingConfig(topk=4),
                                          region_scorer=towers["port"], image_size=64,
                                          batch_size=4, num_workers=2)
    assert stats == want_stats and stats["saved"] == 11
    want, got = _records(tmp_path / "jax"), _records(tmp_path / "port")
    assert got.keys() == want.keys()
    for iid, g in got.items():
        x = want[iid]
        assert g.keys() == x.keys()
        assert g["object_masks"] == x["object_masks"], iid
        assert g["pred_classes"] == x["pred_classes"], iid
        assert g["class_code"] == x["class_code"] and g["pred_names"] is None
        np.testing.assert_allclose(g["scores"], x["scores"], rtol=0, atol=1e-5)
        assert len(g["scores"]) <= 4 and all(0.0 <= s <= 1.0 for s in g["scores"])

    # the per-image scorer inside the drain writes the same store
    def per_image(image, masks):
        return towers["port"](image, masks)

    with ShardWriter(str(tmp_path / "serial"), 0, 1) as w:
        plab.run_labeling_batched(detection["pfn"], items, w, plab.LabelingConfig(topk=4),
                                  region_scorer=per_image, image_size=64, batch_size=4,
                                  num_workers=0)
    serial = _records(tmp_path / "serial")
    for iid, g in got.items():
        assert serial[iid]["object_masks"] == g["object_masks"]
        assert serial[iid]["pred_classes"] == g["pred_classes"]
        np.testing.assert_allclose(serial[iid]["scores"], g["scores"], rtol=0, atol=1e-6)

    # resume: every image is in the store
    with ShardWriter(str(tmp_path / "port"), 0, 1) as w:
        again = plab.run_labeling_batched(detection["pfn"], items, w,
                                          plab.LabelingConfig(topk=4),
                                          region_scorer=towers["port"], image_size=64,
                                          batch_size=4)
    assert again == {"saved": 0, "skipped": 11, "empty": 0}


def test_segmenter_detector_matches_batched_path(detection, label_items, tmp_path):
    _, items = label_items
    with ShardWriter(str(tmp_path / "one"), 0, 1) as w:
        plab.run_labeling(plab.segmenter_detector(detection["pfn"], 64), items[:5], w,
                          plab.LabelingConfig(topk=4, match_classes=False))
    with ShardWriter(str(tmp_path / "batched"), 0, 1) as w:
        plab.run_labeling_batched(detection["pfn"], items[:5], w,
                                  plab.LabelingConfig(topk=4, match_classes=False),
                                  image_size=64, batch_size=2, num_workers=1)
    one, batched = _records(tmp_path / "one"), _records(tmp_path / "batched")
    assert one.keys() == batched.keys() and len(one) == 5
    for iid in one:
        assert one[iid]["object_masks"] == batched[iid]["object_masks"]
        assert one[iid]["pred_classes"] == batched[iid]["pred_classes"] == \
            [-1] * len(one[iid]["scores"])
        np.testing.assert_allclose(one[iid]["scores"], batched[iid]["scores"], atol=1e-6)


@pytest.mark.parametrize("target", [1, 7])
@pytest.mark.parametrize("match", [True, False])
def test_select_class_matched_topk_matches_jax(target, match):
    rng = np.random.RandomState(target)
    scores = rng.rand(12).astype(np.float32)
    scores[3] = scores[5]  # a tie: the lower index first
    class_ids = rng.randint(0, 4, 12).astype(np.int32)
    valid = rng.rand(12) < 0.8
    cfg_j = jlab.LabelingConfig(topk=5, score_threshold=0.2, match_classes=match)
    cfg_p = plab.LabelingConfig(topk=5, score_threshold=0.2, match_classes=match)
    want = [np.asarray(x) for x in jlab.select_class_matched_topk(
        jnp.asarray(scores), jnp.asarray(class_ids), jnp.asarray(valid), jnp.asarray(target),
        cfg_j)]
    got = [x.numpy() for x in plab.select_class_matched_topk(
        torch.from_numpy(scores), torch.from_numpy(class_ids), torch.from_numpy(valid),
        target, cfg_p)]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[0][got[2]], want[0][want[2]])
    np.testing.assert_array_equal(got[1], want[1])


class _Writer:
    def __init__(self):
        self.records = []

    def write(self, rec):
        self.records.append(rec)
        return True


def test_save_detection_class_match_and_fallback():
    masks = np.zeros((3, 8, 8), bool)
    for i in range(3):
        masks[i, i:i + 3, i:i + 3] = True
    det = {"masks": masks, "scores": np.array([0.9, 0.6, 0.8], np.float32),
           "class_ids": np.array([0, 1, 2], np.int32), "pred_names": ["a", "b", "c"]}
    w = _Writer()
    assert plab._save_detection(det, {"image_id": "x", "class_id": 1, "class_code": "n1"}, w,
                                plab.LabelingConfig(topk=2), rle)
    r = w.records[0]
    assert r["pred_classes"] == [1] and r["pred_names"] == ["b"] and r["class_code"] == "n1"
    np.testing.assert_array_equal(rle.decode(r["object_masks"][0]), masks[1])
    assert plab._save_detection(det, {"image_id": "y", "class_id": 7}, w,
                                plab.LabelingConfig(topk=2), rle)
    assert w.records[1]["pred_classes"] == [0, 2]  # no match: the best two of all
    assert not plab._save_detection(det, {"image_id": "z", "class_id": 1}, w,
                                    plab.LabelingConfig(score_threshold=0.95), rle)


def test_port_imports_neither_jax_nor_transformers():
    code = (
        "import importlib, pkgutil, sys\n"
        "import partdistillation_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'partdistillation_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'transformers', 'partdistillation_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
