"""Stage 5's data layer and mIoU evaluation on the CPU against the JAX
package's.

- ``load_imagenet_with_segmentation`` lists the same items, joined lazily
  by store path, over several base lists;
- ``PartDistillationTrainMapper`` gives the same arrays for the same item,
  seed and epoch (per-item ``RandomState``), ``PartDistillationSaveMapper``
  for the same item;
- ``evaluation/miou.py``: the rasterisation, confusion matrices, majority
  vote, mIoU math and the merge of per-class matrices, then ``MIoUMatcher``'s
  vote mapping and ``MIoUEvaluator``'s six metrics on random predictions;
  ``distributed=True`` raises without a process group (no single-process
  run of a distributed evaluation).

All comparisons are exact.
"""

import numpy as np
import pytest

from partdistillation_tpu.data import mappers as jmappers
from partdistillation_tpu.data.datasets import imagenet as jimagenet
from partdistillation_tpu.evaluation import miou as jmiou
from partdistillation_torch.data import mappers as pmappers
from partdistillation_torch.data import pseudo_store as pstore
from partdistillation_torch.data.datasets import imagenet as pimagenet
from partdistillation_torch.evaluation import miou as pmiou
from partdistillation_torch.utils import rle as prle

CODES = ["n01440764", "n01443537"]


@pytest.fixture(scope="module")
def stage4_set(tmp_path_factory):
    """Two classes of five JPEGs of several sizes and a stage-4 store over
    eight of them: part masks with cluster labels, scores and the object
    class; one record with an empty mask, one without scores."""
    from PIL import Image

    tmp = tmp_path_factory.mktemp("torch_stage4")
    root = tmp / "imagenet"
    rng = np.random.RandomState(0)
    with pstore.ShardWriter(str(tmp / "stage4"), 0, 1) as w:
        for ci, code in enumerate(CODES):
            (root / code).mkdir(parents=True)
            for j in range(5):
                h, w_ = 48 + 16 * j, 64 + 8 * ci
                img = rng.randint(0, 255, (h, w_, 3), np.uint8)
                Image.fromarray(img).save(str(root / code / f"{code}_{j}.JPEG"))
                if j == 4:  # one image without a stage-4 record
                    continue
                masks = []
                for p in range(2 + j % 3):
                    m = np.zeros((h, w_), bool)
                    if not (ci == 1 and j == 1 and p == 0):
                        m[4 + 3 * p:h - 4, 5 * p:5 * p + 20] = True
                    masks.append(prle.encode(m))
                record = {"image_id": f"{code}_{j}", "part_masks": masks,
                          "part_labels": [(p + j) % 8 for p in range(len(masks))],
                          "object_class": 21999 if j == 3 else 7 * ci + j}
                if not (ci == 0 and j == 2):
                    record["part_scores"] = [0.9 - 0.25 * p for p in range(len(masks))]
                w.write(record)
    return {"root": str(root), "stage4": str(tmp / "stage4")}


@pytest.mark.parametrize("kw,n", [({}, 8), ({"single_class_code": CODES[1]}, 4),
                                  ({"total_partitions": 2, "partition_index": 0}, 4)],
                         ids=["all", "single_class", "partition"])
def test_load_imagenet_with_segmentation_equals_jax(stage4_set, kw, n):
    base = pimagenet.load_imagenet(stage4_set["root"], **kw)
    assert base == jimagenet.load_imagenet(stage4_set["root"], **kw)
    got = pimagenet.load_imagenet_with_segmentation(base, stage4_set["stage4"])
    want = jimagenet.load_imagenet_with_segmentation(base, stage4_set["stage4"])
    assert got == want and len(got) == n


def _equal_examples(a, b) -> int:
    assert (a is None) == (b is None)
    if a is None:
        return 0
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
    return 1


@pytest.mark.parametrize("seed,epoch,size", [(0, 0, 64), (3, 1, 48), (7, 2, 80)])
def test_part_distillation_train_mapper_equals_jax(stage4_set, seed, epoch, size):
    items = pimagenet.load_imagenet_with_segmentation(
        pimagenet.load_imagenet(stage4_set["root"]), stage4_set["stage4"])
    pm = pmappers.PartDistillationTrainMapper(image_size=size, capacity=3, seed=seed)
    jm = jmappers.PartDistillationTrainMapper(image_size=size, capacity=3, seed=seed)
    outs = [pm({**item, "_epoch": epoch}) for item in items]
    mapped = sum(_equal_examples(o, jm({**item, "_epoch": epoch}))
                 for o, item in zip(outs, items))
    assert mapped == len(items) == 8
    assert {int(o["gt_object_class"]) for o in outs} >= {21999, 0, 7}


@pytest.mark.parametrize("size", [56, 64])
def test_part_distillation_save_mapper_equals_jax(stage4_set, size):
    items = pimagenet.load_imagenet_with_segmentation(
        pimagenet.load_imagenet(stage4_set["root"]), stage4_set["stage4"])
    pm = pmappers.PartDistillationSaveMapper(image_size=size, capacity=4)
    jm = jmappers.PartDistillationSaveMapper(image_size=size, capacity=4)
    assert sum(_equal_examples(pm(item), jm(item)) for item in items) == len(items) == 8


# ---------------------------------------------------------------- mIoU


def _predictions(rng, b=6, k=5, t=4, size=24, n_pred=8, n_gt=6):
    """Random predicted and GT part masks with labels, validity and object
    classes (three classes, one image with no valid prediction)."""
    pm = rng.random((b, k, size, size)) < 0.3
    gm = rng.random((b, t, size, size)) < 0.35
    va = rng.random((b, k)) < 0.8
    va[2] = False
    return ({"pred_masks": pm, "pred_labels": rng.integers(0, n_pred, (b, k)).astype(np.int32),
             "valid": va},
            gm, rng.integers(0, n_gt, (b, t)).astype(np.int32), rng.random((b, t)) < 0.9,
            np.array([3, 0, 3, 21999, 0, 5], np.int32))


def test_miou_math_equals_jax():
    rng = np.random.default_rng(4)
    masks = rng.random((5, 9, 7)) < 0.4
    labels = rng.integers(0, 6, 5)
    got = pmiou.binary_masks_to_semseg(masks, labels, 6)
    np.testing.assert_array_equal(got, jmiou.binary_masks_to_semseg(masks, labels, 6))
    f32 = masks.astype(np.float32)
    np.testing.assert_array_equal(pmiou.binary_masks_to_semseg(f32, labels, 6), got)
    gt = rng.integers(0, 7, (9, 7))
    conf = pmiou.confusion_matrix(got, gt, 6)
    np.testing.assert_array_equal(conf, jmiou.confusion_matrix(got, gt, 6))
    np.testing.assert_array_equal(pmiou.majority_vote(conf, 4, 6),
                                  jmiou.majority_vote(conf, 4, 6))
    a, b = pmiou.miou_from_confusion(conf), jmiou.miou_from_confusion(conf)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    dicts = [{0: conf, 3: 2 * conf}, {3: conf, 9: conf}]
    got, want = pmiou.merge_confusion_dicts(dicts), jmiou.merge_confusion_dicts(dicts)
    assert got.keys() == want.keys() == {0, 3, 9}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("seed", [0, 1])
def test_miou_matcher_equals_jax(seed):
    outputs, gm, gl, gv, oc = _predictions(np.random.default_rng(seed))
    got, want = pmiou.MIoUMatcher(8, 6), jmiou.MIoUMatcher(8, 6)
    for m in (got, want):
        m.process(outputs, gm, gl, gv, oc)
    got, want = got.evaluate(), want.evaluate()
    assert got.keys() == want.keys() == {0, 3, 5, 21999}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == np.int32 and got[k].shape == (8,)


@pytest.mark.parametrize("seed", [0, 1])
def test_miou_evaluator_equals_jax(seed):
    outputs, gm, gl, gv, oc = _predictions(np.random.default_rng(seed), n_pred=6)
    got, want = pmiou.MIoUEvaluator(6), jmiou.MIoUEvaluator(6)
    for m in (got, want):
        m.process({k: v[:3] for k, v in outputs.items()}, gm[:3], gl[:3], gv[:3], oc[:3])
        m.process({k: v[3:] for k, v in outputs.items()}, gm[3:], gl[3:], gv[3:], oc[3:])
    got, want = got.evaluate(), want.evaluate()
    assert got.keys() == want.keys() and len(got) == 6
    for k in got:
        assert got[k] == want[k] and 0 <= got[k] <= 100, k


@pytest.mark.parametrize("make", [lambda: pmiou.MIoUMatcher(8, 40, distributed=True),
                                  lambda: pmiou.MIoUEvaluator(40, distributed=True)],
                         ids=["matcher", "evaluator"])
def test_miou_distributed_raises(make):
    with pytest.raises(RuntimeError, match="process group"):
        make().evaluate()
