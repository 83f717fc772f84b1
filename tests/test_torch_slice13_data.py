"""The Pascal-Parts and Cityscapes-Part sets on the CPU against the JAX
package: the loaders, the part-name canonicalisation, the panoptic-parts
decoding, ``PartEvalMapper`` on both sets (merged and per instance), the
eval catalog's items and metadata, and ``SupervisedMIoUEvaluator``.

The files are those ``tests/test_eval_datasets.py`` builds (VOC ``.mat``
structs through ``scipy.io.savemat``, 32-bit uid images), plus one Pascal
image holding two objects, which loads as an array where one object
squeezes to a struct. Masks, labels, vocabularies and class ids are equal
bit for bit; the evaluator's metrics equal.
"""

import argparse

import numpy as np
import pytest

from partdistillation_tpu import run as jcli
from partdistillation_tpu.data import mappers as jmap
from partdistillation_tpu.data.datasets import cityscapes_part as jcs
from partdistillation_tpu.data.datasets import pascal_parts as jpp
from partdistillation_tpu.evaluation import miou as jmiou
from partdistillation_torch import run as pcli
from partdistillation_torch.data import mappers as pmap
from partdistillation_torch.data.datasets import cityscapes_part as pcs
from partdistillation_torch.data.datasets import pascal_parts as ppp
from partdistillation_torch.evaluation import miou as pmiou


def _mask(y0, y1, x0, x1, size=64):
    m = np.zeros((size, size), np.uint8)
    m[y0:y1, x0:x1] = 1
    return m


@pytest.fixture(scope="module")
def pascal_dir(tmp_path_factory):
    import scipy.io as sio
    from PIL import Image

    tmp = tmp_path_factory.mktemp("pascal")
    ann, imgs = tmp / "Annotations_Part", tmp / "JPEGImages"
    ann.mkdir()
    imgs.mkdir()
    rng = np.random.RandomState(0)
    for i, cls in enumerate(["dog", "dog", "cat", "cat"]):
        image_id = f"2008_{i:06d}"
        img = rng.randint(0, 255, (64, 64, 3), np.uint8)
        img[8:56, 8:56] = [200, 120, 60]
        Image.fromarray(img).save(str(imgs / f"{image_id}.jpg"))
        obj = {"class": cls, "mask": _mask(8, 56, 8, 56),
               "parts": [{"part_name": "head", "mask": _mask(8, 28, 8, 56)},
                         {"part_name": "lfleg", "mask": _mask(28, 56, 8, 30)},
                         {"part_name": "rbleg", "mask": _mask(28, 56, 34, 56)}]}
        sio.savemat(str(ann / f"{image_id}.mat"), {"anno": {"objects": [obj]}})
    # two objects of two classes: an array of structs after squeeze_me
    img = rng.randint(0, 255, (64, 64, 3), np.uint8)
    Image.fromarray(img).save(str(imgs / "2008_000004.jpg"))
    objs = [{"class": "dog", "mask": _mask(4, 30, 4, 60),
             "parts": [{"part_name": "head_1", "mask": _mask(4, 14, 4, 30)},
                       {"part_name": "torso", "mask": _mask(14, 30, 4, 60)}]},
            {"class": "cat", "mask": _mask(34, 60, 4, 60),
             "parts": [{"part_name": "reye", "mask": _mask(34, 40, 4, 10)},
                       {"part_name": "leye", "mask": _mask(34, 40, 20, 26)},
                       {"part_name": "head", "mask": _mask(40, 60, 4, 60)}]}]
    sio.savemat(str(ann / "2008_000004.mat"), {"anno": {"objects": objs}})
    return tmp


@pytest.fixture(scope="module")
def cityscapes_dir(tmp_path_factory):
    from PIL import Image

    tmp = tmp_path_factory.mktemp("cityscapes")
    labels = tmp / "gtFinePanopticParts" / "val" / "town"
    images = tmp / "leftImg8bit" / "val" / "town"
    labels.mkdir(parents=True)
    images.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(2):
        stem = f"town_{i:06d}_000019"
        Image.fromarray(rng.randint(0, 255, (64, 64, 3), np.uint8)).save(
            str(images / f"{stem}_leftImg8bit.png"))
        uids = np.full((64, 64), 7, np.int32)  # background sid
        uids[8:32, 8:32] = (24 * 1000 + 0) * 100 + 1  # person 0, parts 1 and 2
        uids[8:32, 32:56] = (24 * 1000 + 0) * 100 + 2
        uids[40:60, 8:56] = (26 * 1000 + 0) * 100 + 1  # car 0, part 1
        uids[40:44, 56:60] = 26 * 1000 + 1  # car 1, no parts
        uids[0:4, 0:4] = 27  # truck, no instance
        if i == 1:
            uids[34:38, 0:8] = (28 * 1000 + 2) * 100 + 5  # bus 2, part 5
        Image.fromarray(uids, mode="I").save(str(labels / f"{stem}_gtFinePanopticParts.tif"))
    return tmp


def _same_items(got, want):
    """Equal item lists, numpy arrays compared bit for bit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)


def _same(g, w):
    if isinstance(w, dict):
        assert g.keys() == w.keys()
        for k in w:
            _same(g[k], w[k])
    elif isinstance(w, list):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            _same(a, b)
    elif isinstance(w, np.ndarray):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    else:
        assert g == w


def test_canonical_part_names_equal_jax():
    names = ["lfleg", "rbleg", "leg_1", "reye", "leye", "fliplate", "frontside", "wheel_2",
             "head", "lbho", "rfpa", "backside", "upperarm", "lear", "bliplate", "leg", "l"]
    assert [ppp.canonical_part_name(n) for n in names] == \
        [jpp.canonical_part_name(n) for n in names]


def test_pascal_loader_and_vocab_equal_jax(pascal_dir):
    args = (str(pascal_dir / "Annotations_Part"), str(pascal_dir / "JPEGImages"))
    got, want = ppp.load_pascal_parts(*args), jpp.load_pascal_parts(*args)
    _same_items(got, want)
    assert len(got) == 5 and len(got[-1]["objects"]) == 2
    assert pmap.PartEvalMapper.pascal_vocab(got) == jmap.PartEvalMapper.pascal_vocab(want)
    assert vars(ppp.pascal_parts_metadata(got)) == vars(jpp.pascal_parts_metadata(want))
    _same_items(ppp.load_pascal_parts(*args, object_classes=["cat"], min_part_area=130,
                                      debug_limit=3),
                jpp.load_pascal_parts(*args, object_classes=["cat"], min_part_area=130,
                                      debug_limit=3))


def test_panoptic_parts_decode_and_loader_equal_jax(cityscapes_dir):
    from PIL import Image

    args = (str(cityscapes_dir / "gtFinePanopticParts"), str(cityscapes_dir / "leftImg8bit"))
    got, want = pcs.load_cityscapes_part(*args), jcs.load_cityscapes_part(*args)
    _same_items(got, want)
    assert len(got) == 2
    uids = np.asarray(Image.open(got[1]["part_png"]))
    _same(pcs.decode_panoptic_parts(uids), jcs.decode_panoptic_parts(uids))
    assert (pcs.CITYSCAPES_PART_SIDS, pcs.CITYSCAPES_PART_BASE, pcs.CITYSCAPES_NUM_PART_CLASSES) \
        == (jcs.CITYSCAPES_PART_SIDS, jcs.CITYSCAPES_PART_BASE, jcs.CITYSCAPES_NUM_PART_CLASSES)
    assert pcs.load_cityscapes_part(*args, split="test") == []


def _config_and_args(pkg, name, pascal_dir, cityscapes_dir):
    cfg = pkg.load_config(pkg.PipelineConfig, None, [
        f"data.pascal_parts_annotations={pascal_dir / 'Annotations_Part'}",
        f"data.pascal_parts_images={pascal_dir / 'JPEGImages'}",
        f"data.cityscapes_part_labels={cityscapes_dir / 'gtFinePanopticParts'}",
        f"data.cityscapes_images={cityscapes_dir / 'leftImg8bit'}"])
    return cfg, argparse.Namespace(eval_dataset=name, num_gt_parts=40)


@pytest.mark.parametrize("name", ["pascal", "cityscapes"])
@pytest.mark.parametrize("merge", [True, False])
def test_catalog_items_and_mapper_equal_jax(name, merge, pascal_dir, cityscapes_dir):
    from partdistillation_torch import config as pconfig
    from partdistillation_tpu import config as jconfig

    ds = pcli._load_eval_items(*_config_and_args(pconfig, name, pascal_dir, cityscapes_dir))
    jds = jcli._load_eval_items(*_config_and_args(jconfig, name, pascal_dir, cityscapes_dir))
    assert ds.keys() == jds.keys()
    _same({k: v for k, v in ds.items() if k != "items"},
          {k: v for k, v in jds.items() if k != "items"})
    _same_items(ds["items"], jds["items"])
    assert len(ds["items"]) == {"pascal": 6, "cityscapes": 10}[name]
    assert ds["n_gt_parts"] == {"pascal": 6, "cityscapes": 23}[name]
    assert pcli._assign_eval_class_ids(None, ds, 8) is ds["items"]
    with pytest.raises(SystemExit, match="object classes"):
        pcli._assign_eval_class_ids(None, ds, 1)
    mapper = pmap.PartEvalMapper(image_size=48, capacity=6, merge_parts_by_class=merge,
                                 **ds["mapper_kwargs"])
    jmapper = jmap.PartEvalMapper(image_size=48, capacity=6, merge_parts_by_class=merge,
                                  **jds["mapper_kwargs"])
    kept = 0
    for item, jitem in zip(ds["items"], jds["items"]):
        got, want = mapper(item), jmapper(jitem)
        assert (got is None) == (want is None)
        if got is not None:
            kept += 1
            _same(got, want)
    assert kept == {"pascal": 6, "cityscapes": 5}[name]  # a class absent from an image: None


def test_pascal_mapper_needs_a_global_vocabulary(pascal_dir):
    items = ppp.load_pascal_parts(str(pascal_dir / "Annotations_Part"),
                                  str(pascal_dir / "JPEGImages"))
    with pytest.raises(ValueError, match="pascal_vocab"):
        pmap.PartEvalMapper(image_size=32)(items[0])


def test_cityscapes_mapper_keeps_32_bit_ids(cityscapes_dir):
    """The uids exceed 16 bits: read through PIL directly, the part ids take
    the class offsets (person 0-3, car 8-12, bus 18-22)."""
    raw = pcs.load_cityscapes_part(str(cityscapes_dir / "gtFinePanopticParts"),
                                   str(cityscapes_dir / "leftImg8bit"))
    mapper = pmap.PartEvalMapper(image_size=64, capacity=8)
    labels = {sid: mapper(dict(raw[1], sid=sid, class_id=0)) for sid in (24, 26, 28)}
    assert sorted(labels[24]["gt_part_labels"][labels[24]["gt_valid"]].tolist()) == [0, 1]
    assert labels[26]["gt_part_labels"][labels[26]["gt_valid"]].tolist() == [8]
    assert labels[28]["gt_part_labels"][labels[28]["gt_valid"]].tolist() == [22]
    whole = mapper(dict(raw[1], class_id=0))
    assert sorted(whole["gt_part_labels"][whole["gt_valid"]].tolist()) == [0, 1, 8, 22]


def test_supervised_miou_evaluator_equals_jax():
    rng = np.random.default_rng(3)
    n_cls, k, t = 6, 5, 4
    port, jax_ = pmiou.SupervisedMIoUEvaluator(n_cls), jmiou.SupervisedMIoUEvaluator(n_cls)
    for _ in range(3):
        out = {"pred_masks": rng.random((2, k, 16, 16)) > 0.6,
               "pred_labels": rng.integers(0, n_cls, (2, k)).astype(np.int32),
               "valid": rng.random((2, k)) > 0.2}
        gt = rng.random((2, t, 16, 16)) > 0.5
        labels = rng.integers(0, n_cls, (2, t)).astype(np.int32)
        valid = rng.random((2, t)) > 0.2
        obj = rng.integers(0, 4, 2).astype(np.int32)
        for ev in (port, jax_):
            ev.process(out, gt, labels, valid, obj)
    got, want = port.evaluate(), jax_.evaluate()
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-9, nan_ok=True), key
    assert list(port._acc.conf) == [0]  # one global confusion matrix
