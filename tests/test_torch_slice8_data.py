"""Slice 8's data layer on the CPU against the JAX package's.

- RLE: the port's numpy codec gives the JAX package's ``counts`` bytes (its
  numpy functions, and ``encode``, which takes the native codec where that
  library is built), the same decoded masks, areas, merges and IoUs;
- bitpack: the port's torch ``unpack_bits`` equals JAX's ``unpack_bits``
  (most significant bit first);
- the store: records written by JAX's ``ShardWriter`` read back equal in the
  port, and the port's writer gives the same shard and index bytes for the
  same records (and JAX reads them back);
- the stage-3 mappers give equal arrays for the same item, seed and epoch;
- the loader yields the same batches in the same order for a seed, and the
  item lists of ``load_imagenet`` / ``load_imagenet_with_proposals`` /
  ``load_part_imagenet`` are equal;
- ``load_config`` of every ``configs/**/*.yaml`` gives JAX's values.

All comparisons are exact.
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partdistillation_tpu import config as jconfig
from partdistillation_tpu.data import loader as jloader
from partdistillation_tpu.data import mappers as jmappers
from partdistillation_tpu.data import pseudo_store as jstore
from partdistillation_tpu.data.datasets import imagenet as jimagenet
from partdistillation_tpu.data.datasets import part_imagenet as jpart
from partdistillation_tpu.utils import bitpack as jbitpack
from partdistillation_tpu.utils import rle as jrle
from partdistillation_torch import config as pconfig
from partdistillation_torch.data import loader as ploader
from partdistillation_torch.data import mappers as pmappers
from partdistillation_torch.data import pseudo_store as pstore
from partdistillation_torch.data.datasets import imagenet as pimagenet
from partdistillation_torch.data.datasets import part_imagenet as ppart
from partdistillation_torch.utils import bitpack as pbitpack
from partdistillation_torch.utils import rle as prle

ROOT = Path(__file__).resolve().parent.parent


def _masks():
    """Random masks of several densities and shapes, and the edge cases:
    empty, full, a first pixel set, one column."""
    rng = np.random.default_rng(0)
    out = [rng.random((h, w)) < p for (h, w), p in
           [((17, 23), 0.5), ((64, 64), 0.1), ((40, 7), 0.9), ((1, 50), 0.5)]]
    blob = np.zeros((48, 33), bool)
    blob[5:40, 3:30] = True
    first = np.zeros((9, 9), bool)
    first[0, 0] = True
    return out + [blob, np.zeros((13, 11), bool), np.ones((6, 5), bool), first,
                  np.ones((31, 1), bool)]


@pytest.mark.parametrize("i", range(9))
def test_rle_bytes_decode_area_equal_jax(i):
    m = _masks()[i]
    got = prle.encode(m)
    assert got["counts"] == jrle._compress_counts(jrle._mask_to_runs(m))
    assert got == jrle.encode(m)  # the native codec where built, else numpy
    assert isinstance(got["counts"], bytes)
    np.testing.assert_array_equal(prle.decode(got), jrle.decode(got))
    np.testing.assert_array_equal(prle.decode(got), m.astype(np.uint8))
    assert prle.area(got) == jrle.area(got) == int(m.sum())
    as_str = dict(got, counts=got["counts"].decode("ascii"))
    np.testing.assert_array_equal(prle.decode(as_str), jrle.decode(as_str))


def test_rle_merge_and_iou_equal_jax():
    rng = np.random.default_rng(1)
    masks = [rng.random((21, 19)) < p for p in (0.2, 0.5, 0.7)]
    rles = [prle.encode(m) for m in masks]
    for intersect in (False, True):
        assert prle.merge(rles, intersect) == jrle.merge(rles, intersect)
    np.testing.assert_array_equal(prle.iou_matrix(rles[:2], rles), jrle.iou_matrix(rles[:2], rles))
    assert prle.encode_batch(np.stack(masks)) == jrle.encode_batch(np.stack(masks))


@pytest.mark.parametrize("w", [8, 13, 640, 1])
def test_unpack_bits_equals_jax(w):
    rng = np.random.default_rng(w)
    x = rng.random((2, 3, 5, w)) < 0.4
    packed = pbitpack.pack_bits_np(x)
    np.testing.assert_array_equal(packed, jbitpack.pack_bits_np(x))
    np.testing.assert_array_equal(packed, np.asarray(jbitpack.pack_bits(jnp.asarray(x))))
    got = pbitpack.unpack_bits(torch.from_numpy(packed), w)
    assert got.dtype == torch.bool and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbitpack.unpack_bits(
        jnp.asarray(packed), w)))
    np.testing.assert_array_equal(got.numpy(), x)
    np.testing.assert_array_equal(pbitpack.unpack_bits_np(packed, w), x)


def _records():
    masks = _masks()
    return [{"image_id": f"img{i}", "part_masks": [prle.encode(m) for m in masks[i:i + 3]],
             "object_ratio": 0.1 * i, "scores": np.arange(i, dtype=np.float32)}
            for i in range(5)]


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


def test_store_bytes_and_records_equal_jax(tmp_path):
    records = _records()
    for writer, d in ((jstore.ShardWriter, "jax"), (pstore.ShardWriter, "port")):
        with writer(str(tmp_path / d), 0, 2) as w:
            for r in records:
                assert w.write(r)
            assert not w.write(records[0])  # resume skip
    for name in ("shard-00000-of-00002.pdrec", "shard-00000-of-00002.pdrec.idx"):
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()
    for reader, d in ((pstore.PseudoLabelStore, "jax"), (jstore.PseudoLabelStore, "port")):
        store = reader(str(tmp_path / d))
        assert len(store) == 5 and sorted(store.ids()) == [r["image_id"] for r in records]
        for r in records:
            _same(store.get(r["image_id"]), r)
        for got, want in zip(store, records):
            _same(got, want)
    # a crash-truncated tail: the port's reader ignores it, its writer cuts it
    shard = tmp_path / "jax" / "shard-00000-of-00002.pdrec"
    (tmp_path / "jax" / "shard-00000-of-00002.pdrec.idx").unlink()
    with open(shard, "ab") as f:
        f.write(b"\x4b\x52\x44\x50\xff\x00\x00\x00partial")
    assert len(pstore.PseudoLabelStore(str(tmp_path / "jax"))) == 5
    with pstore.ShardWriter(str(tmp_path / "jax"), 0, 2) as w:
        assert len(w.written_ids) == 5
    assert shard.read_bytes() == (tmp_path / "port" / "shard-00000-of-00002.pdrec").read_bytes()


@pytest.fixture(scope="module")
def image_set(tmp_path_factory):
    """Two classes of JPEGs of several sizes, a stage-2b store over them and
    a PartImageNet json with polygon and RLE part annotations."""
    from PIL import Image

    tmp = tmp_path_factory.mktemp("torch_data")
    root = tmp / "imagenet"
    rng = np.random.RandomState(0)
    codes = ["n01440764", "n01443537"]
    images, anns = [], []
    with pstore.ShardWriter(str(tmp / "dcrf"), 0, 1) as w:
        for ci, code in enumerate(codes):
            (root / code).mkdir(parents=True)
            for j in range(5):
                h, w_ = 48 + 16 * j, 64 + 8 * ci
                img = rng.randint(0, 255, (h, w_, 3), np.uint8)
                Image.fromarray(img).save(str(root / code / f"{code}_{j}.JPEG"))
                masks = []
                for p in range(2 + j % 3):
                    m = np.zeros((h, w_), bool)
                    m[4 + 3 * p:h - 4, 5 * p:5 * p + 20] = True
                    masks.append(prle.encode(m))
                if j != 4:  # one image without proposals
                    w.write({"image_id": f"{code}_{j}", "part_masks": masks,
                             "object_ratio": 0.2 + 0.1 * j})
                iid = ci * 5 + j
                images.append({"id": iid, "file_name": f"{code}/{code}_{j}.JPEG",
                               "height": h, "width": w_})
                anns.append({"id": 2 * iid, "image_id": iid, "category_id": j % 3,
                             "segmentation": [[2.0, 3.0, 30.0, 3.0, 30.0, h - 5.0, 2.0, h - 5.0]]})
                seg = np.zeros((h, w_), bool)
                seg[10:20, 30:50] = True
                anns.append({"id": 2 * iid + 1, "image_id": iid, "category_id": 1 + j % 2,
                             "segmentation": {k: (v.decode() if isinstance(v, bytes) else v)
                                              for k, v in prle.encode(seg).items()}})
    (root / "labels.txt").write_text("n01440764 tench, Tinca tinca\nn01443537 goldfish\n")
    part_json = tmp / "part.json"
    part_json.write_text(json.dumps({"images": images, "annotations": anns,
                                     "categories": [{"id": c, "name": f"p{c}"} for c in range(3)]}))
    return {"root": str(root), "dcrf": str(tmp / "dcrf"), "json": str(part_json), "tmp": tmp}


@pytest.mark.parametrize("kw", [{}, {"total_partitions": 2, "partition_index": 1},
                                {"debug_limit": 3}, {"exclude_codes": ["n01440764"]},
                                {"manifest": "manifest.json"}],
                         ids=["all", "partition", "limit", "exclude", "manifest"])
def test_imagenet_item_lists_equal_jax(image_set, kw):
    if "manifest" in kw:
        kw = {"manifest": str(image_set["tmp"] / kw["manifest"])}
    want = jimagenet.load_imagenet(image_set["root"], **kw)
    got = pimagenet.load_imagenet(image_set["root"], **kw)
    assert got == want and len(got) > 0
    assert (pimagenet.load_imagenet_with_proposals(got, image_set["dcrf"])
            == jimagenet.load_imagenet_with_proposals(want, image_set["dcrf"]))
    assert (pimagenet.load_imagenet_with_proposals(got, image_set["dcrf"], 0.35)
            == jimagenet.load_imagenet_with_proposals(want, image_set["dcrf"], 0.35))
    assert pimagenet.global_code_to_id(image_set["root"]) == jimagenet.global_code_to_id(
        image_set["root"])


@pytest.mark.parametrize("kw", [{}, {"label_percentage": 50.0}, {"debug_limit": 4}])
def test_part_imagenet_items_equal_jax(image_set, kw):
    got = ppart.load_part_imagenet(image_set["json"], image_set["root"], **kw)
    assert got == jpart.load_part_imagenet(image_set["json"], image_set["root"], **kw)
    assert len(got) > 0


def _equal_examples(a, b) -> int:
    """Asserts two mapped examples equal; 1 if they are examples, 0 if None."""
    assert (a is None) == (b is None)
    if a is None:
        return 0
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    return 1


@pytest.mark.parametrize("seed,epoch,size", [(0, 0, 64), (3, 1, 48), (7, 2, 80)])
def test_proposal_train_mapper_equals_jax(image_set, seed, epoch, size):
    items = pimagenet.load_imagenet_with_proposals(
        pimagenet.load_imagenet(image_set["root"]), image_set["dcrf"])
    pm = pmappers.ProposalTrainMapper(image_size=size, capacity=3, seed=seed)
    jm = jmappers.ProposalTrainMapper(image_size=size, capacity=3, seed=seed)
    mapped = sum(_equal_examples(pm({**item, "_epoch": epoch}), jm({**item, "_epoch": epoch}))
                 for item in items)
    assert mapped == len(items) == 8


@pytest.mark.parametrize("merge", [True, False])
def test_part_eval_mapper_equals_jax(image_set, merge):
    items = ppart.load_part_imagenet(image_set["json"], image_set["root"])
    pm = pmappers.PartEvalMapper(image_size=56, capacity=4, merge_parts_by_class=merge)
    jm = jmappers.PartEvalMapper(image_size=56, capacity=4, merge_parts_by_class=merge)
    assert sum(_equal_examples(pm(item), jm(item)) for item in items) == len(items) == 10


def _index_mapper(item):
    i = int(item["i"])
    return None if i % 7 == 3 else {"i": np.int64(i), "epoch": np.int64(item["_epoch"]),
                                    "mask": np.full((2, 2, 2), i % 2 == 0)}


@pytest.mark.parametrize("kw", [dict(shuffle=True, seed=5, epochs=3, drop_last=True),
                                dict(shuffle=False, epochs=1), dict(shuffle=True, seed=1,
                                                                    epochs=2)])
def test_loader_batches_equal_jax(kw):
    items = [{"i": i} for i in range(23)]
    got = list(ploader.batch_iterator(items, _index_mapper, 4, num_workers=2, **kw))
    want = list(jloader.batch_iterator(items, _index_mapper, 4, num_workers=2, **kw))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        _equal_examples(a, b)
    loader = ploader.DataLoader(items, _index_mapper, 4, num_workers=2, **kw)
    for a, b in zip(loader, want):
        _equal_examples(a, b)
    endless = ploader.DataLoader(items, _index_mapper, 4, shuffle=True, epochs=None)
    next(iter(endless))
    endless.close()
    assert not endless._thread.is_alive()
    assert ploader.host_shard(items, 1, 3) == jloader.host_shard(items, 1, 3)
    assert ploader.host_shard(items) == items


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT))
                                        for p in (ROOT / "configs").rglob("*.yaml")))
def test_load_config_equals_jax(path):
    sets = ["data.batch_size=2", "max_iters=4", "paths.root=/x"]
    for overrides in ([], sets):
        got = pconfig.load_config(pconfig.PipelineConfig, str(ROOT / path), overrides)
        want = jconfig.load_config(jconfig.PipelineConfig, str(ROOT / path), overrides)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.paths.proposals_dcrf == want.paths.proposals_dcrf
    assert pconfig.load_yaml_tree(str(ROOT / path)) == jconfig.load_yaml_tree(str(ROOT / path))
    with pytest.raises(KeyError):
        pconfig.load_config(pconfig.PipelineConfig, str(ROOT / path), ["data.no_such_key=1"])
