"""The traffic generator repeats exactly from its seed and varies as its
parameters say."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import pytest

from portbench import data
from portbench.tests.tiny import load


def digest(root: str) -> str:
    h = hashlib.sha1()
    for d, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            if f.endswith(".idx"):
                continue
            h.update(f.encode())
            with open(os.path.join(d, f), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


@pytest.mark.parametrize("name", ["stage3_train", "supervised_train"])
def test_same_seed_same_files_other_seed_other_files(tmp_path, name):
    t = dict(load("traffic", name), images=6)
    roots = [str(tmp_path / k) for k in ("a", "b", "c")]
    for root, seed in zip(roots, (3_000_000_019, 3_000_000_019, 7)):
        data.write_dataset(root, t, seed, threads=2)
    assert digest(roots[0]) == digest(roots[1])
    assert digest(roots[0]) != digest(roots[2])


def test_plans_follow_the_parameters():
    t = load("traffic", "supervised_train")
    plans = data._image_plan(np.random.default_rng(11), t)
    assert len(plans) == t["images"]
    sides = [min(p["size"]) for p in plans]
    aspects = [max(p["size"]) / min(p["size"]) for p in plans]
    assert t["short_side"][0] <= min(sides) and max(sides) <= t["short_side"][1]
    assert max(aspects) <= t["aspect"][1] + 0.01
    assert len(set(sides)) > 20  # sizes vary from image to image
    objs = [len(p["objects"]) for p in plans]
    assert set(objs) == set(range(t["objects"][0], t["objects"][1] + 1))
    parts = [len(o["classes"]) for p in plans for o in p["objects"]]
    assert set(parts) == set(range(t["parts"][0], t["parts"][1] + 1))
    classes = np.concatenate([o["classes"] for p in plans for o in p["objects"]])
    assert classes.min() >= 0 and classes.max() < t["part_classes"]


def test_parts_tile_their_objects(tmp_path):
    t = dict(load("traffic", "stage3_train"), images=4)
    plans = data._image_plan(np.random.default_rng(5), t)
    for plan in plans:
        img, parts = data._render(plan)
        assert img.shape == plan["size"] + (3,) and img.dtype == np.uint8
        total = np.zeros(plan["size"], int)
        for m, _ in parts:
            total += m
        assert total.max() <= 1  # disjoint
        assert 1 <= len(parts) <= len(plan["objects"]) * t["parts"][1]


def test_polygons_rasterise_to_their_parts(tmp_path):
    from partdistillation_torch.data.datasets.part_imagenet import ann_to_mask

    t = dict(load("traffic", "supervised_train"), images=3)
    out = data.write_dataset(str(tmp_path), t, 21, threads=1)
    coco = json.load(open(out["part_json"]))
    plans = data._image_plan(np.random.default_rng(21), t)
    for img in coco["images"]:
        _, parts = data._render(plans[img["id"]])
        anns = [a for a in coco["annotations"] if a["image_id"] == img["id"]]
        assert len(anns) == len(parts)
        for ann, (m, cls) in zip(anns, parts):
            r = ann_to_mask(ann, img["height"], img["width"])
            assert ann["category_id"] == cls
            assert (m & ~r).sum() <= 0.02 * m.sum()  # the polygon covers its part
            if m.sum() >= 1000:  # and adds no more than its outline
                assert (r & m).sum() / (r | m).sum() > 0.8
