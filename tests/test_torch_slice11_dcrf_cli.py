"""The port's stage-2b CLI (``python -m partdistillation_torch.run dcrf``)
on the CPU, against the JAX package's.

A synthetic ImageNet split (two classes of three 64 x 64 JPEGs, a coloured
object each) and a stage-2 store of two or three jagged part masks an image
(one image holds only a 2 x 2 mask, which the dCRF removes). Then:

- the port's ``dcrf --device cpu`` store against the JAX CLI's on the same
  stage-2 store: the same ids, object classes and object ratios, and the
  same masks; a pixel may differ only where JAX's top-two probability
  margin there is < 1e-5 (the test prints each differing pixel's margin);
  the image whose refinement keeps no mask leaves no record in either;
- a rerun writes nothing (resume), and the stage-3 join and mapper read the
  store; every record's masks are disjoint and ``object_ratio`` is their
  union's mean;
- ``--watch`` with a late shard: the watcher (a subprocess) refines the
  first shard, the second shard lands while it runs, and it exits on its own
  once both shards are marked complete, having written every record.
"""

import json
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest

from partdistillation_torch import run as pcli
from partdistillation_torch.data.pseudo_store import (PseudoLabelStore, ShardWriter,
                                                      mark_shard_complete, store_complete)
from partdistillation_torch.utils import rle

CODES = ["n01440764", "n01443537"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _part_masks(rng, y0, x0, n):
    """n vertical strips of a 40 x 36 object at (y0, x0), their edges
    jagged by up to 3 pixels."""
    masks, edges = [], np.linspace(x0, x0 + 36, n + 1).astype(int)
    for p in range(n):
        m = np.zeros((64, 64), bool)
        for y in range(y0, y0 + 40):
            a = edges[p] + (rng.randint(-3, 4) if p else 0)
            b = edges[p + 1] + (rng.randint(-3, 4) if p < n - 1 else 0)
            m[y, a:b] = True
        masks.append(m)
    for p in range(1, n):  # disjoint: a later strip gives way to an earlier one
        masks[p] &= ~np.any(masks[:p], axis=0)
    return masks


def _write_images(root, rng):
    for ci, code in enumerate(CODES):
        d = root / code
        d.mkdir(parents=True, exist_ok=True)
        for j in range(3):
            img = rng.randint(0, 255, (64, 64, 3), np.uint8)
            y0, x0 = 10 + 2 * j, 12 + 3 * ci
            for p, tone in enumerate(([200, 60, 40], [60, 180, 60], [40, 60, 200])):
                xa, xb = x0 + 12 * p, x0 + 12 * (p + 1)
                img[y0:y0 + 40, xa:xb] = np.clip(
                    np.array(tone) + rng.randint(-25, 25, (40, xb - xa, 3)), 0, 255)
            from PIL import Image

            Image.fromarray(img).save(str(d / f"{code}_{j}.JPEG"))
    (root / "labels.txt").write_text("n01440764 tench\nn01443537 goldfish\n")


def _record(rng, code, ci, j):
    if (ci, j) == (1, 2):  # only a 2 x 2 mask: refined away
        m = np.zeros((64, 64), bool)
        m[30:32, 30:32] = True
        masks = [m]
    else:
        masks = _part_masks(rng, 10 + 2 * j, 12 + 3 * ci, 2 + (j % 2))
    return {"image_id": f"{code}_{j}", "part_masks": [rle.encode(m) for m in masks],
            "object_ratio": float(np.any(masks, axis=0).mean()), "object_class": ci}


@pytest.fixture(scope="module")
def dcrf_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_dcrf_cli")
    rng = np.random.RandomState(0)
    _write_images(tmp / "imagenet", rng)
    labels = tmp / "pseudo_labels"
    with ShardWriter(str(labels / "proposal_generation"), 0, 1) as w:
        for ci, code in enumerate(CODES):
            for j in range(3):
                w.write(_record(rng, code, ci, j))
    mark_shard_complete(str(labels / "proposal_generation"), 0, 1)
    ov = [f"data.imagenet_root={tmp / 'imagenet'}", "data.image_size=64", "data.batch_size=4",
          "data.mask_capacity=8", "data.num_workers=2", f"checkpoint_dir={tmp}/ckpt"]
    return {"tmp": tmp, "labels": labels, "ov": ov}


def _run(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return [json.loads(line) for line in out if line.startswith("{")]


def _records(path):
    return {r["image_id"]: r for r in PseudoLabelStore(str(path))}


def _labels_root(tmp_path, stage2):
    root = tmp_path / "labels"
    root.mkdir(parents=True)
    (root / "proposal_generation").symlink_to(stage2)
    return root


def _jax_margins(env, image_id):
    """JAX's dCRF Q of one image, as the CLI computes it: its top-two
    probability margin at every pixel."""
    from partdistillation_torch.data.mappers import PartRankingMapper
    from partdistillation_tpu.ops.dense_crf import DenseCRFParams, dense_crf, unary_from_masks

    code = image_id.split("_")[0]
    item = {"image_id": image_id, "file_name": str(env["tmp"] / "imagenet" / code
                                                   / f"{image_id}.JPEG"),
            "proposal_store": str(env["labels"] / "proposal_generation")}
    ex = PartRankingMapper(image_size=64, capacity=8)(item)
    image = jnp.asarray(np.clip(ex["image"], 0, 255).astype(np.uint8).astype(np.float32))
    unary = unary_from_masks(jnp.asarray(ex["part_masks"]), jnp.asarray(ex["part_valid"]), 0.7)
    q = np.sort(np.asarray(dense_crf(image, unary, DenseCRFParams())), -1)
    return q[..., -1] - q[..., -2]


def test_dcrf_store_equals_jax_cli(dcrf_env, capsys, tmp_path):
    from partdistillation_tpu import run as jcli

    import jax

    stores = {}
    saved = jax.config.jax_compilation_cache_dir
    try:
        for name, main, dev in (("jax", jcli.main, []), ("port", pcli.main, ["--device", "cpu"])):
            root = _labels_root(tmp_path / name, dcrf_env["labels"] / "proposal_generation")
            res = _run(main, ["dcrf", *dev, "--set", *dcrf_env["ov"], f"paths.root={root}"],
                       capsys)[-1]
            assert res["stage"] == "dcrf" and res["saved"] == 5, res
            stores[name] = _records(root / "proposals_dcrf")
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)
    assert stores["port"].keys() == stores["jax"].keys()
    assert f"{CODES[1]}_2" not in stores["port"]  # refined to nothing: no record
    for image_id, got in stores["port"].items():
        want = stores["jax"][image_id]
        assert got.keys() == want.keys()
        assert got["object_class"] == want["object_class"]
        assert len(got["part_masks"]) == len(want["part_masks"])
        differ = np.zeros((64, 64), bool)
        for a, b in zip(got["part_masks"], want["part_masks"]):
            differ |= rle.decode(a).astype(bool) != rle.decode(b).astype(bool)
        if differ.any():
            margins = _jax_margins(dcrf_env, image_id)[differ]
            print(image_id, "differing pixels' JAX top-two margins:", margins.tolist())
            assert (margins < 1e-5).all(), (image_id, margins)
        else:
            assert got["object_ratio"] == want["object_ratio"]


def test_dcrf_store_resumes_and_feeds_stage3(dcrf_env, capsys, tmp_path):
    from partdistillation_torch.data.datasets.imagenet import (load_imagenet,
                                                               load_imagenet_with_proposals)
    from partdistillation_torch.data.mappers import ProposalTrainMapper

    root = _labels_root(tmp_path, dcrf_env["labels"] / "proposal_generation")
    argv = ["dcrf", "--device", "cpu", "--set", *dcrf_env["ov"], f"paths.root={root}"]
    assert _run(pcli.main, argv + ["data.debug_limit=2"], capsys)[-1]["saved"] == 2
    assert _run(pcli.main, argv, capsys)[-1]["saved"] == 3
    assert _run(pcli.main, argv, capsys)[-1]["saved"] == 0
    records = _records(root / "proposals_dcrf")
    assert len(records) == 5
    for r in records.values():
        masks = np.stack([rle.decode(m).astype(bool) for m in r["part_masks"]])
        assert masks.shape[1:] == (64, 64) and masks.any((1, 2)).all()
        assert masks.sum(0).max() == 1
        assert r["object_ratio"] == pytest.approx(masks.any(0).mean(), abs=1e-12)
    items = load_imagenet_with_proposals(load_imagenet(str(dcrf_env["tmp"] / "imagenet")),
                                         str(root / "proposals_dcrf"))
    assert len(items) == 5
    ex = ProposalTrainMapper(image_size=64, capacity=8)(items[0])
    assert ex is not None and ex["valid"].sum() >= 1


def test_dcrf_watch_picks_up_a_late_shard(dcrf_env, tmp_path):
    store = dcrf_env["labels"] / "proposal_generation"
    prop = tmp_path / "labels" / "proposal_generation"
    records = list(PseudoLabelStore(str(store)))
    first = [r for r in records if r["image_id"].startswith(CODES[0])]
    late = [r for r in records if r["image_id"].startswith(CODES[1])]
    with ShardWriter(str(prop), 0, 2) as w:
        for r in first:
            w.write(r)
    mark_shard_complete(str(prop), 0, 2)
    assert not store_complete(str(prop))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    watcher = subprocess.Popen(
        [sys.executable, "-m", "partdistillation_torch.run", "dcrf", "--device", "cpu",
         "--watch", "--watch-interval", "0.5", "--iters", "2", "--set", *dcrf_env["ov"],
         f"paths.root={tmp_path / 'labels'}"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out_dir = str(tmp_path / "labels" / "proposals_dcrf")
    try:
        deadline = time.time() + 120
        while time.time() < deadline and watcher.poll() is None:
            if os.path.isdir(out_dir) and any(
                    i.startswith(CODES[0]) for i in PseudoLabelStore(out_dir).ids()):
                break
            time.sleep(0.5)
        assert watcher.poll() is None, "the watcher exited early: " + watcher.stderr.read()[-2000:]
        assert any(i.startswith(CODES[0]) for i in PseudoLabelStore(out_dir).ids())
        with ShardWriter(str(prop), 1, 2) as w:  # the late shard
            for r in late:
                w.write(r)
        mark_shard_complete(str(prop), 1, 2)
        out, err = watcher.communicate(timeout=120)
    finally:
        if watcher.poll() is None:
            watcher.kill()
            watcher.communicate()
    assert watcher.returncode == 0, err[-2000:]
    result = json.loads(out.strip().splitlines()[-1])
    assert result["stage"] == "dcrf"
    written = set(PseudoLabelStore(out_dir).ids())
    assert result["saved"] == len(written) >= 4
    assert {r["image_id"] for r in first} <= written
    assert {r["image_id"] for r in late} - written <= {f"{CODES[1]}_2"}
