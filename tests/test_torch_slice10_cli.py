"""The port's k-means stages' CLIs (``python -m partdistillation_torch.run
rank / propose / eval-pixel-grouping``) on the CPU, with ``--tiny --device
cpu``, against the JAX package's CLIs.

A synthetic ImageNet split (two classes of four 64 x 64 JPEGs, a textured
object each), a stage-1 store (one object mask an image), a stage-2b store
(three part masks an image) and a PartImageNet-style GT json. Then:

- ``rank`` cluster,save then match,eval: the bank (num_object_classes, 8, D)
  in ``rank_centroids.npz``, the stage-4 store (labels in [0, 8), scores in
  [0, 1], each image's class), which the port's stage-5 join and mapper
  read, the mapping (num_object_classes, 8) in ``rank_mapping.npz``, the six
  metrics;
- on weights written from a JAX initialisation (``--torch-params``) and the
  JAX CLI's own ``rank_centroids.npz``, the port's save phase writes the
  JAX CLI's store (masks, labels and classes equal, scores within 1e-5), and
  its match and eval phases give the JAX CLI's mapping and metrics (within
  1e-6);
- a padded last batch with ``--save-topk 1``: the JAX CLI counts the
  overflow of its padded slots, the port counts the real images' only;
- ``propose`` then ``eval-pixel-grouping``; with both packages seeded alike
  (the first k valid rows, patched into each), the port's stage-2 store
  equals the JAX CLI's (masks equal, object ratios within 1e-7)
  and so do the AR@k; a rerun of ``propose`` skips the images written;
- ``--eval-dataset pascal`` and ``--tiny`` on cuda raise SystemExit before
  any device is touched.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice10_models import first_valid_rows_jax, first_valid_rows_port

from partdistillation_torch import run as pcli
from partdistillation_torch.data.pseudo_store import PseudoLabelStore, ShardWriter
from partdistillation_torch.utils import rle

CODES = ["n01440764", "n01443537"]
NUM_OBJ, K = 6, 8
METRICS = ("C-mIoU", "A-mIoU", "C-mACC", "A-mACC", "C-mIoPred", "A-mIoPred")
AR = ("AR@1", "AR@10", "AR@50", "AR@100")


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    from PIL import Image

    tmp = tmp_path_factory.mktemp("torch_k_means_cli")
    root = tmp / "imagenet"
    rng = np.random.RandomState(0)
    labels = tmp / "pseudo_labels"
    with ShardWriter(str(labels / "object_labels"), 0, 1) as objects, \
            ShardWriter(str(labels / "proposals_dcrf"), 0, 1) as dcrf:
        for ci, code in enumerate(CODES):
            d = root / code
            d.mkdir(parents=True)
            for j in range(4):
                img = rng.randint(0, 255, (64, 64, 3), np.uint8)
                y0, x0 = 8 + 2 * j, 10 + 3 * ci
                tone = np.array([60 + 80 * ci, 160, 220 - 60 * ci])
                img[y0:y0 + 44, x0:x0 + 40] = np.clip(
                    tone + rng.randint(-40, 40, (44, 40, 3)), 0, 255)
                Image.fromarray(img).save(str(d / f"{code}_{j}.JPEG"))
                obj = np.zeros((64, 64), bool)
                obj[y0:y0 + 44, x0:x0 + 40] = True
                parts = []
                for p in range(3):
                    m = np.zeros((64, 64), bool)
                    m[y0:y0 + 44, x0 + 13 * p:x0 + 13 * (p + 1) + (p == 2)] = True
                    parts.append(rle.encode(m))
                image_id = f"{code}_{j}"
                objects.write({"image_id": image_id, "object_masks": [rle.encode(obj)],
                               "object_scores": [0.9]})
                dcrf.write({"image_id": image_id, "part_masks": parts, "object_ratio": 0.4})
    (root / "labels.txt").write_text("n01440764 tench\nn01443537 goldfish\n")

    images, annotations, aid = [], [], 0
    for ci, code in enumerate(CODES):
        for j in range(4):
            iid = ci * 4 + j
            images.append({"id": iid, "file_name": f"{code}/{code}_{j}.JPEG",
                           "height": 64, "width": 64})
            y0, x0 = 8 + 2 * j, 10 + 3 * ci
            for p in range(2):
                xa, xb = float(x0 + 20 * p), float(x0 + 20 * (p + 1))
                annotations.append({
                    "id": aid, "image_id": iid, "category_id": (ci + p) % 3,
                    "segmentation": [[xa, float(y0), xb, float(y0), xb, float(y0 + 44),
                                      xa, float(y0 + 44)]]})
                aid += 1
    part_json = tmp / "part_imagenet.json"
    part_json.write_text(json.dumps({
        "images": images, "annotations": annotations,
        "categories": [{"id": c, "name": f"part{c}"} for c in range(3)]}))
    overrides = [
        f"data.imagenet_root={root}", f"data.part_imagenet_json={part_json}",
        f"data.part_imagenet_images={root}", "data.image_size=64", "data.batch_size=4",
        "data.mask_capacity=8", "data.num_workers=2", f"paths.root={labels}",
        f"checkpoint_dir={tmp}/ckpt"]
    return {"tmp": tmp, "overrides": overrides}


def _run(main, argv, capsys):
    """Run a CLI's ``main``; return the JSON lines it printed."""
    capsys.readouterr()
    main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return [json.loads(line) for line in out if line.startswith("{")]


def _cpu(cmd, *rest):
    return [cmd, "--tiny", "--device", "cpu", "--allow-random-init", *rest]


def _check_metrics(res):
    assert set(METRICS) <= set(res)
    for k in METRICS:
        assert np.isnan(res[k]) or 0.0 <= res[k] <= 100.0, (k, res[k])


def _imagenet(argv):
    """The ImageNet items a CLI run with ``argv`` reads."""
    args = pcli.build_parser().parse_args(argv)
    return pcli._imagenet_items(pcli._setup(args), args)


def _records(path):
    return {r["image_id"]: r for r in PseudoLabelStore(str(path))}


def test_rank_round_trip_cluster_save_match_eval(cli_env, capsys, tmp_path):
    from partdistillation_torch.data.datasets.imagenet import load_imagenet_with_segmentation
    from partdistillation_torch.data.mappers import PartDistillationTrainMapper

    ov = [o for o in cli_env["overrides"] if not o.startswith(("paths.root", "checkpoint_dir"))]
    root = tmp_path / "labels"
    root.mkdir()
    (root / "proposals_dcrf").symlink_to(cli_env["tmp"] / "pseudo_labels" / "proposals_dcrf")
    ov += [f"paths.root={root}", f"checkpoint_dir={tmp_path / 'ckpt'}"]
    num_obj = ["--num-object-classes", str(NUM_OBJ)]
    res = _run(pcli.main, _cpu("rank", *num_obj, "--set", *ov), capsys)[-1]
    assert res["stage"] == "rank" and res["phases"] == ["cluster", "save"]
    assert res["cluster"]["kmeans_classes"] == 2 and res["save"]["saved"] == 8
    bank = np.load(tmp_path / "ckpt" / "rank_centroids.npz")["centroids"]
    assert bank.shape == (NUM_OBJ, K, 32) and bank.dtype == np.float32
    assert np.isfinite(bank).all()
    # classes 0 and 1 clustered: unit-norm features give centroids inside the ball
    assert (np.linalg.norm(bank[:2], axis=-1) <= 1.0 + 1e-5).all()
    np.testing.assert_array_equal(
        bank[2:], np.random.RandomState(0).randn(NUM_OBJ - 2, K, 32).astype(np.float32))

    store = root / "part_masks_with_class"
    records = _records(store)
    assert len(records) == 8
    for image_id, r in records.items():
        masks = [rle.decode(m) for m in r["part_masks"]]
        assert masks and all(m.shape == (64, 64) for m in masks)
        assert sum(m.astype(int) for m in masks).max() <= 1  # disjoint
        assert all(0 <= x < K for x in r["part_labels"])
        assert all(0.0 <= x <= 1.0 for x in r["part_scores"])
        assert r["object_class"] == CODES.index(image_id.split("_")[0])
    items = load_imagenet_with_segmentation(_imagenet(_cpu("rank", "--set", *ov)), str(store))
    assert len(items) == 8
    ex = PartDistillationTrainMapper(image_size=64, capacity=8)(items[0])
    assert ex["valid"].any() and 0 <= ex["gt_object_class"] < NUM_OBJ

    res = _run(pcli.main, _cpu("rank", *num_obj, "--phases", "match,eval", "--set", *ov),
               capsys)
    assert [r["stage"] for r in res] == ["rank-eval", "rank"]
    _check_metrics(res[-1]["eval"])
    mapping = np.load(tmp_path / "ckpt" / "rank_mapping.npz")["mapping"]
    assert mapping.shape == (NUM_OBJ, K) and mapping.dtype == np.int32
    assert ((0 <= mapping) & (mapping < 40)).all()


@pytest.fixture
def jax_cache_dir_kept():
    """The JAX CLI's setup points JAX's compilation cache at the repository;
    put the tests' cache back afterwards."""
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


@pytest.fixture(scope="module")
def jax_rank_weights(tmp_path_factory):
    """The JAX CLI's stage-4 model initialisation at seed 0 as a port
    state_dict."""
    from partdistillation_tpu import run as jcli
    from partdistillation_tpu.models.meta_arch.proposal import normalize_images
    from partdistillation_tpu.models.segmenter import MaskFormerSegmenter as JSeg
    from partdistillation_torch.utils.convert_weights import state_dict_from_flax

    seg = jcli._segmenter_cfg(True, num_classes=1, num_queries=200)
    params = jax.jit(JSeg(seg).init)(jax.random.PRNGKey(0),
                                     normalize_images(jnp.zeros((1, 64, 64, 3))))
    path = tmp_path_factory.mktemp("jax_rank_weights") / "weights.pth"
    torch.save(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)), path)
    return str(path)


@pytest.fixture(scope="module")
def jax_rank_run(cli_env, jax_rank_weights, tmp_path_factory):
    """The JAX CLI's ``rank`` (cluster,save, then match,eval) on those
    weights: its bank, store, mapping and metrics."""
    from partdistillation_tpu import run as jcli

    saved = jax.config.jax_compilation_cache_dir
    tmp = tmp_path_factory.mktemp("jax_rank")
    root = tmp / "labels"
    root.mkdir()
    (root / "proposals_dcrf").symlink_to(cli_env["tmp"] / "pseudo_labels" / "proposals_dcrf")
    ov = [o for o in cli_env["overrides"] if not o.startswith(("paths.root", "checkpoint_dir"))]
    ov += [f"paths.root={root}", f"checkpoint_dir={tmp / 'ckpt'}"]
    argv = ["--tiny", "--num-object-classes", str(NUM_OBJ), "--torch-params", jax_rank_weights]
    import contextlib
    import io

    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            jcli.main(["rank", *argv, "--set", *ov])
            jcli.main(["rank", *argv, "--phases", "match,eval", "--set", *ov])
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    return {"ov": ov, "argv": argv, "ckpt": tmp / "ckpt", "store": root / "part_masks_with_class",
            "metrics": [x for x in lines if x["stage"] == "rank-eval"][-1]}


def _port_on_jax_bank(jax_rank_run, tmp_path):
    """A port checkpoint dir holding the JAX CLI's bank, and overrides for it."""
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir(parents=True)
    (ckpt / "rank_centroids.npz").symlink_to(jax_rank_run["ckpt"] / "rank_centroids.npz")
    root = tmp_path / "labels"
    root.mkdir()
    (root / "proposals_dcrf").symlink_to(jax_rank_run["store"].parent / "proposals_dcrf")
    ov = [o for o in jax_rank_run["ov"] if not o.startswith(("paths.root", "checkpoint_dir"))]
    return ov + [f"paths.root={root}", f"checkpoint_dir={ckpt}"], root


def test_rank_save_on_jax_bank_equals_jax_cli(jax_rank_run, capsys, tmp_path):
    ov, root = _port_on_jax_bank(jax_rank_run, tmp_path)
    res = _run(pcli.main, ["rank", "--tiny", "--device", "cpu", *jax_rank_run["argv"],
                           "--phases", "save", "--set", *ov], capsys)[-1]
    assert res["save"]["saved"] == 8
    want, got = _records(jax_rank_run["store"]), _records(root / "part_masks_with_class")
    assert got.keys() == want.keys() and len(got) == 8
    for k, g in got.items():
        w = want[k]
        assert g.keys() == w.keys()
        assert g["part_labels"] == w["part_labels"] and g["object_class"] == w["object_class"]
        np.testing.assert_allclose(g["part_scores"], w["part_scores"], rtol=0, atol=1e-5)
        assert len(g["part_masks"]) == len(w["part_masks"])
        for a, b in zip(g["part_masks"], w["part_masks"]):
            np.testing.assert_array_equal(rle.decode(a), rle.decode(b), err_msg=k)


def test_rank_match_eval_on_jax_bank_equals_jax_cli(jax_rank_run, capsys, tmp_path):
    ov, _ = _port_on_jax_bank(jax_rank_run, tmp_path)
    res = _run(pcli.main, ["rank", "--tiny", "--device", "cpu", *jax_rank_run["argv"],
                           "--phases", "match,eval", "--set", *ov], capsys)
    np.testing.assert_array_equal(
        np.load(tmp_path / "ckpt" / "rank_mapping.npz")["mapping"],
        np.load(jax_rank_run["ckpt"] / "rank_mapping.npz")["mapping"])
    got, want = res[0], jax_rank_run["metrics"]
    assert got["stage"] == "rank-eval"
    _check_metrics(got)
    for k in METRICS:
        assert (np.isnan(got[k]) and np.isnan(want[k])) or abs(got[k] - want[k]) <= 1e-6, (
            k, got[k], want[k])


def test_save_overflow_counts_real_images_only(jax_rank_run, capsys, tmp_path,
                                               jax_cache_dir_kept):
    """Batch 3 over 8 images: the last batch holds one padded slot (a copy
    of the last image). With one part saved an image the JAX CLI counts the
    padded slot's overflow too."""
    from partdistillation_tpu import run as jcli

    counts = {}
    for name, main, dev in (("jax", jcli.main, []), ("port", pcli.main, ["--device", "cpu"])):
        ov, _ = _port_on_jax_bank(jax_rank_run, tmp_path / name)
        res = _run(main, ["rank", "--tiny", *dev, *jax_rank_run["argv"], "--phases", "save",
                          "--save-topk", "1", "--set", *ov, "data.batch_size=3"], capsys)[-1]
        counts[name] = res["save"]
    assert counts["port"]["saved"] == counts["jax"]["saved"] == 8
    store = _records(jax_rank_run["store"])
    last = sorted(store)[-1]
    want = sum(len(r["part_masks"]) - 1 for r in store.values())
    assert counts["port"]["overflow"] == want > 0
    assert counts["jax"]["overflow"] == want + len(store[last]["part_masks"]) - 1


# ---------------------------------------------------------------- stage 2


@pytest.fixture
def same_seeding(monkeypatch):
    """Both packages seed k-means with the first k valid rows."""
    from partdistillation_tpu.ops import kmeans as jkm
    from partdistillation_torch.ops import kmeans as pkm

    monkeypatch.setattr(jkm, "_kmeans_pp_init", first_valid_rows_jax)
    monkeypatch.setattr(pkm, "kmeans_pp_init", first_valid_rows_port)


@pytest.fixture(scope="module")
def jax_backbone_weights(tmp_path_factory):
    """The JAX CLI's bare-backbone initialisation at seed 0 as a port
    state_dict (``backbone.*`` keys)."""
    from partdistillation_tpu.models.meta_arch.proposal import normalize_images
    from partdistillation_tpu.models.swin import SwinConfig as JSwin
    from partdistillation_tpu.models.swin import SwinTransformer as JSwinT
    from partdistillation_torch.utils.convert_weights import state_dict_from_flax

    sw = JSwin(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), window_size=4,
               drop_path_rate=0.0)
    params = jax.jit(JSwinT(sw).init)(jax.random.PRNGKey(0),
                                      normalize_images(jnp.zeros((1, 64, 64, 3))))
    params = jax.tree_util.tree_map(np.asarray, params)
    path = tmp_path_factory.mktemp("jax_backbone") / "weights.pth"
    torch.save(state_dict_from_flax({"backbone": params["params"]}), path)
    return str(path)


def test_propose_and_pixel_grouping_equal_jax_cli(cli_env, capsys, tmp_path, same_seeding,
                                                  jax_backbone_weights, jax_cache_dir_kept):
    from partdistillation_tpu import run as jcli

    ov = [o for o in cli_env["overrides"] if not o.startswith("paths.root")]
    stores, ar = {}, {}
    for name, main, dev in (("jax", jcli.main, []), ("port", pcli.main, ["--device", "cpu"])):
        root = tmp_path / name
        root.mkdir()
        (root / "object_labels").symlink_to(cli_env["tmp"] / "pseudo_labels" / "object_labels")
        argv = ["--tiny", *dev, "--torch-params", jax_backbone_weights, "--set", *ov,
                f"paths.root={root}"]
        res = _run(main, ["propose", *argv], capsys)[-1]
        assert res["stage"] == "propose" and res["saved"] == 8
        stores[name] = _records(root / "proposal_generation")
        ar[name] = _run(main, ["eval-pixel-grouping", *argv], capsys)[-1]
    assert stores["port"].keys() == stores["jax"].keys()
    for k, got in stores["port"].items():
        want = stores["jax"][k]
        assert got.keys() == want.keys()
        assert got["object_ratio"] == pytest.approx(want["object_ratio"], abs=1e-7)
        assert got["object_class"] == want["object_class"]
        assert len(got["part_masks"]) == len(want["part_masks"])
        for a, b in zip(got["part_masks"], want["part_masks"]):
            np.testing.assert_array_equal(rle.decode(a), rle.decode(b), err_msg=k)
    for k in AR:
        assert 0.0 <= ar["port"][k] <= 100.0
        assert ar["port"][k] == pytest.approx(ar["jax"][k], abs=1e-6), k


def test_propose_store_resumes_and_is_read_by_stage3(cli_env, capsys, tmp_path):
    from partdistillation_torch.data.datasets.imagenet import load_imagenet_with_proposals
    from partdistillation_torch.data.mappers import ProposalTrainMapper
    from partdistillation_torch.data.pseudo_store import store_complete

    ov = [o for o in cli_env["overrides"] if not o.startswith("paths.root")]
    root = tmp_path / "labels"
    root.mkdir()
    (root / "object_labels").symlink_to(cli_env["tmp"] / "pseudo_labels" / "object_labels")
    ov.append(f"paths.root={root}")
    assert _run(pcli.main, _cpu("propose", "--set", *ov, "data.debug_limit=3"),
                capsys)[-1]["saved"] == 3
    assert _run(pcli.main, _cpu("propose", "--set", *ov), capsys)[-1]["saved"] == 5
    assert _run(pcli.main, _cpu("propose", "--set", *ov), capsys)[-1]["saved"] == 0
    store = root / "proposal_generation"
    assert store_complete(str(store))
    objects = PseudoLabelStore(str(root / "object_labels"))
    for image_id, r in _records(store).items():
        masks = np.stack([rle.decode(m) for m in r["part_masks"]])
        obj = rle.decode(objects.get(image_id)["object_masks"][0]).astype(bool)
        assert 1 <= len(masks) <= 4
        assert masks.sum(0).max() == 1 and np.array_equal(masks.any(0), obj)
        assert r["object_ratio"] == pytest.approx(obj.mean(), abs=1e-7)
    items = load_imagenet_with_proposals(_imagenet(_cpu("propose", "--set", *ov)), str(store))
    assert len(items) == 8
    ex = ProposalTrainMapper(image_size=64, capacity=8)(items[0])
    assert ex["valid"].sum() >= 1


@pytest.mark.parametrize("cmd,flags,reason", [
    ("rank", ["--device", "cpu", "--eval-dataset", "pascal"], "ROADMAP"),
    ("rank", [], "--device cpu"),
    ("propose", [], "--device cpu"),
    ("eval-pixel-grouping", [], "--device cpu"),
], ids=["rank-pascal", "rank-tiny-cuda", "propose-tiny-cuda", "pixel-grouping-tiny-cuda"])
def test_refused_flags_raise_before_any_device(cli_env, cmd, flags, reason, monkeypatch):
    def no_device(*a, **k):
        raise AssertionError("a device was touched")

    monkeypatch.setattr(torch.cuda, "is_available", no_device)
    with pytest.raises(SystemExit, match=reason):
        pcli.main([cmd, "--tiny", *flags, "--allow-random-init", "--set",
                   *cli_env["overrides"]])
