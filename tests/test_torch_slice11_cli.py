"""The port's stage-1 CLIs (``python -m partdistillation_torch.run label /
detect / eval-detect``) on the CPU, against the JAX package's CLIs.

A synthetic ImageNet split (two classes of three 64 x 64 JPEGs), a store of
precomputed detections and a PartImageNet-style json. Then:

- ``label`` writes the JAX CLI's store byte for byte, with and without the
  class match;
- ``detect --tiny --device cpu`` on weights written from a JAX
  initialisation (``--torch-params``) writes the JAX CLI's records (masks,
  classes and every other field equal, scores within 1e-5: the f32
  forwards round apart in the last bits), and a rerun skips every image;
  ``propose``'s mapper reads the store;
- ``detect --clip-model`` on a tiny random transformers ``CLIPModel`` saved
  in the test (its processor a stub tokenizer and a real image processor):
  the device backend (``--clip-backend device`` and its alias ``tpu``)
  against the JAX CLI's device tower in f32, and the host backend
  (``torch``) against the JAX CLI's: masks and classes equal, scores within
  1e-5;
- ``eval-detect``'s AR@k within 1e-6 of the JAX CLI's;
- ``detect`` without weights, ``--tiny`` on cuda, and ``--clip-model``
  without transformers raise SystemExit.
"""

import contextlib
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from partdistillation_torch import run as pcli
from partdistillation_torch.data.pseudo_store import PseudoLabelStore, ShardWriter, shard_name
from partdistillation_torch.utils import rle

CODES = ["n01440764", "n01443537"]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    from PIL import Image

    tmp = tmp_path_factory.mktemp("torch_stage1_cli")
    root = tmp / "imagenet"
    rng = np.random.RandomState(0)
    images, annotations = [], []
    with ShardWriter(str(tmp / "detections"), 0, 1) as det:
        for ci, code in enumerate(CODES):
            (root / code).mkdir(parents=True)
            for j in range(3):
                img = rng.randint(0, 255, (64, 64, 3), np.uint8)
                y0, x0 = 8 + 3 * j, 6 + 4 * ci
                img[y0:y0 + 40, x0:x0 + 44] = np.clip(
                    np.array([60 + 80 * ci, 160, 220 - 60 * ci])
                    + rng.randint(-30, 30, (40, 44, 3)), 0, 255)
                Image.fromarray(img).save(str(root / code / f"{code}_{j}.JPEG"))
                masks = [np.zeros((64, 64), bool) for _ in range(4)]
                for m, (a, b) in zip(masks, ((0, 20), (20, 44), (5, 30), (10, 40))):
                    m[y0:y0 + 40, x0 + a:x0 + b] = True
                det.write({"image_id": f"{code}_{j}", "masks": [rle.encode(m) for m in masks],
                           "scores": rng.rand(4).round(3).tolist(),
                           "class_ids": [ci, 1 - ci, ci, 5]})
                iid = 3 * ci + j
                images.append({"id": iid, "file_name": f"{code}/{code}_{j}.JPEG",
                               "height": 64, "width": 64})
                for p in range(2):
                    xa, xb = float(x0 + 22 * p), float(x0 + 22 * (p + 1))
                    annotations.append({
                        "id": len(annotations), "image_id": iid, "category_id": p,
                        "segmentation": [[xa, float(y0), xb, float(y0), xb, float(y0 + 40),
                                          xa, float(y0 + 40)]]})
    (root / "labels.txt").write_text("n01440764 tench\nn01443537 goldfish\n")
    part_json = tmp / "part_imagenet.json"
    part_json.write_text(json.dumps({
        "images": images, "annotations": annotations,
        "categories": [{"id": c, "name": f"part{c}"} for c in range(2)]}))
    ov = [f"data.imagenet_root={root}", f"data.part_imagenet_json={part_json}",
          f"data.part_imagenet_images={root}", "data.image_size=64", "data.batch_size=4",
          "data.num_workers=2", f"checkpoint_dir={tmp}/ckpt"]
    return {"tmp": tmp, "ov": ov}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX CLI's class-agnostic segmenter at seed 0 as a port state_dict."""
    from partdistillation_tpu import run as jcli
    from partdistillation_tpu.models.meta_arch.proposal import normalize_images
    from partdistillation_tpu.models.segmenter import MaskFormerSegmenter as JSeg
    from partdistillation_torch.utils.convert_weights import state_dict_from_flax

    seg = jcli._segmenter_cfg(True, num_classes=1, num_queries=8)
    params = jax.jit(JSeg(seg).init)(jax.random.PRNGKey(0),
                                     normalize_images(jnp.zeros((1, 64, 64, 3))))
    path = tmp_path_factory.mktemp("stage1_weights") / "weights.pth"
    torch.save(state_dict_from_flax(jax.tree_util.tree_map(np.array, params)), path)
    return str(path)


def _run(main, argv):
    """A CLI's JSON lines; JAX's compilation-cache setting is put back."""
    saved = jax.config.jax_compilation_cache_dir
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            main(argv)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)
    return [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]


def _both(argv, tmp_path, store="object_labels"):
    """Run ``argv`` through the JAX CLI and the port's (``--device cpu``), each
    into its own labels root; return their last JSON lines and store dirs."""
    from partdistillation_tpu import run as jcli

    res, dirs = {}, {}
    for name, main, dev in (("jax", jcli.main, []), ("port", pcli.main, ["--device", "cpu"])):
        root = tmp_path / name
        res[name] = _run(main, [argv[0], *dev, *argv[1:], f"paths.root={root}"])[-1]
        dirs[name] = root / store
    return res, dirs


def _shard_bytes(store):
    return (store / shard_name(0, 1)).read_bytes()


def _records(store):
    return {r["image_id"]: r for r in PseudoLabelStore(str(store))}


@pytest.mark.parametrize("flags", [[], ["--no-class-match", "--topk", "2"]],
                         ids=["class-match", "no-class-match"])
def test_label_store_equals_jax_cli_byte_for_byte(env, tmp_path, flags):
    res, dirs = _both(["label", "--detections", str(env["tmp"] / "detections"), *flags,
                       "--set", *env["ov"]], tmp_path)
    assert res["port"] == res["jax"] == {"stage": "label", "saved": 6, "skipped": 0, "empty": 0}
    assert _shard_bytes(dirs["port"]) == _shard_bytes(dirs["jax"])


def _detect_argv(env, weights, *extra):
    return ["detect", "--tiny", "--torch-params", weights, "--num-queries", "8",
            "--proposals", "6", "--topk", "4", *extra, "--set", *env["ov"]]


def test_detect_store_equals_jax_cli(env, weights, tmp_path):
    from partdistillation_torch.data.datasets.imagenet import load_imagenet
    from partdistillation_torch.data.mappers import ProposalGenerationMapper

    res, dirs = _both(_detect_argv(env, weights), tmp_path)
    assert res["jax"] == {"stage": "detect", "saved": 6, "skipped": 0, "empty": 0}
    assert {k: res["port"][k] for k in res["jax"]} == res["jax"]
    assert res["port"]["images_per_sec"] > 0 and res["port"]["total_s"] >= 0
    got = _records(dirs["port"])
    assert all(r["pred_classes"] == [-1] * len(r["scores"]) for r in got.values())
    _same_detections(got, _records(dirs["jax"]), 1e-5)
    again = _run(pcli.main, ["detect", "--device", "cpu", *_detect_argv(env, weights)[1:],
                             f"paths.root={tmp_path / 'port'}"])[-1]
    assert {k: again[k] for k in ("saved", "skipped", "empty")} == {"saved": 0, "skipped": 6,
                                                                    "empty": 0}
    items = load_imagenet(str(env["tmp"] / "imagenet"), object_mask_store=str(dirs["port"]))
    ex = ProposalGenerationMapper(image_size=64)(items[0])
    assert ex is not None and ex["object_mask"].any()


class _Processor:
    """A processor for a tiny CLIP checkpoint: a deterministic word -> id
    tokenizer (no vocabulary files to fetch) and transformers' own image
    processor at the tower's size."""

    vocab, eot, max_len = 99, 98, 12

    def __init__(self):
        self.images = transformers.CLIPImageProcessor(
            size={"shortest_edge": 32}, crop_size={"height": 32, "width": 32})

    def __call__(self, text=None, images=None, return_tensors="pt", padding=True,
                 max_length=None, truncation=False):
        if images is not None:
            return self.images(images=images, return_tensors=return_tensors)
        n = max_length or self.max_len
        ids = np.zeros((len(text), n), np.int64)
        for i, prompt in enumerate(text):
            toks = [97] + [sum(map(ord, w)) % 96 + 1 for w in prompt.split()]
            toks = toks[:n - 1] + [self.eot]
            ids[i, :len(toks)] = toks
        out = {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int64)}
        return {k: torch.from_numpy(v) for k, v in out.items()} if return_tensors == "pt" \
            else out


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    cfg = transformers.CLIPConfig(
        text_config={"vocab_size": 99, "hidden_size": 32, "intermediate_size": 64,
                     "num_hidden_layers": 2, "num_attention_heads": 2,
                     "max_position_embeddings": 12, "eos_token_id": 98, "bos_token_id": 97,
                     "pad_token_id": 0},
        vision_config={"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
                       "num_attention_heads": 2, "image_size": 32, "patch_size": 8},
        projection_dim=16)
    torch.manual_seed(2)
    path = tmp_path_factory.mktemp("tiny_clip")
    transformers.CLIPModel(cfg).eval().save_pretrained(str(path))
    return str(path)


@pytest.fixture
def stub_processor(monkeypatch):
    monkeypatch.setattr(transformers.CLIPProcessor, "from_pretrained",
                        classmethod(lambda cls, *a, **k: _Processor()))


@pytest.fixture
def jax_device_tower_in_f32(monkeypatch):
    """The JAX CLI builds its device tower in bf16 even with --tiny; the
    port's --tiny tower is f32: compare both in f32."""
    import functools

    from partdistillation_tpu.models.meta_arch import labeling as jlab

    monkeypatch.setattr(jlab, "clip_region_scorer_tpu",
                        functools.partial(jlab.clip_region_scorer_tpu, dtype=jnp.float32))


def _same_detections(got, want, tol):
    assert got.keys() == want.keys() and len(got) == 6
    for iid, g in got.items():
        w = want[iid]
        assert g.keys() == w.keys()
        assert {k: v for k, v in g.items() if k != "scores"} == \
            {k: v for k, v in w.items() if k != "scores"}, iid
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=tol)


@pytest.mark.parametrize("backend", ["device", "tpu"])
def test_detect_clip_device_backend_equals_jax_cli(env, weights, clip_dir, stub_processor,
                                                   jax_device_tower_in_f32, tmp_path, backend):
    from partdistillation_tpu import run as jcli

    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    _run(jcli.main, [*_detect_argv(env, weights, "--clip-model", clip_dir),
                     f"paths.root={jax_root}"])
    res = _run(pcli.main, ["detect", "--device", "cpu",
                           *_detect_argv(env, weights, "--clip-model", clip_dir,
                                         "--clip-backend", backend)[1:],
                           f"paths.root={port_root}"])[-1]
    assert res["saved"] == 6
    got, want = _records(port_root / "object_labels"), _records(jax_root / "object_labels")
    _same_detections(got, want, 1e-5)
    assert any(c >= 0 for r in got.values() for c in r["pred_classes"])


def test_detect_clip_host_backend_equals_jax_cli(env, weights, clip_dir, stub_processor,
                                                 tmp_path):
    res, dirs = _both(_detect_argv(env, weights, "--clip-model", clip_dir, "--clip-backend",
                                   "torch"), tmp_path)
    assert res["port"]["saved"] == res["jax"]["saved"] == 6
    _same_detections(_records(dirs["port"]), _records(dirs["jax"]), 1e-5)


def test_eval_detect_equals_jax_cli(env, weights, tmp_path):
    res, _ = _both(["eval-detect", "--tiny", "--torch-params", weights, "--num-queries", "8",
                    "--topk", "8", "--set", *env["ov"]], tmp_path)
    got, want = res["port"], res["jax"]
    assert got["stage"] == want["stage"] == "eval-detect"
    ar = [k for k in want if k.startswith("AR@")]
    assert ar == [k for k in got if k.startswith("AR@")] == ["AR@1"]  # limits <= topk 8
    for k in ar:
        assert 0.0 <= got[k] <= 100.0
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


def test_detect_refusals(env, weights, clip_dir, monkeypatch):
    def no_device(*a, **k):
        raise AssertionError("a device was touched")

    with pytest.raises(SystemExit, match="--allow-random-init"):
        pcli.main(["detect", "--tiny", "--device", "cpu", "--set", *env["ov"]])
    monkeypatch.setattr(torch.cuda, "is_available", no_device)
    with pytest.raises(SystemExit, match="--device cpu"):
        pcli.main(["detect", "--tiny", "--allow-random-init", "--set", *env["ov"]])
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(SystemExit, match="transformers"):
        pcli.main(["detect", "--tiny", "--device", "cpu", "--torch-params", weights,
                   "--num-queries", "8", "--clip-model", clip_dir, "--set", *env["ov"]])
