"""The port's stage-3 CLI (``python -m partdistillation_torch.run``) on the CPU.

A synthetic ImageNet split (two classes of four 64 x 64 JPEGs), a stage-2b
proposal store written by the port's ``ShardWriter`` and a PartImageNet-style
GT json over the same images, built as ``tests/test_cli_pipeline.py`` builds
its set. Then:

- ``train-proposal --tiny --device cpu`` takes two steps, prints the JAX
  CLI's keys, writes ``metrics.jsonl`` and checkpoints; a rerun with
  ``max_iters=3`` resumes at step 2 and takes one step;
- ``eval-proposal --tiny --torch-params F`` gives the JAX CLI's AR values to
  1e-6 on the same files and weights (``F`` written from a JAX-initialised
  tree through ``state_dict_from_flax``), once dense and once banded with
  radius 1 at 256^2, where the band acts on the finest level;
- the flags the port refuses raise SystemExit: ``--params`` (an Orbax tree),
  ``--eval-dataset pascal`` / ``cityscapes`` with their data directories
  unset and ``--tiny --device cuda`` (also beside ``vis_every > 0``, which is
  ported), the last before any device is touched.
"""

import json
import os

import numpy as np
import pytest
import torch

from partdistillation_torch import run as pcli
from partdistillation_torch.data.pseudo_store import PseudoLabelStore, ShardWriter
from partdistillation_torch.utils import rle

CODES = ["n01440764", "n01443537"]


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    root = tmp / "imagenet"
    from PIL import Image

    rng = np.random.RandomState(0)
    with ShardWriter(str(tmp / "pseudo_labels" / "proposals_dcrf"), 0, 1) as writer:
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
                writer.write({"image_id": f"{code}_{j}", "part_masks": parts,
                              "object_ratio": 0.3})
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
        f"data.imagenet_root={root}",
        f"data.part_imagenet_json={part_json}",
        f"data.part_imagenet_images={root}",
        "data.image_size=64",
        "data.batch_size=4",
        "data.mask_capacity=8",
        "data.num_workers=2",
        f"paths.root={tmp}/pseudo_labels",
        f"checkpoint_dir={tmp}/ckpt",
        "log_every=1",
        "checkpoint_every=1000",
    ]
    return {"tmp": tmp, "overrides": overrides}


def _run(main, argv, capsys):
    """Run a CLI's ``main``; return the last JSON line it printed."""
    capsys.readouterr()
    main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return [json.loads(line) for line in out if line.startswith("{")][-1]


def test_train_proposal_tiny_cpu_then_resume(cli_env, capsys):
    from partdistillation_tpu.run import _StageTimer

    ov = cli_env["overrides"]
    res = _run(pcli.main, ["train-proposal", "--tiny", "--device", "cpu", "--set", *ov,
                           "max_iters=2"], capsys)
    timer = _StageTimer()
    timer.batch(4)
    timer.batch(4)
    jax_keys = {"stage", "steps", "images_per_sec"} | set(timer.stats())
    assert jax_keys <= set(res), jax_keys - set(res)
    assert res["stage"] == "train-proposal" and res["steps"] == 2
    assert res["loader_wait_s"] >= 0 and res["step_s"] > 0
    log = cli_env["tmp"] / "ckpt" / "logs" / "train-proposal" / "metrics.jsonl"
    lines = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["total_loss"]) for r in lines)
    ckpt = cli_env["tmp"] / "ckpt" / "proposal"
    assert sorted(p.name for p in ckpt.glob("model_*.pt")) == ["model_00000002.pt"]

    res = _run(pcli.main, ["train-proposal", "--tiny", "--device", "cpu", "--set", *ov,
                           "max_iters=3"], capsys)
    assert res["steps"] == 3
    lines = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2, 3]
    state = torch.load(ckpt / "model_00000003.pt", weights_only=True)
    assert state["step"] == 3


@pytest.fixture
def jax_cache_dir_kept():
    """The JAX CLI's setup points JAX's compilation cache at the repository;
    put the tests' cache back afterwards."""
    import jax

    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


@pytest.mark.parametrize("msda", [[], ["--msda-mode", "banded", "--msda-band-radius", "1"]],
                         ids=["dense", "banded-r1"])
def test_eval_proposal_ar_matches_jax_cli(cli_env, capsys, tmp_path, msda, jax_cache_dir_kept):
    import jax
    import jax.numpy as jnp

    from partdistillation_tpu import run as jcli
    from partdistillation_tpu.models.meta_arch.proposal import normalize_images
    from partdistillation_tpu.models.segmenter import MaskFormerSegmenter
    from partdistillation_torch.utils.convert_weights import state_dict_from_flax

    size = 256
    ov = [o for o in cli_env["overrides"] if not o.startswith("data.image_size")]
    ov += [f"data.image_size={size}"]
    kw = {"msda_mode": "banded", "msda_band_radius": 1} if msda else {}
    if msda:  # the band is narrower than the finest level (32 x 32 at 256^2)
        from partdistillation_torch.ops.ms_deform_attn import msda_band_table

        table = msda_band_table(((8, 8), (16, 16), (32, 32)), 1, 512)
        assert (table[320:, 2, 1] - table[320:, 2, 0]).max() < 32
    seg = jcli._segmenter_cfg(True, num_classes=1, num_queries=200, msda=kw)
    params = jax.jit(MaskFormerSegmenter(seg).init)(
        jax.random.PRNGKey(5), normalize_images(jnp.zeros((1, size, size, 3))))
    weights = tmp_path / "weights.pth"
    torch.save(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)), weights)

    argv = ["eval-proposal", "--tiny", "--torch-params", str(weights), *msda, "--set", *ov]
    want = _run(jcli.main, argv, capsys)
    got = _run(pcli.main, argv[:2] + ["--device", "cpu"] + argv[2:], capsys)
    ar = sorted(k for k in want if k.startswith("AR@"))
    assert ar == sorted(k for k in got if k.startswith("AR@")) and len(ar) == 5
    assert got["dataset"] == want["dataset"] == "part_imagenet"
    assert got["# instances"] == want["# instances"] == 8
    for k in ar:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert max(want[k] for k in ar) > 0  # the proposals do match some parts


@pytest.mark.parametrize("argv,reason", [
    (["eval-proposal", "--tiny", "--device", "cpu", "--params", "params_dir"],
     "--torch-params"),
    # vis_every is ported: with it set, the refusal of --tiny on cuda still comes first
    (["train-proposal", "--tiny", "--set", "vis_every=5"], "--device cpu"),
    (["eval-proposal", "--tiny", "--device", "cpu", "--allow-random-init",
      "--eval-dataset", "pascal"], "data.pascal_parts_annotations"),
    (["eval-proposal", "--tiny", "--device", "cpu", "--allow-random-init",
      "--eval-dataset", "cityscapes"], "data.cityscapes_part_labels"),
    (["train-proposal", "--tiny"], "--device cpu"),
    (["eval-proposal", "--tiny", "--device", "cuda", "--allow-random-init"], "--device cpu"),
], ids=["params", "vis_every", "pascal", "cityscapes", "tiny-default-cuda", "tiny-cuda"])
def test_refused_flags_raise_system_exit(cli_env, argv, reason, monkeypatch):
    def no_device(*a, **k):
        raise AssertionError("a device was touched")

    monkeypatch.setattr(torch.cuda, "is_available", no_device)
    if "--set" in argv:
        i = argv.index("--set") + 1
        argv = argv[:i] + cli_env["overrides"] + argv[i:]
    else:
        argv = argv + ["--set", *cli_env["overrides"]]
    with pytest.raises(SystemExit, match=reason):
        pcli.main(argv)


def test_eval_without_weights_needs_allow_random_init(cli_env):
    with pytest.raises(SystemExit, match="allow-random-init"):
        pcli.main(["eval-proposal", "--tiny", "--device", "cpu", "--set",
                   *cli_env["overrides"]])


def test_store_read_back(cli_env):
    store = PseudoLabelStore(str(cli_env["tmp"] / "pseudo_labels" / "proposals_dcrf"))
    assert len(store) == 8
    rec = store.get("n01440764_0")
    assert len(rec["part_masks"]) == 3 and rle.area(rec["part_masks"][0]) == 36 * 12


def test_import_has_no_side_effects():
    """Importing the CLI module sets up no logging and probes no device."""
    import subprocess
    import sys

    code = ("import logging, sys, torch\n"
            "calls = []\n"
            "torch.cuda.is_available = lambda: calls.append(1) or False\n"
            "root = logging.getLogger()\n"
            "handlers = list(root.handlers)\n"
            "import partdistillation_torch.run\n"
            "sys.exit(1 if calls or root.handlers != handlers else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stderr
