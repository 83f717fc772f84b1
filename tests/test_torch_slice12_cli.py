"""The stage CLIs at world 2 (two gloo ranks with torchrun's variables,
``--tiny --device cpu``) against world 1 on the same data: stage 5's set of
``tests/test_torch_slice9_cli.py`` (two classes of four images, a stage-2b
and a stage-4 store, a PartImageNet-style GT json).

- ``train-proposal`` takes 2 steps at B = 2 a rank (each rank its own
  class), rank 0 writes the checkpoint and the metrics log;
- ``eval-proposal`` and ``distill-eval`` print world 1's metrics, each rank
  evaluating its share of the images, and ``distill_mapping.npz`` is world
  1's bit for bit;
- ``rank --phases match,eval`` from world 1's ``rank_centroids.npz`` writes
  world 1's ``rank_mapping.npz`` bit for bit and prints its metrics;
- ``rank --phases cluster,save`` writes one store shard a rank, whose
  records together cover the split once;
- ``distill-save --set n_model_shards=2``, the head split over both ranks,
  writes world 1's predictions (one shard, written by the first rank: the
  same images, masks and labels, scores within 1e-6);
- ``train-distillation --set n_model_shards=2``, launched as the module
  itself (``run.main`` joins and leaves the group), trains its head sharded
  over both ranks and writes the whole head;
- ``train-proposal`` over one class at world 2, where one data rank would
  have nothing to train on, exits with SystemExit on both ranks.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_slice9_cli import HEAD, METRICS, cli_env  # noqa: F401 (fixture)
from torch_dist_worker import ROOT, TIMEOUT_S, free_port, run_ranks, spawn, torchrun_env

from partdistillation_torch import run as pcli
from partdistillation_torch.data.pseudo_store import PseudoLabelStore
from partdistillation_torch.models.meta_arch.part_distillation import PART_HEAD_WEIGHT

NUM_OBJ = 16


def _cpu(cmd, *rest):
    return [cmd, "--tiny", "--device", "cpu", "--allow-random-init", *rest]


def _world1(argv) -> list:
    """``run.main(argv)`` in this process; its JSON lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        pcli.main(argv)
    return [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]


def _labels(tmp, name, store="proposals_dcrf"):
    """A pseudo-label root of its own that reads the set's ``store``."""
    root = tmp / name
    root.mkdir()
    (root / store).symlink_to(tmp / "pseudo_labels" / store)
    return root


@pytest.fixture(scope="module")
def runs(cli_env):  # noqa: F811
    tmp = cli_env["tmp"]
    base = [o for o in cli_env["overrides"] if not o.startswith(("checkpoint_dir", "paths.root"))]
    data = base + [f"paths.root={tmp}/pseudo_labels"]
    r1, r2 = _labels(tmp, "rank_w1"), _labels(tmp, "rank_w2")
    p1, p2 = (_labels(tmp, name, "part_masks_with_class") for name in ("save_w1", "save_w2"))
    rank_w1 = base + [f"paths.root={r1}", f"checkpoint_dir={tmp}/rank_w1_ckpt"]
    world1 = {
        "cluster": _world1(_cpu("rank", "--num-object-classes", str(NUM_OBJ), "--set", *rank_w1)),
        "match": _world1(_cpu("rank", "--num-object-classes", str(NUM_OBJ), "--phases",
                              "match,eval", "--set", *rank_w1)),
        "eval-proposal": _world1(_cpu("eval-proposal", "--set", *data,
                                      f"checkpoint_dir={tmp}/eval_w1")),
        "distill-eval": _world1(_cpu("distill-eval", *HEAD, "--set", *data,
                                     f"checkpoint_dir={tmp}/eval_w1")),
        "distill-save": _world1(_cpu("distill-save", *HEAD, "--set", *base,
                                     f"paths.root={p1}")),
    }
    (tmp / "rank_m2_ckpt").mkdir()
    shutil.copy(tmp / "rank_w1_ckpt" / "rank_centroids.npz", tmp / "rank_m2_ckpt")
    argvs = [
        ["train-proposal", "--tiny", "--device", "cpu", "--set", *data,
         f"checkpoint_dir={tmp}/train_w2", "data.batch_size=2", "max_iters=2"],
        _cpu("eval-proposal", "--set", *data, f"checkpoint_dir={tmp}/eval_w2"),
        _cpu("distill-eval", *HEAD, "--set", *data, f"checkpoint_dir={tmp}/eval_w2"),
        _cpu("rank", "--num-object-classes", str(NUM_OBJ), "--phases", "match,eval", "--set",
             *base, f"paths.root={r1}", f"checkpoint_dir={tmp}/rank_m2_ckpt"),
        _cpu("rank", "--num-object-classes", str(NUM_OBJ), "--set", *base, f"paths.root={r2}",
             f"checkpoint_dir={tmp}/rank_w2_ckpt"),
        _cpu("distill-save", *HEAD, "--set", *base, f"paths.root={p2}", "n_model_shards=2"),
    ]
    (tmp / "argvs.json").write_text(json.dumps(argvs))
    (tmp / "w2").mkdir()
    world2 = run_ranks("cli", 2, tmp / "w2", str(tmp / "argvs.json"))
    return {"tmp": tmp, "world1": world1, "world2": world2, "data": data}


def test_train_proposal_two_ranks(runs):
    tmp = runs["tmp"]
    for ranks in runs["world2"]:
        res = ranks[0][-1]
        assert res["stage"] == "train-proposal" and res["steps"] == 2
        assert res["grad_sync_s"] >= 0.0
    assert [p.name for p in sorted((tmp / "train_w2" / "proposal").glob("*.pt"))] \
        == ["model_00000002.pt"]
    logged = [json.loads(line) for line in
              (tmp / "train_w2" / "logs" / "train-proposal" / "metrics.jsonl").read_text()
              .splitlines()]
    assert [r["step"] for r in logged] == [1, 2]
    assert all(np.isfinite(r["total_loss"]) for r in logged)


@pytest.mark.parametrize("cmd,index", [("eval-proposal", 1), ("distill-eval", 2)])
def test_evals_print_world_one_metrics(runs, cmd, index):
    want = runs["world1"][cmd][-1]
    for ranks in runs["world2"]:
        got = ranks[index][-1]
        assert got["stage"] == cmd
        keys = [k for k in want if k.startswith(("AR@", "# instances"))] \
            if cmd == "eval-proposal" else list(METRICS)
        assert keys and {k: got[k] for k in keys} == {k: want[k] for k in keys}
    if cmd == "distill-eval":
        np.testing.assert_array_equal(
            np.load(runs["tmp"] / "eval_w2" / "distill_mapping.npz")["mapping"],
            np.load(runs["tmp"] / "eval_w1" / "distill_mapping.npz")["mapping"])


def test_rank_match_eval_writes_world_one_mapping(runs):
    tmp = runs["tmp"]
    want = np.load(tmp / "rank_w1_ckpt" / "rank_mapping.npz")["mapping"]
    got = np.load(tmp / "rank_m2_ckpt" / "rank_mapping.npz")["mapping"]
    assert got.dtype == want.dtype and got.shape == want.shape == (NUM_OBJ, 8)
    np.testing.assert_array_equal(got, want)
    for ranks in runs["world2"]:
        assert ranks[3][-1]["eval"] == {**ranks[3][-1]["eval"],
                                        **{k: runs["world1"]["match"][-1]["eval"][k]
                                           for k in METRICS}}


def test_rank_cluster_save_shards_cover_the_split_once(runs):
    tmp = runs["tmp"]
    store = tmp / "rank_w2" / "part_masks_with_class"
    shards = sorted(p.name for p in store.glob("*.pdrec"))
    assert shards == ["shard-00000-of-00002.pdrec", "shard-00001-of-00002.pdrec"]
    ids = [r["image_id"] for r in PseudoLabelStore(str(store))]
    want = [r["image_id"] for r in PseudoLabelStore(str(tmp / "rank_w1" / "part_masks_with_class"))]
    assert len(ids) == len(set(ids)) and sorted(ids) == sorted(want) and len(want) == 8
    # every rank holds the merged bank of both ranks' classes
    saved = [ranks[4][-1] for ranks in runs["world2"]]
    assert saved[0]["cluster"]["classes_seen"] == saved[1]["cluster"]["classes_seen"] == 2
    assert sum(s["save"]["saved"] for s in saved) == 8


def test_distill_save_head_sharded_writes_world_one_predictions(runs):
    tmp = runs["tmp"]
    store = "part_distillation_predictions"
    want = {r["image_id"]: r for r in PseudoLabelStore(str(tmp / "save_w1" / store))}
    assert [p.name for p in (tmp / "save_w2" / store).glob("*.pdrec")] \
        == ["shard-00000-of-00001.pdrec"]
    got = {r["image_id"]: r for r in PseudoLabelStore(str(tmp / "save_w2" / store))}
    assert got.keys() == want.keys() and len(want) > 0
    for image_id, r in got.items():
        w = want[image_id]
        assert r["part_masks"] == w["part_masks"] and r["part_labels"] == w["part_labels"]
        assert r["object_class"] == w["object_class"]
        np.testing.assert_allclose(r["part_scores"], w["part_scores"], rtol=0, atol=1e-6)
    saved = [ranks[5][-1]["saved"] for ranks in runs["world2"]]
    assert saved == [len(want), 0]


def test_train_distillation_head_sharded_over_two_ranks(runs, tmp_path):
    port = free_port()
    argv = [sys.executable, "-m", "partdistillation_torch.run", "train-distillation", "--tiny",
            "--device", "cpu", *HEAD, "--set", *runs["data"], f"checkpoint_dir={tmp_path}",
            "data.batch_size=2", "max_iters=2", "n_model_shards=2"]
    outs = spawn([argv] * 2, [torchrun_env(r, 2, port) for r in range(2)])
    results = [json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
               for out in outs]
    assert all(r["stage"] == "train-distillation" and r["steps"] == 2 for r in results)
    saved = torch.load(tmp_path / "part_distillation" / "model_00000002.pt", weights_only=True)
    assert saved["model"][PART_HEAD_WEIGHT].shape == (NUM_OBJ * 4 + 1, 32)


def test_train_refuses_a_data_rank_without_items(runs, tmp_path):
    root = tmp_path / "imagenet"
    root.mkdir()
    source = next(o.split("=", 1)[1] for o in runs["data"] if o.startswith("data.imagenet_root"))
    (root / "n01440764").symlink_to(f"{source}/n01440764")
    (root / "labels.txt").write_text("n01440764 tench\n")
    port = free_port()
    argv = [sys.executable, "-m", "partdistillation_torch.run", "train-proposal", "--tiny",
            "--device", "cpu", "--set", *runs["data"], f"data.imagenet_root={root}",
            f"checkpoint_dir={tmp_path}/ckpt", "max_iters=1"]
    procs = [subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env={**os.environ, **torchrun_env(r, 2, port),
                                              "PYTHONPATH": str(ROOT)})
             for r in range(2)]
    try:
        errs = [p.communicate(timeout=TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 1 and "train items per data rank: [4, 0]" in err, err[-2000:]
