"""Multi-process runs of the port on the CPU: two gloo ranks as subprocesses
(``tests/torch_dist_worker.py``), each with a time limit.

- ``engine/launch.py`` and ``parallel/mesh.py``: ``initialize`` joins the
  group from torchrun's variables (and is a no-op without them);
  ``all_gather_objects`` over ragged payloads, in rank order; ``barrier``;
  the data-major layouts (2, 1) and (1, 2); the head's pair of autograd
  functions (identity / sum forward, sum / identity backward);
- no fallback to one process: ``initialize`` raises when the group cannot
  form (no rendezvous address; a cuda run without NCCL), and a rank whose
  peer died raises at its next collective;
- ``resolve_device``: a bare ``cuda`` is ``cuda:LOCAL_RANK`` under torchrun;
- ``chip_smoke.py`` and the port's tools import neither JAX nor the JAX
  package;
- ``merge_reservoirs`` and ``merge_confusion_dicts`` equal the JAX
  package's bit for bit on the same seeded states;
- the data-parallel train step, two ranks at B = 1, against the
  single-process step at B = 2 on the same weights, batch, noise and
  matching (the tiny f32 model, trunk frozen and unfrozen with DropPath):
  the loss (the group mean), every gradient the update starts from and the
  parameters after AdamW within 1e-5 of each tensor's largest magnitude
  (at least 1), the two ranks' valid counts unequal;
  the steps with the mask count or the CE weight sum left per rank miss
  that tolerance;
- the stage-5 head sharded over two model ranks against the unsharded
  step: the loss, every gradient (the head's against its slice), the
  gradient norm and the head after the update within 1e-5; a checkpoint
  written sharded resumes unsharded and the other way round, moments too.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_dist_worker import ROOT, TIMEOUT_S, free_port, run_ranks, torchrun_env

from partdistillation_torch.engine import launch
from partdistillation_torch.evaluation.clustering import merge_reservoirs
from partdistillation_torch.evaluation.miou import merge_confusion_dicts
from partdistillation_torch.models.meta_arch.part_distillation import PART_HEAD_WEIGHT
from partdistillation_torch.parallel.mesh import make_mesh, take_shard

TOL = 1e-5


def _excess(got, want) -> float:
    """How far ``got`` is from ``want`` beyond TOL times the tensor's scale
    (its largest magnitude, at least 1); <= 0 within."""
    got, want = torch.as_tensor(got, dtype=torch.float64), torch.as_tensor(want,
                                                                          dtype=torch.float64)
    return float((got - want).abs().max() - TOL * max(1.0, float(want.abs().max())))


def _worst(got: dict, want: dict, keys=None) -> float:
    keys = keys if keys is not None else want
    return max(_excess(got[k], want[k]) for k in keys)


def test_initialize_is_a_no_op_without_torchrun(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert launch.initialize("cpu") is False
    assert not torch.distributed.is_initialized()
    assert (launch.process_index(), launch.process_count(), launch.is_main_process()) \
        == (0, 1, True)
    launch.barrier()  # nothing to wait for
    mesh = make_mesh()
    assert (mesh.n_data, mesh.n_model, mesh.data_group, mesh.model_group) == (1, 1, None, None)
    with pytest.raises(ValueError, match="not divisible by n_model_shards=2"):
        make_mesh(n_model=2)
    with pytest.raises(RuntimeError, match="process group"):
        launch.all_gather_objects(0)


def test_initialize_raises_when_the_group_cannot_form(monkeypatch):
    for var, value in torchrun_env(0, 2, free_port()).items():
        monkeypatch.setenv(var, value)
    monkeypatch.delenv("MASTER_ADDR")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        launch.initialize("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        launch.initialize("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        launch.initialize("cuda")
    assert not torch.distributed.is_initialized()


def test_a_rank_whose_peer_died_raises(tmp_path):
    port = free_port()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
                               "dies", str(r), "2", str(tmp_path)], cwd=ROOT,
                              env={**os.environ, **torchrun_env(r, 2, port),
                                   "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert procs[1].returncode == 3
    assert procs[0].returncode != 0 and "Error" in outs[0][1], outs[0][1][-2000:]
    assert not (tmp_path / "rank0.pt").exists()


def test_resolve_device_is_the_local_rank_under_torchrun(monkeypatch):
    from partdistillation_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert resolve_device() == resolve_device("cuda") == torch.device("cuda", 3)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")


def test_chip_scripts_import_no_jax():
    files = [ROOT / "chip_smoke.py", *sorted((ROOT / "tools").glob("torch_*.py"))]
    assert ROOT / "tools" / "torch_ddp_check.py" in files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax",
                                                           "partdistillation_tpu")]
            assert not bad, (path.name, bad)


def test_launch_gathers_and_mesh_layouts(tmp_path):
    ranks = run_ranks("collectives", 2, tmp_path)
    for r, out in enumerate(ranks):
        assert out["owned"] and (out["index"], out["count"], out["main"]) == (r, 2, r == 0)
        assert [g["rank"] for g in out["gathered"]] == [0, 1]
        for q, g in enumerate(out["gathered"]):
            assert len(g["ragged"]) == q + 2
            for a in g["ragged"]:
                np.testing.assert_array_equal(a, np.full((q + 1, 3 * q + 1), q, np.float32))
        # data-major: rank = d * n_model + m
        assert out["layouts"][(2, 1)] == {"data_index": r, "model_index": 0,
                                          "data_ranks": [0, 1], "model_ranks": None}
        assert out["layouts"][(1, 2)] == {"data_index": 0, "model_index": r,
                                          "data_ranks": None, "model_ranks": [0, 1]}
        x = torch.arange(4.0)
        # forward: sum over ranks of x * (rank + 1); backward: sum of the ranks' weights
        torch.testing.assert_close(out["head_fwd"], 3 * x, rtol=0, atol=0)
        torch.testing.assert_close(out["head_grad"], 3 * x, rtol=0, atol=0)


def _reservoir_states(seed: int, cap: int):
    """Per-rank reservoirs: overlapping classes, some past the cap."""
    rng = np.random.default_rng(seed)
    states = []
    for _ in range(3):
        feats, seen = {}, {}
        for c in rng.choice(8, size=5, replace=False):
            n = int(rng.integers(1, 3 * cap))
            buf = np.zeros((cap, 4), np.float32)
            buf[:min(n, cap)] = rng.normal(size=(min(n, cap), 4))
            feats[int(c)], seen[int(c)] = buf, n
        states.append((feats, seen))
    return states


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_reservoirs_equals_jax(seed):
    from partdistillation_tpu.evaluation.clustering import merge_reservoirs as jax_merge

    states = _reservoir_states(seed, cap=16)
    got, want = merge_reservoirs(states, 16, seed), jax_merge(states, 16, seed)
    assert got[1] == want[1] and list(got[0]) == list(want[0])
    for c in want[0]:
        np.testing.assert_array_equal(got[0][c], want[0][c])


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_confusion_dicts_equals_jax(seed):
    from partdistillation_tpu.evaluation.miou import merge_confusion_dicts as jax_merge

    rng = np.random.default_rng(seed)
    dicts = [{int(c): rng.integers(0, 50, (9, 9)).astype(np.float64)
              for c in rng.choice(6, size=3, replace=False)} for _ in range(3)]
    got, want = merge_confusion_dicts(dicts), jax_merge(dicts)
    assert list(got) == list(want)
    for c in want:
        np.testing.assert_array_equal(got[c], want[c])


def _loss_keys(metrics):
    return [k for k in metrics if k.startswith(("loss_", "total_loss"))]


@pytest.mark.parametrize("kind", ["frozen", "unfrozen"])
def test_ddp_step_equals_the_global_batch_step(tmp_path, kind):
    ranks = run_ranks("ddp_step", 2, tmp_path, kind)
    ref = ranks[0]["ref"]
    losses = _loss_keys(ref["metrics"])
    for out in ranks:
        ddp = out["ddp"]
        assert _worst(ddp["metrics"], ref["metrics"], losses + ["grad_norm"]) <= 0
        assert ddp["grads"].keys() == ref["grads"].keys()
        assert _worst(ddp["grads"], ref["grads"]) <= 0
        assert _worst(ddp["params"], ref["params"]) <= 0
        if kind == "unfrozen":
            assert any(k.startswith("backbone.") for k in ref["grads"])
    # the same step with a normaliser left per rank misses the tolerance
    for planted in ("local_num_masks", "local_class_weight"):
        bad = ranks[0][planted]
        assert _worst(bad["grads"], ref["grads"]) > 0, planted
        assert _worst(bad["metrics"], ref["metrics"], losses) > 0, planted


def test_sharded_head_equals_the_unsharded_step(tmp_path):
    ranks = run_ranks("head_shards", 2, tmp_path)
    ref = ranks[0]["ref"]
    for m, out in enumerate(ranks):
        assert out["model_index"] == m
        got = out["sharded"]
        shard = {k: (take_shard(v, m, 2, dim=1) if k == PART_HEAD_WEIGHT else v)
                 for k, v in ref["params"].items()}
        want_grads = {k: (take_shard(v, m, 2, dim=1) if k == PART_HEAD_WEIGHT else v)
                      for k, v in ref["grads"].items()}
        assert got["params"][PART_HEAD_WEIGHT].shape == shard[PART_HEAD_WEIGHT].shape
        assert _worst(got["metrics"], ref["metrics"],
                      _loss_keys(ref["metrics"]) + ["grad_norm"]) <= 0
        assert _worst(got["grads"], want_grads) <= 0
        assert _worst(got["params"], shard) <= 0

        # a sharded checkpoint holds the whole head and resumes unsharded
        assert out["saved_head_shape"] == tuple(ref["params"][PART_HEAD_WEIGHT].shape)
        whole = out["resumed"]["sharded_into_whole"]
        assert whole["step"] == 1
        assert _worst(whole["params"], ref["params"]) <= 0
        assert _worst(whole["moments"], out["moments"]["whole"]) <= 0
        # a whole checkpoint resumes sharded: this rank's slice, bit for bit
        sharded = out["resumed"]["whole_into_sharded"]
        torch.testing.assert_close(sharded["head"], shard[PART_HEAD_WEIGHT], rtol=0, atol=0)
        for k, v in out["moments"]["whole"].items():
            torch.testing.assert_close(sharded["moments"][k], take_shard(v, m, 2, dim=1),
                                       rtol=0, atol=0)
