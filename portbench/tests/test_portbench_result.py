"""The result line's keys, the refusals, and the import boundary."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from portbench import run, train
from portbench.tests.tiny import tiny_config, tiny_traffic

LIMITS = {"feature_gap": 1e-3, "grad_gap": 1e-3, "change_gap": 1e-2}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    cfg, t = tiny_config("m2f-swinL-supervised"), tiny_traffic("supervised_train")
    tmp = str(tmp_path_factory.mktemp("runs"))
    return cfg, t, {trace: train.run(cfg, t, 77, 0.5, trace, "cpu", time.perf_counter(), LIMITS,
                                     tmp) for trace in (False, True)}


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_exactly_its_keys(records, trace):
    cfg, t, recs = records
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    wl = next(w for w in bench["workloads"] if w["name"] == "supervised.train")
    res = run.result_line(recs[trace], wl, bench, cfg, t, trace, "cpu-test")
    keys = ["correct", "attempted", "failed", "metrics", "device", "checks"]
    if trace:
        keys.insert(5, "breakdown")
    assert list(res) == keys  # the compared numbers come last
    assert set(res["checks"]) == set(LIMITS)
    assert all(set(v) == {"value", "limit"} for v in res["checks"].values())
    dev = res["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert set(dev) == ({"platform", "kind", "count", "memory_peak_bytes"}
                        | ({"busy_s", "window_s"} if trace else set()))
    if trace:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        # a CPU run has no device trace: those metrics read nothing
        assert "device.idle.train" not in res["metrics"]
        assert "mfu.train" not in res["metrics"]
        assert "data.wait_ms.train" in res["metrics"]
    else:
        assert set(res["metrics"]) == {"train_img_per_s", "setup_s"}
    json.dumps(res)


def test_no_result_without_a_card():
    out = subprocess.run([sys.executable, os.path.join(run.HERE, "run.py"), "--workload",
                          "supervised.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, the program is missing: the run fails and prints nothing."""
    shutil.copytree(run.HERE, tmp_path / "portbench")
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "supervised.train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "partdistillation_tpux", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.linen", object())
    assert run.forbidden_modules() == ["flax"]


def test_a_run_imports_no_jax(tmp_path):
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from portbench import run, train\n"
            "from portbench.tests.tiny import tiny_config, tiny_traffic\n"
            "train.run(tiny_config('m2f-swinL-supervised'), tiny_traffic('supervised_train'),"
            " 5, 0.3, True, 'cpu', time.perf_counter(), %r, %r)\n"
            "from portbench import flops, control\n"
            "print(run.forbidden_modules())\n") % (run.ROOT, LIMITS, str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
