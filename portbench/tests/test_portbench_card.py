"""One short run of every one-card cell on the card, through the benchmark's
command (skips where there is no card)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench import run

BENCH = run.load_json(run.ROOT, "BENCHMARK.json")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"] if w["chips"] == 1])
def test_a_short_run_is_correct(card, workload):
    out = subprocess.run([sys.executable, os.path.join(run.HERE, "run.py"), "--workload",
                          workload, "--seed", "2500000001", "--seconds", "3", "--trace", "1"],
                         capture_output=True, text=True, timeout=600, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0 and res["metrics"]
