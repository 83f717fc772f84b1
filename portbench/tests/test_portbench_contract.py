"""BENCHMARK.json keeps to the benchmark's contract, and every cell's files
resolve by name."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import backbones, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = run.load_json(run.ROOT, "BENCHMARK.json")
NUMBERS = {"input_gap", "feature_gap", "mask_gap", "mask_gap_first_layer", "mask_gap_image_median",
           "grad_diff", "terms_gap_first", "image_coef_gap", "loss_gap", "loss_gap_first",
           "grad_gap", "change_gap"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_exactly_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_resolves_its_files_by_name(workload):
    wl, cfg, traffic, limits = run.cell(BENCH, workload)
    conf = next(c for c in BENCH["configs"] if c["name"] == wl["config"])
    assert conf["file"].startswith("portbench/configs/")
    assert cfg["name"] == conf["name"] and cfg["reduced"] == conf["reduced"]
    assert traffic["loop"] == "train"
    assert {"feature_gap", "mask_gap_first_layer", "image_coef_gap", "change_gap"} <= set(limits)
    assert set(limits) <= NUMBERS
    for m in BENCH["per_layer"]:
        if workload in m["workloads"]:
            assert os.path.exists(os.path.join(run.HERE, "metrics", m["name"] + ".py"))


def test_a_new_cell_is_files_and_entries_only(tmp_path):
    """A later PR adds a cell by adding files and entries: no file that is
    there changes. The stage-3 cell's configuration, traffic and limits are
    in the folder already, so adding it takes two entries alone; a smaller
    mix of it takes a traffic file and a limits file besides."""
    root = tmp_path / "checkout"
    shutil.copytree(run.HERE, root / "portbench")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "m2f-swinL-proposal", "source": "x", "reduced": [],
                             "file": "portbench/configs/m2f-swinL-proposal.json", "why": "x"})
    bench["workloads"].append({"name": "proposal.train", "config": "m2f-swinL-proposal",
                               "traffic": "stage3_train", "chips": 1, "why": "x"})
    wl, cfg, traffic, limits = run.cell(bench, "proposal.train", str(root))
    assert cfg["name"] == "m2f-swinL-proposal" and traffic["batch"] == 8
    assert "image_coef_gap" in limits
    t = run.load_json(run.HERE, "traffic", "stage3_train.json")
    t["images"] = 64
    (root / "portbench" / "traffic" / "stage3_small.json").write_text(json.dumps(t))
    (root / "portbench" / "limits" / "proposal.small.json").write_text(
        json.dumps({"feature_gap": 1, "change_gap": 1}))
    bench["workloads"].append({"name": "proposal.small", "config": "m2f-swinL-proposal",
                               "traffic": "stage3_small", "chips": 1, "why": "x"})
    wl, cfg, traffic, limits = run.cell(bench, "proposal.small", str(root))
    assert traffic["images"] == 64 and cfg["name"] == "m2f-swinL-proposal"


# the wrappers a later PR's new backbone, task and store stand for: Swin,
# the supervised task and the PartImageNet store under names of their own
TWINS = {"backbones/swin_twin.py": "from .swin import *  # noqa: F401,F403\n",
         "tasks/supervised_twin.py": "from .supervised import *  # noqa: F401,F403\n",
         "stores/part_imagenet_twin.py": "from .part_imagenet import *  # noqa: F401,F403\n"}

TWIN_RUN = """
import json, sys, time
sys.path[:0] = [{root!r}, {repo!r}]
import numpy as np, torch
import portbench
assert portbench.__file__.startswith({root!r}), portbench.__file__
from portbench import check, data, flops, program, stores, train
from portbench.tests.test_portbench_pins import SEED, _digest, noises, rows
from portbench.tests.tiny import tiny_config, tiny_traffic
from portbench.weights import make_weights
out = {{}}
for name, traffic in (("m2f-twin", "twin_train"), ("m2f-swinL-supervised", "supervised_train")):
    cfg, t = tiny_config(name), tiny_traffic(traffic)
    noise = noises(cfg, t, SEED, steps=1)
    ref = check.run_reference(cfg, SEED, rows(cfg, t, True, SEED, steps=1), noise, "cpu")
    paths = data.write_dataset({root!r} + "/data-" + traffic, dict(t, images=4), 5, threads=1)
    items, _ = stores.load(t).program_items(paths, cfg["image_size"], cfg["mask_capacity"], 5)
    out[name] = {{"weights": _digest(make_weights(cfg["model"], SEED, "cpu").items()),
                 "noise": _digest(noise[0].items()),
                 "flops": flops.train_step_flops(cfg, t["batch"]),
                 "loss": ref["loss"], "items": len(items),
                 "reference": stores.load(t).REFERENCE.__name__,
                 "program": type(program.segmenter_config(cfg).swin).__name__}}
print(json.dumps(out))
"""


def _tree(root) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_backbone_task_and_store_are_files_only(tmp_path):
    """A later PR adds a model of another backbone, task and store by adding
    a module of each kind and a configuration, with no file that is there
    changed: the copies' twins of Swin, the supervised task and the
    PartImageNet store give the weights, the noise, the FLOP count and a
    reference step of the configuration they copy."""
    root = tmp_path / "checkout"
    shutil.copytree(run.HERE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree(root)
    for rel, text in TWINS.items():
        (root / "portbench" / rel).write_text(text)
    cfg = run.load_json(run.HERE, "configs", "m2f-swinL-supervised.json")
    m = cfg["model"]
    cfg.update(name="m2f-twin", task="supervised_twin",
               model={"swin_twin" if k == "swin" else k: v for k, v in m.items()})
    (root / "portbench" / "configs" / "m2f-twin.json").write_text(json.dumps(cfg))
    t = run.load_json(run.HERE, "traffic", "supervised_train.json")
    (root / "portbench" / "traffic" / "twin_train.json").write_text(
        json.dumps(dict(t, store="part_imagenet_twin")))
    code = TWIN_RUN.format(root=str(root), repo=run.ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["m2f-twin"] == got["m2f-swinL-supervised"]
    assert got["m2f-twin"]["items"] == 4 and got["m2f-twin"]["program"] == "SwinConfig"
    after = _tree(root)
    assert {k: v for k, v in after.items() if k in before} == before


# a module outside the lookups that named a backbone, or chose by task or
# store, would need an edit for a new one
LOOKUPS = ("backbones", "tasks", "stores", "roofline")
KIND = re.compile(r"""\[["']swin["']\]|\[["'](task|store)["']\]\s*(==|!=|in\b|not\b)""")


def test_only_the_lookups_name_a_backbone_task_or_store():
    found = []
    for d, _, files in os.walk(run.HERE):
        if os.path.relpath(d, run.HERE).split(os.sep)[0] in LOOKUPS:
            continue
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    found += [(f, i + 1, line.strip()) for i, line in enumerate(fh)
                              if KIND.search(line)]
    assert not found


def test_configs_state_their_sources_and_cuts():
    files = [c["file"] for c in BENCH["configs"]] + ["portbench/configs/m2f-swinL-proposal.json"]
    for f in files:
        cfg = run.load_json(run.ROOT, f)
        assert cfg["reduced"] == [] and cfg["assumed"] and cfg["sources"]
        assert cfg["precision"] == {"compute": "bfloat16", "parameters": "float32"}
        backbone, sw = backbones.load(cfg["model"])
        assert backbone.__name__ == "portbench.backbones.swin"
        assert (sw["embed_dim"], sw["depths"], sw["num_heads"], sw["window_size"]) == (
            192, [2, 2, 18, 2], [6, 12, 24, 48], 12)
