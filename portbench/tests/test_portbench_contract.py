"""BENCHMARK.json keeps to the benchmark's contract, and every cell's files
resolve by name."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from portbench import run

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
    assert cfg["task"] == "proposal" and traffic["batch"] == 8 and "image_coef_gap" in limits
    t = run.load_json(run.HERE, "traffic", "stage3_train.json")
    t["images"] = 64
    (root / "portbench" / "traffic" / "stage3_small.json").write_text(json.dumps(t))
    (root / "portbench" / "limits" / "proposal.small.json").write_text(
        json.dumps({"feature_gap": 1, "change_gap": 1}))
    bench["workloads"].append({"name": "proposal.small", "config": "m2f-swinL-proposal",
                               "traffic": "stage3_small", "chips": 1, "why": "x"})
    wl, cfg, traffic, limits = run.cell(bench, "proposal.small", str(root))
    assert traffic["images"] == 64 and cfg["name"] == "m2f-swinL-proposal"


def test_configs_state_their_sources_and_cuts():
    files = [c["file"] for c in BENCH["configs"]] + ["portbench/configs/m2f-swinL-proposal.json"]
    for f in files:
        cfg = run.load_json(run.ROOT, f)
        assert cfg["reduced"] == [] and cfg["assumed"] and cfg["sources"]
        assert cfg["precision"] == {"compute": "bfloat16", "parameters": "float32"}
        sw = cfg["model"]["swin"]
        assert (sw["embed_dim"], sw["depths"], sw["num_heads"], sw["window_size"]) == (
            192, [2, 2, 18, 2], [6, 12, 24, 48], 12)
