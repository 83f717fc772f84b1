"""Run one cell of the port's benchmark once and print its result line.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in ``BENCHMARK.json``; its configuration
(``configs/<config>.json``), traffic (``traffic/<traffic>.json``) and limits
(``limits/<cell>.json``) are files of their own, and each per-layer metric
is read by ``metrics/<name>.py``. The run measures ``partdistillation_torch``
on the card: set-up (data, weights, trainer, the checked and warm-up steps),
then a window of ``--seconds``, then the comparison with the plain
reference. With ``--trace 0`` the result holds the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics from a profiled window.
The last line of standard output is one JSON object; the numbers compared
for ``correct`` close standard error and the result line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "partdistillation_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(bench: dict, name: str, root: str = ROOT):
    """(workload entry, config, traffic, limits) of cell ``name``, read
    from the files of those names under ``root``'s ``portbench/``."""
    here = os.path.join(root, "portbench")
    for wl in bench["workloads"]:
        if wl["name"] == name:
            conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
            return (wl, load_json(root, conf["file"]),
                    load_json(here, "traffic", wl["traffic"] + ".json"),
                    load_json(here, "limits", name + ".json"))
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def end_to_end(record: dict, wl: dict, bench: dict) -> dict:
    out = {}
    values = {"setup_s": record["setup_s"],
              "train_img_per_s": record["images"] / record["window_s"]}
    for m in bench["end_to_end"]:
        if "workloads" in m and wl["name"] not in m["workloads"]:
            continue
        if m["name"] in values:
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def per_layer(record: dict, wl: dict, bench: dict, cfg: dict, traffic: dict) -> dict:
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and wl["name"] not in m["workloads"]:
            continue
        path = os.path.join(HERE, "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(out)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(record, cfg, traffic)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_json(ROOT, "BENCHMARK.json")
    wl, cfg, traffic, limits = cell(bench, args.workload)
    sys.path.insert(0, ROOT)
    # the program's kernel caches at fixed paths inside the checkout (its own
    # CUDA library is built into build/torch_kernels/ there)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "portbench", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "portbench", "extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    import torch

    import partdistillation_torch  # noqa: F401  (absent: no result)

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"portbench: {wl['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    if traffic["loop"] != "train":
        raise SystemExit(f"unknown loop {traffic['loop']!r}")
    from portbench import train

    record = train.run(cfg, traffic, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), T_START, limits)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    result = result_line(record, wl, bench, cfg, traffic, bool(args.trace),
                         torch.cuda.get_device_name(0))
    for k, v in record["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def result_line(record: dict, wl: dict, bench: dict, cfg: dict, traffic: dict, trace: bool,
                kind: str) -> dict:
    """The result object of a run's record; the compared numbers come last."""
    metrics = (per_layer(record, wl, bench, cfg, traffic) if trace
               else end_to_end(record, wl, bench))
    device = {"platform": "gpu", "kind": kind, "count": wl["chips"],
              "memory_peak_bytes": int(record["peak_bytes"])}
    result = {"correct": bool(record["correct"]), "attempted": record["steps"],
              "failed": record["failed"], "metrics": metrics, "device": device}
    if trace:
        tr = record["trace"]
        device["busy_s"], device["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = tr["breakdown"]
    result["checks"] = record["checks"]
    return result


if __name__ == "__main__":
    sys.exit(main())
