"""The profiler spans inside the port's train step and the readers of them,
on the CPU.

- ``kernel_op("x", ...)`` on CPU tensors (the plain version standing in for
  the kernel, no backward launcher) under ``torch.profiler``: one ``bwd.x``
  span encloses every op of the backward node's recomputation and VJP, and
  the gradients equal the plain version's own autograd bit for bit;
- a real CPU profile of a two-scope toy step (``backbone`` with a
  ``KernelOp`` and a sigmoid, ``criterion`` with a matmul, a ReLU and a
  sum): ``summarize_trace``'s ``backward_by_scope`` gives each backward node
  to the scope whose forward made it, the ``KernelOp``'s node with the
  nodes it rebuilds and runs inside its own backward;
- a Chrome trace written here, one step of a card's trace in miniature
  with the benchmark's spans around the program's: the backward's kernels
  by forward part (a node rebuilt on autograd's thread whose sequence
  number repeats a forward op's of another part goes with its outer node),
  the device's idle time by span (a gap under ``matcher.lsap`` counts for
  ``matcher``, one under ``portbench.step`` alone as unattributed), device
  and host time by span, to 1e-12;
- the same trace read by the benchmark's ``portbench/trace.reduce_events``
  with and without the program's spans: every number the benchmark's
  metrics read is unchanged, and the idle gaps (the ten largest names) take
  the program's names;
- ``DataLoader.stats()``: a slow mapper leaves the queue empty when batches
  are asked for, a prefilled queue never;
- ``tools/torch_train_profile.py``'s training loop of a tiny benchmark
  configuration: the loader's counters over the traced steps, the host time
  of ``loader.wait``, ``data.pack`` and the matcher, the idle time by span.
"""

import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from partdistillation_torch.data.loader import DataLoader
from partdistillation_torch.ops.autograd import kernel_op
from partdistillation_torch.utils.profiling import (SPANS, TRACE_SUFFIX, summarize_trace,
                                                    trace_steps)

EVALUATE = "autograd::engine::evaluate_function: "


def _toy(x, w):
    return torch.tanh(x @ w) * 2.0


def _events(prof, tmp_path):
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]


def test_named_plain_vjp_span_encloses_its_backward(tmp_path):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 16, generator=g)
    w = torch.randn(16, 16, generator=g)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    _toy(xr, wr).square().sum().backward()
    plain = (xr.grad, wr.grad)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        kernel_op("x", _toy, _toy, xr, wr).square().sum().backward()
    events = _events(prof, tmp_path)
    spans = [e for e in events if e["cat"] == "user_annotation" and e["name"].startswith("bwd.")]
    assert [e["name"] for e in spans] == ["bwd.x"]
    (node,) = [e for e in events if e["name"] == EVALUATE + "KernelOpBackward"]
    span = spans[0]
    assert node["ts"] <= span["ts"] and span["ts"] + span["dur"] <= node["ts"] + node["dur"]
    inner = [e for e in events if e["cat"] == "cpu_op" and e["name"].startswith("aten::")
             and node["ts"] <= e["ts"] <= node["ts"] + node["dur"]]
    assert any(e["name"] == "aten::tanh" for e in inner)  # the recomputation
    for e in inner:
        assert span["ts"] <= e["ts"] and e["ts"] + e["dur"] <= span["ts"] + span["dur"], e
    for a, b in zip((xr.grad, wr.grad), plain):
        assert torch.equal(a, b)


def test_backward_by_scope_on_a_cpu_profile(tmp_path):
    g = torch.Generator().manual_seed(1)
    w1 = torch.randn(32, 32, generator=g, requires_grad=True)
    w2 = torch.randn(32, 32, generator=g, requires_grad=True)
    x = torch.randn(16, 32, generator=g)
    want = {"KernelOpBackward": "backbone", "SigmoidBackward0": "backbone",
            "MmBackward0": "criterion", "ReluBackward0": "criterion",
            "SumBackward0": "criterion"}

    def step():
        with record_function("backbone"):
            h = torch.sigmoid(kernel_op("toy", _toy, _toy, x, w1))
        with record_function("criterion"):
            y = (h @ w2).relu().sum()
        with record_function("backward"):
            y.backward()

    d = trace_steps(step, str(tmp_path / "tr"), steps=2)
    _, detail = summarize_trace(d, steps=2, return_detail=True)
    got = detail["backward_by_scope"]
    events = json.loads((tmp_path / "tr" / ("steps" + TRACE_SUFFIX)).read_text())["traceEvents"]
    events = [e for e in events if e.get("ph") == "X"]
    # the backward's outermost host ops on the CPU: each node's evaluate_function
    backward = [e for e in events if e["name"] == "backward"]
    ops = sorted((e for e in events if e.get("cat") == "cpu_op"
                  and any(b["ts"] <= e["ts"] <= b["ts"] + b["dur"] for b in backward)),
                 key=lambda e: (e["ts"], -e["dur"]))
    expect, end, nested = {}, float("-inf"), 0
    for e in ops:
        if e["ts"] < end:
            nested += e["name"].startswith(EVALUATE)
            continue
        end = e["ts"] + e["dur"]
        node = e["name"][len(EVALUATE):] if e["name"].startswith(EVALUATE) else None
        scope = want.get(node, "<unlinked>")
        expect[scope] = expect.get(scope, 0.0) + e["dur"] / 2e3
    assert nested >= 2  # the KernelOp's rebuilt nodes ran inside it
    assert set(got) == set(expect) and {"backbone", "criterion"} <= set(got)
    for k, v in expect.items():
        assert abs(got[k] - v) <= 1e-9, (k, got[k], v)


def _x(name, cat, tid, ts, dur, pid=7, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts,
            "dur": dur, "args": args}


def _fixture():
    """One step of a card's trace: the main thread tid 1, autograd's thread
    tid 2, the device's stream tid 7 of pid 0; µs."""
    span = [("portbench.step", 0, 2000), ("step.prepare", 0, 50), ("backbone", 50, 250),
            ("pixel_decoder", 300, 100), ("transformer_decoder", 400, 100),
            ("criterion", 500, 400), ("matcher", 600, 250), ("matcher.to_host", 600, 100),
            ("matcher.lsap", 700, 100), ("matcher.to_device", 800, 50),
            ("backward", 900, 600), ("optimizer", 1500, 100), ("step.readback", 1600, 100),
            ("portbench.data", 2000, 400), ("loader.wait", 2000, 300),
            ("data.pack", 2300, 100), ("portbench.step", 2400, 200),
            ("step.prepare", 2400, 50)]
    events = [_x(n, "user_annotation", 1, ts, dur) for n, ts, dur in span]
    events.append(_x("bwd.ln_mlp", "user_annotation", 2, 1065, 285))
    fwd = {"Fwd thread id": 0}
    # forward ops, numbered 100..104 on the main thread
    events += [_x("aten::mm", "cpu_op", 1, 60, 10, **fwd, **{"Sequence number": 100}),
               _x("KernelOp", "cpu_op", 1, 100, 20, **fwd, **{"Sequence number": 101}),
               _x("aten::add", "cpu_op", 1, 310, 10, **fwd, **{"Sequence number": 102}),
               _x("aten::mm", "cpu_op", 1, 410, 10, **fwd, **{"Sequence number": 103}),
               _x("aten::mul", "cpu_op", 1, 510, 5, **fwd, **{"Sequence number": 104}),
               _x("aten::ones_like", "cpu_op", 1, 905, 3)]

    def node(name, ts, dur, seq=None, thread=1):
        args = {} if seq is None else {"Sequence number": seq, "Fwd thread id": thread}
        return _x(EVALUATE + name, "cpu_op", 2, ts, dur, **args)

    events += [node("MulBackward0", 910, 40, 104), node("MmBackward0", 960, 40, 103),
               node("AddBackward0", 1010, 40, 102), node("KernelOpBackward", 1060, 300, 101),
               # the rebuilt plain graph: autograd's thread numbers its ops
               # and nodes from its own counter, here repeating 103
               _x("aten::mm", "cpu_op", 2, 1070, 10, **fwd, **{"Sequence number": 103}),
               node("MmBackward0", 1100, 50, 103, thread=2),
               node("MmBackward0", 1400, 40, 100),
               node("torch::autograd::AccumulateGrad", 1450, 10)]
    # (correlation, launching thread, launch time, device start, duration, kind)
    device = [(1, 1, 65, 70, 100, "kernel"), (2, 1, 110, 170, 130, "kernel"),
              (3, 1, 312, 320, 80, "kernel"), (4, 1, 412, 420, 80, "kernel"),
              (5, 1, 512, 520, 90, "kernel"), (6, 1, 605, 615, 25, "gpu_memcpy"),
              (7, 1, 805, 810, 10, "gpu_memcpy"), (15, 1, 906, 910, 5, "kernel"),
              (8, 2, 920, 930, 30, "kernel"), (9, 2, 970, 975, 25, "kernel"),
              (10, 2, 1020, 1025, 25, "kernel"), (11, 2, 1075, 1080, 20, "kernel"),
              (12, 2, 1110, 1115, 85, "kernel"), (13, 2, 1410, 1415, 25, "kernel"),
              (14, 2, 1455, 1460, 10, "kernel"), (16, 1, 1512, 1520, 40, "kernel"),
              (17, 1, 2410, 2420, 80, "kernel")]
    for corr, tid, launch, start, dur, cat in device:
        events.append(_x("cudaLaunchKernel", "cuda_runtime", tid, launch, 2, correlation=corr))
        events.append(_x(f"k{corr}", cat, 7, start, dur, pid=0, correlation=corr))
    return events


def _write(tmp_path, events):
    d = tmp_path / "tr"
    d.mkdir()
    (d / ("steps" + TRACE_SUFFIX)).write_text(json.dumps({"traceEvents": events}))
    return str(d)


def test_readers_on_a_written_trace(tmp_path):
    _, detail = summarize_trace(_write(tmp_path, _fixture()), steps=2, return_detail=True)
    ms = 2e3  # µs in a step's ms, two steps

    def check(table, want):
        assert set(table) == set(want), set(table) ^ set(want)
        for k, v in want.items():
            assert abs(table[k] - v / ms) <= 1e-12, (k, table[k], v / ms)

    # the rebuilt MmBackward0 (103) goes with its KernelOpBackward (101),
    # not with the decoder's forward op 103
    check(detail["backward_by_scope"], {"backbone": 20 + 85 + 25, "pixel_decoder": 25,
                                        "transformer_decoder": 25, "criterion": 30,
                                        "<unlinked>": 10 + 5})
    check(detail["idle_by_span"], {
        "portbench.step": 1170, "portbench.data": 400, "step.prepare": 20, "backbone": 0,
        "pixel_decoder": 20, "transformer_decoder": 20, "criterion": 275, "matcher": 205,
        "matcher.to_host": 65, "matcher.lsap": 100, "matcher.to_device": 40,
        "backward": 375, "bwd.ln_mlp": 180, "optimizer": 60, "step.readback": 100,
        "loader.wait": 300, "data.pack": 100, "<unattributed>": 300, "<idle>": 1570})
    by_span = detail["device_by_span"]
    for k, v in {"bwd.ln_mlp": 105, "matcher": 35, "backward": 225, "criterion": 125,
                 "portbench.step": 860}.items():
        assert abs(by_span[k] - v / ms) <= 1e-12, k
    host = detail["host_by_span"]
    assert abs(host["matcher.lsap"] - 100 / ms) <= 1e-12
    assert abs(host["step.prepare"] - 100 / ms) <= 1e-12


def test_benchmark_reader_unchanged_by_the_program_spans():
    from portbench.trace import reduce_events

    events = _fixture()
    bare = [e for e in events if not (e["cat"] == "user_annotation" and e["name"] in SPANS)]
    assert len(bare) < len(events)
    old, new = reduce_events(bare, 2, 3.0), reduce_events(events, 2, 3.0)
    assert set(old) == set(new)
    for k in old:
        if k != "breakdown":
            assert new[k] == old[k], k
    assert new["breakdown"]["device_ops"] == old["breakdown"]["device_ops"]
    assert old["scope_ms"]["backward"] == pytest.approx(225 / 2e3, abs=1e-12)
    gaps_old, gaps_new = (dict(r["breakdown"]["idle_gaps"]) for r in (old, new))
    assert sum(gaps_old.values()) == pytest.approx(1570e-6, abs=1e-12)  # every gap, named
    assert gaps_old["portbench.step"] > gaps_new["portbench.step"]
    assert gaps_new["matcher.lsap"] == pytest.approx(170e-6, abs=1e-12)  # 640-810, mid 725
    assert "matcher.lsap" not in gaps_old


def _stats_after(loader, n):
    it = iter(loader)
    for _ in range(n):
        next(it)
    return loader.stats()


def test_loader_counts_empty_takes():
    items = [{"i": i} for i in range(16)]

    def slow(item):
        time.sleep(0.05)
        return {"x": [item["i"]]}

    loader = DataLoader(items, slow, 1, num_workers=1, prefetch=1)
    try:
        stats = _stats_after(loader, 3)
    finally:
        loader.close()
    assert stats["taken"] == 3 and 2 <= stats["taken_empty"] <= 3, stats
    assert all(isinstance(v, int) for v in stats.values())

    loader = DataLoader(items, lambda item: {"x": [item["i"]]}, 1, num_workers=1, prefetch=4)
    try:
        deadline = time.monotonic() + 30.0
        while not loader._q.full() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert loader._q.full()
        assert _stats_after(loader, 4) == {"taken": 4, "taken_empty": 0}
    finally:
        loader.close()


def test_train_profile_loop_reads_the_loader_and_wire_format(tmp_path):
    from portbench.tests.tiny import tiny_config, tiny_traffic
    from tools.torch_train_profile import profile_loop

    steps = 2
    loop, step_ms, host, trace = profile_loop(
        tiny_config("m2f-swinL-supervised"), tiny_traffic("supervised_train"), 2 ** 31 + 7,
        "cpu", steps, 1, tmp_path / "trace", "tiny", "cpu")
    assert loop["loader"]["taken"] == steps
    assert 0 <= loop["loader"]["taken_empty"] <= steps
    assert 0.0 <= loop["queue_empty_share"] <= 1.0
    assert len(loop["untraced_step_ms"]) == 1
    assert host["loader.wait"] > 0 and host["data.pack"] > 0 and host["matcher.lsap"] > 0
    assert step_ms["backward"] > 0 and step_ms["criterion"] > 0
    assert sum(step_ms["backward_op_kinds"]["backward"].values()) > 0
    idle = trace["idle_by_span_ms"]
    assert {"loader.wait", "data.pack", "<unattributed>", "<idle>"} <= set(idle)
    # every span of SPANS but the bwd.* ones, which the kernels' (CUDA) path opens
    assert trace["program_spans"] == 9 and trace["span_cost_off_us"] > 0
