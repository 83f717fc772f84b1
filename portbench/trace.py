"""The traced window: ``torch.profiler`` over the first steps of a run's
measured window, reduced to what the per-layer metrics read.

From the Chrome trace: the device's busy seconds (the union of every kernel,
copy and fill interval), the traced window's length, device ms by the
program's ``record_function`` scope open at each kernel's launch (on any
thread: autograd launches the backward from its own), device ms by kernel
name, and the longest idle gaps of the device named by the host op running
through them. The scope attribution is the arithmetic of the program's
``utils/profiling.summarize_trace`` (a kernel's launch found by the CUDA
runtime call's correlation id, the launch matched to the scopes open at that
moment).
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import time
from typing import Dict, List, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SCOPES = ("backbone", "pixel_decoder", "transformer_decoder", "backward", "optimizer")


class Tracer:
    """Start with ``start()``, stop after the traced steps with ``stop()``
    (the caller synchronises first); ``summary(steps)`` reads the trace."""

    def __init__(self, out_dir: str, cuda: bool):
        self.out_dir, self.cuda = out_dir, cuda
        self.prof = None
        self.t0 = self.t1 = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def summary(self, steps: int) -> dict:
        path = os.path.join(self.out_dir, "window.pt.trace.json")
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        os.remove(path)
        return reduce_events(events, steps, self.t1 - self.t0)


def _union(intervals: List[tuple]) -> List[tuple]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def reduce_events(events: List[dict], steps: int, window_s: float) -> dict:
    """The trace's device time by scope and by kernel (ms a step), busy
    seconds, and the top device ops and idle gaps."""
    spans = collections.defaultdict(list)
    by_ext, launches, device, host = {}, {}, [], []
    for e in events:
        cat, args = e.get("cat"), e.get("args") or {}
        if cat == "user_annotation":
            spans[e["pid"]].append((e["ts"], e["ts"] + e["dur"], e["name"]))
        if cat in ("cpu_op", "user_annotation"):
            by_ext[args.get("External id")] = (e["pid"], e["ts"])
            host.append(e)
        elif cat in LAUNCH_CATS:
            launches[args.get("correlation")] = (e["pid"], e["ts"])
        elif cat in DEVICE_CATS:
            device.append(e)
    sorted_spans = {pid: sorted(s, key=lambda x: (x[0], -x[1])) for pid, s in spans.items()}
    starts = {pid: [s[0] for s in v] for pid, v in sorted_spans.items()}

    def scope_of(pid, ts) -> str:
        if pid not in sorted_spans or ts is None:
            return "<unscoped>"
        end = bisect.bisect_right(starts[pid], ts)
        for s0, s1, name in sorted_spans[pid][:end]:
            if ts <= s1 and name in SCOPES:
                return name
        return "<unscoped>"

    scope_ms = collections.Counter()
    kernel_ms = collections.Counter()
    intervals = []
    for e in device:
        args = e.get("args") or {}
        pid, ts = by_ext.get(args.get("External id"), (None, None))
        pid, ts = launches.get(args.get("correlation"), (pid, ts))
        ms = e["dur"] / 1e3 / max(steps, 1)
        scope_ms[scope_of(pid, ts)] += ms
        kernel_ms[e["name"]] += ms
        intervals.append((e["ts"], e["ts"] + e["dur"]))
    busy = _union(intervals)
    busy_s = sum(e - s for s, e in busy) / 1e6
    # idle gaps inside the busy span, named by the innermost host op running
    # at the gap's middle, else by the innermost scope open then
    gaps = [(busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
            for i in range(len(busy) - 1)]
    gaps.sort(reverse=True)
    ops = sorted((e for e in host if e.get("cat") == "cpu_op"), key=lambda e: e["ts"])
    op_starts = [e["ts"] for e in ops]
    all_spans = sorted((s for v in spans.values() for s in v), key=lambda x: x[0])
    named = collections.Counter()
    for dur, s, e in gaps[:200]:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(op_starts, mid)
        inside = [h for h in ops[max(0, i - 2000):i] if mid <= h["ts"] + h["dur"]]
        if inside:
            name = min(inside, key=lambda h: h["dur"])["name"]
        else:
            open_ = [sp for sp in all_spans if sp[0] <= mid <= sp[1]]
            name = min(open_, key=lambda sp: sp[1] - sp[0])[2] if open_ else "<host idle>"
        named[name] += dur / 1e6
    device_ops = [[short_name(k), v * max(steps, 1) / 1e3] for k, v in kernel_ms.most_common(10)]
    return {"scope_ms": dict(scope_ms), "kernel_ms": dict(kernel_ms), "busy_s": busy_s,
            "window_s": window_s, "steps": steps,
            "breakdown": {"device_ops": device_ops,
                          "idle_gaps": [[k, v] for k, v in named.most_common(10)]}}


def short_name(name: str, limit: int = 160) -> str:
    """A kernel's name without its return type and argument list, at most
    ``limit`` letters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += (name[i] == ")") - (name[i] == "(")
            if depth == 0:
                name = name[:i]
                break
    if name.startswith("void "):
        name = name[5:]
    return name[:limit]


def kernel_time_ms(kernel_ms: Dict[str, float], names: tuple,
                   exclude: Optional[tuple] = None) -> float:
    """ms a step of the kernels whose name contains one of ``names``."""
    return sum(v for k, v in kernel_ms.items()
               if any(n in k for n in names) and not any(x in k for x in (exclude or ())))
