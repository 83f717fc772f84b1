"""Profiling harness: trace a few steps with ``torch.profiler`` and attribute
device time to the model's components.

Counterpart of the JAX package's ``utils/profiling.py``. ``trace_steps``
wraps any step callable and writes a Chrome trace; ``summarize_trace`` reads
the traces in a directory and buckets each device kernel's time (and each
device copy or fill) by the ``torch.profiler.record_function`` scopes open
when it was launched: the segmenter's ``backbone``, ``pixel_decoder`` and
``transformer_decoder``, the Trainer's ``backward`` and ``optimizer``. A
kernel is matched to its launch through the CUDA runtime call's correlation
id, and the launch to every scope of the process that is open at that
moment, on any thread: autograd launches the backward's kernels from its own
thread while the caller waits inside ``backward``. A trace without device
events (a step on the CPU) is bucketed by its host ops instead, each
thread's outermost ops, as the JAX function falls back to host events.
"""

from __future__ import annotations

import bisect
import collections
import glob
import json
import os
from typing import Callable, Dict, Optional

__all__ = ["trace_steps", "summarize_trace", "TRACE_SUFFIX"]

TRACE_SUFFIX = ".pt.trace.json"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def trace_steps(step_fn: Callable[[], None], trace_dir: str,
                steps: int = 3, warmup: int = 1) -> str:
    """Run ``step_fn`` ``warmup`` times untraced, then ``steps`` times under
    ``torch.profiler.profile`` (CPU activity, and CUDA where a card is
    present; each step ends in a device synchronisation), and write the
    Chrome trace ``steps.pt.trace.json`` into ``trace_dir``. Returns
    ``trace_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()

    def run():
        step_fn()
        if cuda:
            torch.cuda.synchronize()

    for _ in range(warmup):
        run()
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        for _ in range(steps):
            run()
    prof.export_chrome_trace(os.path.join(trace_dir, "steps" + TRACE_SUFFIX))
    return trace_dir


class _Scopes:
    """The ``record_function`` scopes of one process, outermost first."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]

    def path(self, ts: float) -> list:
        """The names of the scopes open at ``ts``, outermost first."""
        end = bisect.bisect_right(self.starts, ts)
        return [name for start, stop, name in self.spans[:end] if ts <= stop]


def _samples(events: list) -> list:
    """(pid, launch or start time, op kind, duration µs) of every device
    event, or, without any, of every thread's outermost host op."""
    ops, device, launches, by_ext = [], [], {}, {}
    for e in events:
        cat, args = e.get("cat"), e.get("args") or {}
        if cat in ("cpu_op", "user_annotation"):
            by_ext[args.get("External id")] = (e["pid"], e["ts"],
                                               e["name"] if cat == "cpu_op" else None)
            if cat == "cpu_op":
                ops.append(e)
        elif cat in _LAUNCH_CATS:
            launches[args.get("correlation")] = (e["pid"], e["ts"])
        elif cat in _DEVICE_CATS:
            device.append(e)
    if device:
        out = []
        for e in device:
            args = e.get("args") or {}
            pid, ts, op = by_ext.get(args.get("External id"), (None, None, None))
            pid, ts = launches.get(args.get("correlation"), (pid, ts))
            out.append((pid, ts, op or e["name"], e["dur"]))
        return out
    out, ends = [], {}
    for e in sorted(ops, key=lambda e: (e["ts"], -e["dur"])):
        thread = (e["pid"], e["tid"])
        if e["ts"] >= ends.get(thread, float("-inf")):  # not inside an earlier op
            ends[thread] = e["ts"] + e["dur"]
            out.append((e["pid"], e["ts"], e["name"], e["dur"]))
    return out


def summarize_trace(trace_dir: str, steps: int = 3,
                    scope_depth: int = 4,
                    kind_filter: Optional[tuple] = None,
                    return_detail: bool = False) -> Dict[str, float]:
    """Device time in ms a step by scope, largest first, from the Chrome
    traces (``*.pt.trace.json``) in ``trace_dir``.

    A device event goes to the path of the scopes open at its launch,
    outermost first, cut to ``scope_depth`` levels and joined by ``/``; one
    launched outside every scope goes to ``<op>``, the host op that launched
    it (the kernel's own name when no op encloses the launch). Without
    device events the host ops' time takes the device's place.
    ``kind_filter``: keep only events whose op kind (the launching op's
    name, e.g. ``aten::mm``) starts with one of the given prefixes.
    ``return_detail``: also return ``{scope: {op kind: ms}}``. The JAX
    function's ``hlo_text`` has no counterpart: the scopes are in the trace.
    """
    bucket: collections.Counter = collections.Counter()
    detail: Dict[str, collections.Counter] = collections.defaultdict(collections.Counter)
    for path in sorted(glob.glob(os.path.join(trace_dir, "*" + TRACE_SUFFIX))):
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        spans = collections.defaultdict(list)
        for e in events:
            if e.get("cat") == "user_annotation":
                spans[e["pid"]].append((e["ts"], e["ts"] + e["dur"], e["name"]))
        scopes = {pid: _Scopes(s) for pid, s in spans.items()}
        for pid, ts, kind, dur in _samples(events):
            if kind_filter is not None and not kind.startswith(tuple(kind_filter)):
                continue
            names = scopes[pid].path(ts) if pid in scopes and ts is not None else []
            scope = "/".join(names[:scope_depth]) if names else f"<{kind}>"
            ms = dur / 1e3 / max(steps, 1)
            bucket[scope] += ms
            detail[scope][kind] += ms
    out = dict(bucket.most_common())
    if return_detail:
        return out, {k: dict(v.most_common()) for k, v in detail.items()}
    return out
