"""Profiling harness: trace a few steps with ``torch.profiler`` and attribute
device time to the model's components.

Counterpart of the JAX package's ``utils/profiling.py``. ``trace_steps``
wraps any step callable and writes a Chrome trace; ``summarize_trace`` reads
the traces in a directory and buckets each device kernel's time (and each
device copy or fill) by the ``torch.profiler.record_function`` scopes open
when it was launched: the segmenter's and the Trainer's ``SCOPES`` and the
program's ``SPANS`` inside them. A kernel is matched to its launch through
the CUDA runtime call's correlation id, and the launch to every scope of the
process that is open at that moment, on any thread: autograd launches the
backward's kernels from its own thread while the caller waits inside
``backward``. A trace without device events (a step on the CPU) is bucketed
by its host ops instead, each thread's outermost ops, as the JAX function
falls back to host events.

Two readers link what the scopes alone cannot. The backward by forward
part: each backward kernel goes, through the op that launched it, to the
outermost ``autograd::engine::evaluate_function`` event around the launch on
its thread, and that event's ``Sequence number`` to the forward op of the
same number on the forward's thread, whose outermost ``FORWARD_SCOPES``
scope takes it (the JAX profile gets the same from the compiled program's
metadata). Only the outermost event is matched: a ``KernelOp`` without a
backward kernel rebuilds its plain version's graph on autograd's thread,
whose numbers may repeat the forward thread's. The device's idle time by span: the gaps between the
device's busy intervals, inside the busy span, intersected with each span's
intervals, all on the profiler's clock.

The spans cost one ``record_function`` entry each with the profiler off, and
read no device value.
"""

from __future__ import annotations

import bisect
import collections
import glob
import json
import os
from typing import Callable, Dict, List, NamedTuple, Optional

__all__ = ["trace_steps", "summarize_trace", "TRACE_SUFFIX", "SCOPES", "FORWARD_SCOPES",
           "SPANS"]

TRACE_SUFFIX = ".pt.trace.json"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_EVALUATE = "autograd::engine::evaluate_function"

# the segmenter's three parts and the Trainer's two phases
SCOPES = ("backbone", "pixel_decoder", "transformer_decoder", "backward", "optimizer")
# the forward parts a backward kernel is attributed to
FORWARD_SCOPES = ("backbone", "pixel_decoder", "transformer_decoder", "criterion")
SPANS = (
    "bwd.layer_norm",        # LayerNorm's plain VJP, on autograd's thread
    "bwd.ln_mlp",            # the fused LN->MLP's backward kernels
    "bwd.window_attn",       # window attention's plain VJP
    "bwd.window_attn_proj",  # window attention + output projection's plain VJP
    "bwd.masked_attn",       # the masked attention's backward kernel (#5)
    "bwd.msda",              # deformable sampling's backward: #7's kernel, the others' plain VJP
    "bwd.relpos_attn",       # ViTDet's attention backward kernels (ops/relpos_attention)
    "vit.window_attn",       # ViTDet's window attention forward: tables and kernel
    "vit.global_attn",       # ViTDet's global attention forward: tables and kernel
    "vit.sfp",               # ViTDet's simple feature pyramid
    "criterion",             # set_criterion: every stage's loss after the model's forward
    "matcher",               # hungarian_match: the costs and their host round trip
    "matcher.to_host",       # the costs' copy to the host, which waits for the forward
    "matcher.lsap",          # the host LSAP of every supervised layer and image
    "matcher.to_device",     # the assignments' copy back to the device
    "step.prepare",          # Trainer.train_step's batch_prepare: upload and unpack
    "step.readback",         # the metrics' readback: the host waits for the step's end
    "data.pack",             # the wire format's host side (run._pack_train_batch)
    "loader.wait",           # the consumer waiting on the DataLoader's prefetch queue
)


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


class _Sample(NamedTuple):
    """A device event (or, without any, a thread's outermost host op): the
    process, thread and time of its launch, its op kind, and the interval
    it kept the device busy (µs)."""
    pid: object
    tid: object
    ts: Optional[float]
    kind: str
    start: float
    dur: float


def _samples(events: list) -> List[_Sample]:
    """Every device event, or, without any, every thread's outermost host
    op."""
    ops, device, launches, by_ext = [], [], {}, {}
    for e in events:
        cat, args = e.get("cat"), e.get("args") or {}
        if cat in ("cpu_op", "user_annotation"):
            by_ext[args.get("External id")] = (e["pid"], e["tid"], e["ts"],
                                               e["name"] if cat == "cpu_op" else None)
            if cat == "cpu_op":
                ops.append(e)
        elif cat in _LAUNCH_CATS:
            launches[args.get("correlation")] = (e["pid"], e["tid"], e["ts"])
        elif cat in _DEVICE_CATS:
            device.append(e)
    if device:
        out = []
        for e in device:
            args = e.get("args") or {}
            pid, tid, ts, op = by_ext.get(args.get("External id"), (None, None, None, None))
            pid, tid, ts = launches.get(args.get("correlation"), (pid, tid, ts))
            out.append(_Sample(pid, tid, ts, op or e["name"], e["ts"], e["dur"]))
        return out
    return [_Sample(e["pid"], e["tid"], e["ts"], e["name"], e["ts"], e["dur"])
            for e in _outermost(ops)]


def _outermost(events: list) -> list:
    """The events not inside an earlier one of their thread, by start."""
    out, ends = [], {}
    for e in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        thread = (e["pid"], e["tid"])
        if e["ts"] >= ends.get(thread, float("-inf")):
            ends[thread] = e["ts"] + e["dur"]
            out.append(e)
    return out


def _paths(spans: Dict[object, list], queries: list) -> List[list]:
    """For each (pid, ts) of ``queries``, the names of the process's spans
    ((start, stop, name)) open at ``ts``, outermost first (earlier start,
    then longer): one sweep a process over its spans and the sorted times."""
    out: List[list] = [[] for _ in queries]
    by_pid = collections.defaultdict(list)
    for i, (pid, ts) in enumerate(queries):
        if pid in spans and ts is not None:
            by_pid[pid].append(i)
    for pid, idx in by_pid.items():
        idx.sort(key=lambda i: queries[i][1])
        ordered = sorted(spans[pid], key=lambda s: (s[0], -s[1]))
        active, n = [], 0
        for i in idx:
            ts = queries[i][1]
            while n < len(ordered) and ordered[n][0] <= ts:
                active.append(ordered[n])
                n += 1
            active = [s for s in active if ts <= s[1]]
            out[i] = [s[2] for s in active]
    return out


def _union(intervals) -> List[tuple]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def _overlap(a: List[tuple], b: List[tuple]) -> float:
    """Total length of the intersection of two sorted disjoint interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _idle_by_span(samples: List[_Sample], events: list) -> Dict[str, float]:
    """µs of device idle under each span name (every span of the trace), the
    idle time under no span of ``SCOPES`` or ``SPANS`` (``<unattributed>``)
    and all of it (``<idle>``)."""
    busy = _union((s.start, s.start + s.dur) for s in samples)
    idle = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    by_name = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation":
            by_name[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    out = {name: _overlap(idle, _union(ivs)) for name, ivs in by_name.items()}
    total = sum(e - s for s, e in idle)
    program = _union(iv for name in SCOPES + SPANS for iv in by_name.get(name, ()))
    out["<unattributed>"] = total - _overlap(idle, program)
    out["<idle>"] = total
    return out


def _backward_scopes(events: list, spans: Dict[object, list]):
    """``scope_at(pid, tid, ts)``: the ``FORWARD_SCOPES`` scope of the
    forward op that made the backward node whose outermost
    ``evaluate_function`` event encloses ``ts`` on that thread; ``<unlinked>``
    without such an event or op, ``<unscoped>`` for an op outside them."""
    evaluate, numbered = collections.defaultdict(list), []
    for e in events:
        if e.get("cat") != "cpu_op":
            continue
        if e["name"].startswith(_EVALUATE):
            evaluate[(e["pid"], e["tid"])].append(e)
        elif "Sequence number" in (e.get("args") or {}):
            numbered.append(e)
    outer = {k: _outermost(v) for k, v in evaluate.items()}
    starts = {k: [e["ts"] for e in v] for k, v in outer.items()}

    def enclosing(key, ts):
        i = bisect.bisect_right(starts.get(key, ()), ts) - 1
        if i >= 0 and ts <= outer[key][i]["ts"] + outer[key][i]["dur"]:
            return i
        return None

    # the forward ops: numbered ops outside every backward node of their
    # thread; the last op of a number made its node
    forward = collections.defaultdict(dict)
    for e in sorted(numbered, key=lambda e: e["ts"]):
        key = (e["pid"], e["tid"])
        if enclosing(key, e["ts"]) is None:
            forward[key][e["args"]["Sequence number"]] = (e["pid"], e["ts"])
    # the profiler names the forward thread by its own id: take the thread
    # whose forward ops carry most of that id's numbers
    votes = collections.Counter()
    for evs in outer.values():
        for e in evs:
            args = e.get("args") or {}
            seq = args.get("Sequence number")
            for key, numbers in forward.items():
                if seq is not None and seq in numbers:
                    votes[(args.get("Fwd thread id"), key)] += 1
    thread_of = {}
    for (fwd_id, key), _ in sorted(votes.items(), key=lambda kv: kv[1]):
        thread_of[fwd_id] = key
    links, where = [], []
    for key, evs in outer.items():
        for i, e in enumerate(evs):
            args = e.get("args") or {}
            op = forward.get(thread_of.get(args.get("Fwd thread id")), {}).get(
                args.get("Sequence number"))
            if op is not None:
                links.append(op)
                where.append((key, i))
    scope = {k: ["<unlinked>"] * len(v) for k, v in outer.items()}
    for (key, i), names in zip(where, _paths(spans, links)):
        scope[key][i] = next((n for n in names if n in FORWARD_SCOPES), "<unscoped>")

    def scope_at(pid, tid, ts):
        i = enclosing((pid, tid), ts) if ts is not None else None
        return "<unlinked>" if i is None else scope[(pid, tid)][i]

    return scope_at


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
    ``return_detail``: also return ``{scope: {op kind: ms}}``, with four
    more entries, each in ms a step:
    ``backward_by_scope`` (the ``backward`` scope's device time by the
    forward part its nodes differentiate: ``FORWARD_SCOPES``,
    ``<unscoped>``, ``<unlinked>``), ``device_by_span`` (device time
    launched while each span is open, nested ones counting for each),
    ``idle_by_span`` (the device's idle time while each span is open on any
    thread, ``<unattributed>`` under none of ``SCOPES`` and ``SPANS``, all of
    it as ``<idle>``) and ``host_by_span`` (each span's own host time).
    ``kind_filter`` leaves the idle and host times whole. The JAX function's
    ``hlo_text`` has no counterpart: the scopes are in the trace.
    """
    per_step = 1e3 * max(steps, 1)
    bucket: collections.Counter = collections.Counter()
    detail: Dict[str, collections.Counter] = collections.defaultdict(collections.Counter)
    backward, by_span, idle, host = (collections.Counter() for _ in range(4))
    for path in sorted(glob.glob(os.path.join(trace_dir, "*" + TRACE_SUFFIX))):
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        spans = collections.defaultdict(list)
        for e in events:
            if e.get("cat") == "user_annotation":
                spans[e["pid"]].append((e["ts"], e["ts"] + e["dur"], e["name"]))
                host[e["name"]] += e["dur"] / per_step
        samples = _samples(events)
        if return_detail:
            idle.update({k: v / per_step for k, v in _idle_by_span(samples, events).items()})
            scope_at = _backward_scopes(events, spans)
        if kind_filter is not None:
            samples = [s for s in samples if s.kind.startswith(tuple(kind_filter))]
        for s, names in zip(samples, _paths(spans, [(s.pid, s.ts) for s in samples])):
            scope = "/".join(names[:scope_depth]) if names else f"<{s.kind}>"
            ms = s.dur / per_step
            bucket[scope] += ms
            detail[scope][s.kind] += ms
            if return_detail:
                for name in set(names):
                    by_span[name] += ms
                if "backward" in names:
                    backward[scope_at(s.pid, s.tid, s.ts)] += ms
    out = dict(bucket.most_common())
    if return_detail:
        full = {k: dict(v.most_common()) for k, v in detail.items()}
        full.update(backward_by_scope=dict(backward.most_common()),
                    device_by_span=dict(by_span.most_common()),
                    idle_by_span=dict(idle.most_common()),
                    host_by_span=dict(host.most_common()))
        return out, full
    return out
