"""What the per-layer metric files share: reading a traced run's record."""

from __future__ import annotations

import importlib
from typing import Optional

from .peaks import PEAK_BF16_FLOPS, least_ms
from .trace import kernel_time_ms


def traced(record: dict, loop: str) -> Optional[dict]:
    """The run's trace summary when the run is of ``loop``, was traced and
    its trace holds device time."""
    tr = record.get("trace")
    if record.get("loop") != loop or tr is None or tr["busy_s"] <= 0.0:
        return None
    return tr


def scope_ms(record: dict, loop: str, scope: str) -> Optional[float]:
    tr = traced(record, loop)
    if tr is None or scope not in tr["scope_ms"]:
        return None
    return tr["scope_ms"][scope]


def roofline(record: dict, cfg: dict, traffic: dict, loop: str, op: str) -> Optional[float]:
    """The op's least time at the cell's shapes over the device time of the
    kernels that implement it, in %; None where none of them ran."""
    tr = traced(record, loop)
    if tr is None:
        return None
    mod = importlib.import_module(f"portbench.roofline.{op}")
    ms = kernel_time_ms(tr["kernel_ms"], mod.KERNELS, mod.EXCLUDE)
    if ms <= 0.0:
        return None
    nbytes, flops = mod.work(cfg, traffic)
    return 100.0 * least_ms(nbytes, flops) / ms


def untraced_intervals(record: dict, loop: str) -> Optional[list]:
    """The traced run's intervals between step completions after the
    profiled steps, leaving out the first, which holds the profiler's stop;
    None where the run is not of ``loop`` or was not traced."""
    if record.get("loop") != loop or "trace" not in record:
        return None
    return record["intervals"][record["trace"]["steps"] + 1:]


def mfu(record: dict, loop: str) -> Optional[float]:
    """Model FLOPs of the traced run's untraced steps over their time on the
    host clock at the bf16 peak, in %."""
    steps = untraced_intervals(record, loop)
    if traced(record, loop) is None or not steps or not record.get("step_flops"):
        return None
    return 100.0 * record["step_flops"] * len(steps) / (sum(steps) * PEAK_BF16_FLOPS)
