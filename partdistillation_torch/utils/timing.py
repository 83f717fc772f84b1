"""Kernel timing on the card and the card's bound for a kernel's work, shared
by ``chip_smoke.py`` and ``tools/torch_msda_bench.py``."""

from __future__ import annotations

__all__ = ["PEAK_BYTES_PER_S", "PEAK_BF16_FLOPS", "PEAK_F32_FLOPS", "time_ms", "device_ms",
           "steady", "bound"]

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls after ``warmup``, by
    CUDA events on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms per call of ``fn``: the summed durations of the kernels and
    copies it runs on the card over ``iters`` calls traced by
    ``torch.profiler`` after ``warmup``. Unlike ``time_ms`` it leaves out the
    gaps between launches, so it times a call that the host cannot keep
    busy (autograd's backward of a library call) by its kernels alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / iters


def steady(prefix: str, fn, timer=time_ms) -> dict:
    """``{prefix}ms``: the median of five reads of ``timer(fn)`` (``time_ms``
    or ``device_ms``), and ``{prefix}ms_range``: their min and max. One read
    of a library call can move by several times within a run."""
    t = sorted(timer(fn) for _ in range(5))
    return {f"{prefix}ms": t[2], f"{prefix}ms_range": [t[0], t[-1]]}


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(least ms, "bytes" | "operations") for the work at the card's peaks."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
