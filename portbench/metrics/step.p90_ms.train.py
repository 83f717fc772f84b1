"""The 90th percentile of the intervals between successive step completions
in the traced run's window, leaving out the profiled steps and the profiler's
stop (host clock), ms."""

import statistics

from portbench import readers


def read(record, cfg, traffic):
    steps = readers.untraced_intervals(record, "train")
    if steps is None or len(steps) < 10:
        return None
    return 1e3 * statistics.quantiles(steps, n=10, method="inclusive")[8]
