"""Share of the traced train window in which no kernel, copy or fill ran, %."""

from portbench import readers


def read(record, cfg, traffic):
    tr = readers.traced(record, "train")
    return None if tr is None else 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
