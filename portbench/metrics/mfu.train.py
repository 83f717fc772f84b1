"""Model FLOPs of the traced run's untraced train steps over their time on
the host clock at the bf16 peak, %."""

from portbench import readers


def read(record, cfg, traffic):
    return readers.mfu(record, "train")
