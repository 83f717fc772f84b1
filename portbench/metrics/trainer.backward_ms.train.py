"""Device ms a step in the Trainer's backward scope."""

from portbench import readers


def read(record, cfg, traffic):
    return readers.scope_ms(record, "train", "backward")
