"""The deformable sampling's backward kernels' share of their roofline in a
train step, %."""

from portbench import readers


def read(record, cfg, traffic):
    return readers.roofline(record, cfg, traffic, "train", "msda_bwd")
