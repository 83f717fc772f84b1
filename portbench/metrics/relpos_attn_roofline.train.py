"""ViTDet's attention forward kernel's share of its roofline in a train
step, %."""

from portbench import readers


def read(record, cfg, traffic):
    return readers.roofline(record, cfg, traffic, "train", "relpos_attn")
