"""Device ms a train step of ViTDet's attention kernels, forward and
backward (``relpos_attn_*`` by name); None where none ran."""

from portbench import readers
from portbench.trace import kernel_time_ms


def read(record, cfg, traffic):
    tr = readers.traced(record, "train")
    ms = None if tr is None else kernel_time_ms(tr["kernel_ms"], ("relpos_attn_",))
    return ms or None
