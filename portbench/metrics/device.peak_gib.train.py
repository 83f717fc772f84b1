"""Peak device memory allocated over the train window, GiB."""

from portbench import readers


def read(record, cfg, traffic):
    return (None if not readers.traced(record, "train") or not record["peak_bytes"]
            else record["peak_bytes"] / 2**30)
