"""Device ms a step in the segmenter's pixel_decoder scope (forward)."""

from portbench import readers


def read(record, cfg, traffic):
    return readers.scope_ms(record, "train", "pixel_decoder")
