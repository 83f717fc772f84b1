"""One file per kernel: ``KERNELS`` (substrings of the device kernels'
names that implement it), ``EXCLUDE`` (substrings that rule a name out),
``SCOPE`` (the program's scope its launches run in, or None) and
``work(cfg, traffic) -> (bytes, flops)`` of one step at the cell's shapes,
each input byte read once and each output byte written once."""
