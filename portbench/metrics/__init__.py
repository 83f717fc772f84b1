"""One file per per-layer metric, named as the metric: ``read(record, cfg,
traffic)`` returns its value from a traced run's record, or None where the
run has nothing for it to read (the harness then leaves it out)."""
