"""ms a step the train loop waits for its next batch and packs it into the
wire format (host clock), mean over the traced run's window steps."""


def read(record, cfg, traffic):
    if record.get("loop") != "train" or "trace" not in record:
        return None
    return 1e3 * sum(record["waits"]) / len(record["waits"])
