"""logmel_roofline.train (%): the log-mel kernel's least time over its
profiler device time, one launch a traced training step on this rank's
crops (None where the launches do not match the steps)."""

from perfbench.metrics import _counts


def read(cell, counts, trace):
    if trace is None or counts.get("kind") != "train":
        return None
    seconds, launches = trace.seconds(_counts.is_logmel)
    if launches != trace.units or seconds <= 0:
        return None
    rows = counts["rows_per_step"] // counts["ranks"]
    least = trace.units * _counts.logmel_least_s(cell.config, rows, counts["crop_samples"])
    return 100.0 * least / seconds
