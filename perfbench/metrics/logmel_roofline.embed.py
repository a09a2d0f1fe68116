"""logmel_roofline.embed (%): the log-mel kernel's least time over its
profiler device time, one launch a batch the embedder handed its step in
the traced requests, each on the whole batch it was given (None where the
launches do not match the batches)."""

from perfbench.metrics import _counts


def read(cell, counts, trace):
    if trace is None or counts.get("kind") != "embed":
        return None
    calls = counts["trace_calls"]
    seconds, launches = trace.seconds(_counts.is_logmel)
    if launches != len(calls) or seconds <= 0:
        return None
    least = sum(_counts.logmel_least_s(cell.config, rows, samples) for rows, samples in calls)
    return 100.0 * least / seconds
