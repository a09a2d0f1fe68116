"""attn_pool_roofline.train (%): the attentive pooling's least time in a
training step, forward and backward, over the profiler device time of
the pooling kernels (forward, backward and their reductions) of the
traced steps."""

from perfbench.metrics import _counts


def read(cell, counts, trace):
    if trace is None or counts.get("kind") != "train":
        return None
    seconds, launches = trace.seconds(_counts.is_attn_pool)
    if launches == 0 or seconds <= 0:
        return None
    rows = counts["rows_per_step"] // counts["ranks"]
    least = trace.units * _counts.attn_pool_train_least_s(cell.config, rows, counts["crop_samples"])
    return 100.0 * least / seconds
