"""idle_share.train (%): 1 - (union of the device's operations) / (wall
time) of the traced training steps, averaged over the ranks."""


def read(cell, counts, trace):
    if trace is None or counts.get("kind") != "train":
        return None
    ranks = counts.get("trace_ranks") or [trace]
    if min(t.busy_s for t in ranks) <= 0:
        return None
    return 100.0 * sum(1.0 - t.busy_s / t.window_s for t in ranks) / len(ranks)
