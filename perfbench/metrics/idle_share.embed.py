"""idle_share.embed (%): 1 - (union of the device's operations) / (wall
time) of the traced requests."""


def read(cell, counts, trace):
    if trace is None or counts.get("kind") != "embed" or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
