"""idle_in_feed_share.train (%): the device's idle time while the host was
in the trainer's feed (innermost program span ``feed.gather``), over the
traced read cycle's wall time; rank 0's log and trace (``_spans``)."""

from perfbench.metrics import _spans


def read(cell, counts, trace):
    if counts.get("kind") != "train":
        return None
    return _spans.idle_share(counts, trace, ("feed.gather",))
