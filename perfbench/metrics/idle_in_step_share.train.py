"""idle_in_step_share.train (%): the device's idle time while the host was
in the train step's own host work (innermost program span ``train.step``,
``train.prepare`` or a ``graph.*`` span), over the traced read cycle's
wall time; rank 0's log and trace (``_spans``)."""

from perfbench.metrics import _spans


def read(cell, counts, trace):
    if counts.get("kind") != "train":
        return None
    return _spans.idle_share(counts, trace, ("train.step", "train.prepare") + _spans.GRAPH)
