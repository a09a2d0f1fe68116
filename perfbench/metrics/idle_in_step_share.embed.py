"""idle_in_step_share.embed (%): the device's idle time while the host was
in the serving step (innermost program span ``embed.step``, the host's
whole ``embed_step`` call, ``embed.upload``, a ``graph.*`` span or
``embed.readback``), over the traced read cycle's wall time
(``_spans``)."""

from perfbench.metrics import _spans


def read(cell, counts, trace):
    if counts.get("kind") != "embed":
        return None
    return _spans.idle_share(counts, trace, ("embed.step", "embed.upload", "embed.readback") + _spans.GRAPH)
