"""idle_in_embedder_share.embed (%): the device's idle time while the host
was in the embedder's own work (innermost program span ``embed.request``,
``embed.plan``, ``embed.pad`` or ``embed.merge``), over the traced read
cycle's wall time (``_spans``)."""

from perfbench.metrics import _spans


def read(cell, counts, trace):
    if counts.get("kind") != "embed":
        return None
    return _spans.idle_share(counts, trace, ("embed.request", "embed.plan", "embed.pad", "embed.merge"))
