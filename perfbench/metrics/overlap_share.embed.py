"""overlap_share.embed (%): the batches of the traced read cycle whose
``embed.pad`` began while an earlier batch of the same request was still
on the card (the span's ``in_flight`` count >= 1), over its batches. The
plan fixes it: (batches - requests) / batches where the embedder launches
a batch before it reads the last one back, 0 where it runs them in
series; None for a program whose ``embed.pad`` counts no ``in_flight``."""

from perfbench.metrics import _spans


def read(cell, counts, trace):
    cycle = _spans.read_cycle(counts, trace, _spans.program_log()) if counts.get("kind") == "embed" else None
    pads = [e["counts"] for e in cycle or () if e["name"] == "embed.pad" and "in_flight" in e["counts"]]
    if not pads:
        return None
    return 100.0 * sum(c["in_flight"] >= 1 for c in pads) / len(pads)
