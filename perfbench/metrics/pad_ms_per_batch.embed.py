"""pad_ms_per_batch.embed (ms): the mean host time of the embedder's
``embed.pad`` span (one batch's fresh buffer and its fill) over the
batches of the traced read cycle, from the program's span log."""

from perfbench.metrics import _spans


def read(cell, counts, trace):
    cycle = _spans.read_cycle(counts, trace, _spans.program_log()) if counts.get("kind") == "embed" else None
    pads = [e for e in cycle or () if e["name"] == "embed.pad"]
    if not pads:
        return None
    return 1e-6 * sum(e["end_ns"] - e["start_ns"] for e in pads) / len(pads)
