"""filler_share.embed (%): the samples of the filler rows (a partial
batch's rows past its last window, computed at the bucket's full width)
over the samples computed, rows x bucket of every batch of the traced
read cycle, from the counts of the embedder's ``embed.pad`` spans."""

from perfbench.metrics import _spans


def read(cell, counts, trace):
    cycle = _spans.read_cycle(counts, trace, _spans.program_log()) if counts.get("kind") == "embed" else None
    pads = [e["counts"] for e in cycle or () if e["name"] == "embed.pad"]
    computed = sum(c["computed_samples"] for c in pads)
    if not computed:
        return None
    return 100.0 * sum((c["rows"] - c["real_rows"]) * c["bucket"] for c in pads) / computed
