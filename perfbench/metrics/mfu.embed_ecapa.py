"""mfu.embed_ecapa (%): ECAPA-TDNN's model FLOPs of the real frames
embedded in the window (no filler rows, no padding; ``_counts_ecapa``)
over the window's time and the bf16 peak."""

from perfbench.metrics import _counts, _counts_ecapa


def read(cell, counts, trace):
    if counts.get("kind") != "embed" or cell.config.get("model") != "ecapa_tdnn":
        return None
    cfg = cell.config
    flops = sum(_counts_ecapa.embed_flops(cfg, lengths, counts["buckets"], counts["window_overlap"])
                for lengths in counts["waveforms"])
    return 100.0 * flops / (counts["window_s"] * _counts.peak(cfg)["bf16"])
