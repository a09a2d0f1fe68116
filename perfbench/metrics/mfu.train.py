"""mfu.train (%): the model FLOPs of every training step in the window
(3 x the forward of the real crops and the head) over the window's time
and the bf16 peak of every rank's device."""

from perfbench.metrics import _counts


def read(cell, counts, trace):
    if counts.get("kind") != "train":
        return None
    cfg = cell.config
    flops = counts["steps"] * _counts.train_step_flops(cfg, counts["rows_per_step"], counts["crop_samples"],
                                                       cell.traffic["corpus"]["speakers"])
    return 100.0 * flops / (counts["window_s"] * counts["ranks"] * _counts.peak(cfg)["bf16"])
