"""nccl_ms_per_step.dp (ms): the device time of the NCCL kernels of a
traced step, their waits for the other ranks included, averaged over the
ranks (each rank's own trace)."""


def is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


def read(cell, counts, trace):
    ranks = counts.get("trace_ranks") if trace is not None else None
    if not ranks or counts.get("ranks", 1) < 2:
        return None
    nccl = sum(t.seconds(is_nccl)[0] for t in ranks) / len(ranks)
    return 1e3 * nccl / trace.units if nccl > 0 else None
