"""ctx_pool_roofline.embed_ecapa (%): the least time of ECAPA-TDNN's
context-dependent pooling over the profiler device time of its kernels
(the context statistics and the one-pass pool, with their reductions) in
the traced requests, the least work counted over each row's valid frames
from the lengths the embedder handed its step (``_counts_ecapa``). None
where the launches do not match the traced batches (one context-statistics
and one pool launch a batch): a program that pools in plain torch reads
nothing."""

from perfbench.metrics import _counts_ecapa


def read(cell, counts, trace):
    if trace is None or counts.get("kind") != "embed" or "trace_lengths" not in counts:
        return None
    calls, lengths = counts["trace_calls"], counts["trace_lengths"]
    seconds, _ = trace.seconds(_counts_ecapa.is_ctx_pool)
    _, n_ctx = trace.seconds(lambda name: "ctx_stats_kernel" in name)
    _, n_pool = trace.seconds(lambda name: "pool_onepass_kernel" in name)
    if n_ctx != len(calls) or n_pool != len(calls) or seconds <= 0:
        return None
    least = sum(_counts_ecapa.ctx_pool_least_s(cell.config, lens, samples)
                for (_, samples), lens in zip(calls, lengths))
    return 100.0 * least / seconds
