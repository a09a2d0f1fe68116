"""pad_efficiency.embed (%): the samples the client sent in the window's
requests over the samples the embedder computed for them: rows x samples
of every batch it handed its embedding step (filler rows, padding and the
overlap of windows are the waste), read from the program's own calls."""


def read(cell, counts, trace):
    if counts.get("kind") != "embed":
        return None
    real = sum(sum(lengths) for lengths in counts["waveforms"])
    computed = sum(counts["computed_samples"])
    return 100.0 * real / computed if computed else None
