"""The ``overlap_share.embed`` reader on hand-made span logs: the share of a
read cycle's batches padded while an earlier batch of their request was on
the card."""

import pytest

from perfbench.core import bench
from perfbench.core.bench import Cell
from perfbench.core.trace import Trace
from perfbench.metrics import _spans

CELL = Cell("toy", 1, {}, {}, {}, [], [])
EMBED = {"kind": "embed"}


def _cycle(batches, in_flight=True, pads=True, t0=100.0, first_id=3):
    """One request a count of ``batches``, 10 ms apart: the program's
    ``embed.request`` with an ``embed.pad`` a batch (``in_flight`` 0 for a
    request's first, 1 after it; left out with ``in_flight=False``), and the
    benchmark's ``pb:request`` around each."""
    log, pbs, seq = [], [], 0
    for k, n in enumerate(batches):
        rid, s = first_id + k, t0 + 0.01 * k
        seq += 1
        top = seq
        log.append({"name": "embed.request", "seq": top, "parent": None, "root": rid, "start_ns": round(s * 1e9),
                    "end_ns": round((s + 0.008) * 1e9), "counts": {}})
        for b in range(n if pads else 0):
            seq += 1
            counts = {"bucket": 100, "rows": 4, "real_rows": 4, "computed_samples": 400, "real_samples": 400}
            if in_flight:
                counts["in_flight"] = int(b > 0)
            a = s + 0.001 * (b + 1)
            log.append({"name": "embed.pad", "seq": seq, "parent": top, "root": rid, "start_ns": round(a * 1e9),
                        "end_ns": round((a + 0.0005) * 1e9), "counts": counts})
        pbs.append(("pb:request", s, s + 0.009))
    section = ("pb:section", t0, t0 + 0.01 * len(batches))
    trace = Trace(window_s=section[2] - section[1], busy_s=0.0, ops=[], spans=[section] + pbs, units=len(batches))
    return trace, log


def _read(monkeypatch, log, trace, counts=EMBED):
    monkeypatch.setattr(_spans, "program_log", lambda: log)
    return bench.reader(CELL, "overlap_share.embed")(CELL, counts, trace)


@pytest.mark.parametrize("batches", [[3, 1, 5], [36, 41, 30, 38], [1, 1], [12]])
def test_overlap_share_is_the_plans_batches_less_requests(monkeypatch, batches):
    trace, log = _cycle(batches)
    want = 100.0 * (sum(batches) - len(batches)) / sum(batches)
    assert _read(monkeypatch, log, trace) == pytest.approx(want)


def test_overlap_share_reads_only_the_traced_cycle(monkeypatch):
    _, earlier = _cycle([4, 4], t0=50.0, first_id=1)  # a warm-up's requests the log also holds
    trace, log = _cycle([2, 3])
    assert _read(monkeypatch, earlier + log, trace) == pytest.approx(100.0 * 3 / 5)


def test_overlap_share_is_none_without_its_counts(monkeypatch):
    trace, log = _cycle([3, 2], pads=False)
    assert _read(monkeypatch, log, trace) is None  # no embed.pad span
    trace, log = _cycle([3, 2], in_flight=False)
    assert _read(monkeypatch, log, trace) is None  # a program whose pads count no in_flight
    trace, log = _cycle([3, 2])
    assert _read(monkeypatch, None, trace) is None  # a program without a span log
    assert _read(monkeypatch, log, None) is None
    assert _read(monkeypatch, log, trace, {"kind": "train"}) is None
