"""The program-span readers (``perfbench/metrics/_spans.py`` and the six
metrics on it) on a synthetic trace and span log, and on toy ``--trace 1``
runs on the CPU."""

import json

import pytest

from perfbench import run as run_module
from perfbench.core import bench
from perfbench.core.bench import Cell
from perfbench.core.trace import Trace
from perfbench.metrics import _spans
from perfbench.tests import toy

SHIFT = -1234.5  # the trace's clock minus the host's
EMBED = {"kind": "embed"}
TRAIN = {"kind": "train"}
CELL = Cell("toy", 1, {}, {}, {}, [], [])
NEW = ("pad_ms_per_batch.embed", "filler_share.embed", "idle_in_embedder_share.embed", "idle_in_step_share.embed",
       "idle_in_feed_share.train", "idle_in_step_share.train")


class Log:
    """A synthetic span log on the host's clock (seconds in, ns stored)."""

    def __init__(self):
        self.entries, self.seq = [], 0

    def add(self, name, a, b, root, parent=None, **counts):
        self.seq += 1
        self.entries.append({"name": name, "seq": self.seq, "parent": parent, "root": root,
                             "start_ns": round(a * 1e9), "end_ns": round(b * 1e9), "counts": counts})
        return self.seq


def serving(t0=5000.0, requests=3, gaps_us=(0,), log=None, first_id=7, pad_s=0.002):
    """``requests`` requests 20 ms apart from ``t0`` (host clock): each one
    pb:request 10 ms on the trace's clock, opened ``gaps_us`` before the
    program's ``embed.request``; inside it plan 1 ms, pad ``pad_s``, the
    step 1 ms (in pb:embed_step: 0.1 ms of its own, then upload, graph.key
    and graph.replay), readback 2 ms, merge 1 ms. The device runs from the
    request's start to the pad's, from the step's middle to the readback's
    start and from the merge's start to the request's end: idle in the pad,
    half the step, the readback, and 10 ms outside every request."""
    log = log or Log()
    pbs, ops = [], []
    for k in range(requests):
        rid, s = first_id + k, t0 + 0.02 * k
        end = s + 0.001 + pad_s + 0.001 + 0.002 + 0.001
        top = log.add("embed.request", s, end, rid)
        log.add("embed.plan", s, s + 0.001, rid, top)
        pad = s + 0.001
        log.add("embed.pad", pad, pad + pad_s, rid, top, bucket=100, rows=4, real_rows=3, computed_samples=400,
                real_samples=250)
        up = pad + pad_s
        step = log.add("embed.step", up, up + 0.001, rid, top)
        log.add("embed.upload", up + 0.0001, up + 0.0004, rid, step, bytes=1616, pinned=False)
        log.add("graph.key", up + 0.0004, up + 0.0005, rid, step, tensors=10)
        log.add("graph.replay", up + 0.0005, up + 0.001, rid, step, step="embed_step")
        log.add("embed.readback", up + 0.001, up + 0.003, rid, top)
        log.add("embed.merge", up + 0.003, end, rid, top)
        gap = 1e-6 * gaps_us[k % len(gaps_us)]
        pbs.append(("pb:request", s - gap + SHIFT, s + 0.01 + SHIFT))
        pbs.append(("pb:embed_step", up - 1e-6 + SHIFT, up + 0.001 + 1e-6 + SHIFT))
        ops += [("k", s + SHIFT, pad + SHIFT), ("k", up + 0.0005 + SHIFT, up + 0.001 + SHIFT),
                ("k", up + 0.003 + SHIFT, s + 0.01 + SHIFT)]
    section = ("pb:section", t0 - 0.001 + SHIFT, t0 + 0.02 * requests - 0.01 + SHIFT)
    ops.append(("k", section[2] - 1e-9, section[2]))
    trace = Trace(window_s=section[2] - section[1], busy_s=0.0, ops=sorted(ops, key=lambda o: o[1]),
                  spans=[section] + pbs, units=requests)
    return trace, log


@pytest.fixture
def program(monkeypatch):
    """Hands the readers a synthetic log in place of the program's."""
    box = {}
    monkeypatch.setattr(_spans, "program_log", lambda: box.get("log"))
    return box


def _read(metric, counts, trace):
    return bench.reader(CELL, metric)(CELL, counts, trace)


def test_offset_fit_recovers_a_known_shift():
    trace, log = serving(gaps_us=(10, 12, 11))
    al = _spans.aligned(EMBED, trace, log.entries)
    # pb:request opens 10, 12 and 11 us before embed.request: the median pair gives the shift, which
    # moves each step 11 us before its pb:embed_step (opened 1 us before it): 10 us out
    assert al.offset_s == pytest.approx(SHIFT - 11e-6, abs=1e-9)
    assert al.units == 3 and al.worst_s == pytest.approx(10e-6, abs=1e-9)
    assert len(al.spans) == 3 * 9


def test_read_cycle_skips_an_earlier_cycle(program):
    log = Log()
    serving(t0=4000.0, log=log, first_id=1, pad_s=0.05)  # a warm-up cycle the log also holds
    trace, log = serving(log=log, first_id=4)
    program["log"] = log.entries
    cycle = _spans.read_cycle(EMBED, trace, log.entries)
    assert {e["root"] for e in cycle} == {4, 5, 6} and len(cycle) == 3 * 9
    assert _read("pad_ms_per_batch.embed", EMBED, trace) == pytest.approx(2.0)
    assert _read("filler_share.embed", EMBED, trace) == pytest.approx(25.0)


def test_idle_gap_split_at_span_edges_and_outside(program):
    trace, log = serving()
    program["log"] = log.entries
    split = _spans.idle_by_span(EMBED, trace)
    per_request = {"embed.pad": 0.002, "embed.step": 0.0001, "embed.upload": 0.0003, "graph.key": 0.0001,
                   "embed.readback": 0.002}
    for name, s in per_request.items():
        assert split[name] == pytest.approx(3 * s, abs=1e-9)
    # the section's first ms and 10 ms between requests, twice
    assert split[_spans.OUTSIDE] == pytest.approx(0.001 + 2 * 0.01, abs=1e-9)
    assert {k for k, v in split.items() if v > 1e-12} == set(per_request) | {_spans.OUTSIDE}
    embedder = 100 * 3 * 0.002 / trace.window_s
    step = 100 * 3 * (0.0004 + 0.0001 + 0.002) / trace.window_s
    assert _read("idle_in_embedder_share.embed", EMBED, trace) == pytest.approx(embedder)
    assert _read("idle_in_step_share.embed", EMBED, trace) == pytest.approx(step)


def test_a_span_outside_its_pb_span_aligns_nothing(program, capsys):
    trace, log = serving()
    readback = [e for e in log.entries if e["name"] == "embed.merge"][-1]
    readback["end_ns"] += round(0.005 * 1e9)  # past its pb:request by about a millisecond
    program["log"] = log.entries
    assert _spans.aligned(EMBED, trace, log.entries) is None
    assert "not aligned" in capsys.readouterr().err
    assert _read("idle_in_embedder_share.embed", EMBED, trace) is None
    assert _read("idle_in_step_share.embed", EMBED, trace) is None
    assert _read("pad_ms_per_batch.embed", EMBED, trace) == pytest.approx(2.0)  # needs no alignment


def test_training_spans_split_feed_and_step(program):
    """Two steps: pb:step holds feed.gather (idle 1 ms) and pb:train_step,
    which holds train.step > train.prepare (idle 0.5 ms), graph.key, graph.replay."""
    log, pbs, ops = Log(), [], []
    t0 = 100.0
    for k in range(2):
        s = t0 + 0.1 * k
        log.add("feed.gather", s + 0.001, s + 0.003, None, rows=128)
        top = log.add("train.step", s + 0.004, s + 0.008, 40 + k)
        log.add("train.prepare", s + 0.004, s + 0.005, 40 + k, top)
        log.add("graph.key", s + 0.005, s + 0.006, 40 + k, top, tensors=1900)
        log.add("graph.replay", s + 0.006, s + 0.008, 40 + k, top, step="train_step")
        pbs += [("pb:step", s + SHIFT, s + 0.009 + SHIFT), ("pb:train_step", s + 0.004 + SHIFT,
                                                             s + 0.008 + 5e-6 + SHIFT)]
        ops += [("k", s + SHIFT, s + 0.002 + SHIFT), ("k", s + 0.0045 + SHIFT, s + 0.1 + SHIFT)]
    section = ("pb:section", t0 + SHIFT, t0 + 0.2 + SHIFT)
    trace = Trace(window_s=0.2, busy_s=0.0, ops=ops, spans=[section] + pbs, units=2)
    program["log"] = log.entries
    assert _read("idle_in_feed_share.train", TRAIN, trace) == pytest.approx(100 * 2 * 0.001 / 0.2)
    assert _read("idle_in_step_share.train", TRAIN, trace) == pytest.approx(100 * 2 * 0.0005 / 0.2)
    for metric in NEW[:4]:
        assert _read(metric, TRAIN, trace) is None


def test_readers_return_nothing_without_their_data(program):
    trace, log = serving()
    for metric in NEW:  # an older program keeps no span log
        assert _read(metric, EMBED, trace) is None
    program["log"] = log.entries
    bare = Trace(window_s=trace.window_s, busy_s=0.0, ops=[], spans=trace.spans, units=3)
    for metric in NEW[2:]:  # no device operations
        assert _read(metric, EMBED, bare) is None
    assert _read("pad_ms_per_batch.embed", EMBED, bare) == pytest.approx(2.0)
    for metric in NEW:
        assert _read(metric, EMBED, None) is None


@pytest.mark.parametrize("cell, numbers", [("toy.vox", NEW[:2]), ("toy.train", ())])
def test_toy_traced_run_on_the_cpu(tmp_path, capsys, cell, numbers):
    root = toy.make_root(str(tmp_path))
    rc = run_module.main(["--workload", cell, "--seed", "2400000001", "--seconds", "0.5", "--trace", "1",
                          "--device", "cpu", "--root", root])
    out, _ = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"]
    for metric in NEW:  # the idle readers find no device operations on the CPU
        assert (metric in line["metrics"]) is (metric in numbers)
    for metric in numbers:
        assert line["metrics"][metric]["value"] >= 0.0
