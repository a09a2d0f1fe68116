"""The program's own spans (``titanet_torch.utils.profiling.spans()``, the
span log a ``--trace 1`` run's profiler made the program keep) read
against the traced section.

- The read cycle: the log's last N outermost spans of the cell's kind
  (``embed.request`` a serving request, ``train.step`` a training step),
  N the benchmark spans of the same calls in the trace (``pb:request``,
  ``pb:train_step``), and every span that shares their ids.
- Alignment: the log is on the host's ``perf_counter`` clock, the trace on
  the profiler's. One offset, the median over those N pairs of the ``pb:``
  span's start minus the program span's, maps the whole log onto the
  trace (the two begin a Python call apart). Every shifted span of the
  section must then lie inside the shortest ``pb:`` span that holds its
  middle and is no shorter than it, within :data:`TOLERANCE_S`; otherwise
  nothing is aligned and the reason goes to standard error.
- Idle by span: each idle interval of the device inside ``pb:section``
  (as ``Trace.idle_gaps`` finds them) is cut at the aligned spans' edges,
  and each piece is charged to the innermost program span that covers it,
  or to ``outside``.

A program without the span log (an older one) gives None everywhere.
"""

from __future__ import annotations

import statistics
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from perfbench.core.trace import SPAN

TOLERANCE_S = 0.25e-3
OUTSIDE = "outside"
# the cell's kind -> (the program's outermost span, the benchmark's span of the same call, the unit span)
KINDS = {"embed": ("embed.request", "request", "request"), "train": ("train.step", "train_step", "step")}


def program_log() -> Optional[List[dict]]:
    """The program's span log, or None for a program that keeps none."""
    try:
        from titanet_torch.utils.profiling import spans
    except ImportError:
        return None
    return spans()


def _note(message: str) -> None:
    print(f"perfbench spans: {message}", file=sys.stderr)


def read_cycle(counts, trace, log) -> Optional[List[dict]]:
    """The log's entries of the traced read cycle: the last N outermost
    spans of the cell's kind and every span under their ids; ``feed.gather``
    and other spans outside them are found by time (:func:`aligned`)."""
    kind = KINDS.get(counts.get("kind"))
    if trace is None or log is None or kind is None:
        return None
    n = sum(1 for name, _, _ in trace.spans if name == SPAN + kind[1])
    roots = sorted((e for e in log if e["name"] == kind[0]), key=lambda e: e["start_ns"])[-n:] if n else []
    if not n or len(roots) < n:
        return None
    ids = {e["root"] for e in roots}
    return [e for e in log if e["root"] in ids]


@dataclass
class Aligned:
    spans: List[Tuple[str, float, float]]  # (name, start s, end s) on the trace's clock, inside pb:section
    offset_s: float
    worst_s: float  # the largest distance by which a span leaves its enclosing pb: span
    units: int


def _enclosing(spans, a: float, b: float):
    """The shortest of ``spans`` that holds the middle of ``[a, b]`` and is
    no shorter than it: the span that ought to hold it whole."""
    mid = 0.5 * (a + b)
    inner = [s for s in spans if s[1] <= mid <= s[2] and s[2] - s[1] >= b - a]
    return min(inner, key=lambda s: s[2] - s[1]) if inner else None


def aligned(counts, trace, log) -> Optional[Aligned]:
    """The log on the trace's clock (module docstring), or None."""
    kind = KINDS.get(counts.get("kind"))
    cycle = read_cycle(counts, trace, log)
    section = [s for s in trace.spans if s[0] == SPAN + "section"] if trace is not None else []
    if cycle is None or not section:
        return None
    pbs = sorted((s for s in trace.spans if s[0] == SPAN + kind[1]), key=lambda s: s[1])
    roots = sorted((e for e in cycle if e["name"] == kind[0]), key=lambda e: e["start_ns"])
    offset = statistics.median(p[1] - 1e-9 * e["start_ns"] for p, e in zip(pbs, roots))
    lo, hi = section[0][1], section[0][2]
    shifted = [(e["name"], 1e-9 * e["start_ns"] + offset, 1e-9 * e["end_ns"] + offset) for e in log]
    inside = [s for s in shifted if lo <= 0.5 * (s[1] + s[2]) <= hi]
    enclosing = [s for s in trace.spans if s[0] != SPAN + "section"]
    worst = 0.0
    for name, a, b in inside:
        pb = _enclosing(enclosing, a, b) or section[0]
        worst = max(worst, pb[1] - a, b - pb[2])
    if worst > TOLERANCE_S:
        _note(f"not aligned: a span leaves its pb: span by {1e3 * worst:.3f} ms (tolerance "
              f"{1e3 * TOLERANCE_S:.2f} ms)")
        return None
    return Aligned(sorted(inside, key=lambda s: (s[1], -s[2])), offset, worst, len(roots))


def _segments(spans, lo: float, hi: float) -> List[Tuple[float, float, str]]:
    """``[lo, hi]`` cut into pieces, each labelled with the innermost span
    that covers it (spans nest, sorted by start and then longest first)."""
    out, stack, cur = [], [], lo

    def emit(upto, label):
        nonlocal cur
        upto = min(max(upto, cur), hi)
        if upto > cur:
            out.append((cur, upto, label))
            cur = upto

    for name, a, b in spans:
        while stack and stack[-1][2] <= a:
            emit(stack[-1][2], stack[-1][0])
            stack.pop()
        emit(a, stack[-1][0] if stack else OUTSIDE)
        stack.append((name, a, b))
    while stack:
        emit(stack[-1][2], stack[-1][0])
        stack.pop()
    emit(hi, OUTSIDE)
    return out


def _gaps(trace, lo: float, hi: float) -> List[Tuple[float, float]]:
    gaps, reach = [], lo
    for _, s, e in trace.ops:
        if s > reach:
            gaps.append((reach, min(s, hi)))
        reach = max(reach, e)
        if reach >= hi:
            break
    if hi > reach:
        gaps.append((reach, hi))
    return [(a, b) for a, b in gaps if b > a]


def _intersect(pieces, spans):
    """The parts of ``pieces`` (``(a, b, label)``, sorted, disjoint) inside
    ``spans`` (``(a, b)``, sorted, disjoint)."""
    out, j = [], 0
    for a, b, label in pieces:
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            x, y = max(a, spans[k][0]), min(b, spans[k][1])
            if y > x:
                out.append((x, y, label))
            k += 1
    return out


def idle_by_span(counts, trace) -> Optional[Dict[str, float]]:
    """Idle seconds of the device inside ``pb:section`` by the innermost
    program span the host was in (module docstring); None without device
    operations or without an aligned log."""
    if trace is None or not trace.ops or counts.get("kind") not in KINDS:
        return None
    al = aligned(counts, trace, program_log())
    if al is None:
        return None
    section = next(s for s in trace.spans if s[0] == SPAN + "section")
    lo, hi = section[1], section[2]
    labels = _segments(al.spans, lo, hi)
    pieces = _intersect(labels, _gaps(trace, lo, hi))
    total: Dict[str, float] = {}
    for a, b, label in pieces:
        total[label] = total.get(label, 0.0) + (b - a)
    unit = SPAN + KINDS[counts["kind"]][2]
    units = sorted((s[1], s[2]) for s in trace.spans if s[0] == unit)
    in_units = _intersect(pieces, units)
    idle_units = sum(b - a for a, b, _ in in_units)
    held = sum(b - a for a, b, label in in_units if label != OUTSIDE)
    share = f"{100.0 * held / idle_units:.1f}%" if idle_units > 0 else "none"
    _note(f"{al.units} {counts['kind']} units aligned, offset {al.offset_s:.6f} s, largest misplacement "
          f"{1e3 * al.worst_s:.4f} ms; device idle by program span (ms): "
          + ", ".join(f"{k} {1e3 * v:.3f}" for k, v in sorted(total.items(), key=lambda kv: -kv[1]))
          + f"; program spans hold {share} of the idle inside {unit} ({1e3 * idle_units:.3f} ms)")
    return total


GRAPH = ("graph.key", "graph.capture", "graph.replay")  # the step graphs' spans


def idle_share(counts, trace, names) -> Optional[float]:
    """The device's idle time whose innermost program span is one of
    ``names``, in % of the read cycle's wall time."""
    split = idle_by_span(counts, trace)
    if split is None:
        return None
    return 100.0 * sum(split.get(name, 0.0) for name in names) / trace.window_s
