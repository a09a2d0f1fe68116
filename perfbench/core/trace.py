"""The traced section of a ``--trace 1`` run.

``torch.profiler`` records the device's operations (kernels, copies,
sets) and the benchmark's own spans (``record_function`` ranges named
``pb:<what>``, around each call into the program's layers) over a section
of a few steps or requests, run twice: the first cycle is a traced
warm-up, because a trace that follows a large one loses its first records;
the second is the one read. The device is busy where any operation runs:
the union of their intervals, so operations that overlap on several
streams count once.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

SPAN = "pb:"


def union_s(spans: List[Tuple[float, float]]) -> float:
    """The length of the union of ``(start, end)`` spans, sorted by start."""
    busy, reach = 0.0, float("-inf")
    for start, end in spans:
        busy += max(end, reach) - max(start, reach)
        reach = max(reach, end)
    return busy


@dataclass
class Trace:
    window_s: float  # host clock around the read cycle, synchronized at both ends
    busy_s: float  # union of the device's operations
    ops: List[Tuple[str, float, float]]  # (name, start s, end s) on the device, sorted by start
    spans: List[Tuple[str, float, float]]  # the benchmark's spans, host side
    units: int  # steps or requests in the read cycle

    def seconds(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """Device seconds and count of the operations whose name matches."""
        hits = [(e - s) for n, s, e in self.ops if match(n)]
        return sum(hits), len(hits)

    def device_ops(self, top: int = 10) -> List[list]:
        total: Dict[str, float] = {}
        for n, s, e in self.ops:
            total[n] = total.get(n, 0.0) + (e - s)
        return [[n[:160], v] for n, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle seconds of the device summed by the innermost benchmark span
        the host was in at each gap's middle."""
        section = [s for s in self.spans if s[0] == SPAN + "section"]
        if not section or not self.ops:
            return []
        lo, hi = section[0][1], section[0][2]
        gaps, reach = [], lo
        for _, s, e in self.ops:
            if s > reach:
                gaps.append((reach, s))
            reach = max(reach, e)
        if hi > reach:
            gaps.append((reach, hi))
        total: Dict[str, float] = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            inner = [sp for sp in self.spans if sp[1] <= mid <= sp[2]]
            name = min(inner, key=lambda sp: sp[2] - sp[1])[0][len(SPAN):] if inner else "outside"
            total[name] = total.get(name, 0.0) + (b - a)
        return [[n, v] for n, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def span(name: str):
    """A benchmark span (a no-op outside a trace costs a few microseconds)."""
    return torch.profiler.record_function(SPAN + name)


def traced(section: Callable[[], int], device) -> Trace:
    """Run ``section()`` (returns how many steps or requests it ran) twice
    under the profiler and read the second cycle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    sched = schedule(wait=0, warmup=1, active=1, repeat=1)
    window, units = 0.0, 0

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with profile(activities=acts, schedule=sched) as prof:
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            with span("section"):
                units = section()
                sync()
            window = time.perf_counter() - t0
            prof.step()
    ops, spans = [], []
    for ev in prof.events():
        start, end = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.name.startswith(SPAN):  # a span, on the host or as the profiler's mark on the device
            if ev.device_type != DeviceType.CUDA:
                spans.append((ev.name, start, end))
        elif ev.device_type == DeviceType.CUDA:
            ops.append((ev.name, start, end))
    ops.sort(key=lambda o: o[1])
    busy = union_s([(s, e) for _, s, e in ops])
    return Trace(window_s=window, busy_s=busy, ops=ops, spans=spans, units=units)


@contextlib.contextmanager
def wrapped(module, attr: str, name: Optional[str] = None, on_call: Optional[Callable] = None):
    """For the duration, put a benchmark span ``name`` around every call of
    ``module.attr`` (in a traced section), and hand each call's arguments to
    ``on_call`` first."""
    fn = getattr(module, attr)

    def call(*args, **kwargs):
        if on_call is not None:
            on_call(*args, **kwargs)
        if name is None:
            return fn(*args, **kwargs)
        with span(name):
            return fn(*args, **kwargs)

    setattr(module, attr, call)
    try:
        yield
    finally:
        setattr(module, attr, fn)
