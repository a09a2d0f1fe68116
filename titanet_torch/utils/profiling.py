"""Profiling and tracing (port of ``titanet_tpu/utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` capture over the CPU and, where a
  card exists, CUDA activity, written into ``logdir`` as a Chrome trace
  (Perfetto or ``chrome://tracing`` open it), with the spans it recorded
  beside it as JSON lines,
- :func:`span`: the program's span, a named region at a layer boundary
  with counts of what it handled; :func:`spans` reads the spans recorded,
- :class:`StepProfiler`: per-step host wall time, fenced with
  ``torch.cuda.synchronize`` on the device of the tensors it is given, so
  asynchronous launches do not hide device time,
- :func:`device_memory_stats`: live device memory of a card.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

LOG_SPANS = 1 << 16  # the span log keeps the last this many
_LOG: collections.deque = collections.deque(maxlen=LOG_SPANS)
_SEQ = itertools.count()
_LOCAL = threading.local()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed region; the Chrome trace lands in ``logdir``
    as ``trace_<pid>_<n>.json``. Yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    first = next(_SEQ)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        n = len([f for f in os.listdir(logdir) if f.startswith(f"trace_{os.getpid()}_")])
        prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))
        with open(os.path.join(logdir, f"spans_{os.getpid()}_{n}.jsonl"), "w") as f:
            for entry in spans():
                if entry["seq"] > first:
                    f.write(json.dumps(entry) + "\n")


class _Span:
    """A span while a profiler records (:func:`span`)."""

    __slots__ = ("name", "id", "counts", "seq", "parent", "root", "t0", "_region")

    def __init__(self, name: str, id, counts: dict):
        self.name, self.id, self.counts = name, id, counts

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.seq = next(_SEQ)
        self.parent = None if parent is None else parent.seq
        self.root = self.id if parent is None else parent.root
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        self._region = torch._C._profiler._RecordFunctionFast(self.name)
        self._region.__enter__()
        return self

    def __exit__(self, *exc):
        self._region.__exit__(*exc)
        t1 = time.perf_counter_ns()
        _stack().pop()
        _LOG.append({"name": self.name, "seq": self.seq, "parent": self.parent, "root": self.root,
                     "start_ns": self.t0, "end_ns": t1, "counts": self.counts})
        return False

    def count(self, **counts) -> None:
        """Add counts known only inside the span."""
        self.counts.update(counts)


class _Off:
    """The span while no profiler records: one shared object that does
    nothing, and is false, so that a count costly to compute can be
    skipped (``if sp: sp.count(...)``)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self) -> bool:
        return False

    def count(self, **counts) -> None:
        pass


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def span(name: str, id=None, **counts):
    """The program's span around the work of one layer boundary, with
    ``counts`` of what it handled (more by ``.count(...)`` inside it).

    While no profiler records (``torch.autograd._profiler_enabled()`` is
    false) it is one shared null context: a flag check and nothing else.
    While one records, the span is a region of the profiler's function
    scope (``torch._C._profiler._RecordFunctionFast``), so the profiler's
    trace shows it on the host's row above the device work it launched, on
    the device's clock. Unlike ``torch.profiler.record_function``'s user
    scope it adds no mark to the device's rows, where a reader of device
    time would count it as the device's work. As it ends, it appends to the
    span log (:func:`spans`) its name, its sequence number, its parent's
    (the enclosing span of this thread), the id of its outermost span
    (``id`` of that span: a request's or a step's number, so the spans of
    one request share it), its start and end (``time.perf_counter_ns``)
    and its counts."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, id, counts)


def spans() -> List[dict]:
    """The span log: the last :data:`LOG_SPANS` spans recorded, in the
    order they ended (a child before its parent)."""
    return list(_LOG)


def _fence(result) -> None:
    """``torch.cuda.synchronize`` on the device of every CUDA tensor in
    ``result`` (a tensor or a nest of lists, tuples and dicts); nothing for
    CPU tensors."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(result)
    for dev in devices:
        torch.cuda.synchronize(dev)


class StepProfiler:
    """Honest per-step timing: the step's wall time runs until the device
    has finished the fenced results."""

    def __init__(self):
        self.times: Dict[str, list] = {}

    @contextlib.contextmanager
    def step(self, name: str, result_to_fence=None):
        """Time the enclosed block. ``result_to_fence`` is the block's
        result, or a zero-argument callable returning it (for results made
        inside the block)."""
        t0 = time.perf_counter()
        yield
        fence = result_to_fence() if callable(result_to_fence) else result_to_fence
        if fence is not None:
            _fence(fence)
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        import numpy as np

        return {
            f"{k}_ms_median": float(np.median(v) * 1e3) for k, v in self.times.items()
        }


def device_memory_stats(device=None) -> Dict:
    """Live device memory (bytes) of a card: ``bytes_in_use`` and
    ``peak_bytes_in_use`` from the caching allocator, ``bytes_limit`` the
    card's total memory. ``{}`` for the CPU or where no card exists."""
    device = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else torch.device("cpu")
    )
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(total),
    }
