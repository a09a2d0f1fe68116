"""Profiling and tracing (port of ``titanet_tpu/utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` capture over the CPU and, where a
  card exists, CUDA activity, written into ``logdir`` as a Chrome trace
  (Perfetto or ``chrome://tracing`` open it),
- :func:`annotate`: a named region on the timeline
  (``torch.profiler.record_function``),
- :class:`StepProfiler`: per-step host wall time, fenced with
  ``torch.cuda.synchronize`` on the device of the tensors it is given, so
  asynchronous launches do not hide device time,
- :func:`device_memory_stats`: live device memory of a card.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed region; the Chrome trace lands in ``logdir``
    as ``trace_<pid>_<n>.json``. Yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        n = len([f for f in os.listdir(logdir) if f.startswith(f"trace_{os.getpid()}_")])
        prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))


def annotate(name: str):
    """Named region on the profiler timeline."""
    return torch.profiler.record_function(name)


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
