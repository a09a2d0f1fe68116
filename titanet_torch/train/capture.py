"""Step capture: one CUDA graph a step and shape, the port's counterpart
of the executables ``jax.jit`` compiles (``_jitted_embed_step``,
``embed_step_quantized``, ``eval_step`` and the donated
``_jitted_train_step`` in the JAX package's ``train/state.py``).

A graph holds the step's kernels in their order and replays them with one
host launch. :class:`StepGraphs` keeps one for each key: the step's name
and static arguments (frontend, ``masked``), each input's shape and dtype,
and, for each module or tree the step reads (its "owners"), its identity
and the address and dtype of every parameter and buffer. So

- a parameter updated in place (an optimizer step, ``load_state_dict``,
  the JAX weight bridge) is seen by the next replay, as JAX sees new
  argument values;
- a parameter replaced (``model.to(...)``) changes the key, and the step
  is captured again;
- the graphs of an owner are dropped once the owner is collected.

An owner may also be a CUDA ``torch.Generator`` the step draws from (the
train step's dropout, SpecAugment and noise generators): it is registered
with the graph before capture, so every replay reads the generator's seed
and offset and advances the offset by what the step draws, as an eager
step does (``CUDAGraph.register_generator_state``). A capture that draws
from a generator that is not registered raises. A CUDA generator cannot be
referenced weakly: its graphs hold it, so that its id stays its own while
they live, and go with the other owners.

The first call of a key runs the step eagerly on a side stream (the
warm-up, which also fixes cuBLAS workspaces and cuDNN algorithm choices
before capture) and returns that output; then it captures the step on the
same stream into the process's one memory pool
(``torch.cuda.graph_pool_handle()``). Every later call copies the inputs
into the graph's static buffers, replays and returns a copy of the output:
the static output is overwritten by the next replay. Replays run one after
another on that stream under a lock, and each output is copied out before
the next, so the graphs can share the pool. Each call thus launches every
kernel of the step once.

A kernel wrapper counts its launches in Python (``.launches``), which a
replay does not run. Capture records each counter's change and takes it
back (capture launches nothing); every replay adds it again, so a counter
still counts launches. The collective counts of
``titanet_torch.parallel.distributed`` (``collective_stats()``) are kept
the same way.

A step under a mesh of P > 1 ranks on an NCCL group holds its collectives
(``train_step(..., mesh=)`` and the ``shard_map`` step): every rank
captures on the same call, since the key is built from what every rank
shares (shapes, static arguments, the same sequence of owners), and the
warm-up runs the step's collectives eagerly first, which creates the
communicator before capture. Capture runs in CUDA's ``thread_local``
mode, so that another thread's CUDA calls (c10d's watchdog querying its
events, this module's :class:`ReplayWatchdog`) do not invalidate it; host
work on the capturing thread still fails the capture. A replay enqueues
no work that c10d's watchdog sees: :class:`ReplayWatchdog` records an
event after each replay of a graph with collectives and, when one has not
completed within ``TITANET_DIST_TIMEOUT`` seconds of becoming the oldest
pending, aborts the group and fails the process, so a lost rank fails
the others instead of hanging them. A graph must not outlive the
communicators it holds: a cache that captured collectives registers with
``titanet_torch.parallel.distributed.hold_collectives``, whose
``destroy_process_group`` (and exit hook) calls
:meth:`StepGraphs.release_collectives` before the group goes.

There is no fallback: a capture or replay that fails raises. A capture of
host work (a read of a device value, a host-to-device copy of pageable
memory) fails, so the steps keep such work outside ``fn``. Python side
effects of ``fn`` (hooks, prints, counters) run at the warm-up and the
capture only, as the body of a jitted function runs only while it is
traced: the train step advances its step counts and computes its scalars
outside ``fn``, once a call. The warm-up of a step that updates state in
place (the train step) is that call's update; the capture updates
nothing.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import sys
import threading
import time
import weakref
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn
from torch.utils import _pytree as pytree

from titanet_torch.parallel import distributed as pd
from titanet_torch.utils.profiling import span


def wanted(capture: Optional[bool], device: torch.device) -> bool:
    """Whether a step on ``device`` runs as a graph: ``capture`` None means
    on CUDA and not on the CPU; ``True`` on another device than CUDA
    raises."""
    if capture is None:
        return device.type == "cuda"
    if capture and device.type != "cuda":
        raise ValueError(f"step capture needs a CUDA device, got {device}")
    return bool(capture)


def owned_tensors(owner) -> list:
    """The tensors a step reads from ``owner``: a module's parameters and
    buffers, or every tensor of a tree (dataclass, named tuple, list,
    dict)."""
    if isinstance(owner, nn.Module):  # each module's own dicts: half the time of parameters() + buffers()
        return [t for m in owner.modules() for d in (m._parameters, m._buffers) for t in d.values() if t is not None]
    if isinstance(owner, torch.Tensor):
        return [owner]
    if dataclasses.is_dataclass(owner):
        return [t for f in dataclasses.fields(owner) for t in owned_tensors(getattr(owner, f.name))]
    if isinstance(owner, (list, tuple)):
        return [t for item in owner for t in owned_tensors(item)]
    if isinstance(owner, dict):
        return [t for item in owner.values() for t in owned_tensors(item)]
    return []


def _owner_key(owner) -> tuple:
    tensors = owned_tensors(owner)
    return (id(owner), tuple(map(torch.Tensor.data_ptr, tensors)), tuple(t.dtype for t in tensors))


def _input_key(x) -> tuple:
    return None if x is None else (tuple(x.shape), x.stride(), x.dtype)


def _counters():
    from titanet_torch.ops.kernels import launch_counters

    return launch_counters()


@dataclasses.dataclass
class StepGraph:
    """One captured step: the graph, its static inputs and output leaves,
    the output's tree structure, each launch counter's change a replay
    makes, and the seconds capture took."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple
    outputs: list
    spec: pytree.TreeSpec
    deltas: tuple
    capture_s: float
    owners: tuple
    generators: tuple = ()
    # {kind: (calls, bytes)} of the collectives a replay issues
    collectives: dict = dataclasses.field(default_factory=dict)


class StepGraphs:
    """The cache of captured steps (module docstring). ``captures`` counts
    the graphs this cache captured."""

    def __init__(self):
        self._graphs: Dict[tuple, StepGraph] = {}
        self._lock = threading.RLock()
        self._pools: dict = {}
        self._streams: dict = {}
        self._watched: set = set()
        self._dead: list = []
        self.captures = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def graphs(self) -> list:
        """The captured steps, in capture order."""
        return list(self._graphs.values())

    def run(self, name: str, static, owners: Sequence, fn: Callable, inputs: Sequence):
        """``fn(*inputs)`` through the graph of its key (module docstring).
        ``inputs``: CUDA tensors or None, all on one device; ``static``:
        hashable arguments ``fn`` closes over that change what it
        computes; ``owners``: the modules or trees whose tensors ``fn``
        reads, and the generators it draws from. Returns ``fn``'s output
        (a tree of tensors and None), new tensors the caller owns."""
        inputs = tuple(inputs)
        with span("graph.key") as sp:
            key = self.key(name, static, owners, inputs)
            if sp:
                sp.count(tensors=sum(len(ptrs) for _, ptrs, _ in key[4]))
        dev = key[2]
        with self._lock:
            self._collect_dead()
            entry = self._graphs.get(key)
            if entry is None:
                with span("graph.capture", step=name):
                    return self._capture(key, owners, fn, inputs, dev)
            with span("graph.replay", step=name):
                return self._replay(entry, inputs, dev)

    @staticmethod
    def key(name: str, static, owners: Sequence, inputs: Sequence) -> tuple:
        """The key of a step's graph: ``(name, static, device, each input's
        shape, strides and dtype, each owner's identity and the address and
        dtype of each of its tensors)``."""
        dev = next(x.device for x in inputs if x is not None)
        return (name, static, dev, tuple(_input_key(x) for x in inputs), tuple(_owner_key(o) for o in owners))

    def release_collectives(self) -> int:
        """Drop the graphs that hold collectives, after the card has run
        them; returns how many. A graph must not outlive the communicators
        it holds: ``titanet_torch.parallel.distributed.destroy_process_group``
        calls this before it destroys the group (module docstring)."""
        with self._lock:
            keys = [k for k, g in self._graphs.items() if g.collectives]
            if keys and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            for k in keys:
                del self._graphs[k]
        return len(keys)

    def pool_bytes(self, device=None) -> int:
        """Bytes the shared pool of ``device`` (the current CUDA device by
        default) holds: its segments in the allocator's snapshot."""
        dev = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
        pool = self._pools.get(dev)
        if pool is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if seg["device"] == dev.index and tuple(seg["segment_pool_id"]) == tuple(pool))

    def _stream(self, dev: torch.device) -> torch.cuda.Stream:
        """The side stream of ``dev`` that warms up, captures and replays;
        ``dev``'s pool is made with it."""
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
            self._pools[dev] = torch.cuda.graph_pool_handle()
        return self._streams[dev]

    def _watch(self, owners) -> None:
        """Drop an owner's graphs once it is collected: the finalizer only
        notes its id (it may run inside a capture), the next call drops."""
        for owner in owners:
            if isinstance(owner, torch.Generator):
                continue  # held by its graphs (module docstring)
            if id(owner) not in self._watched:
                self._watched.add(id(owner))
                weakref.finalize(owner, self._dead.append, id(owner))

    def _collect_dead(self) -> None:
        while self._dead:
            oid = self._dead.pop()
            self._watched.discard(oid)
            for key in [k for k, g in self._graphs.items() if oid in g.owners]:
                del self._graphs[key]

    def _capture(self, key, owners, fn, inputs, dev):
        stream = self._stream(dev)
        current = torch.cuda.current_stream(dev)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = fn(*inputs)  # the warm-up: this call's result
            static_in = tuple(None if x is None else torch.empty_like(x) for x in inputs)
        current.wait_stream(stream)
        for t in pytree.tree_leaves(out):
            if t is not None:
                t.record_stream(current)
        counters = _counters()
        before = [getattr(obj, attr) for obj, attr in counters]
        stats = pd.stats_snapshot()
        graph = torch.cuda.CUDAGraph()
        gens = tuple(o for o in owners if isinstance(o, torch.Generator))
        for gen in gens:
            if gen.device.type != "cuda":
                raise ValueError(f"a captured step draws from a CUDA generator, got one on {gen.device}")
            graph.register_generator_state(gen)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self._pools[dev], stream=stream, capture_error_mode="thread_local"):
                static_out = fn(*static_in)
        finally:
            deltas = tuple(getattr(obj, attr) - b for (obj, attr), b in zip(counters, before))
            for (obj, attr), b in zip(counters, before):
                setattr(obj, attr, b)
            collectives = pd.stats_since(stats)
        outputs, spec = pytree.tree_flatten(static_out)
        self._watch(owners)
        self._graphs[key] = StepGraph(graph, static_in, outputs, spec, deltas, time.perf_counter() - t0,
                                      tuple(id(o) for o in owners), gens, collectives)
        if collectives:
            pd.hold_collectives(self)
        self.captures += 1
        return out

    def _replay(self, entry: StepGraph, inputs, dev):
        if entry.collectives:
            WATCHDOG.check()  # no replay after the group was aborted
        stream = self._stream(dev)
        current = torch.cuda.current_stream(dev)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            for static, x in zip(entry.inputs, inputs):
                if static is not None:
                    static.copy_(x)
            entry.graph.replay()
            if entry.collectives:
                done = torch.cuda.Event()
                done.record(stream)
                WATCHDOG.watch(done, pd.timeout().total_seconds(), dev)
            outputs = [None if t is None else t.clone() for t in entry.outputs]
        current.wait_stream(stream)
        for t in outputs:
            if t is not None:
                t.record_stream(current)
        for (obj, attr), d in zip(_counters(), entry.deltas):
            if d:
                setattr(obj, attr, getattr(obj, attr) + d)
        pd.add_stats(entry.collectives)
        return pytree.tree_unflatten(outputs, entry.spec)


class ReplayWatchdog:
    """The timeout of replayed collectives (module docstring). :meth:`watch`
    takes an event recorded after a replay; a daemon thread waits for the
    events in order. The oldest pending event's clock starts when it was
    recorded or when the one before it completed, whichever is later, so
    the timeout bounds how long the card makes no progress on a replay's
    collectives, not how far the host runs ahead. When it passes, the
    watchdog writes why to stderr, aborts the default group (the spinning
    collective kernels return, and the caller's next replay raises with
    that message) and, ``grace_s`` seconds later, ends the process with
    exit code 1, as c10d ends a process whose collective timed out.
    ``abort`` and ``exit`` are replaceable for tests."""

    def __init__(self, abort: Callable = pd.abort, exit: Callable = os._exit, grace_s: float = 10.0,
                 poll_s: float = 0.01):
        self._abort, self._exit, self.grace_s, self.poll_s = abort, exit, grace_s, poll_s
        self._pending: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[str] = None

    def check(self) -> None:
        """Raises once the watchdog has fired."""
        if self.error:
            raise RuntimeError(self.error)

    def watch(self, event, timeout_s: float, device: Optional[torch.device] = None) -> None:
        """Bound ``event`` (recorded after a replay on ``device``) by
        ``timeout_s``; raises once the watchdog has fired."""
        self.check()
        with self._cv:
            self._pending.append((event, timeout_s, device, time.monotonic()))
            if self._thread is None:
                self._thread = threading.Thread(target=self._run, name="titanet-replay-watchdog", daemon=True)
                self._thread.start()
            self._cv.notify()

    def pending(self) -> int:
        return len(self._pending)

    def _run(self) -> None:
        last_done = time.monotonic()
        while True:
            with self._cv:
                while not self._pending:
                    self._cv.wait()
                event, timeout_s, device, recorded = self._pending[0]
            if device is not None:
                # the event's card: a query on another would open a context there
                torch.cuda.set_device(device)
            start = max(recorded, last_done)
            while not event.query():
                if time.monotonic() - start > timeout_s:
                    self._fire(timeout_s)
                    return
                time.sleep(self.poll_s)
            last_done = time.monotonic()
            with self._cv:
                self._pending.popleft()

    def _fire(self, timeout_s: float) -> None:
        self.error = (f"titanet_torch: the collectives of a replayed step did not finish within {timeout_s:g} s "
                      "(TITANET_DIST_TIMEOUT): a rank is lost; the process group is aborted")
        print(self.error, file=sys.stderr, flush=True)
        # the abort runs apart: the process ends after the grace whatever it does
        threading.Thread(target=self._abort_quietly, name="titanet-replay-abort", daemon=True).start()
        time.sleep(self.grace_s)
        self._exit(1)

    def _abort_quietly(self) -> None:
        try:
            self._abort()
        except Exception as e:
            print(f"titanet_torch: aborting the process group failed: {e!r}", file=sys.stderr, flush=True)


GRAPHS = StepGraphs()  # the process's graphs, as jax.jit's cache of executables is the process's
WATCHDOG = ReplayWatchdog()  # the process's bound on replayed collectives
