"""Multi-process runtime and the collectives of the data-parallel step
(port of ``titanet_tpu/parallel/distributed.py``).

One process (a rank) drives one device. Every rank calls
:func:`maybe_initialize_distributed` before it touches a device (the CLI
does, ``titanet_torch.cli.main``); the train loader then deals each rank a
disjoint round-robin share of the epoch's batches, and the logical global
batch of one step is the rank-ordered CONCATENATION of the local batches
(global batch = ``P * batch_size``). The step computes what one process fed
that concatenated batch computes: BatchNorm statistics over the global
batch (``titanet_torch.ops.norm``), the gradient mean over it (one bucketed
``all_reduce``, ``titanet_torch.train.state``) and random draws over it
(:func:`titanet_torch.parallel.mesh.draw_rows`).

Environment contract (the JAX package's, set per process by the launcher):

- ``TITANET_COORDINATOR``   host:port of rank 0 (e.g. ``localhost:9911``)
- ``TITANET_NUM_PROCESSES`` the world size
- ``TITANET_PROCESS_ID``    this process's rank
- ``TITANET_DISTRIBUTED=auto`` instead of the three above: torch's own
  launcher environment (``torchrun``: ``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``).

``TITANET_DIST_TIMEOUT`` (seconds, default 600) bounds every collective:
a lost rank fails the others instead of hanging them.

Every all-reduce of the port goes through :func:`all_reduce_` (the
differentiable :func:`all_reduce` and :func:`all_gather_rows` too), which
counts the calls and bytes (:func:`collective_stats`).

On an NCCL group the data-parallel train steps run as one CUDA graph a
step shape (``titanet_torch.train.capture``), with every collective of the
step inside: BatchNorm's forward and backward all-reduces, the GE2E row
gathers, the gradient bucket and the loss mean. A replay runs no Python,
so the capture records the change a step makes to the counts and every
replay adds it (:func:`stats_since`, :func:`add_stats`): the counts read
the same after N captured steps as after N eager ones. A graph must not
outlive the communicators it holds: every rank leaves its group through
:func:`destroy_process_group`, which drops the graphs that hold the
group's collectives (:func:`hold_collectives`) before it destroys the
group; at exit the same drop runs by itself. A replay enqueues
no work that c10d's watchdog sees, so the graphs keep the timeout
themselves: a replay's collectives that have not finished within
``TITANET_DIST_TIMEOUT`` abort the group (:func:`abort`) and fail the
process (``titanet_torch.train.capture.ReplayWatchdog``). gloo cannot be
captured: on a gloo group the steps run eagerly (:func:`capturable`).
"""

from __future__ import annotations

import atexit
import datetime
import os
import weakref
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0

# calls and bytes of every all-reduce this process issued (forward and
# backward), by kind, since the last reset_collective_stats()
_STATS: dict = {}

# what holds graphs with the group's collectives (hold_collectives); weak,
# so that registering keeps nothing alive
_HOLDERS: "weakref.WeakSet" = weakref.WeakSet()


def timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=float(os.environ.get("TITANET_DIST_TIMEOUT", DEFAULT_TIMEOUT_S)))


def maybe_initialize_distributed(verbose: bool = True, backend: Optional[str] = None) -> bool:
    """Start the process group from the environment contract.

    Returns True if a multi-process group is (or already was) up. Without
    the contract this is a no-op that reports whether a caller already
    started a group. ``backend`` defaults to NCCL where a CUDA device
    exists and gloo on a CPU-only machine; on NCCL the rank first selects
    its card (``cuda:<LOCAL_RANK or rank> mod visible cards``)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator = os.environ.get("TITANET_COORDINATOR")
    auto = os.environ.get("TITANET_DISTRIBUTED", "").lower() == "auto"
    if not coordinator and not auto:
        return False
    if coordinator:
        rank = int(os.environ["TITANET_PROCESS_ID"])
        kw = dict(init_method=f"tcp://{coordinator}", rank=rank,
                  world_size=int(os.environ["TITANET_NUM_PROCESSES"]))
    else:
        rank = int(os.environ["RANK"])
        kw = dict(init_method="env://")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(local_device_index(rank))
    dist.init_process_group(backend, timeout=timeout(), **kw)
    if verbose:
        print(f"[distributed] rank {dist.get_rank()}/{dist.get_world_size()} up ({backend})")
    return True


def free_port() -> int:
    """A TCP port of 127.0.0.1 that is free now (for a local group's
    ``tcp://127.0.0.1:<port>`` rendezvous)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_device_index(rank: int) -> int:
    """The card a rank drives: ``LOCAL_RANK`` (else the rank) modulo the
    visible cards."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("titanet_torch: no CUDA device is available for this rank")
    return int(os.environ.get("LOCAL_RANK", rank)) % n


def world() -> tuple:
    """``(rank, world size)`` of the live group, ``(0, 1)`` without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_batch_array(sharding, host_array) -> torch.Tensor:
    """This rank's LOCAL rows of one step's global batch, on its device.

    The global batch stays logical (the rank-ordered concatenation of the
    local batches; global batch = ``P * local batch``). ``sharding`` is
    :func:`titanet_torch.parallel.batch_sharding`'s; in a single process
    this is a plain device copy."""
    return torch.as_tensor(np.asarray(host_array)).to(sharding.mesh.device)


def collective_stats() -> dict:
    """``{"count", "bytes", "by_kind": {kind: {"count", "bytes"}}}`` of the
    all-reduces issued since the last :func:`reset_collective_stats`
    (bytes: each call's payload, once)."""
    by_kind = {k: dict(v) for k, v in _STATS.items()}
    return {"count": sum(v["count"] for v in by_kind.values()),
            "bytes": sum(v["bytes"] for v in by_kind.values()), "by_kind": by_kind}


def reset_collective_stats() -> None:
    _STATS.clear()


def stats_snapshot() -> dict:
    """A copy of the counts, for :func:`stats_since`."""
    return {k: dict(v) for k, v in _STATS.items()}


def stats_since(snapshot: dict) -> dict:
    """``{kind: (calls, bytes)}`` counted since ``snapshot``; the counts go
    back to it (a capture launches nothing)."""
    delta = {}
    for k, v in _STATS.items():
        old = snapshot.get(k, {"count": 0, "bytes": 0})
        if v["count"] != old["count"] or v["bytes"] != old["bytes"]:
            delta[k] = (v["count"] - old["count"], v["bytes"] - old["bytes"])
    _STATS.clear()
    _STATS.update({k: dict(v) for k, v in snapshot.items()})
    return delta


def add_stats(delta: dict) -> None:
    """Count ``delta`` (:func:`stats_since`'s), as a replay of the step
    it was recorded from issues it."""
    for k, (count, nbytes) in delta.items():
        st = _STATS.setdefault(k, {"count": 0, "bytes": 0})
        st["count"] += count
        st["bytes"] += nbytes


def backend(group=None) -> Optional[str]:
    """The backend of ``group`` (the default group when None), lower
    case, or None without a live group."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return str(dist.get_backend(group)).lower()


def capturable(group=None) -> bool:
    """Whether a CUDA graph can hold the collectives of ``group``: NCCL
    can be captured, gloo cannot (its collectives run on the host)."""
    return backend(group) == "nccl"


def hold_collectives(holder) -> None:
    """Register ``holder``, whose ``release_collectives()`` drops its graphs
    that hold collectives (``titanet_torch.train.capture.StepGraphs``), to
    be released before the group goes (:func:`destroy_process_group`, and
    at exit). The registry is weak: it keeps no holder alive."""
    _HOLDERS.add(holder)


def release_collectives() -> int:
    """Drop every registered holder's graphs that hold collectives, after
    the card has run them; returns how many went."""
    return sum(h.release_collectives() for h in list(_HOLDERS))


# before the interpreter's teardown destroys the process group (atexit runs
# its hooks last registered first, and torch.distributed's come before)
atexit.register(release_collectives)


def destroy_process_group() -> None:
    """Leave the default group: drop the graphs that hold its collectives
    (a graph must not outlive the communicators it holds), then destroy
    it. Every rank of the port leaves its group through this."""
    release_collectives()
    dist.destroy_process_group()


def abort() -> None:
    """Abort the default group's communicators: a collective that waits
    for a lost rank returns, so the process can fail instead of
    hanging."""
    dist.distributed_c10d._abort_process_group()


def all_reduce_(x: torch.Tensor, group=None, op=dist.ReduceOp.SUM, kind: str = "other") -> torch.Tensor:
    """In-place reduction (default: sum) of ``x`` over the ranks, not
    differentiable; counted under ``kind``."""
    st = _STATS.setdefault(kind, {"count": 0, "bytes": 0})
    st["count"] += 1
    st["bytes"] += x.numel() * x.element_size()
    dist.all_reduce(x, op=op, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    """``y = sum over ranks of x`` on every rank. Every rank's loss reads
    ``y``, so the gradient of the sum of the ranks' losses with respect to
    this rank's ``x`` is the sum over ranks of their gradients of ``y``:
    the backward is the same all-reduce."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return all_reduce_(x.detach().clone().contiguous(), group, kind=kind)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.detach().clone().contiguous(), ctx.group, kind=ctx.kind + "_backward"), None, None


def all_reduce(x: torch.Tensor, group=None, kind: str = "other") -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group`` (a new
    tensor; one collective forward, one backward, counted under ``kind``
    and ``kind + "_backward"``)."""
    return _AllReduceSum.apply(x, group, kind)


def all_gather_rows(x: torch.Tensor, rank: int, size: int, group=None, kind: str = "other") -> torch.Tensor:
    """Differentiable rank-ordered concatenation ``[size * B, ...]`` of every
    rank's ``x [B, ...]`` (equal shapes on every rank), as one all-reduce
    of a zero tensor that holds ``x`` at this rank's rows: the sum is exact
    (each entry has one non-zero term) and every backend offers it, gloo on
    CUDA tensors included. Its backward hands this rank the summed
    gradient of its rows."""
    b = x.shape[0]
    pad = [0, 0] * (x.dim() - 1) + [rank * b, (size - 1 - rank) * b]
    return all_reduce(torch.nn.functional.pad(x, pad), group, kind)
