"""The data-parallel layout and batch placement (port of
``titanet_tpu/parallel/mesh.py``).

The JAX package shards the batch over a device mesh and lets GSPMD insert
the collectives. Here one rank drives one device and the mesh is the
process group: :class:`Mesh` holds the world size, this rank, its device,
the group and the axis name. Parameters and optimizer state are replicated
(every rank applies the same averaged update); the batch is split by rows.

A step runs under a mesh by activating it (``with mesh.active():``, as
``train_step(..., mesh=mesh)`` does). While it is active:

- BatchNorm in training computes its statistics over the global batch
  (``titanet_torch.ops.norm``), or, for a module built with an
  ``axis_name``, the JAX ``shard_map`` rule (the mean of the ranks'
  moments);
- every random draw of the step (dropout, SpecAugment, noise) is made over
  the GLOBAL batch shape and each rank keeps its own rows
  (:func:`draw_rows`): the single-key draws of the JAX package's GSPMD
  step, so that P ranks compute what one process fed the concatenated
  batch computes. Each rank draws P times its share; with
  ``global_batch=False`` (the ``shard_map`` counterpart) the draws stay
  local.

At world size 1 nothing changes: no collective is issued and no draw is
widened.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from titanet_torch.parallel import distributed as pd


@dataclass(frozen=True)
class Mesh:
    """``size`` ranks along ``axis_name``; this process is ``rank`` and
    drives ``device``; ``group`` is the process group (None: the default
    group, or no group at size 1)."""

    size: int
    rank: int
    device: torch.device
    group: Any = None
    axis_name: str = "data"

    @contextlib.contextmanager
    def active(self, global_batch: bool = True):
        """Activate the mesh for the steps run inside (see the module
        docstring); ``global_batch=False`` keeps the draws local."""
        _ACTIVE.append((self, global_batch))
        try:
            yield self
        finally:
            _ACTIVE.pop()

    def agree_max(self, values) -> list:
        """The maximum over the ranks of each of ``values`` (ints; one
        all-reduce on this rank's device)."""
        if self.size == 1:
            return [int(v) for v in values]
        x = torch.tensor([int(v) for v in values], dtype=torch.int64, device=self.device)
        return pd.all_reduce_(x, self.group, torch.distributed.ReduceOp.MAX, kind="batch_width").tolist()

    def rank0_value(self, value: float) -> float:
        """Rank 0's ``value`` on every rank (one all-reduce), so that a
        decision taken from it is the same on every rank."""
        if self.size == 1:
            return value
        x = torch.tensor([value if self.rank == 0 else 0.0], dtype=torch.float64, device=self.device)
        return pd.all_reduce_(x, self.group, kind="decision").item()

    def rows(self, n_global: int) -> slice:
        """This rank's rows of a global batch of ``n_global`` rows."""
        if n_global % self.size:
            raise ValueError(
                f"a global batch of {n_global} rows does not split over {self.size} ranks "
                f"(batch size % mesh size = {n_global % self.size})"
            )
        b = n_global // self.size
        return slice(self.rank * b, (self.rank + 1) * b)


_ACTIVE: list = []


def active_mesh():
    """``(mesh, global_batch)`` of the innermost active mesh of size > 1,
    or ``(None, False)``."""
    if _ACTIVE and _ACTIVE[-1][0].size > 1:
        return _ACTIVE[-1]
    return None, False


def draw_rows(draw: Callable, shape) -> torch.Tensor:
    """``draw(shape)`` for a tensor whose leading axis is the batch: under
    an active mesh with global draws, ``draw`` runs over the global shape
    ``[size * B, ...]`` and this rank keeps rows ``[rank * B, (rank+1) *
    B)``. Every rank must pass the same local shape."""
    mesh, global_batch = active_mesh()
    if mesh is None or not global_batch:
        return draw(tuple(shape))
    b = shape[0]
    full = draw((b * mesh.size,) + tuple(shape[1:]))
    return full[mesh.rank * b:(mesh.rank + 1) * b]


def make_mesh(num_devices: Optional[int] = None, axis_name: str = "data", device="cuda") -> Mesh:
    """The mesh of the live process group (one rank a device), or a mesh
    of size 1 without one. ``num_devices``, when given, must equal the
    world size. ``device``: ``"cuda"`` gives each rank
    ``cuda:<LOCAL_RANK or rank> mod visible cards``; ``"cpu"`` the CPU."""
    from titanet_torch._device import resolve_device

    dev = resolve_device(device)
    rank, size = pd.world()
    if num_devices is not None and num_devices != size:
        raise ValueError(
            f"make_mesh({num_devices}) needs a process group of {num_devices} ranks, this one has "
            f"{size}: launch that many processes (TITANET_COORDINATOR/TITANET_NUM_PROCESSES/"
            "TITANET_PROCESS_ID, or TITANET_DISTRIBUTED=auto under torchrun), or set "
            "mesh.num_devices in the trainer's config, which starts them"
        )
    if dev.type == "cuda" and dev.index is None and size > 1:
        dev = torch.device("cuda", pd.local_device_index(rank))
    return Mesh(size=size, rank=rank, device=dev, group=None, axis_name=axis_name)


@dataclass(frozen=True)
class BatchSharding:
    """The rule for a rank's rows: the global batch is the rank-ordered
    concatenation of equal local batches (leading axis)."""

    mesh: Mesh
    axis_name: str = "data"

    def place(self, host_array) -> torch.Tensor:
        """This rank's rows of a GLOBAL host array, on its device."""
        x = torch.as_tensor(np.asarray(host_array))
        return x[self.mesh.rows(x.shape[0])].to(self.mesh.device)


@dataclass(frozen=True)
class Replicated:
    """The rule for replicated tensors: rank 0's value on every rank."""

    mesh: Mesh

    def place(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` on this rank's device, overwritten with rank 0's value."""
        x = x.to(self.mesh.device)
        if self.mesh.size > 1:
            torch.distributed.broadcast(x, src=0, group=self.mesh.group)
        return x


def batch_sharding(mesh: Mesh, axis_name: str = "data") -> BatchSharding:
    """Leading-axis (batch) split over the ranks."""
    return BatchSharding(mesh, axis_name)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def shard_batch(batch: dict, mesh: Mesh, axis_name: str = "data") -> dict:
    """A host batch (dict of arrays, the GLOBAL batch) -> this rank's rows
    of each, on its device."""
    sharding = batch_sharding(mesh, axis_name)
    return {k: sharding.place(v) for k, v in batch.items()}
