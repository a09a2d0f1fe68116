"""Checkpoints with resume (replaces the JAX package's orbax module,
``titanet_tpu/train/checkpoint.py``).

The layout is the JAX package's: one directory per epoch under the run
directory (``<run>/<epoch>/``), ``0`` holding the best checkpoint the
training loop tracks, and every checkpoint kept, as the JAX package's
``save_checkpoint`` keeps them (its orbax manager's ``max_to_keep`` is
None). Each directory holds ``state.pt``,
written with ``torch.save`` into a temporary directory that is renamed into
place, and read back with ``torch.load(weights_only=True)``.

A checkpoint holds everything a train step reads: the model's and the
head's parameters and buffers (BatchNorm running statistics included), the
optimizer state and its step count, the step, the weight EMA, and the
dropout, SpecAugment and noise generators (CUDA generators too), so a
resumed run continues as the straight run would.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

from titanet_torch.train.state import TrainState

FILENAME = "state.pt"


def _epochs(path: str):
    if not os.path.isdir(path):
        return []
    return sorted(
        int(d) for d in os.listdir(path)
        if d.isdigit() and os.path.isfile(os.path.join(path, d, FILENAME))
    )


def _cpu(tensors):
    return None if tensors is None else [t.detach().cpu() for t in tensors]


def state_dict(state: TrainState) -> dict:
    """The train state as a dict of CPU tensors and plain values."""
    opt = state.opt_state
    return {
        "model": {k: v.cpu() for k, v in state.model.state_dict().items()},
        "head": {k: v.cpu() for k, v in state.head.state_dict().items()},
        "step": int(state.step),
        "opt_state": {
            "count": int(opt.count), "mini_step": int(opt.mini_step),
            "mu": _cpu(opt.mu), "nu": _cpu(opt.nu), "acc": _cpu(opt.acc),
        },
        "ema": _cpu(state.ema),
        "generators": {name: g.get_state() for name, g in state.generators().items()},
    }


def load_state_dict(state: TrainState, data: dict) -> TrainState:
    """Copy ``data`` (from :func:`state_dict`) into ``state`` in place;
    returns ``state``. Shapes and list lengths must match."""
    state.model.load_state_dict(data["model"])
    state.head.load_state_dict(data["head"])
    state.step = int(data["step"])
    opt, saved = state.opt_state, data["opt_state"]
    opt.count, opt.mini_step = int(saved["count"]), int(saved["mini_step"])
    with torch.no_grad():
        for name in ("mu", "nu", "acc"):
            _copy_list(getattr(opt, name), saved[name], f"opt_state.{name}")
        _copy_list(state.ema, data["ema"], "ema")
    for name, g in state.generators().items():
        g.set_state(data["generators"][name])
    return state


def _copy_list(dst, src, what: str) -> None:
    if (dst is None) != (src is None):
        raise ValueError(f"checkpoint and state disagree on {what}")
    if dst is None:
        return
    if len(dst) != len(src):
        raise ValueError(f"{what}: {len(src)} tensors in the checkpoint, {len(dst)} in the state")
    for d, s in zip(dst, src):
        if d.shape != s.shape:
            raise ValueError(f"{what}: shape {tuple(s.shape)} in the checkpoint, {tuple(d.shape)} in the state")
        d.copy_(s)


def save_checkpoint(path: str, epoch: int, state: TrainState) -> None:
    """Save the full train state under ``path/<epoch>``."""
    final = os.path.join(os.path.abspath(path), str(int(epoch)))
    tmp = f"{final}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state_dict(state), os.path.join(tmp, FILENAME))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)


def latest_epoch(path: str) -> Optional[int]:
    """The newest epoch saved under ``path``, or None."""
    epochs = _epochs(path)
    return epochs[-1] if epochs else None


def read_checkpoint(path: str, epoch: int) -> dict:
    """The saved dict of ``path/<epoch>`` (CPU tensors), as
    :func:`state_dict` made it."""
    return torch.load(os.path.join(path, str(int(epoch)), FILENAME), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(path: str, epoch: int, state: TrainState) -> TrainState:
    """Load ``path/<epoch>`` into ``state`` (built as training built it, on
    the device to restore to) in place; returns ``state``."""
    return load_state_dict(state, read_checkpoint(path, epoch))


def restore_latest(path: str, state: TrainState):
    """-> (state, epoch) from the newest checkpoint, or (None, 0)."""
    epoch = latest_epoch(path)
    if epoch is None:
        return None, 0
    return restore_checkpoint(path, epoch, state), epoch
