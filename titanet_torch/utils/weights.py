"""Weight bridge from the JAX package's variables to the port's modules.

``load_jax_variables(model, params, batch_stats)`` takes the JAX
``{"params", "batch_stats"}`` trees as nested dicts of arrays (anything
``np.asarray`` reads) and fills the port's module by path: the port's
module attribute names are the JAX tree's keys.

- 1-D conv kernels, WIO ``[K, in/groups, out]`` -> ``weight [out, in/groups, K]``
  (a grouped conv's ``[K, 1, C]`` -> ``[C, 1, K]``);
- 2-D conv kernels ``[kT, kF, in, out]`` -> ``weight [out, in, kT, kF]``;
- Dense kernels ``[in, out]`` -> ``weight [out, in]``;
- BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, and ``mean``/``var``
  from ``batch_stats`` -> ``running_mean``/``running_var``;
- LayerNorm ``scale``/``bias`` -> ``weight``/``bias``;
- a flax ``OptimizedLSTMCell`` (per-gate ``i{i,f,g,o}/kernel [in, H]`` and
  ``h{i,f,g,o}/kernel [H, H]``, ``h*/bias``) -> an ``LSTMLayer``'s packed
  ``weight_ih [4H, in]``, ``weight_hh [4H, H]`` and ``bias [4H]``, gate
  rows i, f, g, o (the inverse of the JAX package's
  ``convert_dvector_state_dict``);
- a parameter held directly by any other module (the angular-margin head's
  ``weight [E, N*K]``, GE2E's ``w`` and ``b``) -> the leaf of its own name,
  in the JAX layout.

``load_jax_train_state(model, head, params, batch_stats)`` does the same
for a train state's ``params = {"backbone", "head"}``.

Every leaf of both trees must be used and every shape must match; it
raises otherwise.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from titanet_torch.models.baselines import LSTMLayer
from titanet_torch.ops.conv import Conv2d, SamePadConv1d
from titanet_torch.ops.dense import Dense
from titanet_torch.ops.norm import BatchNorm, LayerNorm

LSTM_GATES = ("i", "f", "g", "o")  # torch's packed row order


def _node(tree: Mapping, path):
    node = tree
    for key in path:
        if not isinstance(node, Mapping) or key not in node:
            raise KeyError(f"JAX variables have no entry {'/'.join(path)}")
        node = node[key]
    return node


def _count_leaves(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def _assign(target: torch.Tensor, value, where: str) -> None:
    arr = np.array(value, dtype=np.float32)  # a writable copy
    if tuple(arr.shape) != tuple(target.shape):
        raise ValueError(f"{where}: shape {arr.shape} does not match {tuple(target.shape)}")
    with torch.no_grad():
        target.copy_(torch.from_numpy(arr))


def load_jax_variables(
    model: nn.Module, params: Mapping, batch_stats: Optional[Mapping] = None
) -> nn.Module:
    """Fill ``model`` from the JAX trees in place; returns ``model``."""
    batch_stats = batch_stats or {}
    used_params = used_stats = 0
    for name, mod in model.named_modules():
        path = name.split(".") if name else []
        where = "/".join(path)
        if isinstance(mod, (SamePadConv1d, Dense)):
            node = _node(params, path)
            kernel = np.asarray(node["kernel"])
            kernel = np.transpose(kernel, (2, 1, 0)) if kernel.ndim == 3 else kernel.T
            _assign(mod.weight, kernel, where + "/kernel")
            used_params += 1
            if mod.bias is not None:
                _assign(mod.bias, node["bias"], where + "/bias")
                used_params += 1
        elif isinstance(mod, Conv2d):
            node = _node(params, path)
            _assign(mod.weight, np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)), where + "/kernel")
            used_params += 1
            if mod.bias is not None:
                _assign(mod.bias, node["bias"], where + "/bias")
                used_params += 1
        elif isinstance(mod, LayerNorm):
            node = _node(params, path)
            _assign(mod.weight, node["scale"], where + "/scale")
            _assign(mod.bias, node["bias"], where + "/bias")
            used_params += 2
        elif isinstance(mod, LSTMLayer):
            node = _node(params, path)
            gate = lambda k, leaf: np.asarray(_node(node, [k, leaf]))  # noqa: E731
            _assign(mod.weight_ih, np.concatenate([gate(f"i{g}", "kernel").T for g in LSTM_GATES]),
                    where + "/i*/kernel")
            _assign(mod.weight_hh, np.concatenate([gate(f"h{g}", "kernel").T for g in LSTM_GATES]),
                    where + "/h*/kernel")
            _assign(mod.bias, np.concatenate([gate(f"h{g}", "bias") for g in LSTM_GATES]), where + "/h*/bias")
            used_params += 3 * len(LSTM_GATES)
        elif isinstance(mod, BatchNorm):
            node = _node(params, path)
            _assign(mod.weight, node["scale"], where + "/scale")
            _assign(mod.bias, node["bias"], where + "/bias")
            stats = _node(batch_stats, path)
            _assign(mod.running_mean, stats["mean"], where + "/mean")
            _assign(mod.running_var, stats["var"], where + "/var")
            used_params += 2
            used_stats += 2
        else:
            for pname, param in mod.named_parameters(recurse=False):
                _assign(param, _node(params, path + [pname]), f"{where}/{pname}")
                used_params += 1
    if used_params != _count_leaves(params) or used_stats != _count_leaves(batch_stats):
        raise ValueError(
            f"JAX variables do not match the module: used {used_params} of "
            f"{_count_leaves(params)} params and {used_stats} of "
            f"{_count_leaves(batch_stats)} batch_stats leaves"
        )
    return model


def load_jax_train_state(
    model: nn.Module, head: nn.Module, params: Mapping, batch_stats: Optional[Mapping] = None
):
    """Fill ``model`` and ``head`` in place from a JAX train state's
    ``params = {"backbone": ..., "head": ...}`` and ``batch_stats``;
    returns ``(model, head)``."""
    if set(params) != {"backbone", "head"}:
        raise ValueError(f"params must have keys backbone and head, got {sorted(params)}")
    load_jax_variables(model, params["backbone"], batch_stats)
    load_jax_variables(head, params["head"])
    return model, head
