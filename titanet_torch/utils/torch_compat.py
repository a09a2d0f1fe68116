"""The reference implementation's ``.pth`` checkpoints in and out of the
port (the port's counterpart of ``titanet_tpu/utils/torch_compat.py``).

The reference saves ``{"model": TitaNet.state_dict(), "optimizer", ...}``
(its ``src/learn.py:188-199``), keyed by its own module paths
(``encoder.mega_blocks.0.sub_blocks.0.conv_block.0.conv.0.weight``); the
port names its modules after the JAX parameter tree
(``encoder.mega_block_0.sub_block_0.conv.depthwise.weight``). Both keep
torch layouts (conv ``[out, in/groups, K]``, linear ``[out, in]``,
BatchNorm ``weight``/``bias``/``running_mean``/``running_var``), so the
mapping renames keys and copies values; only the angular-margin head's
weight is transposed (the port keeps the JAX layout ``[E, n_classes]``).

- :func:`convert_titanet_state_dict`, :func:`convert_head_state_dict`:
  reference keys -> the port's ``state_dict`` keys;
- :func:`load_reference_checkpoint`: a reference ``.pth`` -> a port
  ``TitaNet`` (its architecture read from the keys and shapes), or its
  ``state_dict``, and the head's state dict when asked;
- :func:`export_titanet_state_dict`, :func:`export_head_state_dict`,
  :func:`save_reference_checkpoint`: the way back, to reference keys;
- :func:`convert_dvector_state_dict`: the reference's d-vector baseline
  (``recurrent.*`` of its ``nn.LSTM``, ``projection.*``) -> the port's
  :class:`~titanet_torch.models.DVectorBaseline`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(x))


def _ids(sd: Dict, prefix: str, field: int, needle: str = "") -> list:
    """Sorted integer ids at dotted position ``field`` of the keys under
    ``prefix`` (that also hold ``needle``)."""
    return sorted({int(k.split(".")[field]) for k in sd if k.startswith(prefix) and needle in k})


def _suffix_ids(sd: Dict, prefix: str, field: int) -> list:
    """Sorted integer suffixes (``mega_block_3`` -> 3) of dotted position
    ``field`` of the port's keys under ``prefix``."""
    return sorted({int(k.split(".")[field].rsplit("_", 1)[1]) for k in sd if k.startswith(prefix)})


def convert_titanet_state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    """Reference ``TitaNet.state_dict()`` -> the port's ``TitaNet`` state
    dict. Mega-block and sub-block counts come from the keys. Reference
    module paths (its ``src/models.py:342-584``, ``src/modules.py``):

      encoder.prolog.conv_block.{0=conv,1=bn}
      encoder.mega_blocks.{i}.sub_blocks.{j}.conv_block.{0=dwconv,1=bn}   j<n_sub
      encoder.mega_blocks.{i}.sub_blocks.{n_sub}.excitation.{0,2}        (SE)
      encoder.mega_blocks.{i}.skip_connection.{0=conv,1=bn}
      encoder.epilog.conv_block.{0=conv,1=bn}
      decoder.pool.0.{in_linear,out_linear} ; decoder.pool.1 (bn)
      decoder.linear.{0=linear,1=bn}
    """
    out: Dict[str, torch.Tensor] = {}

    def copy(dst: str, src: str, names=("weight", "bias")) -> None:
        for n in names:
            if f"{src}.{n}" in sd:
                out[f"{dst}.{n}"] = _tensor(sd[f"{src}.{n}"])

    def bn(dst: str, src: str) -> None:
        copy(dst, src, ("weight", "bias", "running_mean", "running_var"))

    def conv_block(dst: str, src: str, depthwise: bool) -> None:
        if depthwise:
            copy(f"{dst}.conv.depthwise", f"{src}.conv_block.0.conv.0")
            copy(f"{dst}.conv.pointwise", f"{src}.conv_block.0.conv.1")
        else:
            copy(f"{dst}.conv", f"{src}.conv_block.0")
        bn(f"{dst}.norm", f"{src}.conv_block.1")

    conv_block("encoder.prolog", "encoder.prolog", False)
    conv_block("encoder.epilog", "encoder.epilog", False)
    for i in _ids(sd, "encoder.mega_blocks.", 2):
        src, dst = f"encoder.mega_blocks.{i}", f"encoder.mega_block_{i}"
        subs = _ids(sd, f"{src}.sub_blocks.", 4, "conv_block")
        for j in subs:
            conv_block(f"{dst}.sub_block_{j}", f"{src}.sub_blocks.{j}", True)
        copy(f"{dst}.se.fc1", f"{src}.sub_blocks.{len(subs)}.excitation.0")
        copy(f"{dst}.se.fc2", f"{src}.sub_blocks.{len(subs)}.excitation.2")
        copy(f"{dst}.skip_conv", f"{src}.skip_connection.0")
        bn(f"{dst}.skip_norm", f"{src}.skip_connection.1")
    if "decoder.pool.0.in_linear.weight" in sd:  # attentive pooling
        copy("decoder.pool.in_linear", "decoder.pool.0.in_linear")
        copy("decoder.pool.out_linear", "decoder.pool.0.out_linear")
        bn("decoder.pool_norm", "decoder.pool.1")
    else:  # simple pool: AdaptiveAvgPool1d, Squeeze, Linear
        copy("decoder.pool.linear", "decoder.pool.2")
    copy("decoder.linear", "decoder.linear.0")
    bn("decoder.linear_norm", "decoder.linear.1")
    return out


def convert_dvector_state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    """Reference ``DVectorBaseline.state_dict()`` (its ``src/models.py:70-159``:
    ``recurrent`` an ``nn.LSTM``, ``projection`` a ``Linear``) -> the port's
    ``DVectorBaseline`` state dict. Both keep torch's packed gate layout
    (rows i, f, g, o); the port's layer ``k`` is ``lstm_{k}`` with one
    bias, the sum of the reference's ``bias_ih_l{k}`` and ``bias_hh_l{k}``
    (torch adds the two at run time)."""
    out: Dict[str, torch.Tensor] = {}
    layer = 0
    while f"recurrent.weight_ih_l{layer}" in sd:
        src, dst = "recurrent", f"lstm_{layer}"
        out[f"{dst}.weight_ih"] = _tensor(sd[f"{src}.weight_ih_l{layer}"])
        out[f"{dst}.weight_hh"] = _tensor(sd[f"{src}.weight_hh_l{layer}"])
        out[f"{dst}.bias"] = _tensor(sd[f"{src}.bias_ih_l{layer}"]) + _tensor(sd[f"{src}.bias_hh_l{layer}"])
        layer += 1
    if not layer:
        raise KeyError("no recurrent.weight_ih_l0: not a reference d-vector state dict")
    out["projection.weight"] = _tensor(sd["projection.weight"])
    out["projection.bias"] = _tensor(sd["projection.bias"])
    return out


def convert_head_state_dict(sd: Dict) -> Optional[Dict[str, torch.Tensor]]:
    """The classification head's state dict in the port's layout, or None
    when the checkpoint holds no ``loss_function.*`` keys (the reference
    registers its loss module on the model): CE ``fc.weight``/``fc.bias``;
    angular margin ``weight [E, n_classes]`` (the reference's
    ``fc.weight`` transposed); GE2E ``w``, ``b``."""
    if "loss_function.fc.weight" in sd:
        if "loss_function.fc.bias" in sd:  # CEHead
            return {"fc.weight": _tensor(sd["loss_function.fc.weight"]),
                    "fc.bias": _tensor(sd["loss_function.fc.bias"])}
        return {"weight": _tensor(sd["loss_function.fc.weight"]).t().contiguous()}  # angular
    if "loss_function.w" in sd:  # GE2E: scalars (a file may hold them as [1])
        return {"w": _tensor(sd["loss_function.w"]).reshape(()), "b": _tensor(sd["loss_function.b"]).reshape(())}
    return None


def titanet_from_state_dict(sd: Dict[str, torch.Tensor], dtype=None, device="cuda"):
    """A port ``TitaNet`` shaped as the port state dict ``sd`` says (every
    width, kernel size and count read from the keys and shapes), holding
    its values; in eval mode on ``device``. Raises on a missing or
    unexpected key."""
    from titanet_torch._device import resolve_device
    from titanet_torch.models.titanet import TitaNet

    dev = resolve_device(device)
    prolog = sd["encoder.prolog.conv.weight"]  # [H, n_mels, K]
    blocks = _suffix_ids(sd, "encoder.mega_block_", 1)
    first = "encoder.mega_block_0"
    n_sub = len(_suffix_ids(sd, f"{first}.sub_block_", 2)) if blocks else 3
    simple = "decoder.pool.linear.weight" in sd
    hidden = prolog.shape[0]
    kwargs = dict(
        n_mels=prolog.shape[1],
        n_mega_blocks=len(blocks),
        n_sub_blocks=n_sub,
        encoder_hidden_size=hidden,
        encoder_output_size=sd["encoder.epilog.conv.weight"].shape[0],
        embedding_size=sd["decoder.linear.weight"].shape[0],
        prolog_kernel_size=prolog.shape[2],
        epilog_kernel_size=sd["encoder.epilog.conv.weight"].shape[2],
        simple_pool=simple,
        dtype=dtype,
    )
    if blocks:
        kwargs["mega_block_kernel_size"] = sd[f"{first}.sub_block_0.conv.depthwise.weight"].shape[2]
        kwargs["se_reduction"] = hidden // sd[f"{first}.se.fc1.weight"].shape[0]
    if not simple:
        kwargs["attention_hidden_size"] = sd["decoder.pool.in_linear.weight"].shape[0]
    model = TitaNet(**kwargs)
    model.load_state_dict({k: v.float() for k, v in sd.items()}, strict=True)
    return model.to(dev).eval()


def load_reference_checkpoint(path: str, with_head: bool = False, as_model: bool = True,
                              dtype=None, device="cuda"):
    """Load a reference ``.pth`` checkpoint (a bare state dict or the
    ``{"model": ...}`` blob the reference saves).

    Returns a port ``TitaNet`` in eval mode on ``device`` (``as_model``), or
    the port's state dict; with ``with_head``, a pair whose second element
    is the head's state dict in the port's layout (None when the checkpoint
    has no loss module), to load into ``build_head(name, E, n_classes)``
    (the head's kind and margins are not in the checkpoint)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("model", blob) if isinstance(blob, dict) else blob
    state = convert_titanet_state_dict(sd)
    out = titanet_from_state_dict(state, dtype=dtype, device=device) if as_model else state
    if with_head:
        return out, convert_head_state_dict(sd)
    return out


def _state(module_or_sd) -> Dict[str, torch.Tensor]:
    if isinstance(module_or_sd, torch.nn.Module):
        return module_or_sd.state_dict()
    return module_or_sd


def _np(t) -> np.ndarray:
    return _tensor(t).numpy()


def export_titanet_state_dict(model) -> Dict[str, np.ndarray]:
    """Inverse of :func:`convert_titanet_state_dict`: a port ``TitaNet`` (or
    its state dict) -> a numpy-valued dict keyed exactly like the
    reference's ``TitaNet.state_dict()``, BatchNorm's
    ``num_batches_tracked`` included (0), so a reference user can
    ``load_state_dict`` weights trained with the port."""
    sd = _state(model)
    out: Dict[str, np.ndarray] = {}

    def copy(dst: str, src: str, names=("weight", "bias")) -> None:
        for n in names:
            if f"{src}.{n}" in sd:
                out[f"{dst}.{n}"] = _np(sd[f"{src}.{n}"])

    def bn(dst: str, src: str) -> None:
        copy(dst, src, ("weight", "bias", "running_mean", "running_var"))
        out[f"{dst}.num_batches_tracked"] = np.asarray(0, np.int64)

    def conv_block(dst: str, src: str, depthwise: bool) -> None:
        if depthwise:
            copy(f"{dst}.conv_block.0.conv.0", f"{src}.conv.depthwise")
            copy(f"{dst}.conv_block.0.conv.1", f"{src}.conv.pointwise")
        else:
            copy(f"{dst}.conv_block.0", f"{src}.conv")
        bn(f"{dst}.conv_block.1", f"{src}.norm")

    conv_block("encoder.prolog", "encoder.prolog", False)
    conv_block("encoder.epilog", "encoder.epilog", False)
    for i in _suffix_ids(sd, "encoder.mega_block_", 1):
        src, dst = f"encoder.mega_block_{i}", f"encoder.mega_blocks.{i}"
        subs = _suffix_ids(sd, f"{src}.sub_block_", 2)
        for j in subs:
            conv_block(f"{dst}.sub_blocks.{j}", f"{src}.sub_block_{j}", True)
        copy(f"{dst}.sub_blocks.{len(subs)}.excitation.0", f"{src}.se.fc1")
        copy(f"{dst}.sub_blocks.{len(subs)}.excitation.2", f"{src}.se.fc2")
        copy(f"{dst}.skip_connection.0", f"{src}.skip_conv")
        bn(f"{dst}.skip_connection.1", f"{src}.skip_norm")
    if "decoder.pool.in_linear.weight" in sd:  # attentive pooling
        copy("decoder.pool.0.in_linear", "decoder.pool.in_linear")
        copy("decoder.pool.0.out_linear", "decoder.pool.out_linear")
        bn("decoder.pool.1", "decoder.pool_norm")
    else:  # simple pool
        copy("decoder.pool.2", "decoder.pool.linear")
    copy("decoder.linear.0", "decoder.linear")
    bn("decoder.linear.1", "decoder.linear_norm")
    return out


def export_head_state_dict(head_name: str, head) -> Dict[str, np.ndarray]:
    """A port head (or its state dict) -> the reference's
    ``loss_function.*`` keys: CE ``fc.weight`` + ``fc.bias``, angular
    ``fc.weight`` ``[n_classes, E]``, GE2E ``w``/``b``."""
    sd = _state(head)
    if head_name == "ce":
        return {"loss_function.fc.weight": _np(sd["fc.weight"]), "loss_function.fc.bias": _np(sd["fc.bias"])}
    if head_name in ("arc", "cos", "sphere"):
        return {"loss_function.fc.weight": _np(sd["weight"]).T}
    if head_name == "ge2e":
        return {"loss_function.w": _np(sd["w"]), "loss_function.b": _np(sd["b"])}
    raise ValueError(f"unknown head {head_name!r}")


def save_reference_checkpoint(path: str, model, head_name: Optional[str] = None, head=None,
                              epoch: int = 0) -> None:
    """Write a reference-format ``.pth`` (the layout its ``learn.py``
    saves: model / optimizer / lr_scheduler / epoch) from a port model and,
    optionally, its head. The optimizer and scheduler slots are empty."""
    sd = export_titanet_state_dict(model)
    if head_name is not None and head is not None:
        sd.update(export_head_state_dict(head_name, head))
    torch.save({
        "model": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},  # 0-d stays 0-d
        "optimizer": {},
        "lr_scheduler": {},
        "epoch": int(epoch),
    }, path)
