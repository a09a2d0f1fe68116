"""The measured program's objects, built from the benchmark's weights.

The model is made on the meta device (no weights drawn) and then filled
with the weights the benchmark drew, so that the program and the plain
reference start from one set of numbers that neither made.
"""

from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference import titanet as ref_titanet


def frontend(cfg: dict):
    from titanet_torch.ops.frontend import FrontendConfig

    fe = cfg["frontend"]
    return FrontendConfig(sample_rate=fe["sample_rate"], n_fft=fe["n_fft"], win_length=fe["win_length"],
                          hop_length=fe["hop_length"], n_mels=fe["n_mels"], precision=fe["precision"],
                          use_pallas_fused=fe["fused"])


def titanet(cfg: dict, weights: Dict[str, torch.Tensor], device, dropout: float = 0.0):
    """``titanet_torch.models.titanet.TitaNet`` of ``cfg`` on ``device``
    holding ``weights`` (parameters and, where given, BatchNorm running
    statistics; zeros and ones otherwise)."""
    from titanet_torch.models.titanet import TitaNet

    with torch.device("meta"):
        model = TitaNet(
            n_mels=cfg["frontend"]["n_mels"], n_mega_blocks=cfg["n_mega_blocks"],
            n_sub_blocks=cfg["n_sub_blocks"], encoder_hidden_size=cfg["hidden_size"],
            encoder_output_size=cfg["output_size"], embedding_size=cfg["embedding_size"],
            mega_block_kernel_size=cfg["kernel_size"], prolog_kernel_size=cfg["prolog_kernel_size"],
            epilog_kernel_size=cfg["epilog_kernel_size"], attention_hidden_size=cfg["attention_hidden_size"],
            se_reduction=cfg["se_reduction"], dropout=dropout, dtype=getattr(torch, cfg["compute_dtype"]),
        )
    model.to_empty(device=device)
    sd = {n: weights[n] for n, *_ in ref_titanet.param_spec(cfg)}
    for name, c in ref_titanet.norm_sites(cfg):
        sd[f"{name}.running_mean"] = weights.get(f"{name}.running_mean", torch.zeros(c, device=device))
        sd[f"{name}.running_var"] = weights.get(f"{name}.running_var", torch.ones(c, device=device))
    model.load_state_dict(sd, strict=True)
    return model
