"""TitaNet S/M/L, its fused serving variant (:mod:`.fused_inference`) and its
int8 one (:mod:`.quantized`); the rest of the JAX package's model zoo is not
ported yet."""

import torch

from titanet_torch.models.titanet import (  # noqa: F401
    TARGET_PARAMS,
    ConvBlock1d,
    Decoder,
    Encoder,
    MegaBlock,
    TitaNet,
    find_n_mega_blocks,
    get_titanet,
    titanet_param_count,
)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize(p=2) semantics."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)
