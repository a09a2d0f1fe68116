"""Model zoo: TitaNet S/M/L (with its fused serving variant,
:mod:`.fused_inference`, and its int8 one, :mod:`.quantized`), ECAPA-TDNN,
x-vector TDNN, ResNet r-vector, MFA-Conformer, the d-vector LSTM baseline
and the smoke-test convnet (port of ``titanet_tpu/models``)."""

import torch

from titanet_torch.models.baselines import (  # noqa: F401
    DumbConvNet,
    DVectorBaseline,
)
from titanet_torch.models.ecapa import (  # noqa: F401
    EcapaTdnn,
    get_ecapa,
)
from titanet_torch.models.xvector import (  # noqa: F401
    XVector,
    get_xvector,
)
from titanet_torch.models.resnet import (  # noqa: F401
    SpeakerResNet,
    get_resnet,
)
from titanet_torch.models.conformer import (  # noqa: F401
    MfaConformer,
    get_conformer,
)
from titanet_torch.models.quantized import (  # noqa: F401
    QuantTitaNet,
    quantize_titanet,
    titanet_apply_quantized,
)
from titanet_torch.models.titanet import (  # noqa: F401
    TARGET_PARAMS,
    ConvBlock1d,
    Decoder,
    Encoder,
    MegaBlock,
    TitaNet,
    find_n_mega_blocks,
    get_titanet,
    stack_mega_block_params,
    titanet_param_count,
    unstack_mega_block_params,
)


def count_params(model: torch.nn.Module) -> int:
    """Number of parameter entries (the JAX package's ``count_params``
    counts its parameter tree's, which the port's modules mirror)."""
    return sum(p.numel() for p in model.parameters())


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize(p=2) semantics."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)
