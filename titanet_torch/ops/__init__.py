"""Ops of the port: frontend, convolutions, BatchNorm, SE, pooling, and
the CUDA kernels in :mod:`titanet_torch.ops.kernels`."""

from titanet_torch.ops.conv import (  # noqa: F401
    DepthwiseSeparableConv1d,
    SamePadConv1d,
    conv1d_same,
    same_padding,
)
from titanet_torch.ops.augment import (  # noqa: F401
    AugmentConfig,
    log_mel_specaugment,
    spec_augment,
)
from titanet_torch.ops.norm import BatchNorm  # noqa: F401
from titanet_torch.ops.pooling import (  # noqa: F401
    AttentiveStatsPooling,
    SimplePooling,
    attentive_stats,
)
from titanet_torch.ops.se import SqueezeExcitation  # noqa: F401
