"""Heads of the port (:mod:`.heads`): CE, angular margin (SphereFace,
CosFace, ArcFace), GE2E. Each returns ``(normalized_embeddings,
predictions, loss)``."""

from titanet_torch.losses.heads import (  # noqa: F401
    LOSSES,
    AngularMarginHead,
    ArcFaceHead,
    CEHead,
    CosFaceHead,
    GE2EHead,
    SphereFaceHead,
    build_head,
    head_param_count,
    renormalize_params,
)
