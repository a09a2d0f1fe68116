"""Classification and metric heads: CE, SphereFace/CosFace/ArcFace, GE2E
(port of ``titanet_tpu/losses/heads.py``).

Every head maps ``(embeddings [B, E], targets [B])`` to
``(unit-norm embeddings, predictions or None, scalar loss)`` in f32. The
parameter layouts are the JAX package's: ``CEHead.fc`` is a Dense layer,
``AngularMarginHead.weight`` is ``[E, n_classes * sub_centers]`` (no
transpose), ``GE2EHead`` has scalars ``w`` and ``b``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from titanet_torch._device import resolve_device
from titanet_torch.ops.conv import torch_conv_init_
from titanet_torch.ops.dense import Dense


def _l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=eps)


def _safe_l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    """L2 normalize with a finite gradient at x == 0 (a leave-one-out
    centroid of a speaker with one utterance in the batch is all zero)."""
    sumsq = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sumsq, min=eps * eps))


class CEHead(nn.Module):
    """Linear(E -> n_classes) + softmax cross-entropy."""

    def __init__(self, n_classes: int, embedding_size: int = 192):
        super().__init__()
        self.n_classes, self.embedding_size = n_classes, embedding_size
        self.fc = Dense(embedding_size, n_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.fc.reset_parameters(generator)

    def forward(self, embeddings: torch.Tensor, targets: torch.Tensor):
        logits = self.fc(embeddings).float()
        preds = torch.argmax(logits, dim=-1)
        logp = F.log_softmax(logits, dim=-1)
        loss = -torch.mean(torch.gather(logp, 1, targets.long()[:, None]))
        return _l2_normalize(embeddings), preds, loss


class AngularMarginHead(nn.Module):
    """SphereFace/CosFace/ArcFace through ``(m1, m2, m3)``:

      target logit     = scale * (cos(m1*theta + m2) - m3)
      non-target logit = scale * cos(theta)
      loss = CE over those logits, with ``+eps`` inside the log

    The forward always uses the column-normalized weight; pass the head
    through :func:`renormalize_params` after each optimizer step to project
    the stored weight as the reference does. ``stable`` clamps cosines to
    ``1 - 1e-7`` (a finite arccos gradient); ``sub_centers`` K > 1 takes the
    per-class max over K prototype columns; ``margin_scale`` (a scalar in
    [0, 1]) scales every margin toward its identity value; None keeps the
    plain margins.
    """

    def __init__(
        self,
        n_classes: int,
        embedding_size: int = 192,
        scale: Optional[float] = None,
        m1: float = 1.0,
        m2: float = 0.0,
        m3: float = 0.0,
        eps: float = 1e-6,
        stable: bool = True,
        sub_centers: int = 1,
    ):
        super().__init__()
        self.n_classes, self.embedding_size = n_classes, embedding_size
        self.scale, self.m1, self.m2, self.m3 = scale, m1, m2, m3
        self.eps, self.stable, self.sub_centers = eps, stable, sub_centers
        self.weight = nn.Parameter(torch.empty(embedding_size, n_classes * sub_centers))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        torch_conv_init_(self.weight, self.embedding_size, generator)

    def forward(self, embeddings: torch.Tensor, targets: torch.Tensor, margin_scale=None):
        emb32 = embeddings.float()
        norms = torch.linalg.vector_norm(emb32, dim=-1)
        normalized = emb32 / torch.clamp(norms[:, None], min=1e-12)
        w = _l2_normalize(self.weight.float(), dim=0)
        lim = 1.0 - 1e-7 if self.stable else 1.0
        cosines = torch.clamp(normalized @ w, -lim, lim)
        if self.sub_centers > 1:
            cosines = cosines.reshape(-1, self.n_classes, self.sub_centers).amax(dim=-1)
        preds = torch.argmax(cosines, dim=-1)
        scales = torch.full_like(norms, self.scale) if self.scale is not None else norms
        angles = torch.arccos(cosines)
        tgt = targets.long()
        target_angle = torch.gather(angles, 1, tgt[:, None])[:, 0]
        if margin_scale is None:
            m1, m2, m3 = self.m1, self.m2, self.m3
        else:
            s = torch.as_tensor(margin_scale, dtype=torch.float32, device=emb32.device)
            m1 = 1.0 + s * (self.m1 - 1.0)
            m2 = s * self.m2
            m3 = s * self.m3
        numerator = scales * (torch.cos(m1 * target_angle + m2) - m3)
        all_logits = scales[:, None] * cosines
        onehot = F.one_hot(tgt, self.n_classes).bool()
        masked = torch.where(onehot, torch.full_like(all_logits, -float("inf")), all_logits)
        denominator = torch.exp(numerator) + torch.sum(
            torch.where(onehot, torch.zeros_like(masked), torch.exp(masked)), dim=-1
        )
        loss = -torch.mean(numerator - torch.log(denominator + self.eps))
        return normalized, preds, loss


class SphereFaceHead(AngularMarginHead):
    """Multiplicative angular margin (reference src/losses.py:135-149):
    m1 = margin > 1."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if not self.m1 > 1:
            raise ValueError("Margin out of bounds")


def make_sphereface(n_classes, embedding_size=192, scale=None, margin=4.0, **kw):
    """Multiplicative angular margin: m1 = margin > 1."""
    if not margin > 1:
        raise ValueError("Margin out of bounds")
    return SphereFaceHead(n_classes, embedding_size, scale=scale, m1=margin, **kw)


class CosFaceHead(AngularMarginHead):
    """Additive cosine margin (reference src/losses.py:152-166): m3 = margin."""


def make_cosface(n_classes, embedding_size=192, scale=64.0, margin=0.2, **kw):
    """Additive cosine margin: m3 = margin."""
    if not 0 <= margin < 1 - np.cos(np.pi / 4):
        raise ValueError("Margin out of bounds")
    return CosFaceHead(n_classes, embedding_size, scale=scale, m3=margin, **kw)


class ArcFaceHead(AngularMarginHead):
    """Additive angular margin (reference src/losses.py:169-183): m2 = margin."""


def make_arcface(n_classes, embedding_size=192, scale=64.0, margin=0.5, **kw):
    """Additive angular margin: m2 = margin (0 is plain normalized softmax)."""
    if not 0 <= margin < 1:
        raise ValueError("Margin out of bounds")
    return ArcFaceHead(n_classes, embedding_size, scale=scale, m2=margin, **kw)


class GE2EHead(nn.Module):
    """Generalized end-to-end loss, softmax variant, vectorized: class
    centroids from one ``one_hot.T @ embeddings`` product, each sample's
    own-class centroid left-one-out in closed form (divided by the full
    class count, as the reference does). Returns the summed loss and no
    predictions."""

    def __init__(self, n_classes: int, embedding_size: int = 192, eps: float = 1e-8):
        super().__init__()
        self.n_classes, self.embedding_size, self.eps = n_classes, embedding_size, eps
        self.w = nn.Parameter(torch.tensor(1.0))
        self.b = nn.Parameter(torch.tensor(0.0))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.w.fill_(1.0)
            self.b.zero_()

    def forward(self, embeddings: torch.Tensor, targets: torch.Tensor):
        x = embeddings.float()
        tgt = targets.long()
        onehot = F.one_hot(tgt, self.n_classes).float()
        counts = onehot.sum(dim=0)
        sums = onehot.t() @ x
        present = counts > 0
        safe_counts = torch.clamp(counts, min=1.0)
        centroids = sums / safe_counts[:, None]
        loo = (sums[tgt] - x) / safe_counts[tgt][:, None]
        xn = _safe_l2_normalize(x, eps=self.eps)
        sim_all = xn @ _safe_l2_normalize(centroids, eps=self.eps).t()
        sim_own = torch.sum(xn * _safe_l2_normalize(loo, eps=self.eps), dim=-1)
        w_pos = torch.relu(self.w)
        s_all = w_pos * sim_all + self.b
        s_own = w_pos * sim_own + self.b
        s_all = torch.where(onehot.bool(), s_own[:, None], s_all)
        s_all = torch.where(present[None, :], s_all, torch.full_like(s_all, -float("inf")))
        loss = torch.sum(-s_own + torch.logsumexp(s_all, dim=-1))
        return _l2_normalize(embeddings), None, loss


def head_param_count(loss_name: str, embedding_size: int, n_classes: int, sub_centers: int = 1) -> int:
    """Parameters of each head (the reference counted them in the model)."""
    if loss_name == "ce":
        return embedding_size * n_classes + n_classes
    if loss_name in ("sphere", "cos", "arc"):
        return embedding_size * n_classes * sub_centers
    if loss_name == "ge2e":
        return 2
    raise ValueError(loss_name)


def build_head(
    loss_name: str,
    embedding_size: int,
    n_classes: int,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    **kwargs,
) -> nn.Module:
    """Head by name (``ce``, ``sphere``, ``cos``, ``arc``, ``ge2e``) on
    ``device``, weights drawn from ``generator`` (default: seeded with 0)."""
    if loss_name == "ce":
        head = CEHead(n_classes, embedding_size)
    elif loss_name == "sphere":
        head = make_sphereface(n_classes, embedding_size, **kwargs)
    elif loss_name == "cos":
        head = make_cosface(n_classes, embedding_size, **kwargs)
    elif loss_name == "arc":
        head = make_arcface(n_classes, embedding_size, **kwargs)
    elif loss_name == "ge2e":
        head = GE2EHead(n_classes, embedding_size)
    else:
        raise ValueError(f"Unknown loss {loss_name!r}")
    head.reset_parameters(generator or torch.Generator().manual_seed(0))
    return head.to(resolve_device(device))


LOSSES = {
    "ce": build_head,
    "sphere": build_head,
    "cos": build_head,
    "arc": build_head,
    "ge2e": build_head,
}


@torch.no_grad()
def renormalize_params(head: nn.Module) -> nn.Module:
    """Project an angular-margin head's weight to unit column norm in place
    (the reference's per-step renormalization); other heads are unchanged."""
    if isinstance(head, AngularMarginHead):
        w = head.weight
        w.copy_(w / torch.clamp(torch.linalg.vector_norm(w, dim=0, keepdim=True), min=1e-12))
    return head
