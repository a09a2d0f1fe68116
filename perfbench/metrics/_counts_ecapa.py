"""ECAPA-TDNN's model FLOPs and the least work of its context-dependent
pooling, from the configuration's shapes and the inputs (the arithmetic of
:mod:`perfbench.metrics._counts`, for this model).

- Model FLOPs: 2 x the multiply-adds of every convolution and linear layer,
  real rows and frames only.
- The pooling's least work: the bf16 activations read once over each row's
  valid frames, the two products of the energies (4 x frames x C x H), the
  weights of those products read once and the bf16 output written once;
  counted from the shapes, not from the kernels' design. Its least time is
  the larger of operations over the bf16 peak and bytes over the memory
  rate, with the configuration's stated peaks.

Copies that the measured program cannot change.
"""

from __future__ import annotations

from typing import Sequence

from perfbench.metrics._counts import frames, peak
from perfbench.reference.embed import window_lengths

CTX_POOL_KERNELS = ("ctx_stats_kernel", "ctx_finish_kernel", "pool_onepass_kernel", "pool_merge_kernel")


def forward_flops_per_frame(cfg: dict) -> int:
    """The layers that run once a frame: the prolog, each block's two 1x1
    convolutions and its Res2 group convolutions, the MFA convolution and
    the attention's two products."""
    n_mels, c, k = cfg["frontend"]["n_mels"], cfg["channels"], cfg["kernel_size"]
    w, mfa, a = c // cfg["scale"], cfg["mfa_channels"], cfg["attention_hidden_size"]
    blocks = len(cfg["dilations"])
    block = 2 * c * c + (cfg["scale"] - 1) * k * w * w
    return 2 * (cfg["prolog_kernel_size"] * n_mels * c + blocks * block + blocks * c * mfa + 2 * mfa * a)


def forward_flops_per_row(cfg: dict) -> int:
    """The layers that run once an utterance: squeeze-excitation, the
    context's product and the head's linear layer."""
    c, mfa, a, e = cfg["channels"], cfg["mfa_channels"], cfg["attention_hidden_size"], cfg["embedding_size"]
    se = c // max(1, c // cfg["se_bottleneck"])
    return 2 * (len(cfg["dilations"]) * 2 * c * se + 2 * mfa * a + 2 * mfa * e)


def embed_flops(cfg: dict, lengths: Sequence[int], buckets: Sequence[int], overlap: float) -> int:
    """The forward of every window of utterances of ``lengths`` samples,
    their real frames only."""
    hop = cfg["frontend"]["hop_length"]
    total = 0
    for n in lengths:
        for _, m in window_lengths(int(n), buckets, overlap):
            total += frames(m, hop) * forward_flops_per_frame(cfg) + forward_flops_per_row(cfg)
    return total


def valid_frames(cfg: dict, lengths: Sequence[int], samples: int) -> int:
    """The frames a batch of bucket width ``samples`` holds for rows of
    ``lengths`` samples (``1 + length // hop``, at most the bucket's)."""
    hop = cfg["frontend"]["hop_length"]
    cap = frames(samples, hop)
    return sum(min(frames(int(n), hop), cap) for n in lengths)


def ctx_pool_least_s(cfg: dict, lengths: Sequence[int], samples: int) -> float:
    """Least time of the pooling of one batch of bucket width ``samples``
    whose rows hold ``lengths`` samples."""
    c, a = cfg["mfa_channels"], cfg["attention_hidden_size"]
    f = valid_frames(cfg, lengths, samples)
    ops = 4 * f * c * a
    nbytes = 2 * f * c + 2 * 2 * c * a + 2 * len(lengths) * 2 * c
    pk = peak(cfg)
    return max(ops / pk["bf16"], nbytes / pk["hbm"])


def is_ctx_pool(name: str) -> bool:
    return any(k in name for k in CTX_POOL_KERNELS)
