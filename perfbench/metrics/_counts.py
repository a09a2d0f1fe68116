"""The yardstick's arithmetic: the model's product FLOPs and each kernel's
least work, from the configuration's shapes and the inputs.

- Model FLOPs: 2 x the multiply-adds of every convolution and linear
  layer, real rows and frames only; a training step is 3 x its forward
  (no recomputation counted).
- A kernel's least work: each input byte read once and each output byte
  written once, and the operations of the cheapest standard algorithm for
  the function it computes (a real FFT for the log-mel's DFT, the
  triangular filterbank's non-zeros for the mel product). Its least time
  is the larger of operations over the peak rate and bytes over the
  memory rate, with the configuration's stated peaks.

These are copies that the measured program cannot change.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np

from perfbench.reference.embed import window_lengths
from perfbench.reference.frontend import mel_filterbank

LOGMEL_KERNELS = ("logmel", "mel_frames")
POOL_KERNELS = ("pool_onepass_kernel", "pool_merge_kernel", "tc_atb_kernel", "tc_de_kernel", "tc_dh_kernel",
                "sum_parts_kernel", "attn_u_kernel", "attn_stats_kernel", "attn_de_kernel")


def frames(n_samples: int, hop: int) -> int:
    return 1 + n_samples // hop


def forward_flops_per_frame(cfg: dict) -> int:
    """The layers that run once a frame."""
    n_mels, h, k = cfg["frontend"]["n_mels"], cfg["hidden_size"], cfg["kernel_size"]
    o, a = cfg["output_size"], cfg["attention_hidden_size"]
    prolog = cfg["prolog_kernel_size"] * n_mels * h
    block = cfg["n_sub_blocks"] * (k * h + h * h) + h * h
    return 2 * (prolog + cfg["n_mega_blocks"] * block + cfg["epilog_kernel_size"] * h * o + 2 * o * a)


def forward_flops_per_row(cfg: dict) -> int:
    """The layers that run once an utterance: squeeze-excitation and the
    decoder's linear layer."""
    h, o, e = cfg["hidden_size"], cfg["output_size"], cfg["embedding_size"]
    r = h // cfg["se_reduction"]
    return 2 * (cfg["n_mega_blocks"] * 2 * h * r + 2 * o * e)


def train_step_flops(cfg: dict, rows: int, samples: int, n_classes: int) -> int:
    """3 x the forward of ``rows`` crops of ``samples`` and the head."""
    f = frames(samples, cfg["frontend"]["hop_length"])
    fwd = rows * (f * forward_flops_per_frame(cfg) + forward_flops_per_row(cfg)) \
        + rows * 2 * cfg["embedding_size"] * n_classes
    return 3 * fwd


def embed_flops(cfg: dict, lengths: Sequence[int], buckets: Sequence[int], overlap: float) -> int:
    """The forward of every window of utterances of ``lengths`` samples,
    their real frames only."""
    hop = cfg["frontend"]["hop_length"]
    total = 0
    for n in lengths:
        for _, m in window_lengths(int(n), buckets, overlap):
            total += frames(m, hop) * forward_flops_per_frame(cfg) + forward_flops_per_row(cfg)
    return total


def peak(cfg: dict) -> Dict[str, float]:
    p = cfg["peak"]
    return {"bf16": p["bf16_tflop_s"] * 1e12, "fp32": p["fp32_tflop_s"] * 1e12, "hbm": p["hbm_tb_s"] * 1e12}


def logmel_least_s(cfg: dict, rows: int, samples: int) -> float:
    """Least time of one log-mel call on ``rows`` waveforms of ``samples``
    float32 samples: a real FFT of ``n_fft`` (2.5 N log2 N operations) of
    each windowed frame, the power, the filterbank's non-zeros, the log
    and the L2 norm over the mels, at the FP32 rate; the waveform read
    once and the log-mel written once."""
    fe = cfg["frontend"]
    n_fft, n_mels = fe["n_fft"], fe["n_mels"]
    bins = n_fft // 2 + 1
    nnz = int(np.count_nonzero(mel_filterbank(bins, n_mels, fe["sample_rate"])))
    per_frame = 2.5 * n_fft * math.log2(n_fft) + fe["win_length"] + 3 * bins + 2 * nnz + n_mels + 3 * n_mels
    f = frames(samples, fe["hop_length"])
    ops = rows * f * per_frame
    nbytes = 4 * rows * samples + 4 * rows * f * n_mels
    pk = peak(cfg)
    return max(ops / pk["fp32"], nbytes / pk["hbm"])


def attn_pool_train_least_s(cfg: dict, rows: int, samples: int) -> float:
    """Least time of the attentive pooling's forward and backward in one
    training step: the two products of the energies forward and their
    four backward (12 B T C H operations) at the bf16 rate; the encoder's
    bf16 output read once and its gradient written once."""
    t = frames(samples, cfg["frontend"]["hop_length"])
    c, h = cfg["output_size"], cfg["attention_hidden_size"]
    ops = 12 * rows * t * c * h
    nbytes = 2 * 2 * rows * t * c
    pk = peak(cfg)
    return max(ops / pk["bf16"], nbytes / pk["hbm"])


def is_logmel(name: str) -> bool:
    return any(k in name for k in LOGMEL_KERNELS)


def is_attn_pool(name: str) -> bool:
    return any(k in name for k in POOL_KERNELS)
