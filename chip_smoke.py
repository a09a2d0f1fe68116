#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``titanet_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. build the CUDA kernels from ``titanet_torch/csrc`` (one nvcc each, in
     parallel), timed;
  2. fused log-mel kernel vs its plain version at the serving shapes
     (B=128 x 3 s), f32 (``logmel_kernel``, atol 1e-4) and bf16 (the
     tensor-core ``logmel_tc_kernel``, atol 2e-3), timed by device time;
  3. attentive-pool kernel vs its plain version at B=128, T=301, C=1536,
     H=128, with and without the fold, bf16 (rtol 2e-2) and f32 (rtol 1e-4);
  4. ``embed_step`` on TitaNet-S (17 mega-blocks, random weights from seed
     0) at B=128 x 3 s, serving bf16 and parity f32 (TF32 off): launch
     counts (bf16 through the tensor-core log-mel kernel), unit-norm finite
     embeddings, bf16-vs-f32 cosine, agreement with
     the all-plain route, median ms per batch;
  5. ``SpeakerEmbedder.embed`` on 1.2 s, 3 s, 7 s and 40 s requests: each
     padded-batch embedding equals the request's solo embedding; every
     log-mel launch on the tensor-core kernel;
  6. attentive-pool backward kernel vs its plain version at B=128, T=301,
     C=1536, H=128, bf16 and f32, fold on and off: every gradient; the
     workspace bytes of each route;
  7. depthwise-conv backward kernel vs its plain version and vs the library
     (autograd of the cuDNN grouped conv) at B=128, T=301, C=256,
     K = 3, 7, 11, bf16 and f32: the kernel's two launches and the
     library's backward timed by their device time (``torch.profiler``);
     then TitaNet M and L widths (C = 512, 1024) at the same batch, ragged
     and long shapes (T = 1, 2, 137, 4096), each against its plain version,
     two calls giving identical bits, the workspace against its mirror;
  8. ``train_step`` on TitaNet-S (17 blocks, dropout 0.5, bf16, fused mel,
     CE over 251 classes, Adam 1e-3) at B=128 x 3 s from seed 0, under
     ``TITANET_DW_BWD=xla`` and ``=pallas``: launches per step, every
     gradient finite, the loss falling over 20 steps on one batch, median ms
     per step, utterances/s, peak memory and device time a step (the
     depthwise backward's share under ``pallas``); at dropout 0 from equal
     weights the two routes agree (loss 1e-3, gradient cosine > 0.99), and
     the bf16 step's loss agrees with the f32 step's (5e-2);
  9. frames log-mel kernel vs its plain version on the N = 128 x 301 frames
     of the phase-2 waveforms, "highest" (atol 1e-4; FP32 cores) and
     "default" (atol 2e-3; tensor cores), and vs the fused kernel's output on
     the same waveforms (the same limits), timed by device time; "default"
     on frames of one tap each: the power rounded once (1e-6), not apart;
  10. mega-block kernel vs its plain version at B=128, T=301, S=3, (C, k) =
     (256, 3), (512, 7), (1024, 11), f32 (1e-4 of the largest entry) and
     bf16 (one bf16 ulp of it), biases of std 0.3 so the edge rows carry
     real values; edge-row and interior errors apart; which design ran
     (bf16 tensor-core with wgmma or mma.sync, f32 fp32-core); the unfused library route (the
     port's ``MegaBlock`` sub-blocks in eval mode) timed beside; one ragged
     bf16 case more at (256, 3): B=3, T=1000 (9 tiles, the last partial);
  11. the fused serving path on TitaNet-S: wav -> ``log_mel_spectrogram_pallas``
     -> ``titanet_apply_fused`` -> ``l2_normalize``, bf16 and f32: launches
     {mel_frames: 1, megablock: 17}, finite unit-norm [128, 192], cosine vs
     ``embed_step`` of the same model (below 1 through the edge rows of each
     mega-block), kernel route vs all-plain fused route (f32 > 0.99999),
     median ms per batch and device time a call;
  12. the int8 variant: ``quantize_titanet`` -> ``embed_step_quantized`` at
     B=128 x 3 s: unit norm, cosine vs the f32 ``embed_step`` > 0.99, median
     ms, weight bytes; ``SpeakerEmbedder(quantized=True)`` padded == solo
     (> 0.999);
  13. the trainer as users run it: first each of its four kernels against
     its plain version on the tensors the trainer gives it (every batch of
     the trainer's own train, validation and test loaders through the f32
     log-mel kernel with the lengths each step passes, ragged ones
     included, atol 1e-4; the pool forward at the train and validation T,
     the pool backward and all 51 ``dw_bwd`` launches of one train step,
     their inputs and output gradients kept by hooks, at phases 3, 6 and 7's
     tolerances); then ``titanet_torch.cli.train`` on a synthetic
     corpus (64 speakers x 16 utterances), TitaNet-S at full width, bf16,
     CE, B=64, chunk + SpecAugment + noise, under ``TITANET_DW_BWD=pallas``
     and ``=xla``: run A trains 2 epochs straight (validation every epoch,
     verification at the end), run B trains 1 epoch and resumes for the
     second, and B's epoch-2 metrics must equal A's (identical bits under
     pallas, ``RESUME_XLA_RTOL`` under xla); finite losses, both
     checkpoints, the launches of the four kernels of the path against the
     count the loaders' batches give (SpecAugment steps compute their mel in
     plain torch); one more epoch with ``[chunk]`` only (the log-mel kernel
     in every step); ``cli.evaluate_checkpoint`` on run A (EER and minDCF in
     [0, 1], the log-mel kernel in the verification embeddings); utt/s of
     the whole loop, the ``StepTimer`` data/model split, epoch wall time
     and peak memory;
  14. the serving entry points as users run them, on run A's checkpoint
     (TitaNet-S at full width, bf16; phase 13's 2 epochs resumed to 8 by
     ``cli.train``): ``cli.main`` in process for ``infer --audio`` (the
     test split's 32 utterances as WAV files and a 40 s file: finite
     unit-norm rows equal to ``SpeakerEmbedder.embed`` called directly,
     1e-6), ``infer --split test -n 32`` (equal to ``loop.infer``),
     ``trials`` on all 496 pairs (the plain and the AS-norm scores files,
     cohort ``infer -o``'s, top 8, equal to the scores recomputed from
     trials' own embeddings as written, pair by pair, and spread far
     beyond what they are held to; the plain scores within each pair's
     bound of the cosine of infer's embeddings; a Kaldi-format list gives
     the same scores; EER, minDCF in [0, 1]) and ``diarize`` on a 30-45 s
     conversation of 3 speakers (NME-SC, known k, AHC, VAD: the RTTM reads
     back; DER reported) and ``OnlineDiarizer`` in 1.5 s chunks; then the
     speaker service (``titanet_torch.serve``: default,
     ``--fast-frontend``, ``--quantized --fast-frontend``) on 127.0.0.1 in
     a thread: /embed, /enroll, /verify, /identify -> 200, a malformed
     body -> 400, /embed equal to a direct embed (1e-6). Every embedding
     call of a command runs the fused log-mel kernel (f32 on the CLI, the
     bf16 tensor-core kernel under ``--fast-frontend``; the default
     service's frontend is plain torch), and the kernel matches its plain
     version on every launch's own operands (bucket widths, lengths,
     filler rows of length 1; phase 2's tolerances); ``infer --split``'s
     one (``loop.infer`` pools unmasked) also runs the pool forward
     kernel, held as in phase 13, and no other command does. Printed: the
     median ms of an /embed of a 3 s WAV per variant, ``trials`` files/s
     and ``diarize``'s real-time factor.

  15. the model zoo (every family but TitaNet, at its published width:
     ECAPA-TDNN C=512 and C=1024, x-vector H=512/P=1500, ResNet34 base 32,
     MFA-Conformer 6 x 256 FF 2048, d-vector LSTM 3 x 768, the smoke
     convnet 10 x 256; bf16, seed 0), one line a family: ``cli.train`` for
     one epoch of phase 13's corpus with ``[chunk]`` only under
     ``TITANET_DW_BWD=pallas`` (finite loss, the checkpoint) and
     ``cli.evaluate_checkpoint`` (EER, minDCF in [0, 1]); 20 ``train_step``s
     on one batch of 64 x 3 s (every gradient finite, the last loss below
     the first; median ms a step, kernels and device ms a step, idle share,
     peak memory); ``embed_step`` at B=128 x 3 s (median and device ms,
     idle share); ``SpeakerEmbedder`` padded == solo (cosine > 0.999) on
     1.2, 3, 7 and 40 s requests; ``infer --audio`` on the trained
     checkpoint equal to a direct ``SpeakerEmbedder.embed`` (1e-6); the
     service ``--model-size <family> --checkpoint-dir <run>`` (default and
     ``--fast-frontend``) answering /embed with 200 (the d-vector and the
     convnet have no ``--model-size``). Every log-mel launch of the family
     is replayed on its own operands against its plain version (phase 2's
     tolerances); the Conformer's pool forward and backward of a train
     step (C = 1536, H = 128, T' = 151) and its pool-forward launches of
     ``infer --split`` likewise (phases 3 and 6); every other family
     launches no pool kernel, and no family the depthwise backward.
  16. the device-resident corpus and the utilities: (a) phase 13's corpus
     as one int16 CUDA tensor (MB, upload ms and GB/s), phase 13's four
     trainer kernels held against their plain versions on the device
     route's own batches, then ``cli.train`` (TitaNet-S at full width,
     bf16, B=64, ``generic.device_corpus``, ``[chunk, specaugment]``, one
     epoch, ``TITANET_DW_BWD=pallas``): the launches of the four kernels
     against the count the batches give, every staged batch a
     ``DeviceBatch`` gathered on the card, the train, validation and test
     loaders on the one corpus, every batch replayed bit-equal to a host
     loader with ``transport_dtype`` int16, no H2D copy as large as a
     window in a profiler window of two steps, a finite loss; gather ms a
     batch beside the host route's H2D copy of it as f32, utt/s and the
     ``StepTimer`` split beside phase 13's host-fed run A; (b) run A
     restored as an f32 model and exported (``export_titanet_embedder``,
     B=8 x 3 s) with the default frontend and with ``use_pallas_fused``,
     each loaded from bytes: per-row cosine vs ``embed_step`` > 0.99999,
     and the fused log-mel kernel launched exactly once a call of the fused
     artifact (none in the default one); (c) ``profiling.trace`` around
     three ``embed_step`` calls (the trace names ``logmel_kernel``),
     ``StepProfiler`` over ten, ``device_memory_stats`` (0 < in use <= peak
     <= the card's memory); (d) an epoch with ``figures.enabled``, ``infer
     --fig`` and ``trials --det-out``: the PNGs where matplotlib imports,
     else the JAX package's message and no file, the runs complete. Corpus
     fetching is host-only code and is not run on the card (no network).

The line before the last is the card's name and power limit; before it, a
JSON line with each kernel's launches on its path (serving for the forward
kernels, the pallas-route training step for the backward kernels, the
fused serving call for the frames and mega-block kernels; rows 1-4 also
``zoo_trainer_launches``: each zoo family's launches in its phase-15
trainer run, and ``device_corpus_trainer_launches``: phase 16's
device-resident ``cli.train``), error
vs its plain version, time, plain time, bound and library time, every number
from this run, and ``timed_by``: ``"profiler"`` (device time of the
kernel's launches), or ``"events"`` (CUDA events around its wrapper) where
the profiler saw no device time. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}  # FP32 CUDA cores; bf16 tensor cores
B, SECONDS, SR = 128, 3, 16000
# Least cosine of the fused serving path vs embed_step of the same model: the
# fused kernel's edge rows (the first and last (S-1)*pad rows of every
# mega-block) differ from the per-conv path by construction. Measured on
# TitaNet-S at B=128 x 3 s (NVIDIA H100 80GB HBM3, 700 W): 0.9999998 in f32
# and 0.9999918 in bf16, for the kernel route and the all-plain fused route
# alike; the limits sit just under.
FUSED_VS_EMBED_STEP_F32 = 0.99999
FUSED_VS_EMBED_STEP_BF16 = 0.9999
# Times of the FP32-core designs that the bf16 tensor-core kernels replaced,
# at the same shapes (NVIDIA H100 80GB HBM3, 700 W), quoted in the phases'
# lines beside this run's times and nowhere else: the mega-block kernel at
# (C, k) = (256, 3), (512, 7), (1024, 11); the pool backward, fold on / off; the
# pool forward, fold on.
PREV_MS = {
    ("megablock", 256): 0.727, ("megablock", 512): 2.911, ("megablock", 1024): 26.947,
    ("pool_bwd", True): 7.994, ("pool_bwd", False): 7.578,
    ("pool", True): 2.948,
    # the depthwise backward at C=256, K = 3, 7, 11 and the frames log-mel
    # "default" before their redesign (same card and shapes, CUDA events)
    ("dw_bwd", 3): 0.160, ("dw_bwd", 7): 0.183, ("dw_bwd", 11): 0.204,
    ("mel_frames", "default"): 1.628,
    # the fused log-mel's bf16 route on the FP32 cores (logmel_kernel),
    # before the tensor-core kernel (same card and shapes, CUDA events)
    ("logmel", "bf16"): 1.088,
}
DW_KERNELS = ("dw_bwd_kernel", "dw_reduce_kernel")
# the kernels of csrc/attn_pool.cu, both routes, forward and backward
POOL_KERNELS = ("tc_u_kernel", "tc_stats_kernel", "tc_de_kernel", "tc_dh_kernel", "tc_atb_kernel",
                "sum_parts_kernel", "attn_u_kernel", "attn_stats_kernel", "attn_de_kernel", "gemm_kernel")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def cuda_ms(fn, iters=20, warmup=3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, names=None, iters=10, warmup=3, attempts=3):
    """Device time of one ``fn()`` in ms: the CUDA kernels that
    ``torch.profiler`` records over ``iters`` calls (those whose name holds
    one of ``names``, or all), summed and divided by ``iters``. A trace can
    lose kernel records: after a large one (phase 8's train steps) each
    trace lost its first two (18 of 20 single-launch calls recorded,
    NVIDIA H100 80GB HBM3), and now and then one loses more. So the calls
    are traced after a traced warm-up cycle of as many calls, which takes the
    first loss, and a trace is taken again (``attempts`` in all) unless it
    holds the same whole number of records for every call. Returns
    ``(ms, busy ms, kernels a call, "profiler")``, or CUDA-event time
    twice, None and ``"events"`` where no trace was whole. ``busy`` is the
    union of the kernels' time spans: kernels that overlap on several
    streams (cuDNN's LSTM runs its layers as a wavefront) count once."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):  # the warm-up cycle, then the recorded one
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA and (names is None or any(n in e.name for n in names)))
        if spans and len(spans) % iters == 0:
            busy, reach = 0.0, float("-inf")
            for start, end in spans:
                busy += max(end, reach) - max(start, reach)
                reach = max(reach, end)
            total = sum(end - start for start, end in spans)
            return total / iters / 1e3, busy / iters / 1e3, len(spans) // iters, "profiler"
    ms = cuda_ms(fn, iters=iters, warmup=0)
    return ms, ms, None, "events"


def device_ms(fn, names=None, iters=10, warmup=3, attempts=3):
    """:func:`device_profile` without the kernel count: ``(ms, timed_by)``."""
    ms, _, _, timed_by = device_profile(fn, names, iters, warmup, attempts)
    return ms, timed_by




def median_ms(fn, runs=10, warmup=3):
    """Median, min and max wall ms of a synchronized ``fn()`` over ``runs``
    calls after ``warmup``."""
    import torch

    times = []
    for i in range(warmup + runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times), max(times)


def library_dw_conv(x, w, b):
    """The library's depthwise same-pad conv (cuDNN grouped conv), f32
    parameters cast to x's dtype, as the port's xla route runs it."""
    from titanet_torch.ops.conv import conv1d_same

    return conv1d_same(x, w.to(x.dtype), b.to(x.dtype), groups=x.shape[-1])


POOL_GRADS = ("dh", "da", "dc", "dwa", "dba", "dwb", "dbb")


def pool_bwd_errors(got, ref, fold: bool, tol: float, what: str) -> dict:
    """Each gradient of the pool backward kernel (``got``) against its plain
    version (``ref``): error over the gradient's largest entry, raising
    above ``tol``. Without the fold da and dc must be zero. dbb is zero in
    exact arithmetic (softmax over T ignores a per-channel shift): both are
    noise, held below tol of max |dWb|."""
    import torch

    errs = {}
    for gname, x, r in zip(POOL_GRADS, got, ref):
        if not torch.isfinite(x).all() or x.shape != r.shape or x.dtype != r.dtype:
            raise AssertionError(f"{what}: {gname} bad shape, dtype or value")
        if gname in ("da", "dc") and not fold:
            if x.any() or r.any():
                raise AssertionError(f"{what}: {gname} not zero without the fold")
            continue
        scale = ref[5].abs().max().item() if gname == "dbb" else r.float().abs().max().item()
        err = (x.float() - r.float()).abs().max().item()
        errs[gname] = err / scale
        if gname == "dbb":
            err = max(x.abs().max().item(), r.abs().max().item())
        if err > tol * scale:
            raise AssertionError(f"{what}: {gname} error {err} > {tol} x {scale}")
    return errs


def bound_ms(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# Trainer phase (13): TitaNet-S at full width (17 mega-blocks, hidden 256,
# epilog 1536, embedding 192), bf16, CE, B=64, on a synthetic corpus of 64
# speakers x 16 utterances (1.2-3.5 s): 4 utterances a speaker for
# validation, 8 test speakers x 4 for verification, 736 for training (11
# steps an epoch).
TRAIN_SPEAKERS, TRAIN_UTTERANCES, TRAIN_BATCH = 64, 16, 64
# Run B (one epoch, then resumed for the second) against run A (two epochs
# straight): the epoch-2 metrics compared. Under TITANET_DW_BWD=pallas every
# backward of the step adds in a fixed order, so they must agree to the bit;
# under xla cuDNN's depthwise backward may sum in another order each call,
# and its rounding (bf16 activations) is held to this relative difference.
RESUME_XLA_RTOL = 1e-2
RESUME_KEYS = ("train/avg_loss", "train/accuracy", "val/avg_loss", "val/accuracy",
               "test/eer", "test/mindcf")


def trainer_config(root: str, run: str, epochs: int, enable, resume: bool = False, model=None):
    """Phase 13's trainer config; ``model`` (config sections, e.g.
    ``{"ecapa": {"enabled": True}}``) selects another family (phase 15)."""
    from titanet_torch.config import Config

    return Config.from_dict({**(model or {}),
        "dataset": {"name": "synthetic", "synthetic_speakers": TRAIN_SPEAKERS,
                    "synthetic_utterances": TRAIN_UTTERANCES},
        "training": {"batch_size": TRAIN_BATCH, "epochs": epochs, "dtype": "bfloat16", "loss": "ce",
                     "checkpoints_path": root, "checkpoints_frequency": 1, "run_name": run,
                     "resume": resume},
        "validation": {"every": 1, "batch_size": TRAIN_BATCH, "num_utterances_per_speaker": 4},
        "test": {"num_speakers": 8, "num_utterances_per_speaker": 4},
        "titanet": {"model_size": "s", "n_mega_blocks": 17, "attention_hidden_size": 128},
        "generic": {"seed": 0, "workers": 2, "embedding_size": 192},
        "augmentation": {"enable": list(enable)},
    })


def read_jsonl(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f]


def epoch_record(records, epoch, prefix):
    """The merged metrics of ``epoch`` whose keys start with ``prefix``
    (the last record wins: a resumed run appends)."""
    out = {}
    for r in records:
        if r.get("epoch") == epoch and any(k.startswith(prefix) for k in r):
            out.update({k: v for k, v in r.items() if k.startswith(prefix)})
    return out


def pool_fwd_vs_plain(args, eps, fold, path_out, what: str) -> float:
    """Replays the pool-forward kernel on the operands a path gave it
    (``attentive_pool_fwd``'s): the replay must give the path's own output
    bit for bit (it saw the path's inputs) and match
    ``attentive_pool_fwd_plain`` at phase 3's tolerance (rtol and atol
    2e-2). Raises on a miss; returns the max abs error."""
    import torch

    from titanet_torch.ops.kernels import pool as pk

    out, ref = pk.attentive_pool_fwd(*args, eps, fold), pk.attentive_pool_fwd_plain(*args, eps, fold)
    torch.cuda.synchronize()
    if not torch.equal(out, path_out):
        raise AssertionError(f"{what}: the replay differs from the path's output")
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    return (out.float() - ref.float()).abs().max().item()


def keep_grad(out, rec: dict) -> None:
    """Keep the gradient that reaches ``out`` in ``rec["g"]`` (a train
    step's output: the backward kernels run on that gradient)."""
    if out.requires_grad:
        out.register_hook(lambda g: rec.__setitem__("g", g.detach().clone()))


def keep_pool_calls(model, kept: list) -> list:
    """Forward hooks on every ``AttentiveStatsPooling`` of ``model`` that
    append to ``kept``, for each unmasked call, the operands the pool
    kernels are handed (``attentive_pool_fwd``'s, cloned), the output and,
    in a train step, the output's gradient. Returns the hooks."""
    import torch

    from titanet_torch.ops.pooling import AttentiveStatsPooling

    def on_pool(mod, args, kwargs, out):
        x, prescale, preshift = args[0], kwargs.get("prescale"), kwargs.get("preshift")
        if kwargs.get("mask") is not None:
            return  # masked pooling runs plain
        dt = mod.dtype or torch.promote_types(x.dtype, torch.float32)
        fold = prescale is not None
        zeros = torch.zeros(x.shape[-1], device=x.device)
        vec = lambda v: (v if fold else zeros).detach().float().clone()  # noqa: E731
        rec = {"out": out.detach().clone(), "eps": mod.eps, "fold": fold, "args": (
            x.detach().to(dt).contiguous().clone(), vec(prescale), vec(preshift),
            mod.in_linear.weight.detach().t().to(dt).contiguous(), mod.in_linear.bias.detach().float().clone(),
            mod.out_linear.weight.detach().t().to(dt).contiguous(), mod.out_linear.bias.detach().float().clone())}
        kept.append(rec)
        keep_grad(out, rec)

    return [m.register_forward_hook(on_pool, with_kwargs=True)
            for m in model.modules() if isinstance(m, AttentiveStatsPooling)]


def replay_pool(rec: dict, where: str) -> str:
    """A call kept by :func:`keep_pool_calls` replayed: the pool forward
    kernel (:func:`pool_fwd_vs_plain`, phase 3's tolerance) and, where the
    gradient was kept, the backward kernel against its plain version
    (phase 6's 2e-2 of each gradient's largest entry). Raises on a miss;
    returns the line to print."""
    import torch

    from titanet_torch.ops.kernels import pool as pk

    args, eps, fold = rec["args"], rec["eps"], rec["fold"]
    err = pool_fwd_vs_plain(args, eps, fold, rec["out"], f"pool forward ({where})")
    line = (f"pool forward ({where}, {args[0].dtype}, h {tuple(args[0].shape)}, "
            f"fold={fold}): max abs err {err:.3e} (rtol 2e-2)")
    if "g" in rec:
        g = rec["g"].to(args[0].dtype).contiguous()
        got, bref = pk.attentive_pool_bwd(*args, g, eps, fold), pk.attentive_pool_bwd_plain(*args, g, eps, fold)
        torch.cuda.synchronize()
        errs = pool_bwd_errors(got, bref, fold, 2e-2, f"pool backward ({where})")
        line += (f"; pool backward: error / max per gradient "
                 f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} } (tol 2e-2)")
    return line


def trainer_kernels_vs_plain(cfg, datasets, tag: str, label: str = "trainer") -> None:
    """Phase 13's kernel checks: each of the four kernels of the trainer's
    path against its plain version on the tensors that path gives it.
    Every batch of the trainer's own train, validation and test loaders
    (``cli._loaders``), staged by ``device_prefetch`` as the loop stages
    them, goes through the log-mel kernel (f32: ``frontend_precision:
    highest``) with the lengths its step passes (None for a uniform train
    batch, as the loop's fast path; ragged otherwise). Then one train step
    (``cfg``'s SpecAugment and noise, ``TITANET_DW_BWD=pallas``) on the first
    train batch and one ``eval_step`` on the first validation batch run with
    hooks that keep the inputs of the pooling and of each depthwise conv
    and the gradients of their outputs: the pool forward at both T, the pool
    backward and every ``dw_bwd`` launch of the step are replayed on those
    tensors and held against their plain versions, at the tolerances of
    phases 2, 3, 6 and 7. The replayed forward must give the path's own
    output bit for bit (the replay saw the path's inputs). With
    ``generic.device_corpus`` the loaders are switched to the device corpus
    first (``cli._attach_device_corpus``), so every batch is a window
    gathered on the card, as the device-resident trainer runs it. Raises on
    a miss."""
    import torch

    from titanet_torch import cli
    from titanet_torch.ops import frontend as tf
    from titanet_torch.ops.conv import SamePadConv1d
    from titanet_torch.ops.kernels import dwconv
    from titanet_torch.ops.kernels.melspec import log_mel_fused, log_mel_fused_plain
    from titanet_torch.train import loop
    from titanet_torch.train import state as ts

    dev = torch.device("cuda")
    train_ds, val_ds, test_ds, n_speakers = datasets
    frontend = cli._frontend(cfg)
    loaders = dict(zip(("train", "val", "test"), cli._loaders(cfg, train_ds, val_ds, test_ds, None)))
    if cfg.generic.device_corpus:
        cli._attach_device_corpus(cfg, list(loaders.values()), dev)
    loaders["train"].set_epoch(1)
    staged = {kind: list(loop._staged_batches(ld, dev)) for kind, ld in loaders.items()}

    # the log-mel kernel on every batch, with the lengths each step passes
    mel_err, mel_calls, ragged = 0.0, 0, 0
    for kind, batches in staged.items():
        for (wav, lengths, _), batch in batches:
            uniform = int(batch.lengths.min()) == wav.shape[1]
            lens = None if kind == "train" and uniform else lengths
            args, kw = tf.log_mel_fused_operands(ts._dequantize_waveform(wav), frontend, lens)
            out = log_mel_fused(*args, **kw)
            ref = log_mel_fused_plain(*args, n_frames=kw["n_frames"], hop=kw["hop"])
            err = (out - ref).abs().max().item()
            if not torch.isfinite(out).all() or err > 1e-4:
                raise AssertionError(f"trainer log-mel f32 on a {kind} batch {tuple(wav.shape)}: "
                                     f"max abs err {err} > 1e-4")
            mel_err, mel_calls = max(mel_err, err), mel_calls + 1
            ragged += lens is not None and not uniform
    print(f"{label} kernels vs plain: log-mel f32 (logmel_kernel) on all {mel_calls} batches of the "
          f"trainer's train/validation/test loaders ({ragged} with ragged lengths), "
          f"max abs err {mel_err:.3e} (atol 1e-4) {tag}")

    # one train step and one eval_step, keeping what the pool and the
    # depthwise convs are given
    os.environ["TITANET_DW_BWD"] = "pallas"
    _, _, state = cli._new_state(cfg, n_speakers, dev, len(loaders["train"]))
    kept = {"pool": [], "dw": []}

    def on_dw(mod, args, out):
        x = args[0].to(mod.dtype) if mod.dtype is not None else args[0]
        if not out.requires_grad or mod.groups != x.shape[-1] or not dwconv.kernel_supports(x.shape[1], x.shape[-1], mod.kernel_size,
                                                                    x.dtype):
            return
        rec = {"x": x.detach().contiguous().clone(), "w": mod.weight.detach().clone()}
        kept["dw"].append(rec)
        keep_grad(out, rec)

    hooks = keep_pool_calls(state.model, kept["pool"])
    hooks += [m.register_forward_hook(on_dw) for m in state.model.modules()
              if isinstance(m, SamePadConv1d) and m.groups > 1]
    (wav, lengths, speakers), batch = staged["train"][0]
    uniform = int(batch.lengths.min()) == wav.shape[1]
    dw_before = dwconv.dw_bwd.launches
    ts.train_step(state, wav, None if uniform else lengths, speakers, frontend=frontend,
                  augment=cli._augment_config(cfg, None))
    dw_launches = dwconv.dw_bwd.launches - dw_before
    (vwav, vlengths, vspeakers), _ = staged["val"][0]
    ts.eval_step(state, vwav, vlengths, vspeakers, frontend=frontend)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    if len(kept["pool"]) != 2 or "g" not in kept["pool"][0] or len(kept["dw"]) != dw_launches \
            or not all("g" in r for r in kept["dw"]):
        raise AssertionError(f"trainer kernels: kept {len(kept['pool'])} pool calls and {len(kept['dw'])} "
                             f"depthwise convs for {dw_launches} dw_bwd launches")

    for rec, where in zip(kept["pool"], ("train step", "eval_step")):
        print(f"{label} kernels vs plain: {replay_pool(rec, where)} {tag}")

    worst = {"dx": 0.0, "dk": 0.0, "db": 0.0}
    shapes = set()
    for rec in kept["dw"]:
        x, w = rec["x"], rec["w"]
        dy = rec["g"].to(x.dtype).contiguous()
        got, ref = dwconv.dw_bwd(x, w, dy), dwconv.dw_bwd_plain(x, w, dy)
        torch.cuda.synchronize()
        for gname, a_, r in zip(("dx", "dk", "db"), got, ref):
            err = (a_.float() - r.float()).abs().max().item() / r.float().abs().max().item()
            if not torch.isfinite(a_).all() or err > 3e-2:
                raise AssertionError(f"trainer dw_bwd {tuple(x.shape)} K={w.shape[-1]} {x.dtype}: {gname} "
                                     f"error / max {err} > 3e-2")
            worst[gname] = max(worst[gname], err)
        shapes.add((tuple(x.shape), w.shape[-1]))
    print(f"{label} kernels vs plain: dw_bwd, every one of the step's {len(kept['dw'])} launches "
          f"({', '.join(f'{s} K={k}' for s, k in sorted(shapes))}, {kept['dw'][0]['x'].dtype}): worst error / "
          f"max {json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})} (tol 3e-2) {tag}")
    os.environ.pop("TITANET_DW_BWD", None)


# phase 13's host-fed run A (pallas route): steps, utterances, whole-loop
# wall and the StepTimer split, printed beside phase 16's device-resident run
HOST_FED_RUN_A: dict = {}


def trainer_phase(tag: str):
    """Phase 13: ``titanet_torch.cli.train`` as a user runs it, then
    ``cli.evaluate_checkpoint``; raises on any failed check. Returns
    ``(root, n_speakers)``: the directory that holds the runs (run A under
    ``a-pallas``, which phase 14 serves; the caller removes it) and the
    number of training speakers."""
    import tempfile

    import numpy as np
    import torch

    from titanet_torch import cli
    from titanet_torch.ops.kernels import dwconv
    from titanet_torch.ops.kernels.melspec import log_mel_fused
    from titanet_torch.ops.kernels.pool import attentive_pool_bwd, attentive_pool_fwd
    from titanet_torch.train import checkpoint as ckpt

    counters = {"logmel": log_mel_fused, "pool_fwd": attentive_pool_fwd,
                "pool_bwd": attentive_pool_bwd, "dw_bwd": dwconv.dw_bwd}

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: c.launches for k, c in counters.items()}

    augmented = ("chunk", "specaugment", "noise")
    root = tempfile.mkdtemp(prefix="titanet_torch_trainer_")
    # set-up: synthesize the corpus once (cli.train's datasets share the
    # process-wide cache), and count the batches of each kind in one epoch
    t0 = time.perf_counter()
    train_ds, val_ds, test_ds, n_speakers = cli._datasets(trainer_config(root, "probe", 1, augmented), True)
    for ds in (train_ds, val_ds, test_ds):
        for i in range(len(ds)):
            ds.get_sample(i)
    steps = len(train_ds) // TRAIN_BATCH
    val_batches = -(-len(val_ds) // TRAIN_BATCH)
    test_batches = -(-len(test_ds) // TRAIN_BATCH)
    print(f"trainer set-up: {TRAIN_SPEAKERS * TRAIN_UTTERANCES} synthetic utterances made in "
          f"{time.perf_counter() - t0:.2f} s; {len(train_ds)} train ({steps} steps of {TRAIN_BATCH}), "
          f"{len(val_ds)} validation, {len(test_ds)} test {tag}")
    trainer_kernels_vs_plain(trainer_config(root, "kernels", 1, augmented),
                             (train_ds, val_ds, test_ds, n_speakers), tag)

    # one epoch without SpecAugment first (it also warms the process up):
    # the train step's mel on the log-mel kernel
    os.environ["TITANET_DW_BWD"] = "pallas"
    _, counts = counted(lambda: cli.train(trainer_config(root, "chunk-only", 1, ("chunk",))))
    expect = {"logmel": steps + val_batches + test_batches, "pool_fwd": steps + val_batches,
              "pool_bwd": steps, "dw_bwd": 51 * steps}
    if counts != expect:
        raise AssertionError(f"trainer chunk only: launches {counts}, expected {expect}")
    loss = epoch_record(read_jsonl(os.path.join(root, "chunk-only", "metrics.jsonl")), 1,
                        "train/")["train/avg_loss"]
    if not np.isfinite(loss):
        raise AssertionError(f"trainer chunk only: loss {loss}")
    print(f"trainer pallas, augmentation [chunk] only, 1 epoch: launches {counts} (log-mel kernel in every "
          f"step); train/avg_loss {loss:.4f} {tag}")

    for route in ("pallas", "xla"):
        os.environ["TITANET_DW_BWD"] = route
        # run A: two epochs straight, validation every epoch, verification at the end
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, counts = counted(lambda: cli.train(trainer_config(root, f"a-{route}", 2, augmented)))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        run_a = os.path.join(root, f"a-{route}")
        rec_a = read_jsonl(os.path.join(run_a, "metrics.jsonl"))
        # SpecAugment steps compute their mel in plain torch: the log-mel
        # kernel runs in validation (eval_step) and verification (embed_step)
        expect = {"logmel": 2 * val_batches + test_batches, "pool_fwd": 2 * (steps + val_batches),
                  "pool_bwd": 2 * steps, "dw_bwd": 2 * steps * 51 if route == "pallas" else 0}
        if counts != expect:
            raise AssertionError(f"trainer {route}: launches {counts}, expected {expect}")
        losses = [epoch_record(rec_a, e, "train/")["train/avg_loss"] for e in (1, 2)]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"trainer {route}: non-finite epoch losses {losses}")
        if ckpt.latest_epoch(run_a) != 2 or not all(
                os.path.isfile(os.path.join(run_a, str(e), ckpt.FILENAME)) for e in (1, 2)):
            raise AssertionError(f"trainer {route}: checkpoints of epochs 1 and 2 missing under {run_a}")
        falls = losses[1] < losses[0]
        if route == "pallas":
            HOST_FED_RUN_A.update(steps=2 * steps, wall=wall)
        tr = [epoch_record(rec_a, e, "train/") for e in (1, 2)]
        ts_ = [r["ts"] for r in rec_a if "train/avg_loss" in r]
        n_utt = 2 * steps * TRAIN_BATCH
        data_s = sum(r["train/total_data_time"] for r in tr)
        model_s = sum(r["train/total_model_time"] for r in tr)
        if route == "pallas":
            HOST_FED_RUN_A.update(data_s=data_s, model_s=model_s, utt=n_utt)
        test_a = epoch_record(rec_a, 2, "test/")
        print(f"trainer {route} (cli.train, TitaNet-S 17 blocks, bf16, B={TRAIN_BATCH}, {steps} steps an "
              f"epoch, chunk+specaugment+noise): launches {counts}; train/avg_loss epoch 1 {losses[0]:.4f} -> "
              f"epoch 2 {losses[1]:.4f}"
              f"{'' if falls else ' (did not fall: two epochs of 11 steps from random weights, SpecAugment and noise on half the rows)'}"
              f"; val/avg_loss {epoch_record(rec_a, 2, 'val/')['val/avg_loss']:.4f}; test/eer "
              f"{test_a['test/eer']:.4f}, test/mindcf {test_a['test/mindcf']:.4f}; whole loop {wall:.2f} s for "
              f"{n_utt} training utterances ({n_utt / wall:.1f} utt/s, validation, checkpoints and "
              f"verification included; {n_utt / (data_s + model_s):.1f} utt/s over the training steps "
              f"alone); StepTimer data {data_s:.3f} s / model {model_s:.3f} s over {2 * steps} steps; "
              f"epoch 2 wall {ts_[1] - ts_[0]:.2f} s (train record to train record: 11 steps, epoch 1's "
              f"validation and checkpoint); peak memory {peak / 2**30:.2f} GiB {tag}")

        # run B: one epoch, then resumed for the second
        cli.train(trainer_config(root, f"b-{route}", 1, augmented))
        cli.train(trainer_config(root, f"b-{route}", 2, augmented, resume=True))
        rec_b = read_jsonl(os.path.join(root, f"b-{route}", "metrics.jsonl"))
        got = {**epoch_record(rec_b, 2, "train/"), **epoch_record(rec_b, 2, "val/"),
               **epoch_record(rec_b, 2, "test/")}
        ref = {**tr[1], **epoch_record(rec_a, 2, "val/"), **test_a}
        diffs = {k: abs(got[k] - ref[k]) for k in RESUME_KEYS}
        if route == "pallas":
            if any(got[k] != ref[k] for k in RESUME_KEYS):
                raise AssertionError(f"trainer pallas: resumed epoch 2 differs from the straight run: {diffs}")
        elif any(diffs[k] > RESUME_XLA_RTOL * max(abs(ref[k]), 1e-3) for k in RESUME_KEYS):
            raise AssertionError(f"trainer xla: resumed epoch 2 differs beyond {RESUME_XLA_RTOL}: {diffs}")
        print(f"trainer {route}: resumed run (1 epoch, then resume: true) vs straight run at epoch 2: "
              f"{'identical bits' if all(v == 0 for v in diffs.values()) else 'differences'} "
              f"{json.dumps(diffs)} {tag}")

    # eval: the saved checkpoint of run A, whole utterances, masked pooling
    metrics, counts = counted(lambda: cli.evaluate_checkpoint(
        trainer_config(root, "a-pallas", 2, augmented), os.path.join(root, "a-pallas")))
    if not (0.0 <= metrics["test/eer"] <= 1.0 and 0.0 <= metrics["test/mindcf"] <= 1.0):
        raise AssertionError(f"evaluate_checkpoint: {metrics}")
    if counts["logmel"] != test_batches or counts["pool_fwd"] != 0:
        raise AssertionError(f"evaluate_checkpoint: launches {counts}")
    print(f"evaluate_checkpoint (run A pallas, epoch 2): test/eer {metrics['test/eer']:.4f}, test/mindcf "
          f"{metrics['test/mindcf']:.4f}; launches {counts} (masked pooling runs plain) {tag}")
    os.environ.pop("TITANET_DW_BWD", None)
    return root, n_speakers


# Serving phase (14): the entry points a user runs after training, on run
# A of phase 13 (TitaNet-S at full width, bf16), resumed from its 2 epochs
# to SERVE_EPOCHS: after 2 epochs (22 steps) its embeddings nearly
# coincide (every pair of the test split scored a cosine within 3e-6 of
# 1), too close to check a scores file written to 6 decimals. The entry
# points run over WAV files of the synthetic corpus's test split (8
# speakers x 4 utterances), a 40 s file of one speaker (past the largest
# bucket: two windows) and a conversation of three speakers in turns. The
# CLI's frontend is the f32 fused log-mel kernel; the service's
# --fast-frontend is the bf16 tensor-core kernel.
SERVE_EPOCHS = 8


class embedding_calls:
    """Counts the embedding steps that ``SpeakerEmbedder``, ``loop.infer``
    and direct calls of ``state.embed_step`` run and the launches of the two kernels an embedding
    step can reach (the fused log-mel kernel; the pool forward, which runs
    where the pooling is unmasked), with every counter set to 0 on entry.
    It keeps what each kernel call was given, cloned, by wrapping the names
    the path looks the kernels up by (``frontend._log_mel_fused`` with the
    waveform, config and lengths it turns into the kernel's operands;
    ``pooling.attentive_pool_fused``) and the output. On exit ``calls``,
    ``launches``, ``tc_launches``, ``pool_launches``, ``mel`` and ``pool``
    hold them."""

    def __enter__(self):
        from titanet_torch.ops import frontend, pooling
        from titanet_torch.ops.kernels.melspec import log_mel_fused
        from titanet_torch.ops.kernels.pool import attentive_pool_fwd
        from titanet_torch.train import extractor, loop, state

        self.calls, self.mel, self.pool, self._saved = 0, [], [], []
        for mod in (extractor, loop, state):
            for name in ("embed_step", "embed_step_quantized"):
                if getattr(mod, name, None) is not None:
                    self._wrap(mod, name, self._counted)
        self._wrap(frontend, "_log_mel_fused", self._keep_mel)
        self._wrap(pooling, "attentive_pool_fused", self._keep_pool)
        self._mel_fn, self._pool_fn = log_mel_fused, attentive_pool_fwd
        log_mel_fused.launches = log_mel_fused.tc_launches = attentive_pool_fwd.launches = 0
        return self

    def _wrap(self, mod, name, make):
        fn = getattr(mod, name)
        self._saved.append((mod, name, fn))
        setattr(mod, name, make(fn))

    def _counted(self, fn):
        def call(*a, **k):
            self.calls += 1
            return fn(*a, **k)
        return call

    def _keep_mel(self, fn):
        def call(waveform, cfg, lengths):
            out = fn(waveform, cfg, lengths)
            self.mel.append(dict(waveform=waveform.clone(), cfg=cfg, out=out.clone(),
                                 lengths=None if lengths is None else lengths.clone()))
            return out
        return call

    def _keep_pool(self, fn):
        def call(h, a, c, wa, ba, wb, bb, eps, fold):
            out = fn(h, a, c, wa, ba, wb, bb, eps, fold)
            dt = h.dtype  # the operands as the pool's autograd function hands them to the kernel
            args = (h.contiguous(), a.float().contiguous(), c.float().contiguous(), wa.to(dt).contiguous(),
                    ba.float().contiguous(), wb.to(dt).contiguous(), bb.float().contiguous())
            self.pool.append(dict(args=tuple(t.clone() for t in args), eps=eps, fold=fold, out=out.clone()))
            return out
        return call

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self.launches, self.tc_launches = self._mel_fn.launches, self._mel_fn.tc_launches
        self.pool_launches = self._pool_fn.launches
        return False


def replay_mel(records, what: str, dtype=None):
    """Every log-mel launch kept by :class:`embedding_calls` replayed on its
    own operands (the waveform, config and lengths the path turned into
    them): the replay gives the path's output bit for bit and matches
    ``log_mel_fused_plain`` within phase 2's tolerance (f32 atol 1e-4, bf16
    2e-3); ``dtype``, when given, is the operands' required dtype. Raises on
    a miss; returns ``(max abs err, filler rows of length 1, buffer
    shapes)``."""
    import torch

    from titanet_torch.ops import frontend as tf
    from titanet_torch.ops.kernels.melspec import log_mel_fused, log_mel_fused_plain

    err, n_fillers, widths = 0.0, 0, set()
    for rec in records:
        args, kw = tf.log_mel_fused_operands(rec["waveform"], rec["cfg"], rec["lengths"])
        if dtype is not None and args[0].dtype != dtype:
            raise AssertionError(f"{what}: log-mel kernel ran on {args[0].dtype}, expected {dtype}")
        atol = 2e-3 if args[0].dtype == torch.bfloat16 else 1e-4
        out = log_mel_fused(*args, **kw)
        ref = log_mel_fused_plain(*args, n_frames=kw["n_frames"], hop=kw["hop"])
        torch.cuda.synchronize()
        if not torch.equal(out, rec["out"]):
            raise AssertionError(f"{what}: the log-mel replay on {tuple(args[0].shape)} differs from the "
                                 "path's output")
        e = (out - ref).abs().max().item()
        if not torch.isfinite(out).all() or e > atol:
            raise AssertionError(f"{what}: log-mel kernel vs plain on {tuple(args[0].shape)} "
                                 f"{args[0].dtype}: max abs err {e} > {atol}")
        err = max(err, e)
        n_fillers += int((args[1] == 1).sum().item()) if args[1] is not None else 0
        widths.add(tuple(args[0].shape))
    return err, n_fillers, widths


def check_command_kernels(calls: "embedding_calls", what: str, tag: str, *, mel: str = "f32",
                          fillers: bool = True, pool: bool = False, echo: bool = True) -> dict:
    """The kernels a command's embedding calls went through, held against
    their plain versions on the tensors the command gave them; raises on a
    miss, returns the summary.

    ``mel`` ``"f32"`` or ``"bf16"``: every embedding call launched the fused
    log-mel kernel once (bf16: the tensor-core one), and each launch,
    replayed on its own operands (the bucket width, the lengths, the filler
    rows of length 1 that ``SpeakerEmbedder`` pads a group with, which
    ``fillers`` requires to be among them), gives the command's output bit
    for bit and matches ``log_mel_fused_plain``: f32 atol 1e-4, bf16 2e-3,
    as phase 2. ``mel`` None: no launch (a plain torch frontend).

    ``pool``: every embedding call pooled unmasked through the pool-forward
    kernel once, and each launch holds as phase 13's
    (:func:`pool_fwd_vs_plain`); otherwise no launch."""
    import torch

    want_mel = calls.calls if mel else 0
    want_pool = calls.calls if pool else 0
    if calls.calls == 0 or calls.launches != want_mel or len(calls.mel) != want_mel \
            or calls.tc_launches != (want_mel if mel == "bf16" else 0) \
            or calls.pool_launches != want_pool or len(calls.pool) != want_pool:
        raise AssertionError(f"{what}: {calls.calls} embedding calls; {calls.launches} log-mel launches "
                             f"({calls.tc_launches} tensor-core, {len(calls.mel)} kept), expected {want_mel} "
                             f"{mel}; {calls.pool_launches} pool-forward launches ({len(calls.pool)} kept), "
                             f"expected {want_pool}")
    summary = {"calls": calls.calls, "launches": calls.launches, "pool_launches": calls.pool_launches}
    line = f"  {what}: {calls.calls} embedding calls"
    if mel:
        atol = 2e-3 if mel == "bf16" else 1e-4
        err, n_fillers, widths = replay_mel(calls.mel, what, torch.bfloat16 if mel == "bf16" else torch.float32)
        if fillers and n_fillers == 0:
            raise AssertionError(f"{what}: no launch held filler rows")
        summary["max_abs_err"] = err
        route = "logmel_tc_kernel, bf16" if mel == "bf16" else "logmel_kernel, f32"
        line += (f", all through the log-mel kernel ({route});"
                 f" replayed on every launch's operands, the command's output bit for bit, vs plain (buffers "
                 f"{sorted(widths)}, {n_fillers} filler rows of length 1): max abs err {err:.3e} (atol {atol})")
    else:
        line += ", no log-mel kernel launch (plain torch frontend)"
    if pool:
        errs = [pool_fwd_vs_plain(rec["args"], rec["eps"], rec["fold"], rec["out"], f"{what}: pool forward")
                for rec in calls.pool]
        summary["pool_max_abs_err"] = max(errs)
        shapes = sorted({(tuple(r["args"][0].shape), str(r["args"][0].dtype), r["fold"]) for r in calls.pool})
        line += (f"; unmasked pooling, all through the pool-forward kernel, replayed on every launch's operands "
                 f"(h, dtype, fold {shapes}), the command's output bit for bit, vs plain: max abs err "
                 f"{max(errs):.3e} (rtol 2e-2)")
    else:
        line += "; masked pooling (plain torch), no pool-forward launch"
    if echo:
        print(f"{line} {tag}")
    return summary


def post(url: str, body: bytes):
    """POST ``body`` to the service: ``(status, decoded JSON reply)``."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def serving_phase(root: str, n_speakers: int, tag: str) -> None:
    """Phase 14: ``python -m titanet_torch infer | trials | diarize``
    through ``cli.main`` in process, and the speaker service
    (``titanet_torch.serve``) in a thread, on run A of phase 13 resumed to
    ``SERVE_EPOCHS``. Raises on any failed check."""
    import threading
    from http.server import HTTPServer

    import numpy as np
    import torch

    from titanet_torch import cli, serve
    from titanet_torch.config import Config
    from titanet_torch.data.audio_io import read_mono, write_wav
    from titanet_torch.train import diarize as td
    from titanet_torch.train.enroll import SpeakerRegistry
    from titanet_torch.train.extractor import SpeakerEmbedder
    from titanet_torch.train.loop import infer as loop_infer
    from titanet_torch.train.trials import embed_trial_files, trial_scores

    sr = SR
    augmented = ("chunk", "specaugment", "noise")
    t0 = time.perf_counter()
    cli.train(trainer_config(root, "a-pallas", SERVE_EPOCHS, augmented, resume=True))
    cfg = trainer_config(root, "a-pallas", SERVE_EPOCHS, augmented)
    run = os.path.join(root, "a-pallas")
    losses = [epoch_record(read_jsonl(os.path.join(run, "metrics.jsonl")), e, "train/")["train/avg_loss"]
              for e in (2, SERVE_EPOCHS)]
    print(f"serving set-up: run A resumed from epoch 2 to {SERVE_EPOCHS} (cli.train, resume: true) in "
          f"{time.perf_counter() - t0:.2f} s; train/avg_loss {losses[0]:.4f} -> {losses[1]:.4f} {tag}")
    work = os.path.join(root, "serving")
    utt_dir = os.path.join(work, "utts")
    os.makedirs(utt_dir)
    params = os.path.join(work, "params.json")
    with open(params, "w") as f:
        json.dump(cfg.to_dict(), f)
    if Config.from_yaml(params).to_dict() != cfg.to_dict():
        raise AssertionError("serving: the JSON config does not read back to the trainer's")

    # the test split as WAV files, a 40 s file, a conversation
    test_ds = cli._datasets(cfg, True)[2]
    wave_of = lambda i: np.asarray(test_ds[i]["waveform"], np.float32).reshape(-1)  # noqa: E731
    files, spk_of = [], {}
    speakers = sorted(test_ds.speakers_utterances)
    for s, spk in enumerate(speakers):
        for i, idx in enumerate(test_ds.speakers_utterances[spk]):
            path = os.path.join(utt_dir, f"spk{s}_{i}.wav")
            write_wav(path, wave_of(idx), sr)
            files.append(path)
            spk_of[path] = s
    per_spk = {s: [p for p in files if spk_of[p] == s] for s in range(len(speakers))}
    long_wav = np.concatenate([wave_of(i) for i in test_ds.speakers_utterances[speakers[0]]] * 10)
    long_wav = long_wav[: 40 * sr]
    long_path = os.path.join(work, "long40.wav")
    write_wav(long_path, long_wav, sr)
    probe_path = os.path.join(work, "probe3s.wav")
    write_wav(probe_path, long_wav[: 3 * sr], sr)
    pieces, truth, t = [], [], 0.0
    turn = 0
    while t < 32.0:
        s = turn % 3 + 1
        wav = wave_of(test_ds.speakers_utterances[speakers[s]][turn // 3 % 4])
        pieces.append(wav)
        truth.append((t, t + len(wav) / sr, s))
        t += len(wav) / sr
        turn += 1
    conv_path = os.path.join(work, "conversation.wav")
    write_wav(conv_path, np.concatenate(pieces), sr)
    conv_s = t
    if len(files) != 32 or not 30.0 <= conv_s <= 45.0:
        raise AssertionError(f"serving set-up: {len(files)} files, conversation {conv_s:.1f} s")
    print(f"serving set-up: {len(files)} test utterances ({len(speakers)} speakers) as WAV, a 40 s file, "
          f"a {conv_s:.2f} s conversation of 3 speakers in {len(truth)} turns {tag}")

    base = ["-p", params, "-c", run]
    # infer --audio: the directory and the 40 s file
    npz = os.path.join(work, "a.npz")
    with embedding_calls() as calls:
        emb, labels = cli.main(["infer", *base, "--audio", utt_dir, long_path, "-o", npz])
    check_command_kernels(calls, "infer --audio", tag)
    state, frontend, _ = cli._restore_for_eval(cfg, n_speakers, run, None, "cuda")
    paths = files + [long_path]
    direct = SpeakerEmbedder(state.model, frontend, device="cuda").embed([read_mono(p, sr) for p in paths])
    norm_err = np.abs(np.linalg.norm(emb, axis=-1) - 1).max()
    diff = np.abs(emb - direct).max()
    if emb.shape != (33, 192) or not np.isfinite(emb).all() or norm_err > 1e-5 or diff > 1e-6 \
            or list(labels) != [os.path.splitext(os.path.basename(p))[0] for p in paths]:
        raise AssertionError(f"infer --audio: shape {emb.shape}, norm error {norm_err}, vs direct embed {diff}")
    print(f"infer --audio (32 utterances + the 40 s file): [33, 192] finite, unit norm ({norm_err:.1e}); vs "
          f"SpeakerEmbedder.embed called directly max abs {diff:.1e} (limit 1e-6) {tag}")
    with embedding_calls() as calls:
        emb_split, spk_split = cli.main(["infer", *base, "--split", "test", "-n", "32"])
    check_command_kernels(calls, "infer --split test -n 32 (the loader's batches: no filler rows; loop.infer "
                                 "pools unmasked)", tag, fillers=False, pool=True)
    want, want_spk = loop_infer(state, test_ds, list(range(32)), frontend=frontend, sample_rate=sr,
                                batch_size=cfg.validation.batch_size)
    diff = np.abs(emb_split - want).max()
    if diff > 1e-6 or list(spk_split) != list(want_spk):
        raise AssertionError(f"infer --split: vs loop.infer max abs {diff}")
    print(f"infer --split test -n 32: vs train/loop.py::infer max abs {diff:.1e} {tag}")

    # trials: every pair of the 32 utterances
    names = [os.path.relpath(p, work) for p in files]
    pairs = [(i, j) for i in range(32) for j in range(i + 1, 32)]
    vox, kaldi = os.path.join(work, "veri.txt"), os.path.join(work, "trials")
    with open(vox, "w") as f:
        f.writelines(f"{int(spk_of[files[i]] == spk_of[files[j]])} {names[i]} {names[j]}\n" for i, j in pairs)
    with open(kaldi, "w") as f:
        f.writelines(f"{names[i]} {names[j]} {'target' if spk_of[files[i]] == spk_of[files[j]] else 'nontarget'}\n"
                     for i, j in pairs)
    tbase = ["trials", *base, "--audio-root", work]

    def read_scores(path):
        """The scores file's third column, as written (6 decimals)."""
        with open(path) as f:
            return [line.split()[2] for line in f]

    t0 = time.perf_counter()
    with embedding_calls() as calls:
        plain = cli.main([*tbase, "--trial-file", vox, "-o", os.path.join(work, "plain.txt")])
    trials_s = time.perf_counter() - t0
    check_command_kernels(calls, "trials", tag)
    with embedding_calls() as calls:
        normed = cli.main([*tbase, "--trial-file", vox, "--cohort", npz, "--cohort-topk", "8",
                           "-o", os.path.join(work, "vox.txt")])
    check_command_kernels(calls, "trials --cohort --cohort-topk 8", tag)
    normed_k = cli.main([*tbase, "--trial-file", kaldi, "--cohort", npz, "--cohort-topk", "8",
                         "-o", os.path.join(work, "kaldi.txt")])
    # Both scores files are recomputed from the embeddings trials itself
    # computes (embed_trial_files through the same embedder, the same
    # batches: the same bits) and must equal them as written, 6 decimals,
    # pair by pair: a score written for the wrong pair or in the wrong order
    # shows as long as the scores are spread well beyond that rounding,
    # which is checked too. The plain scores are also held to the cosine of
    # infer's embeddings. infer embeds in batches of 32 and trials in the
    # validation's 64, so the bf16 model rounds a file's embedding apart in
    # the two; for unit vectors |a.b - a'.b'| <= |a - a'| + |b - b'|, which
    # bounds each score's distance from infer's cosine by its two files'
    # distances between the commands (each within bf16's rounding: cosine
    # >= 0.999). AS-norm divides each score by its sides' spread over their
    # top 8 cohort scores, so it is held only to the recomputation.
    enrolls, tests = [names[i] for i, _ in pairs], [names[j] for _, j in pairs]
    trial_emb = embed_trial_files(enrolls + tests, SpeakerEmbedder(
        state.model, frontend, batch_size=cfg.validation.batch_size, device="cuda"), audio_root=work, sample_rate=sr)
    written = {k: read_scores(os.path.join(work, f"{k}.txt")) for k in ("plain", "vox", "kaldi")}
    want = {"plain": trial_scores(trial_emb, enrolls, tests),
            "vox": trial_scores(trial_emb, enrolls, tests, cohort_embeddings=emb, cohort_topk=8)}
    exact = {k: [f"{x:.6f}" for x in want[k]] == written[k] for k in want}
    s_plain = np.array([float(x) for x in written["plain"]])
    span = s_plain.max() - s_plain.min()
    s_norm = np.array([float(x) for x in written["vox"]])
    unit = emb[:32].astype(np.float64)
    unit /= np.linalg.norm(unit, axis=-1, keepdims=True)
    unit_t = np.stack([trial_emb[n] for n in names]).astype(np.float64)
    unit_t /= np.linalg.norm(unit_t, axis=-1, keepdims=True)
    apart, agree = np.linalg.norm(unit - unit_t, axis=-1), (unit * unit_t).sum(-1).min()
    bound = np.array([apart[i] + apart[j] for i, j in pairs]) + 1e-6  # + the file's rounding
    d_plain = np.abs(s_plain - np.array([unit[i] @ unit[j] for i, j in pairs]))
    coh = unit_t @ (emb / np.linalg.norm(emb, axis=-1, keepdims=True)).T.astype(np.float64)
    spread = np.partition(coh, coh.shape[1] - 8, axis=1)[:, -8:].std(axis=1)
    scores_line = (f"plain scores span {s_plain.min():.6f}..{s_plain.max():.6f} (max - min {span:.3e}, "
                   f"{len(set(written['plain']))} distinct of 496 as written); AS-norm scores span "
                   f"{s_norm.min():.6f}..{s_norm.max():.6f} ({len(set(written['vox']))} distinct)")
    for m in (plain, normed, normed_k):
        if not (0.0 <= m["eer"] <= 1.0 and 0.0 <= m["mindcf"] <= 1.0 and np.isfinite(m["min_cllr"])) \
                or (m["n_trials"], m["n_files"]) != (496, 32):
            raise AssertionError(f"trials: {m}")
    infer_line = (f"plain vs infer's cosine max abs {d_plain.max():.3e}, within each pair's bound (max "
                  f"{bound.max():.3e}; the commands' embeddings of a file: min cosine {agree:.7f})")
    if not all(exact.values()) or agree < 0.999 or (d_plain > bound).any() or written["vox"] != written["kaldi"] \
            or normed_k != normed:
        raise AssertionError(f"trials: scores files equal the recomputation as written {exact}; {infer_line}, "
                             f"{int((d_plain > bound).sum())} pairs past it; Kaldi vs VoxCeleb list equal: "
                             f"{written['vox'] == written['kaldi']}; {scores_line}")
    if span < 20 * bound.max():
        raise AssertionError(f"trials: the plain scores span {span:.3e}, not 20x the {bound.max():.3e} they are "
                             f"held to: the checks could not see scores written for the wrong pairs; {scores_line}")
    print(f"trials (496 pairs of 32 files): EER {plain['eer']:.4f}, minDCF {plain['mindcf']:.4f}, min-Cllr "
          f"{plain['min_cllr']:.4f}; {scores_line}; both files equal the scores recomputed from trials' own "
          f"embeddings as written (6 decimals), pair by pair; {infer_line}; AS-norm (cohort a.npz, top 8; each "
          f"file's top-8 spread {spread.min():.2e}-{spread.max():.2e}): EER {normed['eer']:.4f}, minDCF "
          f"{normed['mindcf']:.4f}, min-Cllr {normed['min_cllr']:.4f}, Kaldi list identical; {32 / trials_s:.1f} files/s "
          f"({trials_s:.3f} s a command, restore included) {tag}")

    # diarize: NME-SC, known k, AHC, VAD
    rttm = os.path.join(work, "out.rttm")
    dbase = ["diarize", *base, "--audio", conv_path, "--rttm", rttm]
    for extra in ([], ["--known-k", "3"], ["--clustering", "ahc"], ["--vad"]):
        t0 = time.perf_counter()
        with embedding_calls() as calls:
            segs = cli.main([*dbase, *extra])[conv_path]
        wall = time.perf_counter() - t0
        check_command_kernels(calls, f"diarize {' '.join(extra) or '(NME-SC)'}", tag)
        back = td.read_rttm(rttm)["conversation"]
        if not segs or len(back) != len(segs) or any(
                abs(a.start - b.start) > 1e-3 or abs(a.end - b.end) > 1e-3 or a.speaker != b.speaker
                for a, b in zip(segs, back)):
            raise AssertionError(f"diarize {extra}: RTTM does not read back to the segments")
        der = td.diarization_error_rate(truth, segs)
        print(f"diarize {' '.join(extra) or '(NME-SC)'}: {len(segs)} segments, "
              f"{len({s.speaker for s in segs})} speakers (truth 3), DER {der:.4f} (reported, not gated: "
              f"{SERVE_EPOCHS} epochs of a synthetic corpus); RTTM reads back; real-time factor {conv_s / wall:.1f} "
              f"({conv_s:.2f} s of audio in {wall:.3f} s, restore included) {tag}")
    online = td.OnlineDiarizer(SpeakerEmbedder(state.model, frontend, batch_size=cfg.validation.batch_size,
                                               device="cuda"), sr)
    conv = read_mono(conv_path, sr)
    for start in range(0, len(conv), int(1.5 * sr)):
        online.feed(conv[start:start + int(1.5 * sr)])
    osegs = online.finish()
    if not osegs or not all(isinstance(s.speaker, int) and s.speaker >= 0 and np.isfinite([s.start, s.end]).all()
                            for s in osegs):
        raise AssertionError(f"OnlineDiarizer: {osegs[:3]}")
    print(f"OnlineDiarizer (1.5 s chunks): {len(osegs)} segments, {len({s.speaker for s in osegs})} speakers, "
          f"DER {td.diarization_error_rate(truth, osegs):.4f} (reported) {tag}")
    del state

    # the service, three variants, in a thread
    def body(path):
        with open(path, "rb") as f:
            return f.read()

    for variant in ([], ["--fast-frontend"], ["--quantized", "--fast-frontend"]):
        label = " ".join(variant) or "default"
        args = serve.build_parser().parse_args(["--checkpoint-dir", run, "--n-classes", str(n_speakers),
                                                "--port", "0", *variant])
        embedder = serve.build_embedder(args)
        registry = SpeakerRegistry(threshold=args.threshold)
        httpd = HTTPServer(("127.0.0.1", 0), serve.make_handler(embedder, registry))
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_port}"
        try:
            with embedding_calls() as calls:
                codes = [post(url + "/embed", body(probe_path))]
                for s in range(3):
                    codes += [post(url + f"/enroll?name=spk{s}", body(p)) for p in per_spk[s][:2]]
                codes += [post(url + "/verify?name=spk0", body(per_spk[0][2])),
                          post(url + "/verify?name=spk0", body(per_spk[1][2]))]
                probes = [(s, p) for s in range(3) for p in per_spk[s][2:]]
                idents = [post(url + "/identify", body(p)) for _, p in probes]
                bad = post(url + "/embed", b"this is not a wav file")
            if any(c != 200 for c, _ in codes + idents) or bad[0] != 400:
                raise AssertionError(f"service {label}: codes {[c for c, _ in codes + idents]}, malformed {bad[0]}")
            direct = embedder.embed([read_mono(probe_path, sr)])[0]
            diff = np.abs(np.asarray(codes[0][1]["embedding"]) - direct).max()
            if diff > 1e-6:
                raise AssertionError(f"service {label}: /embed vs direct embed {diff}")
            fast = "--fast-frontend" in variant
            # without --fast-frontend the service's frontend is plain torch (FrontendConfig.from_ms())
            check_command_kernels(calls, f"service {label}", tag, mel="bf16" if fast else None)
            top1 = np.mean([r[1]["candidates"][0]["speaker"] == f"spk{s}" for (s, _), r in zip(probes, idents)])
            accept_same, accept_other = codes[7][1]["accept"], codes[8][1]["accept"]
            ms, embed_ms = [], []
            probe, wav3 = body(probe_path), read_mono(probe_path, sr)
            for i in range(23):
                t0 = time.perf_counter()
                status, _ = post(url + "/embed", probe)
                if status != 200:
                    raise AssertionError(f"service {label}: /embed {status}")
                t1 = time.perf_counter()
                embedder.embed([wav3])
                if i >= 3:
                    ms.append((t1 - t0) * 1e3)
                    embed_ms.append((time.perf_counter() - t1) * 1e3)
            dev_ms, timed_by = device_ms(lambda: embedder.embed([wav3]), iters=5)
            print(f"service {label} ({'log-mel kernel bf16' if fast else 'plain torch frontend, f32'}"
                  f"{', int8 encoder' if '--quantized' in variant else ''}; {calls.calls} embedding calls): "
                  f"/embed /enroll x6 /verify x2 /identify x{len(probes)} -> 200, malformed body -> 400; /embed vs "
                  f"direct embed max abs {diff:.1e}; verify same {accept_same}, other {accept_other}; identify "
                  f"top-1 {top1:.3f} (reported); /embed of a 3 s WAV median {statistics.median(ms):.3f} ms "
                  f"(min {min(ms):.3f}, max {max(ms):.3f}, 20 requests after 3), of which embed() "
                  f"{statistics.median(embed_ms):.3f} ms (median of 20 direct calls, batch {args.batch_size} x "
                  f"{embedder._bucket_for(len(wav3))} samples) and device time {dev_ms:.3f} ms a call ({timed_by}; "
                  f"idle {1 - dev_ms / statistics.median(embed_ms):.2f}) {tag}")
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=10)


# Zoo phase (15): every family of the model zoo but TitaNet at its
# published width, bf16, weights from seed 0 (generic.seed 0), on phase 13's
# corpus: (name, config sections, --model-size of the service or None: the
# JAX service names no size for the d-vector or the convnet).
ZOO_FAMILIES = (
    ("ecapa512", {"ecapa": {"enabled": True, "channels": 512}}, "ecapa512"),
    ("ecapa1024", {"ecapa": {"enabled": True, "channels": 1024}}, "ecapa1024"),
    ("xvector", {"xvector": {"enabled": True, "hidden_size": 512, "frame_out": 1500}}, "xvector"),
    ("resnet34", {"resnet": {"enabled": True, "depth": 34, "base_channels": 32}}, "resnet"),
    ("conformer", {"conformer": {"enabled": True, "num_blocks": 6, "dim": 256, "num_heads": 4,
                                 "ff_hidden": 2048}}, "conformer"),
    ("dvector", {"baseline": {"enabled": True, "n_layers": 3, "hidden_size": 768}}, None),
    ("dumb", {"dumb": {"enabled": True, "n_layers": 10, "hidden_size": 256}}, None),
)
ZOO_STEPS = 20  # train steps on one batch of TRAIN_BATCH x SECONDS s


def zoo_phase(tag: str) -> dict:
    """Phase 15: each family of :data:`ZOO_FAMILIES` through the trainer
    (``cli.train``, one epoch of ``[chunk]`` only, so the f32 log-mel kernel
    runs in every step, then ``cli.evaluate_checkpoint``), ``ZOO_STEPS``
    train steps on one batch, ``embed_step`` at B=128 x 3 s, the
    ``SpeakerEmbedder`` on 1.2, 3, 7 and 40 s requests, ``infer --audio``
    and the speaker service (``--model-size``, default and
    ``--fast-frontend``) on the trained checkpoint. Every log-mel launch is
    replayed on its own operands against its plain version; the
    Conformer's pool-forward and pool-backward launches of a train step
    (C = 1536, T' = 151) and of ``infer --split`` too; every other family
    launches no pool kernel. Raises on any failed check; returns each
    family's launches of the four kernels in its trainer run."""
    import tempfile
    import threading
    from http.server import HTTPServer

    import numpy as np
    import torch

    from titanet_torch import cli, serve
    from titanet_torch.data.audio_io import read_mono, write_wav
    from titanet_torch.models import count_params
    from titanet_torch.ops.frontend import FrontendConfig
    from titanet_torch.ops.kernels import dwconv
    from titanet_torch.ops.kernels.melspec import log_mel_fused
    from titanet_torch.ops.kernels.pool import attentive_pool_bwd, attentive_pool_fwd
    from titanet_torch.train import checkpoint as ckpt
    from titanet_torch.train import state as ts
    from titanet_torch.train.extractor import SpeakerEmbedder

    dev = torch.device("cuda")
    counters = {"logmel": log_mel_fused, "pool_fwd": attentive_pool_fwd, "pool_bwd": attentive_pool_bwd,
                "dw_bwd": dwconv.dw_bwd}

    def zero():
        for c in counters.values():
            c.launches = 0

    def read():
        torch.cuda.synchronize()
        return {k: c.launches for k, c in counters.items()}

    rng = np.random.default_rng(15)
    wav = torch.from_numpy((rng.standard_normal((B, SECONDS * SR)) * 0.1).astype(np.float32)).to(dev)
    lengths = torch.full((B,), SECONDS * SR, dtype=torch.int32, device=dev)
    reqs = [(rng.standard_normal(int(s * SR)) * 0.1).astype(np.float32) for s in (1.2, 3, 7, 40)]
    cfg16 = FrontendConfig.from_ms(precision="default", use_pallas_fused=True)
    root = tempfile.mkdtemp(prefix="titanet_torch_zoo_")
    out = {}
    try:
        # set-up: phase 13's corpus, 8 test utterances as WAV files, a 3 s
        # probe, and one batch of 64 training utterances spread over the
        # split, each repeated to 3 s
        train_ds, val_ds, test_ds, n_speakers = cli._datasets(trainer_config(root, "probe", 1, ("chunk",)), True)
        steps = len(train_ds) // TRAIN_BATCH
        val_batches, test_batches = -(-len(val_ds) // TRAIN_BATCH), -(-len(test_ds) // TRAIN_BATCH)
        utt_dir = os.path.join(root, "utts")
        os.makedirs(utt_dir)
        for i in range(8):
            write_wav(os.path.join(utt_dir, f"utt{i}.wav"), np.asarray(test_ds[i]["waveform"], np.float32).reshape(-1),
                      SR)
        probe_path = os.path.join(root, "probe3s.wav")
        write_wav(probe_path, np.resize(np.asarray(test_ds[0]["waveform"], np.float32).reshape(-1), SECONDS * SR), SR)
        with open(probe_path, "rb") as f:
            probe = f.read()
        picks = np.linspace(0, len(train_ds) - 1, TRAIN_BATCH).astype(int).tolist()
        batch_wav = torch.from_numpy(np.stack([
            np.resize(np.asarray(train_ds[i]["waveform"], np.float32).reshape(-1), SECONDS * SR)
            for i in picks])).to(dev)
        batch_spk = torch.tensor([train_ds[i]["speaker_id"] for i in picks], device=dev)
        print(f"zoo set-up: {len(train_ds)} train utterances ({steps} steps of {TRAIN_BATCH}), {len(val_ds)} "
              f"validation, {len(test_ds)} test; {len(set(batch_spk.tolist()))} speakers in the step batch {tag}")

        for name, model_cfg, size in ZOO_FAMILIES:
            t_family = time.perf_counter()
            conformer = "conformer" in model_cfg
            cfg = trainer_config(root, name, 1, ("chunk",), model=model_cfg)
            run = os.path.join(root, name)
            os.environ["TITANET_DW_BWD"] = "pallas"

            # 1. the trainer: one epoch, then the verification of its checkpoint
            zero()
            t0 = time.perf_counter()
            with embedding_calls() as calls:
                cli.train(cfg)
                train_s = time.perf_counter() - t0
                metrics = cli.evaluate_checkpoint(cfg, run)
            trainer = read()
            want = {"logmel": steps + val_batches + 2 * test_batches,
                    "pool_fwd": steps + val_batches if conformer else 0, "pool_bwd": steps if conformer else 0,
                    "dw_bwd": 0}
            if trainer != want or len(calls.mel) != want["logmel"]:
                raise AssertionError(f"zoo {name} trainer: launches {trainer} ({len(calls.mel)} log-mel kept), "
                                     f"expected {want}")
            mel_err, _, _ = replay_mel(calls.mel, f"zoo {name} trainer", torch.float32)
            loss = epoch_record(read_jsonl(os.path.join(run, "metrics.jsonl")), 1, "train/")["train/avg_loss"]
            if not np.isfinite(loss) or ckpt.latest_epoch(run) != 1:
                raise AssertionError(f"zoo {name} trainer: loss {loss}, checkpoint {ckpt.latest_epoch(run)}")
            if not (0.0 <= metrics["test/eer"] <= 1.0 and 0.0 <= metrics["test/mindcf"] <= 1.0):
                raise AssertionError(f"zoo {name} evaluate_checkpoint: {metrics}")
            n_mel = len(calls.mel)
            del calls

            # 2. ZOO_STEPS train steps on one batch (all rows full length:
            # the pooling unmasked), the Conformer's pool kept by hooks in
            # the first
            _, _, state = cli._new_state(cfg, n_speakers, dev, 1)
            frontend = cli._frontend(cfg)
            kept = []
            hooks = keep_pool_calls(state.model, kept) if conformer else []
            step = lambda: ts.train_step(state, batch_wav, None, batch_spk, frontend=frontend)  # noqa: E731
            losses, norms, step_ms = [], [], []
            torch.cuda.reset_peak_memory_stats()
            zero()
            for i in range(ZOO_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, met = step()
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                for h in hooks:
                    h.remove()
                hooks = []
                losses.append(met["loss"].item())
                norms.append(met["grad_norm"].item())
            per_step = read()
            peak = torch.cuda.max_memory_allocated()
            if not (np.isfinite(losses).all() and np.isfinite(norms).all()) or losses[-1] >= losses[0] \
                    or not all(torch.isfinite(p).all() for p in state.params()):
                raise AssertionError(f"zoo {name} train steps: losses {losses}, grad norms {norms}")
            want = {"logmel": ZOO_STEPS, "pool_fwd": ZOO_STEPS if conformer else 0,
                    "pool_bwd": ZOO_STEPS if conformer else 0, "dw_bwd": 0}
            if per_step != want:
                raise AssertionError(f"zoo {name} train steps: launches {per_step}, expected {want}")
            pool_line = ""
            if conformer:
                t_half = -(-(1 + SECONDS * SR // 160) // 2)  # T' = ceil(F / 2) of F = 301 frames: 151
                width = cfg.conformer.num_blocks * cfg.conformer.dim  # 1536
                if len(kept) != 1 or "g" not in kept[0] or tuple(kept[0]["args"][0].shape) != (TRAIN_BATCH, t_half, width):
                    raise AssertionError(f"zoo {name}: kept {len(kept)} pool calls "
                                         f"{[tuple(r['args'][0].shape) for r in kept]}")
                pool_line = "; " + replay_pool(kept[0], "train step")
            step_dev, step_busy, step_kernels, timed_by = device_profile(step, iters=3, warmup=1)
            step_med = statistics.median(step_ms[1:])

            # 3. embedding: embed_step at B=128 x 3 s (the bf16 tensor-core
            # log-mel kernel; unmasked, so the Conformer pools through the
            # pool kernel) and the SpeakerEmbedder (masked, the CLI's f32
            # log-mel kernel)
            model = state.model.eval()
            embed = lambda: ts.embed_step(model, wav, lengths, frontend=cfg16, device=dev)  # noqa: E731
            with embedding_calls() as calls:
                e = embed()
            if e.shape != (B, 192) or not torch.isfinite(e.float()).all() \
                    or (torch.linalg.vector_norm(e.float(), dim=-1) - 1).abs().max().item() > 1e-2:
                raise AssertionError(f"zoo {name} embed_step: not finite unit rows [B, 192]")
            embed_k = check_command_kernels(calls, f"zoo {name} embed_step", tag, mel="bf16", fillers=False,
                                            pool=conformer, echo=False)
            emb_med, _, _ = median_ms(embed, runs=5, warmup=1)
            emb_dev, emb_busy, emb_kernels, _ = device_profile(embed, iters=3, warmup=1)
            embedder = SpeakerEmbedder(model, frontend, device=dev)
            with embedding_calls() as calls:
                batched = embedder.embed(reqs)
                solo = np.concatenate([embedder.embed([r]) for r in reqs])
            cos = np.sum(batched * solo, -1) / (np.linalg.norm(batched, axis=-1) * np.linalg.norm(solo, axis=-1))
            if batched.shape != (4, 192) or not np.isfinite(batched).all() or cos.min() <= 0.999:
                raise AssertionError(f"zoo {name} SpeakerEmbedder: padded vs solo cosines {cos}")
            check_command_kernels(calls, f"zoo {name} SpeakerEmbedder", tag, echo=False)
            n_params = count_params(model)
            cls = type(model).__name__
            del state, model, embedder, step, embed

            # 4. the entry points on the trained checkpoint
            params = os.path.join(root, f"{name}.json")
            with open(params, "w") as f:
                json.dump(cfg.to_dict(), f)
            with embedding_calls() as calls:
                emb, labels = cli.main(["infer", "-p", params, "-c", run, "--audio", utt_dir])
            check_command_kernels(calls, f"zoo {name} infer --audio", tag, echo=False)
            restored, rfront, _ = cli._restore_for_eval(cfg, n_speakers, run, None, dev)
            direct = SpeakerEmbedder(restored.model, rfront, device=dev).embed(
                [read_mono(os.path.join(utt_dir, f"{lab}.wav"), SR) for lab in labels])
            infer_diff = np.abs(emb - direct).max()
            if emb.shape != (8, 192) or not np.isfinite(emb).all() or infer_diff > 1e-6:
                raise AssertionError(f"zoo {name} infer --audio: shape {emb.shape}, vs direct embed {infer_diff}")
            split_line = ""
            if conformer:
                with embedding_calls() as calls:
                    cli.main(["infer", "-p", params, "-c", run, "--split", "test", "-n", "32"])
                split = check_command_kernels(calls, f"zoo {name} infer --split", tag, fillers=False, pool=True,
                                              echo=False)
                shapes = sorted({tuple(r["args"][0].shape) for r in calls.pool})
                split_line = (f"; infer --split test -n 32: {split['pool_launches']} pool-forward launches (h "
                              f"{shapes}) replayed, max abs err {split['pool_max_abs_err']:.3e} (rtol 2e-2)")
            del restored
            serve_line = "; service: none (no --model-size)"
            if size is not None:
                serve_ms = {}
                for variant in ([], ["--fast-frontend"]):
                    args = serve.build_parser().parse_args(["--model-size", size, "--checkpoint-dir", run,
                                                            "--n-classes", str(n_speakers), "--port", "0", *variant])
                    served = serve.build_embedder(args)
                    httpd = HTTPServer(("127.0.0.1", 0), serve.make_handler(served))
                    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
                    thread.start()
                    url = f"http://127.0.0.1:{httpd.server_port}/embed"
                    try:
                        with embedding_calls() as calls:
                            status, reply = post(url, probe)
                        fast = "--fast-frontend" in variant
                        check_command_kernels(calls, f"zoo {name} service", tag, mel="bf16" if fast else None,
                                              echo=False)
                        diff = np.abs(np.asarray(reply.get("embedding", [np.nan])) -
                                      served.embed([read_mono(probe_path, SR)])[0]).max()
                        if status != 200 or not diff <= 1e-6:
                            raise AssertionError(f"zoo {name} service {variant}: /embed {status}, vs direct {diff}")
                        times = []
                        for _ in range(6):
                            t0 = time.perf_counter()
                            post(url, probe)
                            times.append((time.perf_counter() - t0) * 1e3)
                        serve_ms[" ".join(variant) or "default"] = statistics.median(times[1:])
                    finally:
                        httpd.shutdown()
                        httpd.server_close()
                        thread.join(timeout=10)
                    del served
                serve_line = (f"; service --model-size {size}: /embed -> 200 equal to a direct embed (1e-6), median "
                              + ", ".join(f"{k} {v:.2f} ms" for k, v in serve_ms.items()))
            shutil.rmtree(run, ignore_errors=True)
            torch.cuda.empty_cache()
            os.environ.pop("TITANET_DW_BWD", None)
            out[name] = trainer
            print(f"zoo {name} ({cls}, {n_params / 1e6:.2f}M params, bf16): cli.train 1 epoch ({steps} steps of "
                  f"{TRAIN_BATCH}, [chunk]) {train_s:.2f} s, train/avg_loss {loss:.4f}, test/eer "
                  f"{metrics['test/eer']:.4f}, test/mindcf {metrics['test/mindcf']:.4f}, launches {trainer}, "
                  f"all {n_mel} log-mel launches replayed vs plain max abs err {mel_err:.3e} (atol 1e-4); "
                  f"train_step x{ZOO_STEPS} on B={TRAIN_BATCH} x {SECONDS} s: loss {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f}, grad norms finite, median {step_med:.2f} ms a step (min {min(step_ms[1:]):.2f}, "
                  f"max {max(step_ms[1:]):.2f}), device {step_dev:.2f} ms, busy {step_busy:.2f} ms ({timed_by}), "
                  f"{step_kernels} kernels a step, idle {1 - step_busy / step_med:.2f}, peak {peak / 2**30:.2f} GiB, launches "
                  f"{ {k: v // ZOO_STEPS for k, v in per_step.items()} } a step{pool_line}; embed_step B={B} x "
                  f"{SECONDS} s median {emb_med:.2f} ms, device {emb_dev:.2f} ms, busy {emb_busy:.2f} ms, {emb_kernels} kernels, idle "
                  f"{1 - emb_busy / emb_med:.2f}, log-mel bf16 err {embed_k['max_abs_err']:.2e}"
                  f"{', pool ' + format(embed_k['pool_max_abs_err'], '.2e') if conformer else ''}; SpeakerEmbedder "
                  f"padded vs solo min cosine {cos.min():.7f}; infer --audio vs direct {infer_diff:.1e}{split_line}"
                  f"{serve_line}; {time.perf_counter() - t_family:.1f} s wall {tag}")
        return out
    finally:
        os.environ.pop("TITANET_DW_BWD", None)
        shutil.rmtree(root, ignore_errors=True)


# Utilities and device-resident corpus phase (16): phase 13's trainer
# config (TitaNet-S at full width, bf16, CE, B=64, phase 13's corpus) with
# generic.device_corpus and augmentation [chunk, specaugment], as
# configs/bench21_scaled_eer.yml and bench22_easy_eer.yml set them; then
# the export, profiling and figure utilities on phase 13's run A (phase 14
# resumed it to SERVE_EPOCHS). Corpus fetching (data/acquire.py) is
# host-only stdlib code and the card's machine has no network: it is not
# run here; the CPU tests fetch local file:// archives through it.
DC_ENABLE = ("chunk", "specaugment")
EXPORT_B, EXPORT_SAMPLES = 8, 48000


def traced_kernels(fn, attempts: int = 3) -> list:
    """Names of the CUDA kernels ``torch.profiler`` records over one
    ``fn()``, after a traced warm-up call (a trace can lose its first
    records: see :func:`device_profile`). The trace is taken again, up to
    ``attempts`` times, while it records no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    names = []
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names:
            break
    return names


def utilities_phase(root: str, n_speakers: int, tag: str) -> dict:
    """Phase 16: (a) the trainer on the device-resident corpus, (b) the
    exported embedder, (c) the profiling helpers, (d) the figures. Raises on
    any failed check. Returns the launches of the log-mel, pool-forward,
    pool-backward and depthwise-backward kernels in (a)'s ``cli.train``."""
    import contextlib
    import glob
    import importlib.util
    import io

    import numpy as np
    import torch

    from titanet_torch import cli
    from titanet_torch.data import device_corpus as tdc
    from titanet_torch.data import loader as tld
    from titanet_torch.ops.kernels import dwconv
    from titanet_torch.ops.kernels.melspec import log_mel_fused
    from titanet_torch.ops.kernels.pool import attentive_pool_bwd, attentive_pool_fwd
    from titanet_torch.train import state as ts
    from titanet_torch.train.loop import _staged_batches
    from titanet_torch.train.state import embed_step
    from titanet_torch.utils import export as tx
    from titanet_torch.utils import profiling as tp

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    counters = {"logmel": log_mel_fused, "pool_fwd": attentive_pool_fwd,
                "pool_bwd": attentive_pool_bwd, "dw_bwd": dwconv.dw_bwd}

    def dc_config(run: str, figures: bool = False):
        cfg = trainer_config(root, run, 1, DC_ENABLE)
        cfg.generic.device_corpus = True
        cfg.figures.enabled = figures
        cfg.figures.path = os.path.join(root, "figures")
        return cfg

    # (a) the corpus, built as cli.train builds it (same cache key, so the
    # trainer reuses it); the upload of its flat tensor timed again alone
    cfg = dc_config("dc")
    train_ds, val_ds, test_ds, n_train = cli._datasets(cfg, True)
    base, _ = tdc.resolve_base(train_ds)
    tdc._CORPUS_CACHE.clear()
    t0 = time.perf_counter()
    corpus = tdc.DeviceCorpus.build(base, SR, device=dev, cache_key=tdc.corpus_cache_key(base))
    build_s = time.perf_counter() - t0
    flat = corpus.flat
    if not (flat.is_cuda and flat.dtype == torch.int16 and flat.dim() == 1 and flat.is_contiguous()):
        raise AssertionError(f"device corpus: {flat.dtype} {tuple(flat.shape)} on {flat.device}")
    host_flat = flat.cpu().numpy()
    uploads = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = tdc._upload(host_flat, dev, 32 << 20)
        uploads.append(time.perf_counter() - t0)
        if not torch.equal(again, flat):
            raise AssertionError("device corpus: a second upload differs from the first")
        del again
    upload_s = statistics.median(uploads)
    mb = flat.numel() * 2 / 1e6
    print(f"device corpus: one int16 CUDA tensor of {flat.numel()} samples ({mb:.1f} MB, {len(base)} utterances "
          f"+ {400_000} tail zeros); built in {build_s:.2f} s (decode, quantize, upload); upload alone (32 MB "
          f"slabs through pinned memory) median {upload_s * 1e3:.2f} ms of 3 ({min(uploads) * 1e3:.2f}-"
          f"{max(uploads) * 1e3:.2f}), {mb / 1e3 / upload_s:.2f} GB/s {tag}")

    steps = len(train_ds) // TRAIN_BATCH
    val_batches = -(-len(val_ds) // TRAIN_BATCH)
    test_batches = -(-len(test_ds) // TRAIN_BATCH)
    trainer_kernels_vs_plain(dc_config("dc-kernels"), (train_ds, val_ds, test_ds, n_train), tag,
                             label="device-corpus trainer")

    # cli.train, counted: the loaders it attaches, the gathers, what is staged
    os.environ["TITANET_DW_BWD"] = "pallas"
    seen = {"loaders": [], "gathers": 0, "staged": []}
    attach, gather, stage = cli._attach_device_corpus, tdc.gather_windows, tld._stage

    def attach_kept(cfg_, loaders, device):
        seen["loaders"] = list(loaders)
        return attach(cfg_, loaders, device)

    def gather_counted(*a, **k):
        seen["gathers"] += 1
        return gather(*a, **k)

    def stage_kept(batch, device, stream):
        seen["staged"].append(type(batch).__name__)
        return stage(batch, device, stream)

    cli._attach_device_corpus, tdc.gather_windows, tld._stage = attach_kept, gather_counted, stage_kept
    try:
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.train(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: c.launches for k, c in counters.items()}
    finally:
        cli._attach_device_corpus, tdc.gather_windows, tld._stage = attach, gather, stage
    batches = steps + val_batches + test_batches
    expect = {"logmel": val_batches + test_batches, "pool_fwd": steps + val_batches, "pool_bwd": steps,
              "dw_bwd": 51 * steps}
    if counts != expect:
        raise AssertionError(f"device-corpus trainer: launches {counts}, expected {expect}")
    if len(seen["loaders"]) != 3 or any(l._device_corpus is not corpus for l in seen["loaders"]):
        raise AssertionError("device-corpus trainer: the train, validation and test loaders do not share the "
                             "corpus built above")
    if seen["staged"] != ["DeviceBatch"] * batches or seen["gathers"] != batches:
        raise AssertionError(f"device-corpus trainer: staged {sorted(set(seen['staged']))} x "
                             f"{len(seen['staged'])}, {seen['gathers']} gathers, expected {batches} DeviceBatch")
    rec = epoch_record(read_jsonl(os.path.join(root, "dc", "metrics.jsonl")), 1, "train/")
    if not np.isfinite(rec["train/avg_loss"]):
        raise AssertionError(f"device-corpus trainer: loss {rec['train/avg_loss']}")

    # every batch of the run's own loaders, replayed (epoch 1), against the
    # host loaders: the train loader's int16 batches (transport_dtype
    # int16) equal bits; the validation and test loaders ship f32, which
    # quantized as the corpus is (clip(x * 32768)) gives equal bits
    host_cfg = trainer_config(root, "host16", 1, DC_ENABLE)
    host_cfg.training.transport_dtype = "int16"
    host_loaders = cli._loaders(host_cfg, train_ds, val_ds, test_ds, None)

    def as_int16(w):
        return w if w.dtype == np.int16 else np.clip(w * 32768.0, -32768, 32767).astype(np.int16)

    compared, widths = 0, set()
    for kind, dl, hl in zip(("train", "val", "test"), seen["loaders"], host_loaders):
        dl.set_epoch(1)
        hl.set_epoch(1)
        pairs = list(zip(dl, hl))
        if not len(pairs) == len(dl) == len(hl) > 0:
            raise AssertionError(f"device-corpus replay {kind}: {len(pairs)} batches vs {len(dl)} / {len(hl)}")
        for db, hb in pairs:
            wav, lens, spk = db.gather()
            if (tuple(wav.shape) != hb.waveform.shape or not np.array_equal(wav.cpu().numpy(), as_int16(hb.waveform))
                    or not np.array_equal(lens.cpu().numpy(), hb.lengths)
                    or not np.array_equal(spk.cpu().numpy(), hb.speaker_ids)):
                raise AssertionError(f"device-corpus replay {kind}: a gathered batch differs from the host's")
            compared += 1
            widths.add(db.t)
    # one train batch: the gather, and the host route's H2D copy of it as f32
    dl = seen["loaders"][0]
    dl.set_epoch(1)
    db = next(iter(dl._iter_batches()))
    gms = cuda_ms(lambda: tdc.gather_windows(corpus, db.starts, db.lengths, db.t))
    w32 = (db.gather()[0].cpu().numpy().astype(np.float32) / 32768.0)
    pinned = torch.from_numpy(w32).pin_memory()
    hms = cuda_ms(lambda: pinned.to(dev, non_blocking=True))
    # a profiler window of two device-fed train steps: no H2D copy as large
    # as a window
    _, _, state = cli._new_state(cfg, n_train, dev, steps)
    frontend, augment = cli._frontend(cfg), cli._augment_config(cfg, None)
    dl.set_epoch(2)
    trace_path = os.path.join(root, "dc_steps_trace.json")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i, ((wav, lens, spk), batch) in enumerate(_staged_batches(dl, dev)):
            uniform = int(batch.lengths.min()) == wav.shape[1]
            ts.train_step(state, wav, None if uniform else lens, spk, frontend=frontend, augment=augment)
            if i == 1:
                break
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    h2d = [e for e in events if "HtoD" in e.get("name", "") and e.get("ph") == "X"]
    sizes = [e.get("args", {}).get("bytes") for e in h2d]
    window_bytes = TRAIN_BATCH * db.t * 2
    if not h2d or any(b is None for b in sizes) or max(sizes) >= window_bytes:
        raise AssertionError(f"device-corpus steps: H2D copies {len(h2d)}, bytes {sorted(set(map(str, sizes)))[:8]} "
                             f"(an int16 window is {window_bytes} B)")
    os.environ.pop("TITANET_DW_BWD", None)
    utt = steps * TRAIN_BATCH
    a = HOST_FED_RUN_A
    print(f"device-corpus trainer (cli.train, TitaNet-S 17 blocks, bf16, B={TRAIN_BATCH}, {steps} steps, "
          f"[chunk, specaugment], TITANET_DW_BWD=pallas, 1 epoch): launches {counts}; {batches} batches staged, "
          f"all DeviceBatch, {seen['gathers']} gathers, no waveform through the host; {compared} batches of the "
          f"run's train/validation/test loaders replayed bit-equal to the host loaders' int16 batches (train: "
          f"transport_dtype int16; validation, test: their f32 batches quantized as the corpus is) "
          f"(bucket widths {sorted(widths)}); profiler window of 2 device-fed steps: {len(h2d)} H2D copies, "
          f"largest {max(sizes)} B (an int16 [{TRAIN_BATCH}, {db.t}] window is {window_bytes} B); "
          f"train/avg_loss {rec['train/avg_loss']:.4f} {tag}")
    print(f"device-corpus trainer: gather {gms:.4f} ms a [{TRAIN_BATCH}, {db.t}] batch (CUDA events) vs the "
          f"host route's H2D copy of the same batch as f32 ({w32.nbytes / 1e6:.2f} MB from pinned memory) "
          f"{hms:.4f} ms; whole loop {wall:.2f} s for {utt} training utterances ({utt / wall:.1f} utt/s, "
          f"validation, checkpoint and verification included; "
          f"{utt / (rec['train/total_data_time'] + rec['train/total_model_time']):.1f} utt/s over the training "
          f"steps alone); StepTimer data {rec['train/total_data_time'] / steps * 1e3:.2f} ms / model "
          f"{rec['train/total_model_time'] / steps * 1e3:.2f} ms a step | beside phase 13's host-fed run A "
          f"(pallas, [chunk, specaugment, noise], 2 epochs): {a['utt'] / a['wall']:.1f} utt/s whole loop, "
          f"{a['utt'] / (a['data_s'] + a['model_s']):.1f} utt/s over the steps, data "
          f"{a['data_s'] / a['steps'] * 1e3:.2f} ms / model {a['model_s'] / a['steps'] * 1e3:.2f} ms a step {tag}")

    # (b) export: run A restored into an f32 model, B=8 x 3 s
    run = os.path.join(root, "a-pallas")
    cfg32 = trainer_config(root, "a-pallas", SERVE_EPOCHS, ("chunk", "specaugment", "noise"))
    cfg32.training.dtype = "float32"
    state, frontend, epoch = cli._restore_for_eval(cfg32, n_speakers, run, None, "cuda")
    model = state.model.eval()
    waves = [np.asarray(test_ds[i]["waveform"], np.float32).reshape(-1) for i in range(EXPORT_B)]
    wav8 = np.zeros((EXPORT_B, EXPORT_SAMPLES), np.float32)
    len8 = np.zeros(EXPORT_B, np.int32)
    for i, w in enumerate(waves):
        w = np.resize(w, EXPORT_SAMPLES) if i % 2 == 0 else w[:EXPORT_SAMPLES]  # whole rows and short rows
        wav8[i, :len(w)], len8[i] = w, len(w)
    wav8, len8 = torch.from_numpy(wav8).to(dev), torch.from_numpy(len8).to(dev)
    for fused in (False, True):
        fe = frontend._replace(use_pallas_fused=fused)
        t0 = time.perf_counter()
        blob = tx.export_titanet_embedder(model, None, fe, batch_size=EXPORT_B, num_samples=EXPORT_SAMPLES)
        export_s = time.perf_counter() - t0
        served = tx.load_embedder(blob)
        with torch.no_grad():
            out = served(wav8, len8)
            before = log_mel_fused.launches
            served(wav8, len8)
            torch.cuda.synchronize()
            op_launches = log_mel_fused.launches - before
            names = traced_kernels(lambda: served(wav8, len8))
        ref = embed_step(model, wav8, len8, frontend=fe, device=dev)
        cos = torch.nn.functional.cosine_similarity(out.float(), ref.float(), dim=-1)
        mel_kernels = [n for n in names if "logmel" in n]
        want = 1 if fused else 0
        if out.shape != (EXPORT_B, 192) or not torch.isfinite(out).all() or cos.min().item() <= 0.99999:
            raise AssertionError(f"export (fused={fused}): shape {tuple(out.shape)}, cosines vs embed_step {cos}")
        if op_launches != want or len(mel_kernels) != want or (fused and "logmel_kernel" not in mel_kernels[0]):
            raise AssertionError(f"export (fused={fused}): {op_launches} log-mel wrapper launches, traced "
                                 f"kernels {mel_kernels}, expected {want}")
        med, lo, hi = median_ms(lambda: served(wav8, len8))
        print(f"export (run A epoch {epoch} as f32 TitaNet-S, B={EXPORT_B} x {EXPORT_SAMPLES}, "
              f"use_pallas_fused={fused}): torch.export in {export_s:.2f} s, artifact {len(blob) / 1e6:.2f} MB, "
              f"loaded from bytes; per-row cosine vs embed_step min {cos.min().item():.9f} (limit 0.99999); "
              f"log-mel kernel launches in a profiler window of one call {len(mel_kernels)} {mel_kernels} "
              f"(wrapper count {op_launches}); {len(names)} kernels a call; median {med:.3f} ms a call "
              f"({lo:.3f}-{hi:.3f}) {tag}")
        del served, out, ref

    # (c) profiling
    logdir = os.path.join(root, "trace")
    with tp.trace(logdir):
        with tp.annotate("embed_step x3"):
            for _ in range(3):
                embed_step(model, wav8, len8, frontend=frontend, device=dev)
        torch.cuda.synchronize()
    traces = glob.glob(os.path.join(logdir, "*.json"))
    text = open(traces[0]).read() if len(traces) == 1 else ""
    if "logmel_kernel" not in text:
        raise AssertionError(f"profiling: trace files {traces} do not name logmel_kernel")
    sp, box = tp.StepProfiler(), {}
    for _ in range(10):
        with sp.step("embed_step_b8", lambda: box["e"]):
            box["e"] = embed_step(model, wav8, len8, frontend=frontend, device=dev)
    mem = tp.device_memory_stats()
    total = torch.cuda.get_device_properties(dev).total_memory
    if not (0 < mem["bytes_in_use"] <= mem["peak_bytes_in_use"] <= mem["bytes_limit"] == total):
        raise AssertionError(f"profiling: device_memory_stats {mem}, card memory {total}")
    print(f"profiling: trace() of 3 embed_step calls wrote {os.path.basename(traces[0])} "
          f"({len(text) / 1e6:.2f} MB, names logmel_kernel); StepProfiler over 10 steps {sp.summary()}; "
          f"device_memory_stats {mem} {tag}")

    # (d) figures: one epoch with figures.enabled, infer --fig, trials --det-out
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    params = os.path.join(root, "serving", "params.json")
    utt_dir = os.path.join(root, "serving", "utts")
    trial_file = os.path.join(root, "figures_trials.txt")
    with open(trial_file, "w") as f:
        for s_ in range(4):
            f.write(f"1 spk{s_}_0.wav spk{s_}_1.wav\n0 spk{s_}_0.wav spk{s_ + 1}_0.wav\n")
    fig, det = os.path.join(root, "figures", "infer.png"), os.path.join(root, "figures", "det.png")
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        cli.train(dc_config("dc-figures", figures=True))
        with embedding_calls() as calls_infer:
            cli.main(["infer", "-p", params, "-c", run, "--audio",
                      *sorted(glob.glob(os.path.join(utt_dir, "*.wav")))[:16], "--fig", fig])
        with embedding_calls() as calls_trials:
            cli.main(["trials", "-p", params, "-c", run, "--trial-file", trial_file, "--audio-root", utt_dir,
                      "--det-out", det])
    sys.stdout.write(captured.getvalue())
    check_command_kernels(calls_infer, "infer --fig", tag, fillers=False)
    check_command_kernels(calls_trials, "trials --det-out", tag, fillers=False)
    pngs = [os.path.join(root, "figures", "dc-figures", f"epoch_1_{k}.png") for k in ("train", "val")] + [fig, det]
    disabled = captured.getvalue().count("[viz disabled: matplotlib unavailable]")
    if have_mpl:
        bad = [p for p in pngs if not (os.path.isfile(p) and open(p, "rb").read(4) == b"\x89PNG")]
        if bad:
            raise AssertionError(f"figures: matplotlib imports but {bad} are not PNG files")
        case = f"matplotlib present: {len(pngs)} PNGs written"
    else:
        if any(os.path.exists(p) for p in pngs) or disabled < len(pngs):
            raise AssertionError(f"figures without matplotlib: {disabled} messages, files "
                                 f"{[p for p in pngs if os.path.exists(p)]}")
        case = (f"matplotlib absent: the JAX package's message printed {disabled} times, no file written, "
                "the epoch and both commands completed")
    print(f"figures (an epoch with figures.enabled, infer --fig, trials --det-out): {case} {tag}")
    print(f"utilities phase: {time.perf_counter() - t_phase:.1f} s wall {tag}")
    return counts


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from titanet_torch.models import get_titanet
    from titanet_torch.ops import frontend as tf
    from titanet_torch.models import fused_inference, l2_normalize
    from titanet_torch.models.quantized import quantize_titanet
    from titanet_torch.models.titanet import MegaBlock
    from titanet_torch.ops.kernels import _build, dwconv
    from titanet_torch.ops.kernels import pool as pool_kernels
    from titanet_torch.ops.kernels.megablock import fused_sub_blocks, fused_sub_blocks_plain, kernel_design
    from titanet_torch.ops.kernels.melspec import (
        log_mel_frames,
        log_mel_frames_plain,
        log_mel_fused,
        log_mel_fused_plain,
        log_mel_spectrogram_pallas,
    )
    from titanet_torch.ops.kernels.pool import (
        attentive_pool_bwd,
        attentive_pool_bwd_plain,
        attentive_pool_fwd,
        attentive_pool_fwd_plain,
    )
    from titanet_torch.train.extractor import SpeakerEmbedder
    from titanet_torch.train.state import embed_step, embed_step_quantized

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = card()
    tag = f"| card: {name}"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} {tag}")

    # 1. build
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall for {sorted(built)} {tag}")
    for src, (secs, log) in built.items():
        info = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln or "C75" in ln]
        print(f"  nvcc {src}: {secs:.2f} s; " + " / ".join(info))

    rng = np.random.default_rng(0)
    cfg32 = tf.FrontendConfig.from_ms(use_pallas_fused=True)
    cfg16 = tf.FrontendConfig.from_ms(precision="default", use_pallas_fused=True)
    n_samples = SECONDS * SR
    wav = torch.from_numpy((rng.standard_normal((B, n_samples)) * 0.1).astype(np.float32)).to(dev)
    lengths = torch.full((B,), n_samples, dtype=torch.int32, device=dev)
    report = {}

    # 2. fused log-mel kernel vs plain. bf16 runs the tensor-core kernel:
    # 2e-3, over 4x the 4.6e-4 this input gives (NVIDIA H100 80GB HBM3,
    # 700 W), a square summed in another order landing on the other side of
    # a bf16 rounding
    buf32, n_frames, _ = tf._framing_buffer(wav, 512, 160, lengths)
    for cfg, dt, atol, kernel in ((cfg32, torch.float32, 1e-4, "logmel_kernel"),
                                  (cfg16, torch.bfloat16, 2e-3, "logmel_tc_kernel")):
        buf = buf32.to(dt).contiguous()
        _, _, _, basis, fb = tf._constants(cfg, dev, dt)
        run = lambda: log_mel_fused(buf, lengths, basis, fb, n_frames=n_frames, hop=160, win_length=400)  # noqa: E731
        plain = lambda: log_mel_fused_plain(buf, lengths, basis, fb, n_frames=n_frames, hop=160)  # noqa: E731
        tc_before = log_mel_fused.tc_launches
        out, ref = run(), plain()
        torch.cuda.synchronize()
        if log_mel_fused.tc_launches - tc_before != (dt == torch.bfloat16):
            raise AssertionError(f"log-mel {dt}: expected {kernel}")
        err = (out - ref).abs().max().item()
        if not torch.isfinite(out).all() or err > atol:
            raise AssertionError(f"log-mel {dt}: max abs err {err} > {atol}")
        n_bins, n_mels = 257, 80
        ops = 2 * B * n_frames * (400 * 2 * n_bins + n_bins * n_mels)
        # the buffer, the basis rows of the 400 window taps, fb, the output
        nbytes = buf.numel() * buf.element_size() + out.numel() * 4 \
            + (2 * 400 * n_bins + fb.numel()) * basis.element_size()
        bms, by = bound_ms(nbytes, ops, str(dt).split(".")[1])
        ms, timed_by = device_ms(run, names=(kernel,), iters=20)
        pms = cuda_ms(plain, iters=5)
        report[("logmel", dt)] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                                      timed_by=timed_by)
        was = f"; FP32-core design: {PREV_MS['logmel', 'bf16']} ms by events" if dt == torch.bfloat16 else ""
        print(f"logmel {dt} ({kernel}): max_abs_err {err:.3e} (atol {atol}); kernel {ms:.4f} ms (device time, "
              f"{timed_by}{was}), plain {pms:.4f} ms, bound {bms:.4f} ms ({by}; {ops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB) {tag}")

    # 3. attentive-pool kernel vs plain
    t_frames, ch, hid = n_frames, 1536, 128
    h32 = torch.from_numpy(rng.standard_normal((B, t_frames, ch)).astype(np.float32)).to(dev)
    a = torch.from_numpy(rng.uniform(0.5, 1.5, ch).astype(np.float32)).to(dev)
    c = torch.from_numpy((rng.standard_normal(ch) * 0.2).astype(np.float32)).to(dev)
    def uniform(shape, fan_in):
        x = rng.uniform(-1, 1, shape) / np.sqrt(fan_in)
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    wa32, ba = uniform((ch, hid), ch), uniform(hid, ch)
    wb32, bb = uniform((hid, ch), hid), uniform(ch, hid)
    for dt, rtol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        h, wa, wb = h32.to(dt), wa32.to(dt).contiguous(), wb32.to(dt).contiguous()
        for fold in (True, False):
            args = (h, a, c, wa, ba, wb, bb, 1e-6, fold)
            out, ref = attentive_pool_fwd(*args), attentive_pool_fwd_plain(*args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=rtol)
            ms, timed_by = device_ms(lambda: attentive_pool_fwd(*args), names=POOL_KERNELS, iters=20)
            pms = cuda_ms(lambda: attentive_pool_fwd_plain(*args), iters=5)
            ops = 4 * B * t_frames * ch * hid
            nbytes = (h.numel() + wa.numel() + wb.numel()) * h.element_size() + 4 * (3 * ch + hid) \
                + out.numel() * out.element_size()
            bms, by = bound_ms(nbytes, ops, str(dt).split(".")[1])
            report[("pool", dt, fold)] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                                              timed_by=timed_by)
            was = PREV_MS.get(("pool", fold)) if dt == torch.bfloat16 else None
            print(f"attn_pool {dt} fold={fold}: max_abs_err {err:.3e} (rtol {rtol}); kernel {ms:.4f} ms "
                  f"(device time, {timed_by}){f' (fp32-core design: {was} ms by events)' if was else ''}, "
                  f"plain {pms:.4f} ms, bound {bms:.4f} ms ({by}; {ops / 1e9:.2f} GFLOP, "
                  f"{nbytes / 1e6:.1f} MB) {tag}")
    del h32, h, buf32

    # 4. embed_step, TitaNet-S, 17 mega-blocks, B=128 x 3 s
    m16 = get_titanet(n_mega_blocks=17, dtype=torch.bfloat16, device=dev,
                      generator=torch.Generator().manual_seed(0))
    m32 = get_titanet(n_mega_blocks=17, device=dev, generator=torch.Generator().manual_seed(0))
    log_mel_fused.launches = log_mel_fused.tc_launches = attentive_pool_fwd.launches = 0
    e16 = embed_step(m16, wav, lengths, frontend=cfg16, device=dev)
    torch.cuda.synchronize()
    launches = {"logmel": log_mel_fused.launches, "pool": attentive_pool_fwd.launches}
    if launches["logmel"] < 1 or launches["pool"] < 1:
        raise AssertionError(f"serving run did not go through both kernels: {launches}")
    if log_mel_fused.tc_launches != launches["logmel"]:
        raise AssertionError("bf16 serving run: the log-mel did not take the tensor-core kernel")
    log_mel_fused.launches = attentive_pool_fwd.launches = 0
    e32 = embed_step(m32, wav, lengths, frontend=cfg32, device=dev)
    torch.cuda.synchronize()
    if log_mel_fused.launches < 1 or attentive_pool_fwd.launches != 0:
        raise AssertionError("f32 run: expected the mel kernel and the plain pooling path")
    e16f = e16.float()
    for e, tol in ((e16f, 1e-2), (e32, 1e-5)):
        if e.shape != (B, 192) or not torch.isfinite(e).all():
            raise AssertionError("embeddings are not finite [B, 192]")
        norm_err = (torch.linalg.vector_norm(e, dim=-1) - 1).abs().max().item()
        if norm_err > tol:
            raise AssertionError(f"embeddings are not unit norm: {norm_err}")
    cos = torch.nn.functional.cosine_similarity(e16f, e32, dim=-1).min().item()
    if cos <= 0.999:
        raise AssertionError(f"bf16 vs f32 embedding cosine {cos} <= 0.999")
    plain32 = embed_step(m32, wav, lengths, frontend=cfg32._replace(use_pallas_fused=False), device=dev)
    cos_plain = torch.nn.functional.cosine_similarity(e32, plain32, dim=-1).min().item()
    if cos_plain <= 0.99999:
        raise AssertionError(f"f32 kernel route vs all-plain route cosine {cos_plain}")
    print(f"embed_step: launches per serving call {launches} (log-mel on logmel_tc_kernel); min cosine bf16 vs f32 {cos:.7f}; "
          f"f32 kernel route vs plain route {cos_plain:.9f} {tag}")
    for label, model, cfg in (("bf16 serving", m16, cfg16), ("f32 parity", m32, cfg32)):
        times = []
        for i in range(13):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            embed_step(model, wav, lengths, frontend=cfg, device=dev)
            torch.cuda.synchronize()
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(times)
        print(f"embed_step {label}: median {med:.3f} ms per batch of {B} x {SECONDS} s "
              f"(min {min(times):.3f}, max {max(times):.3f}, 10 runs) {tag}")
    del m32, e32, plain32

    # 5. SpeakerEmbedder on variable-length requests
    embedder = SpeakerEmbedder(m16, cfg16, device=dev)
    reqs = [(rng.standard_normal(int(s * SR)) * 0.1).astype(np.float32) for s in (1.2, 3, 7, 40)]
    log_mel_fused.launches = log_mel_fused.tc_launches = 0
    t0 = time.perf_counter()
    batched = embedder.embed(reqs)
    t_batch = time.perf_counter() - t0
    solo = np.concatenate([embedder.embed([r]) for r in reqs])
    embedder_launches = (log_mel_fused.launches, log_mel_fused.tc_launches)
    if embedder_launches[0] < 1 or embedder_launches[1] != embedder_launches[0]:
        raise AssertionError(f"SpeakerEmbedder: log-mel launches (all, tensor-core) {embedder_launches}")
    cosines = np.sum(batched * solo, -1) / (np.linalg.norm(batched, axis=-1) * np.linalg.norm(solo, axis=-1))
    if batched.shape != (4, 192) or not np.isfinite(batched).all() or cosines.min() <= 0.9999:
        raise AssertionError(f"SpeakerEmbedder padded vs solo cosines {cosines}")
    print(f"SpeakerEmbedder: 4 requests (1.2/3/7/40 s) in {t_batch * 1e3:.1f} ms; padded vs solo "
          f"cosines {np.array2string(cosines, precision=7)}; log-mel launches {embedder_launches[0]}, all on "
          f"logmel_tc_kernel {tag}")

    del embedder, m16

    # 6. attentive-pool backward kernel vs plain, every gradient
    g32 = torch.from_numpy(rng.standard_normal((B, 2 * ch)).astype(np.float32)).to(dev)
    h32 = torch.from_numpy(rng.standard_normal((B, t_frames, ch)).astype(np.float32)).to(dev)
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        h, wa, wb, g = h32.to(dt), wa32.to(dt).contiguous(), wb32.to(dt).contiguous(), g32.to(dt)
        for fold in (True, False):
            args = (h, a, c, wa, ba, wb, bb, g, 1e-6, fold)
            got, ref = attentive_pool_bwd(*args), attentive_pool_bwd_plain(*args)
            torch.cuda.synchronize()
            errs = pool_bwd_errors(got, ref, fold, tol, f"pool backward {dt} fold={fold}")
            ms, timed_by = device_ms(lambda: attentive_pool_bwd(*args), names=POOL_KERNELS, iters=10)
            pms = cuda_ms(lambda: attentive_pool_bwd_plain(*args), iters=3)
            ops = 12 * B * t_frames * ch * hid
            nbytes = 2 * h.numel() * h.element_size() + g.numel() * g.element_size() \
                + (wa.numel() + wb.numel()) * h.element_size() + 4 * (3 * ch + hid) \
                + 4 * (2 * ch * hid + 3 * ch + hid)
            bms, by = bound_ms(nbytes, ops, str(dt).split(".")[1])
            dh_err = (got[0].float() - ref[0].float()).abs().max().item()
            report[("pool_bwd", dt, fold)] = dict(max_abs_err=dh_err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                                                  timed_by=timed_by)
            was = PREV_MS.get(("pool_bwd", fold)) if dt == torch.bfloat16 else None
            work = pool_kernels._lib().titanet_attn_pool_bwd_workspace_bytes(B, t_frames, ch, hid, h.element_size())
            if work != pool_kernels.bwd_workspace_bytes(B, t_frames, ch, hid, h.element_size()):
                raise AssertionError(f"pool backward {dt}: workspace {work} B differs from the Python mirror")
            print(f"attn_pool_bwd {dt} fold={fold}: error / max per gradient "
                  f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} } (tol {tol}); dh max abs err {dh_err:.3e}; "
                  f"kernel {ms:.4f} ms (device time, {timed_by}){f' (fp32-core design: {was} ms by events)' if was else ''}, "
                  f"plain {pms:.4f} ms, "
                  f"bound {bms:.4f} ms ({by}; {ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); workspace {work / 1e6:.1f} MB ({work} B; one f32 [B*T, C] array would be "
                  f"{B * t_frames * ch * 4 / 1e6:.1f} MB) {tag}")
    del h32, h, g32, g

    # 7. depthwise-conv backward kernel vs plain and vs the library backward
    dw_ch = 256
    for k in (3, 7, 11):
        x32 = torch.from_numpy(rng.standard_normal((B, t_frames, dw_ch)).astype(np.float32)).to(dev)
        dy32 = torch.from_numpy(rng.standard_normal((B, t_frames, dw_ch)).astype(np.float32)).to(dev)
        w = torch.from_numpy((rng.standard_normal((dw_ch, 1, k)) * 0.3).astype(np.float32)).to(dev)
        bias = torch.zeros(dw_ch, device=dev)
        for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-5)):
            x, dy = x32.to(dt), dy32.to(dt)
            got, ref = dwconv.dw_bwd(x, w, dy), dwconv.dw_bwd_plain(x, w, dy)
            xl, wl, bl = (x.clone().requires_grad_(), w.clone().requires_grad_(), bias.clone().requires_grad_())
            out = library_dw_conv(xl, wl, bl)
            lib = torch.autograd.grad(out, (xl, wl, bl), dy, retain_graph=True)
            torch.cuda.synchronize()
            errs = {}
            for gname, x_, r, l in zip(("dx", "dk", "db"), got, ref, lib):
                scale = r.float().abs().max().item()
                e_plain = (x_.float() - r.float()).abs().max().item()
                e_lib = (x_.float() - l.float()).abs().max().item()
                errs[gname] = (e_plain / scale, e_lib / scale)
                # vs the library: its bf16 gradients are stored in bf16
                if e_plain > tol * scale or e_lib > max(tol, 3e-2) * scale:
                    raise AssertionError(f"dw backward K={k} {dt}: {gname} error {e_plain} / {e_lib} (scale {scale})")
            # device time of the kernel's two launches, and of every kernel
            # the library's backward (cuDNN and the bias/weight reductions) runs
            ms, timed_by = device_ms(lambda: dwconv.dw_bwd(x, w, dy), names=DW_KERNELS, iters=20)
            lms, _ = device_ms(lambda: torch.autograd.grad(out, (xl, wl, bl), dy, retain_graph=True), iters=20)
            pms = cuda_ms(lambda: dwconv.dw_bwd_plain(x, w, dy), iters=5)
            nbytes = 3 * x.numel() * x.element_size() + 4 * (2 * dw_ch * k + dw_ch)
            bms, by = bound_ms(nbytes, 4 * k * x.numel(), str(dt).split(".")[1])
            if dt == torch.bfloat16:
                report[("dw_bwd", k)] = dict(max_abs_err=(got[0].float() - ref[0].float()).abs().max().item(),
                                             ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by, library_ms=lms,
                                             timed_by=timed_by)
            print(f"dw_bwd K={k} {dt}: error / max (vs plain, vs library) "
                  f"{ {n: tuple(float(f'{v:.2e}') for v in e) for n, e in errs.items()} }; kernel {ms:.4f} ms "
                  f"(device time, {timed_by}; previous design at bf16: {PREV_MS['dw_bwd', k]} ms by events), "
                  f"plain {pms:.4f} ms, library {lms:.4f} ms (device time), bound {bms:.4f} ms ({by}; "
                  f"{nbytes / 1e6:.1f} MB) {tag}")
        del x32, dy32, x, dy, xl, out, lib
    # ragged and wide shapes (TitaNet M and L widths at the main-path batch,
    # T below the halo, T = 4096); identical bits from two calls; workspace
    for b_, t_, c_, k_ in ((128, 301, 512, 7), (128, 301, 1024, 11), (3, 1, 128, 3), (3, 2, 256, 11),
                           (2, 4096, 1024, 11), (5, 137, 128, 7)):
        x32 = torch.from_numpy(rng.standard_normal((b_, t_, c_)).astype(np.float32)).to(dev)
        dy32 = torch.from_numpy(rng.standard_normal((b_, t_, c_)).astype(np.float32)).to(dev)
        w = torch.from_numpy((rng.standard_normal((c_, 1, k_)) * 0.3).astype(np.float32)).to(dev)
        for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-5)):
            x, dy = x32.to(dt), dy32.to(dt)
            got, again = dwconv.dw_bwd(x, w, dy), dwconv.dw_bwd(x, w, dy)
            ref = dwconv.dw_bwd_plain(x, w, dy)
            torch.cuda.synchronize()
            errs = {}
            for gname, a_, a2, r in zip(("dx", "dk", "db"), got, again, ref):
                errs[gname] = (a_.float() - r.float()).abs().max().item() / r.float().abs().max().item()
                if not torch.equal(a_, a2) or not torch.isfinite(a_).all() or errs[gname] > tol:
                    raise AssertionError(f"dw backward B={b_} T={t_} C={c_} K={k_} {dt}: {gname} error "
                                         f"{errs[gname]} > {tol} or not identical on a second call")
            work = dwconv._lib().titanet_dw_bwd_workspace_bytes(b_, t_, c_, k_, x.element_size())
            if work != dwconv.workspace_bytes(b_, t_, c_, k_, x.element_size()):
                raise AssertionError(f"dw backward workspace {work} B differs from the Python mirror")
            line = (f"dw_bwd B={b_} T={t_} C={c_} K={k_} {dt}: error / max "
                    f"{ {n: float(f'{v:.2e}') for n, v in errs.items()} } (tol {tol}); second call identical; "
                    f"workspace {work} B")
            if t_ == 301:
                ms, timed_by = device_ms(lambda: dwconv.dw_bwd(x, w, dy), names=DW_KERNELS, iters=10)
                nbytes = 3 * x.numel() * x.element_size() + 4 * (2 * c_ * k_ + c_)
                bms, by = bound_ms(nbytes, 4 * k_ * x.numel(), str(dt).split(".")[1])
                line += f"; kernel {ms:.4f} ms (device time, {timed_by}), bound {bms:.4f} ms ({by})"
            print(f"{line} {tag}")
        del x32, dy32, x, dy, got, again, ref

    # 8. train_step, TitaNet-S, B=128 x 3 s, CE over 251 classes, Adam 1e-3
    from titanet_torch.losses.heads import build_head
    from titanet_torch.train import state as ts

    n_cls = 251
    cfg_train = tf.FrontendConfig.from_ms(use_pallas_fused=True)
    tt = np.arange(n_samples) / SR
    f0 = rng.uniform(100.0, 2000.0, (B, 1))
    amp = rng.uniform(0.05, 0.5, (B, 1))
    wav_t = torch.from_numpy((amp * np.sin(2 * np.pi * f0 * tt) + 0.05 * rng.standard_normal((B, n_samples)))
                             .astype(np.float32)).to(dev)
    spk = torch.from_numpy(rng.integers(0, n_cls, B)).to(dev)

    def new_state(dtype, dropout):
        model = get_titanet(n_mega_blocks=17, dtype=dtype, dropout=dropout, device=dev,
                            generator=torch.Generator().manual_seed(0))
        head = build_head("ce", 192, n_cls, device=dev, generator=torch.Generator().manual_seed(1))
        return ts.create_train_state(model, head, ts.make_optimizer(start_lr=1e-3), seed=0)

    counters = {"logmel": log_mel_fused, "pool_fwd": attentive_pool_fwd,
                "pool_bwd": attentive_pool_bwd, "dw_bwd": dwconv.dw_bwd}
    train_launches = {}
    for route in ("xla", "pallas"):
        os.environ["TITANET_DW_BWD"] = route
        st = new_state(torch.bfloat16, 0.5)
        for fn in counters.values():
            fn.launches = 0
        st, met = ts.train_step(st, wav_t, lengths, spk, frontend=cfg_train)
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in counters.items()}
        expect = {"logmel": 1, "pool_fwd": 1, "pool_bwd": 1, "dw_bwd": 51 if route == "pallas" else 0}
        if counts != expect:
            raise AssertionError(f"train_step {route}: launches {counts}, expected {expect}")
        train_launches[route] = counts
        _, grads, _, _ = ts.loss_and_grads(st, wav_t, lengths, spk, frontend=cfg_train)
        names = [n for n, _ in st.model.named_parameters()] + [n for n, _ in st.head.named_parameters()]
        bad = [n for n, gr in zip(names, grads) if gr is None or not torch.isfinite(gr).all()]
        if bad:
            raise AssertionError(f"train_step {route}: parameters without a finite gradient: {bad[:5]}")
        del grads
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, met = ts.train_step(st, wav_t, lengths, spk, frontend=cfg_train)
            losses.append(met["loss"].item())
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        if not all(np.isfinite(losses)) or not np.mean(losses[-5:]) < losses[0]:
            raise AssertionError(f"train_step {route}: loss did not fall over 20 steps: {losses}")
        med = statistics.median(times[3:])

        def step():
            nonlocal st
            st, _ = ts.train_step(st, wav_t, lengths, spk, frontend=cfg_train)

        dev_ms, timed_by = device_ms(step, iters=3, warmup=1)
        dw_ms, _ = device_ms(step, names=DW_KERNELS, iters=3, warmup=0) if route == "pallas" else (0.0, None)
        print(f"train_step {route}: launches per step {counts}; every parameter has a finite gradient; loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} over 20 steps; median {med:.3f} ms per step "
              f"(min {min(times[3:]):.3f}, max {max(times[3:]):.3f}, steps 4-20), {B / med * 1e3:.1f} utt/s, "
              f"peak memory {peak / 2**30:.2f} GiB; device time {dev_ms:.3f} ms a step ({timed_by}, 3 steps)"
              f"{f', of it dw_bwd {dw_ms:.3f} ms for 51 launches' if route == 'pallas' else ''} {tag}")
        del st, met

    def loss_grads(route, dtype):
        os.environ["TITANET_DW_BWD"] = route
        st = new_state(dtype, 0.0)
        loss, grads, emb, _ = ts.loss_and_grads(st, wav_t, lengths, spk, frontend=cfg_train)
        return loss.item(), torch.cat([gr.double().flatten() for gr in grads]), emb.double()

    lx, gx, ex = loss_grads("xla", torch.bfloat16)
    lp, gp, ep = loss_grads("pallas", torch.bfloat16)
    l32, g32, e32 = loss_grads("xla", None)
    cosine = torch.nn.functional.cosine_similarity
    cos_routes = cosine(gx, gp, dim=0).item()
    cos_dtype = cosine(gp, g32, dim=0).item()
    emb_dtype = cosine(ep, e32, dim=-1).min().item()
    print(f"train_step agreement at dropout 0: loss xla {lx:.6f}, pallas {lp:.6f}, f32 {l32:.6f}; gradient "
          f"cosine xla vs pallas {cos_routes:.6f}; bf16 (pallas) vs f32: gradient cosine {cos_dtype:.6f}, min "
          f"train-mode embedding cosine {emb_dtype:.6f} (not held: at random init the 17-block network "
          f"magnifies bf16 rounding, in the JAX package too) {tag}")
    # the routes differ only in the depthwise backward's rounding
    if abs(lx - lp) > 1e-3 * abs(lx) or cos_routes < 0.99:
        raise AssertionError("xla and pallas depthwise-backward routes disagree")
    if abs(lp - l32) > 5e-2 * abs(l32):
        raise AssertionError("bf16 and f32 train-step losses disagree")
    del gx, gp, g32
    os.environ.pop("TITANET_DW_BWD", None)

    cosine_rows = torch.nn.functional.cosine_similarity

    def check_embeddings(e, tol, what):
        if e.shape != (B, 192) or not torch.isfinite(e).all():
            raise AssertionError(f"{what}: embeddings are not finite [B, 192]")
        norm_err = (torch.linalg.vector_norm(e.float(), dim=-1) - 1).abs().max().item()
        if norm_err > tol:
            raise AssertionError(f"{what}: embeddings are not unit norm: {norm_err}")

    # 9. frames log-mel kernel vs plain, and vs the fused kernel. "default":
    # 2e-3, under 4x the 5.5e-4 (vs plain) and 5.7e-4 (vs the fused kernel,
    # which rounds the power twice) this input gives (NVIDIA H100 80GB HBM3,
    # 700 W); the card tests hold the serving class, 5e-2, at other inputs
    frames = tf.frame_signal(wav, 512, 160, lengths=lengths)
    frames = frames.reshape(B * n_frames, 512).contiguous()
    buf32, _, _ = tf._framing_buffer(wav, 512, 160, lengths)
    for cfg, dt, atol in ((cfg32, torch.float32, 1e-4), (cfg16, torch.bfloat16, 2e-3)):
        _, _, _, basis, fb = tf._constants(cfg, dev, dt)
        buf = buf32.to(dt).contiguous()
        run = lambda: log_mel_frames(frames, basis, fb, precision=cfg.precision, win_length=400)  # noqa: E731
        plain = lambda: log_mel_frames_plain(frames, basis, fb, precision=cfg.precision)  # noqa: E731
        fused = lambda: log_mel_fused(buf, lengths, basis, fb, n_frames=n_frames, hop=160, win_length=400)  # noqa: E731
        out, ref, other = run(), plain(), fused().reshape(B * n_frames, 80)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        err_fused = (out - other).abs().max().item()
        if not torch.isfinite(out).all() or err > atol or err_fused > atol:
            raise AssertionError(f"mel_frames {cfg.precision}: max abs err {err} vs plain, {err_fused} vs the "
                                 f"fused kernel > {atol}")
        ops = 2 * B * n_frames * (400 * 2 * 257 + 257 * 80)
        # the function reads the 400 window taps of each frame and their
        # basis rows, fb, and writes the output
        nbytes = B * n_frames * 400 * 4 + out.numel() * 4 + (2 * 400 * 257 + fb.numel()) * basis.element_size()
        bms, by = bound_ms(nbytes, ops, str(dt).split(".")[1])
        ms, timed_by = device_ms(run, names=("mel_frames",), iters=20)
        fms, _ = device_ms(fused, names=("logmel_kernel", "logmel_tc_kernel"), iters=20)
        pms = cuda_ms(plain, iters=5)
        report[("mel_frames", dt)] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                                          timed_by=timed_by)
        was = PREV_MS.get(("mel_frames", cfg.precision))
        print(f"mel_frames {cfg.precision}: N={B * n_frames}; max_abs_err {err:.3e} vs plain, {err_fused:.3e} vs the "
              f"fused kernel (atol {atol}); kernel {ms:.4f} ms (device time, {timed_by}"
              f"{f'; FP32-core design: {was} ms by events' if was else ''}), plain {pms:.4f} ms, fused kernel on "
              f"the same waveforms {fms:.4f} ms (device time), bound {bms:.4f} ms ({by}; {ops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB) {tag}")
    # Fault 3: "default" rounds re^2 + im^2 to bf16 once. One power-of-two
    # tap a frame makes re^2 and im^2 exact, so the kernel and its plain
    # version round the same power: 1e-6; rounding them apart lands further
    one_tap = torch.zeros(4096, 512, device=dev)
    taps = torch.from_numpy(rng.integers(56, 456, 4096)).to(dev)
    sizes = torch.from_numpy(rng.choice([-1.0, 1.0], 4096) * 2.0 ** rng.integers(-6, 2, 4096)).float().to(dev)
    one_tap[torch.arange(4096, device=dev), taps] = sizes
    _, _, _, basis, fb = tf._constants(cfg16, dev, torch.bfloat16)
    out = log_mel_frames(one_tap, basis, fb, precision="default", win_length=400)
    once = log_mel_frames_plain(one_tap, basis, fb, precision="default")
    b32, f16 = basis.float(), one_tap.bfloat16().float()
    re, im = f16 @ b32[0], f16 @ b32[1]
    db = 10.0 * torch.log10(torch.clamp(((re * re).bfloat16().float() + (im * im).bfloat16().float()) @ fb.float(),
                                        min=1e-10))
    apart = db / torch.clamp(torch.linalg.vector_norm(db, dim=-1, keepdim=True), min=1e-12)
    e_once, e_apart = (out - once).abs().max().item(), (out - apart).abs().max().item()
    if not torch.isfinite(out).all() or e_once > 1e-6 or e_apart <= 1e-5:
        raise AssertionError(f"mel_frames default on one-tap frames: {e_once} vs the power rounded once "
                             f"(limit 1e-6), {e_apart} vs rounded apart (must exceed 1e-5)")
    print(f"mel_frames default, Fault 3: on 4096 one-tap frames max abs err {e_once:.3e} vs the power rounded once "
          f"(limit 1e-6), {e_apart:.3e} vs re^2 and im^2 rounded apart (must exceed 1e-5) {tag}")
    del frames, buf32, buf, out, ref, other, one_tap, once, apart, re, im, db

    # 10. mega-block kernel vs plain; the unfused library route beside it
    n_sub = 3
    for c_, k_ in ((256, 3), (512, 7), (1024, 11)):
        pad = (k_ - 1) // 2
        edge = (n_sub - 1) * pad
        x32 = torch.from_numpy(rng.standard_normal((B, t_frames, c_)).astype(np.float32)).to(dev)
        f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
        dw_w = f32(rng.standard_normal((n_sub, k_, c_)) * 0.5)
        dw_b = f32(rng.standard_normal((n_sub, c_)) * 0.3)
        pw32 = f32(rng.standard_normal((n_sub, c_, c_)) / np.sqrt(c_))
        pw_b = f32(rng.standard_normal((n_sub, c_)) * 0.3)
        bn = f32(np.stack([rng.uniform(0.5, 1.5, (n_sub, c_)), rng.standard_normal((n_sub, c_)) * 0.3], axis=1))
        for dt in (torch.float32, torch.bfloat16):
            args = (x32.to(dt), dw_w, dw_b, pw32.to(dt), pw_b, bn)
            out, ref = fused_sub_blocks(*args, kernel_size=k_), fused_sub_blocks_plain(*args, kernel_size=k_)
            torch.cuda.synchronize()
            top = ref.float().abs().max().item()
            tol = 1e-4 * top if dt == torch.float32 else 2.0 ** (np.floor(np.log2(top)) - 7)
            per_row = (out.float() - ref.float()).abs().amax(dim=(0, 2))
            e_edge = max(per_row[:edge].max().item(), per_row[t_frames - edge:].max().item())
            e_in = per_row[edge:t_frames - edge].max().item()
            if not torch.isfinite(out).all() or max(e_edge, e_in) > tol:
                raise AssertionError(f"megablock C={c_} k={k_} {dt}: error edge {e_edge}, interior {e_in} > {tol}")
            unfused = MegaBlock(c_, k_, n_sub, dtype=None if dt == torch.float32 else dt).to(dev).eval()

            def library_route(x=args[0], mod=unfused):
                with torch.no_grad():
                    for i in range(n_sub):
                        x = getattr(mod, f"sub_block_{i}")(x)
                return x

            ops = 2 * B * t_frames * n_sub * (c_ * c_ + c_ * k_)
            nbytes = 2 * args[0].numel() * args[0].element_size() + pw32.numel() * args[0].element_size() \
                + 4 * (dw_w.numel() + dw_b.numel() + pw_b.numel() + bn.numel())
            bms, by = bound_ms(nbytes, ops, str(dt).split(".")[1])
            iters = 20 if c_ == 256 else 5
            ms, timed_by = device_ms(lambda: fused_sub_blocks(*args, kernel_size=k_), names=("megablock",),
                                     iters=iters)
            pms = cuda_ms(lambda: fused_sub_blocks_plain(*args, kernel_size=k_), iters=3)
            ums, _ = device_ms(library_route, iters=iters)
            report[("megablock", c_, dt)] = dict(max_abs_err=max(e_edge, e_in), ms=ms, plain_ms=pms,
                                                 bound_ms=bms, bound_by=by, timed_by=timed_by)
            was = f"; fp32-core design: {PREV_MS['megablock', c_]} ms by events" if dt == torch.bfloat16 else ""
            print(f"megablock C={c_} k={k_} {dt} ({kernel_design(dt, c_)}): max abs err first/last {edge} rows {e_edge:.3e}, interior "
                  f"{e_in:.3e} (tol {tol:.3e}, largest entry {top:.3f}); kernel {ms:.4f} ms (device time, {timed_by}{was}), "
                  f"plain {pms:.4f} ms, unfused library route {ums:.4f} ms (device time), bound {bms:.4f} ms ({by}; "
                  f"{ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) {tag}")
            del args, out, ref, unfused
        if c_ == 256:
            # ragged: 9 tiles of 124 rows, the last one of 8
            xr = torch.from_numpy(rng.standard_normal((3, 1000, c_)).astype(np.float32)).to(dev)
            args = (xr.to(torch.bfloat16), dw_w, dw_b, pw32.to(torch.bfloat16), pw_b, bn)
            out, ref = fused_sub_blocks(*args, kernel_size=k_), fused_sub_blocks_plain(*args, kernel_size=k_)
            torch.cuda.synchronize()
            top = ref.float().abs().max().item()
            tol = 2.0 ** (np.floor(np.log2(top)) - 7)
            per_row = (out.float() - ref.float()).abs().amax(dim=(0, 2))
            e_edge = max(per_row[:edge].max().item(), per_row[1000 - edge:].max().item())
            e_in = per_row[edge:1000 - edge].max().item()
            if not torch.isfinite(out).all() or max(e_edge, e_in) > tol:
                raise AssertionError(f"megablock ragged B=3 T=1000: error edge {e_edge}, interior {e_in} > {tol}")
            print(f"megablock C={c_} k={k_} torch.bfloat16 ({kernel_design(torch.bfloat16, c_)}) ragged B=3 T=1000: max abs "
                  f"err first/last {edge} rows {e_edge:.3e}, interior {e_in:.3e} (tol {tol:.3e}, largest entry "
                  f"{top:.3f}) {tag}")
            del xr, args, out, ref
        del x32, pw32

    # 11. fused serving path, TitaNet-S, 17 mega-blocks, B=128 x 3 s
    def fused_serve(model, cfg):
        mel, _ = log_mel_spectrogram_pallas(wav, cfg)
        return l2_normalize(fused_inference.titanet_apply_fused(model, mel))

    fused_launches = {}
    for label, dt, cfg, tol, min_cos in (("bf16", torch.bfloat16, cfg16, 1e-2, FUSED_VS_EMBED_STEP_BF16),
                                         ("f32", None, cfg32, 1e-5, FUSED_VS_EMBED_STEP_F32)):
        model = get_titanet(n_mega_blocks=17, dtype=dt, device=dev, generator=torch.Generator().manual_seed(0))
        log_mel_frames.launches = fused_sub_blocks.launches = 0
        emb = fused_serve(model, cfg)
        torch.cuda.synchronize()
        counts = {"mel_frames": log_mel_frames.launches, "megablock": fused_sub_blocks.launches}
        if counts != {"mel_frames": 1, "megablock": 17}:
            raise AssertionError(f"fused serving {label}: launches {counts}")
        fused_launches[label] = counts
        check_embeddings(emb, tol, f"fused serving {label}")
        ref = embed_step(model, wav, lengths, frontend=cfg, device=dev)
        cos = cosine_rows(emb.float(), ref.float(), dim=-1).min().item()
        # the all-plain fused route: both kernels' plain versions on the same tensors
        fused_inference.fused_sub_blocks = fused_sub_blocks_plain
        try:
            mel_plain = log_mel_frames_plain(
                tf.frame_signal(wav, 512, 160).reshape(B * n_frames, 512).contiguous(),
                *tf._constants(cfg, dev, torch.float32 if dt is None else torch.bfloat16)[3:],
                precision=cfg.precision,
            ).reshape(B, n_frames, 80)
            plain_emb = l2_normalize(fused_inference.titanet_apply_fused(model, mel_plain))
        finally:
            fused_inference.fused_sub_blocks = fused_sub_blocks
        cos_plain = cosine_rows(emb.float(), plain_emb.float(), dim=-1).min().item()
        cos_plain_ref = cosine_rows(plain_emb.float(), ref.float(), dim=-1).min().item()
        if cos < min_cos or cos_plain_ref < min_cos:
            raise AssertionError(f"fused serving {label}: cosine vs embed_step {cos} (kernel route), "
                                 f"{cos_plain_ref} (all-plain route) < {min_cos}")
        if cos_plain <= (0.99999 if dt is None else 0.999):
            raise AssertionError(f"fused serving {label}: kernel route vs all-plain route cosine {cos_plain}")
        med, lo, hi = median_ms(lambda: fused_serve(model, cfg))
        emed, elo, ehi = median_ms(lambda: embed_step(model, wav, lengths, frontend=cfg, device=dev))
        dev_ms, timed_by = device_ms(lambda: fused_serve(model, cfg), iters=5)
        print(f"fused serving {label}: launches per call {counts}; min cosine vs embed_step {cos:.7f} (all-plain "
              f"fused route vs embed_step {cos_plain_ref:.7f}; limit {min_cos}); kernel route vs all-plain route "
              f"{cos_plain:.9f}; median {med:.3f} ms per batch of {B} x {SECONDS} s (min {lo:.3f}, max {hi:.3f}, "
              f"10 runs); device time {dev_ms:.3f} ms a call ({timed_by}, 5 calls); embed_step beside it "
              f"{emed:.3f} ms (min {elo:.3f}, max {ehi:.3f}) {tag}")
        del emb, ref, mel_plain, plain_emb
    m32 = model  # the f32 model of the last pass

    # 12. int8 variant
    e32 = embed_step(m32, wav, lengths, frontend=cfg32, device=dev)
    qtree = quantize_titanet(m32)
    eq = embed_step_quantized(qtree, wav, lengths, frontend=cfg32, device=dev)
    torch.cuda.synchronize()
    check_embeddings(eq, 1e-5, "int8 serving")
    cos_q = cosine_rows(eq, e32, dim=-1).min().item()
    if cos_q <= 0.99:
        raise AssertionError(f"int8 vs f32 embedding cosine {cos_q} <= 0.99")
    quant = [blk.skip for blk in qtree.mega_blocks] + [q for blk in qtree.mega_blocks for q in blk.pw] + [qtree.epilog]
    int8_bytes = sum(q.w_q.numel() for q in quant)
    model_bytes = sum(p.numel() * p.element_size() for p in m32.parameters())
    tree_bytes = model_bytes - 4 * int8_bytes + int8_bytes + sum(q.scale.numel() * 4 for q in quant)
    med, lo, hi = median_ms(lambda: embed_step_quantized(qtree, wav, lengths, frontend=cfg32, device=dev))
    print(f"int8 serving: min cosine vs f32 embed_step {cos_q:.7f}; median {med:.3f} ms per batch of {B} x {SECONDS} s "
          f"(min {lo:.3f}, max {hi:.3f}, 10 runs); int8 weights {int8_bytes / 1e6:.2f} MB in place of "
          f"{4 * int8_bytes / 1e6:.2f} MB f32; all weights {tree_bytes / 1e6:.2f} MB vs the f32 model's "
          f"{model_bytes / 1e6:.2f} MB {tag}")
    embedder = SpeakerEmbedder(m32, cfg32, quantized=True, device=dev)
    batched = embedder.embed(reqs)
    solo = np.concatenate([embedder.embed([r]) for r in reqs])
    cosines = np.sum(batched * solo, -1) / (np.linalg.norm(batched, axis=-1) * np.linalg.norm(solo, axis=-1))
    if batched.shape != (4, 192) or not np.isfinite(batched).all() or cosines.min() <= 0.999:
        raise AssertionError(f"quantized SpeakerEmbedder padded vs solo cosines {cosines}")
    print(f"SpeakerEmbedder(quantized=True): 4 requests (1.2/3/7/40 s); padded vs solo cosines "
          f"{np.array2string(cosines, precision=7)} {tag}")
    del embedder, qtree, m32, model

    # 13. the trainer as users run it; 14. the serving entry points on its run A
    root, n_speakers = trainer_phase(tag)
    try:
        t0 = time.perf_counter()
        serving_phase(root, n_speakers, tag)
        print(f"serving phase: {time.perf_counter() - t0:.1f} s wall {tag}")

        # 15. the model zoo: every other family through the trainer, the steps and the entry points
        t0 = time.perf_counter()
        zoo_launches = zoo_phase(tag)
        print(f"zoo phase: {time.perf_counter() - t0:.1f} s wall {tag}")

        # 16. the device-resident corpus and the utilities, on phase 13's corpus and run A
        dc_launches = utilities_phase(root, n_speakers, tag)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    kernels = []
    for key, name_, src, line, path_launches, zoo_key in (
        (("logmel", torch.bfloat16), "logmel_fused", "titanet_torch/csrc/logmel.cu",
         "titanet_tpu/ops/pallas/melspec.py:271", launches["logmel"], "logmel"),
        (("pool", torch.bfloat16, True), "attentive_pool_fwd", "titanet_torch/csrc/attn_pool.cu",
         "titanet_tpu/ops/pallas/pool.py:234", launches["pool"], "pool_fwd"),
        (("pool_bwd", torch.bfloat16, True), "attentive_pool_bwd", "titanet_torch/csrc/attn_pool.cu",
         "titanet_tpu/ops/pallas/pool.py:270", train_launches["pallas"]["pool_bwd"], "pool_bwd"),
        (("dw_bwd", 3), "dw_bwd", "titanet_torch/csrc/dw_bwd.cu",
         "titanet_tpu/ops/pallas/dwconv.py:102", train_launches["pallas"]["dw_bwd"], "dw_bwd"),
        (("megablock", 256, torch.bfloat16), "fused_sub_blocks", "titanet_torch/csrc/megablock.cu",
         "titanet_tpu/ops/pallas/megablock.py:110", fused_launches["bf16"]["megablock"], None),
        (("mel_frames", torch.bfloat16), "log_mel_frames", "titanet_torch/csrc/mel_frames.cu",
         "titanet_tpu/ops/pallas/melspec.py:109", fused_launches["bf16"]["mel_frames"], None),
    ):
        r = report[key]
        zoo = {fam: n[zoo_key] for fam, n in zoo_launches.items()} if zoo_key else {}
        kernels.append({
            "name": name_, "route": "cuda", "source": src, "replaces": line,
            "launches": path_launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "timed_by": r.get("timed_by", "events"),
            "zoo_trainer_launches": zoo,
            "device_corpus_trainer_launches": dc_launches[zoo_key] if zoo_key else None,
        })
    print(json.dumps({"kernels": kernels}))
    print(name)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
