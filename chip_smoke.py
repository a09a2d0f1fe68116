#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``titanet_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. build the CUDA kernels from ``titanet_torch/csrc`` (one nvcc each, in
     parallel), timed;
  2. fused log-mel kernel vs its plain version at the serving shapes
     (B=128 x 3 s), f32 (``logmel_dmma_kernel``: the DFT on the f64 tensor
     cores, the mel product split TF32; atol 1e-4; two calls equal to the
     bit) and bf16 (the tensor-core ``logmel_tc_kernel``, atol 2e-3), timed
     by device time; which kernel ran by its launch counter and its name in
     a profiler trace; f32 beside its 3xTF32 bound (both products three
     times at the TF32 rate), the bound of its design (the DFT at the f64
     tensor-core rate, three passes over the filterbank tiles it multiplies
     at the TF32 rate), its FP32-core bound, the unfused library route
     (cuBLAS f32 products, TF32 off, then the power, mel product, log and
     norm) and the replaced FP32-core design's time;
  3. attentive-pool kernel vs its plain version at B=128, T=301, C=1536,
     H=128, with and without the fold, bf16 (rtol 2e-2) and f32 (rtol 1e-4):
     one launch a call, two calls equal to the bit; bf16 (the one-pass
     ``pool_onepass_kernel``) also against its decomposition in plain torch
     (``attentive_pool_fwd_split``, the same tolerance), beside the replaced
     two-pass design's time and the bytes the design moves through L2;
     3b. ECAPA-TDNN's context route at the embedder's largest bucket (B=64,
     T=3845, C=1536, H=128, ragged lengths from 1 to T): ``context_stats``
     (``ctx_stats_kernel``, ``ctx_finish_kernel``; atol 1e-4) and the pool
     forward with a bias a row and the rows' lengths (rtol 2e-2) against
     their plain versions, two calls equal to the bit, each timed beside
     its bound (h once over the valid frames) and its plain version;
  4. ``embed_step`` on TitaNet-S (17 mega-blocks, random weights from seed
     0) at B=128 x 3 s, serving bf16 and parity f32 (TF32 off): launch
     counts (bf16 through the tensor-core log-mel kernel), unit-norm finite
     embeddings, bf16-vs-f32 cosine, agreement with
     the all-plain route, median ms per batch (each step through its CUDA
     graph, the default on the card: phase 18);
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
     ``TITANET_DW_BWD=xla`` and ``=pallas``, through its CUDA graph (the
     default on the card since phase 19): launches per step, every
     gradient finite, the loss falling over 20 steps on one batch, median ms
     per step, utterances/s, peak memory and device time a step (the
     depthwise backward's share under ``pallas``); at dropout 0 from equal
     weights the two routes agree (loss 1e-3, gradient cosine > 0.99), and
     the bf16 step's loss agrees with the f32 step's (5e-2);
  9. frames log-mel kernel vs its plain version on the N = 128 x 301 frames
     of the phase-2 waveforms, "highest" (atol 1e-4; the f64 tensor-core
     DFT, ``mel_frames_dmma_kernel``, the fused f32 route's device
     function: equal to the fused kernel's output to the bit, two calls
     equal to the bit; its bounds, library route and replaced design as in
     phase 2) and "default" (atol 2e-3; bf16 tensor cores; vs the fused
     kernel's output within the same limit), timed by device time;
     "default" on frames of one tap each: the power rounded once (1e-6), not
     apart;
  10. mega-block kernel vs its plain version at B=128, T=301, S=3, (C, k) =
     (256, 3), (512, 7), (1024, 11), f32 (1e-4 of the largest entry) and
     bf16 (one bf16 ulp of it), biases of std 0.3 so the edge rows carry
     real values; edge-row and interior errors apart; two calls equal to
     the bit; which design ran (bf16 tensor-core with wgmma or mma.sync,
     f32 tensor-core 3xTF32; at C = 1024 both the cluster design, with the
     clusters the card holds at once); the bound of the work each design
     does (3xTF32: three products at the TF32 rate and the depthwise and
     epilogue passes at the FP32 rate) beside the FP32-core bound; the
     unfused library route (the port's ``MegaBlock`` sub-blocks in eval
     mode) timed beside, and the replaced design's time; ragged cases in
     bf16 and f32 (two calls equal to the bit): B=3, T=1000 at (256, 3)
     and (1024, 11) (the last tile partial), and at (1024, 11) T = one
     tile - 1, one tile and one tile + 1;
  11. the fused serving path on TitaNet-S (17 mega-blocks), then on
     TitaNet-L (``get_titanet(model_size="l")``, 5 mega-blocks, hidden 1024,
     k = 11): wav -> ``log_mel_spectrogram_pallas`` -> ``titanet_apply_fused``
     -> ``l2_normalize``, bf16 and f32: launches {mel_frames: 1, megablock:
     17 or 5}, finite unit-norm [128, 192], cosine vs ``embed_step`` of the
     same model (below 1 through the edge rows of each mega-block; L's
     limits ``FUSED_L_VS_EMBED_STEP_*``), kernel route vs all-plain fused
     route (f32 > 0.99999, bf16 > 0.999), median ms per batch and device time
     a call, ``embed_step``'s beside them;
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
     their inputs and output gradients kept by hooks on an eager step, at
     phases 3, 6 and 7's tolerances); then ``titanet_torch.cli.train``, its
     train steps through their CUDA graphs (one a batch shape), on a synthetic
     corpus (64 speakers x 16 utterances), TitaNet-S at full width, bf16,
     CE, B=64, chunk + SpecAugment + noise, under ``TITANET_DW_BWD=pallas``
     and ``=xla``: run A trains 2 epochs straight (validation every epoch,
     verification at the end; the graphs it captured), run B trains 1 epoch and resumes for the
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
     filler rows of length 1 up to each batch's row class; phase 2's
     tolerances); ``infer --split``'s one (``loop.infer`` pools unmasked)
     also runs the pool forward kernel, held as in phase 13, and no other
     command does. Printed: the
     median ms of an /embed of a 3 s WAV per variant, ``trials`` files/s
     and ``diarize``'s real-time factor.

  15. the model zoo (every family but TitaNet, at its published width:
     ECAPA-TDNN C=512 and C=1024, x-vector H=512/P=1500, ResNet34 base 32,
     MFA-Conformer 6 x 256 FF 2048, d-vector LSTM 3 x 768, the smoke
     convnet 10 x 256; bf16, seed 0), one line a family: ``cli.train`` for
     one epoch of phase 13's corpus with ``[chunk]`` only under
     ``TITANET_DW_BWD=pallas``, its train steps through their CUDA graphs
     (finite loss, the checkpoint; every launch of the graphs replayed on the
     graphs' operands against its plain version) and
     ``cli.evaluate_checkpoint`` (EER, minDCF in [0, 1]); 20 ``train_step``s
     on one batch of 64 x 3 s, the first eagerly (its hooks), then through
     the graph (every gradient finite, the last loss below the first; median
     ms a step, kernels and device ms a step, idle share, peak memory), then
     graph and eager in turns (median and device ms, idle share); ``embed_step`` at B=128 x 3 s (median and device ms,
     idle share); ``SpeakerEmbedder`` padded == solo (cosine > 0.999) on
     1.2, 3, 7 and 40 s requests; ``infer --audio`` on the trained
     checkpoint equal to a direct ``SpeakerEmbedder.embed`` (1e-6); the
     service ``--model-size <family> --checkpoint-dir <run>`` (default and
     ``--fast-frontend``) answering /embed with 200 (the d-vector and the
     convnet have no ``--model-size``). Every log-mel launch of the family
     is replayed on its own operands against its plain version (phase 2's
     tolerances); the Conformer's pool forward and backward of a train
     step (C = 1536, H = 128, T' = 151) and its pool-forward launches of
     ``infer --split`` likewise (phases 3 and 6); both ECAPA families'
     pooling outside autograd in bf16 (validation, verification,
     ``embed_step``, the ``SpeakerEmbedder``, ``infer --audio``) through
     the context route, one ``context_stats`` and one pool-forward launch
     a call, every launch replayed on its own operands (C = 1536, H = 128,
     the embedder's ragged rows up to T = 3845) against its plain version
     (phase 3b's tolerances), their train steps and the f32 service
     plainly; every other family launches no pool kernel, and no family
     the depthwise backward.
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
     artifact (none in the default one); run A as trained (bf16) exported
     with ``use_pallas_fused``: the graph holds the log-mel and pool-forward
     operators, each kernel launched once a call, cosine drift vs
     ``embed_step`` under 1e-5, ms a call; (c) ``profiling.trace`` around
     three ``embed_step`` calls (the trace names ``logmel_dmma_kernel``),
     ``StepProfiler`` over ten, ``device_memory_stats`` (0 < in use <= peak
     <= the card's memory); (d) an epoch with ``figures.enabled``, ``infer
     --fig`` and ``trials --det-out``: the PNGs where matplotlib imports,
     else the JAX package's message and no file, the runs complete. Corpus
     fetching is host-only code and is not run on the card (no network).
  17. data-parallel training (``titanet_torch.parallel``), TitaNet-S at full
     width, bf16, CE, dropout 0.5, phase 13's corpus with [chunk],
     ``TITANET_DW_BWD=pallas``: (a) two ranks on the one card (this script
     with ``--ddp-rank``, gloo through the launcher contract), 32 rows each
     of a global batch of 64, three SGD steps, against this process fed the
     64 rows, cuDNN deterministic in every process: each step's loss, and
     in an f32 run of the same steps each step's grad norm and the update
     difference after step 1 and after 3 (relative to the largest update
     entry), each limit below what a rank that never updates reads; the
     ranks' parameters equal to the bit; inside each rank the four trainer kernels counted over the three
     steps and held against their plain versions (the log-mel kernel on
     every step's rows, the first step's pool forward and backward and all
     51 ``dw_bwd`` launches replayed); the collectives of a step (count and
     bytes, the gradient bucket equal to the parameter bytes) beside the JAX
     dry run's; step ms of each rank and of the one process; (b) ``python -m
     titanet_torch train`` under ``TITANET_COORDINATOR``/``NUM_PROCESSES=1``/
     ``PROCESS_ID=0`` (NCCL, world size 1), one epoch host-fed and one with
     ``generic.device_corpus``, each equal to the bit (metrics and
     checkpoint) to the same epoch without the contract; model ms a step of
     both.
  18. step capture (``titanet_torch/train/capture.py``; the steps the JAX
     package jits run as one CUDA graph a shape, the default on the card
     since phase 4), TitaNet-S at full width (17 mega-blocks, hidden 256,
     weights from seed 0) at B=128 x 3 s: (a) ``embed_step`` bf16 and f32,
     unmasked and masked (ragged lengths), and ``embed_step_quantized``,
     each against ``capture=False``: equal bits on the capture call and on
     replays of new inputs, the replay-aware launch counters (one log-mel
     launch a call; bf16 unmasked one pool forward), median wall ms of 20
     calls of each route in turns, device ms, idle share, kernels and host
     launch calls a call, the capture's ms and the graph pool's MiB; (b)
     ``SpeakerEmbedder`` at the service's 4 buckets (batch 8) and the
     default 10 (batch 32, row classes 32, 16, 8): ``warmup()``'s
     seconds, each (bucket, row class) capture and the pool after it,
     phase 5's requests equal to an eager embedder's to the bit with no
     capture at a request; (c) ``eval_step`` on phase
     13's validation batches with run A: loss, preds and embeddings equal to
     eager's to the bit, one graph a batch shape; (d) in (a)-(c) every
     log-mel and pool-forward launch inside each graph replayed on the
     graph's own operands (kept by reference during its capture, a
     parameter operand cloned inside it; cloned after a replay) and held against its plain version at phases 2 and 3's
     tolerances, the graph's output bit for bit; (e) a second process calls
     ``enable_compilation_cache`` on the directory a first one built the
     kernels into and runs no ``nvcc``. Phases 13-17 hold each launch of
     their commands on the launch's own operands, kept by wrappers that a
     replay does not run, so inside ``embedding_calls`` the steps run
     eagerly; outside it the entry points run their graphs (phase 13's
     trainer validates through them, its launch counts unchanged).
  19. the train step as one CUDA graph a step shape (the JAX package's
     jitted, donated train step) and the mega-blocks' remat, TitaNet-S at
     full width, bf16, dropout 0.5, CE over 251 classes, Adam 1e-3 with
     clipping at 1.0, a 2-step warm-up and a cosine, weight EMA, B=128 x 3
     s: (a) 5 captured steps against 5 ``capture=False`` steps from one
     state, after two eager runs against each other (eager's own spread,
     the limit; 0 so far), under ``TITANET_DW_BWD=xla`` and ``=pallas``,
     with and without SpecAugment + noise (ragged lengths), with
     ``accumulate_steps=2`` (two graphs: accumulate, update) and with an
     ArcFace margin warm-up + renorm: losses, grad norms, every parameter,
     running statistic, Adam moment, weight EMA, the counters and each
     generator's state; (b) graph and eager in turns, 20 steps each: median
     wall ms, utt/s, device ms, idle share, kernels and host launch calls
     a step, the first call's and the capture's seconds, the graph pool's
     MiB; (c) every launch of rows 1-4 inside the pallas-route graph (the
     f32 log-mel, the pool forward and backward, all 51 ``dw_bwd``)
     replayed on the graph's own operands, bit for bit, and held against
     its plain version at phases 2, 3, 6 and 7's limits; (d) plain,
     ``remat=True`` and ``remat_policy="dots_saveable"`` at B=128 and
     B=512: peak memory, ms a step, and the state after 2 captured steps
     equal to the plain model's (within (a)'s spread).
  20. the data-parallel train step as one CUDA graph on every rank over
     NCCL (``train_step(..., mesh=)`` and the ``shard_map`` step; runs
     where two cards or more are visible, else prints ``phase 20 not run:
     1 card visible, needs 2`` and claims nothing): P = min(4, cards)
     ranks, one card each (this script with ``--ddp-capture-rank``),
     phase 19's model and step at 128 rows a rank: (a) under
     ``NCCL_ALGO=Ring`` 4 captured steps against 4 ``capture=False`` steps
     from one state on every rank, to the bit (the global-batch step, with
     SpecAugment + noise on ragged rows, with ``accumulate_steps=2``, and
     the ``shard_map`` step with SpecAugment), ``collective_stats()``
     equal, every rank's graphs captured on the same calls over two bucket
     widths; without the pin, the difference printed; (b) the ranks'
     captured SGD steps (phase 17's learning rate and 32 rows a rank)
     against one process on their rows at phase 17's limits; (c) every
     launch of rows 1-4 inside each rank's graph held on the graph's
     operands at phase 19 (c)'s limits; (d) graph and eager in turns, 20
     steps each, at P = 2 and P = cards: each rank's wall, device and
     NCCL ms, idle share, host launch calls, collectives and bytes a step,
     capture s and pool MiB; (e) ``python -m titanet_torch train`` with
     ``mesh.num_devices`` at P = 1, 2 and cards and under the launcher
     contract at P = cards (2 epochs, 32 rows a rank): whole-loop utt/s,
     utt/s over the second epoch's steps, its wall; (f) the last of two
     ranks killed after launching a replay: the other exits non-zero
     within ``TITANET_DIST_TIMEOUT`` plus a margin. ``python3
     chip_smoke.py --only ddp-capture`` builds the kernels and runs phase
     20 alone (for a four-card machine), then the card's name and the
     last line. ``python3 chip_smoke.py --only megablock-l`` builds the
     kernels and runs phase 10 at (1024, 11) and phase 11 on TitaNet-L
     alone (~2 min), then a JSON line with the mega-block record at (1024,
     11), the card's name and the last line.

The line before the last is the card's name and power limit; before it, a
JSON line with each kernel's launches on its path (serving for the forward
kernels, the pallas-route training step for the backward kernels, the
fused serving call for the frames and mega-block kernels; the f32 routes
of rows 1, 5 and 6 in ``f32_*`` keys: the train step's log-mel launch, the
f32 fused serving call's; ``f32_bound_ms`` is the 3xTF32 bound, rows 1 and
6 add ``f32_design_bound_ms``, the f64 tensor-core design's; row 5 adds
``titanet_l``: both dtypes at (1024, 11) and their launches a TitaNet-L
fused call; rows 1-4 also
``zoo_trainer_launches``: each zoo family's launches in its phase-15
trainer run, ``device_corpus_trainer_launches``: phase 16's
device-resident ``cli.train``, and ``ddp_trainer_launches``: rank 0's
three steps in phase 17; rows 1 and 2 add ``graph_launches``: the launches a
captured call of each path of phase 18 counted; rows 1-4 add
``train_graph_launches``: a replay of phase 19's train graph, and
``ddp_graph_launches``: rank 0's replay of its graph in phase 20, null on
one card; two more rows, ``context_stats`` and ``attentive_pool_fwd_rows``,
ECAPA's context route from phase 3b, their launches an ECAPA-1024
``embed_step`` call and each ECAPA family's trainer launches in phase
15), error
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
# FP32 CUDA cores; tensor cores (bf16, TF32, f64)
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12, "float64_tc": 67e12}
B, SECONDS, SR = 128, 3, 16000
# Least cosine of the fused serving path vs embed_step of the same model: the
# fused kernel's edge rows (the first and last (S-1)*pad rows of every
# mega-block) differ from the per-conv path by construction. Measured on
# TitaNet-S at B=128 x 3 s (NVIDIA H100 80GB HBM3, 700 W): 0.9999998 in f32
# and 0.9999918 in bf16, for the kernel route and the all-plain fused route
# alike; the limits sit just under.
FUSED_VS_EMBED_STEP_F32 = 0.99999
FUSED_VS_EMBED_STEP_BF16 = 0.9999
FUSED_VS_EMBED_STEP = {"f32": FUSED_VS_EMBED_STEP_F32, "bf16": FUSED_VS_EMBED_STEP_BF16}
# The same on TitaNet-L (5 mega-blocks, k = 11: 10 edge rows a side a
# mega-block, against S's 2), B=128 x 3 s: set from the all-plain fused
# route's reading, which the kernel does not change: 0.9999990 in f32 and
# 0.9999921 in bf16 (NVIDIA H100 80GB HBM3, 700 W); the limits sit just
# under, above PARITY.md's budget of 1 - 1e-3.
FUSED_L_VS_EMBED_STEP_F32 = 0.99999
FUSED_L_VS_EMBED_STEP_BF16 = 0.9999
FUSED_L_VS_EMBED_STEP = {"f32": FUSED_L_VS_EMBED_STEP_F32, "bf16": FUSED_L_VS_EMBED_STEP_BF16}
# Times of the designs that this script's kernels replaced, at the same
# shapes (NVIDIA H100 80GB HBM3, 700 W), quoted in the phases' lines beside
# this run's times and nowhere else. The FP32-core designs of the bf16
# routes before their tensor-core kernels: the mega-block kernel at
# (C, k) = (256, 3), (512, 7), (1024, 11); the pool backward, fold on / off.
PREV_MS = {
    ("megablock", 256): 0.727, ("megablock", 512): 2.911, ("megablock", 1024): 26.947,
    ("pool_bwd", True): 7.994, ("pool_bwd", False): 7.578,
    # the bf16 pool forward's two-pass tensor-core design (tc_u_kernel +
    # tc_stats_kernel, h read twice), before the one-pass kernel, fold on /
    # off (same card and shape, profiler device time)
    ("pool", True): 0.2826, ("pool", False): 0.2653,
    # the depthwise backward at C=256, K = 3, 7, 11 and the frames log-mel
    # "default" before their redesign (same card and shapes, CUDA events)
    ("dw_bwd", 3): 0.160, ("dw_bwd", 7): 0.183, ("dw_bwd", 11): 0.204,
    ("mel_frames", "default"): 1.628,
    # the fused log-mel's bf16 route on the FP32 cores (logmel_kernel),
    # before the tensor-core kernel (same card and shapes, CUDA events)
    ("logmel", "bf16"): 1.088,
    # the f32 mega-block on the FP32 cores (megablock_kernel), before the
    # 3xTF32 design, at (C, k) = (256, 3), (512, 7), (1024, 11) (same card
    # and shapes, profiler device time); and the fused f32 serving call of
    # phase 11 it ran in: median wall ms and device ms a call
    ("megablock_f32", 256): 0.7166, ("megablock_f32", 512): 2.9906, ("megablock_f32", 1024): 27.2492,
    # the bf16 mega-block at (1024, 11) on one block a tile of 32 rows
    # (mma.sync), before the cluster design (same card and shape, profiler
    # device time)
    ("megablock_tc", 1024): 5.4884,
    # the f32 log-mel routes on the FP32 cores (logmel_kernel<float>,
    # mel_frames_kernel), before the f64 tensor-core design (same card and
    # shapes, profiler device time); and the fused f32 serving call of phase
    # 11 with that frames kernel: median wall ms and device ms a call
    ("logmel", "f32"): 1.1953, ("mel_frames", "highest"): 1.5583,
    ("fused_f32", "median"): 19.373, ("fused_f32", "device"): 18.775,
}
DW_KERNELS = ("dw_bwd_kernel", "dw_reduce_kernel")
# the kernels of csrc/attn_pool.cu, both routes, forward and backward
POOL_KERNELS = ("pool_onepass_kernel", "pool_merge_kernel", "tc_de_kernel", "tc_dh_kernel", "tc_atb_kernel",
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
            total = sum(end - start for start, end in spans)
            return total / iters / 1e3, union_us(spans) / iters / 1e3, len(spans) // iters, "profiler"
    ms = cuda_ms(fn, iters=iters, warmup=0)
    return ms, ms, None, "events"


def union_us(spans) -> float:
    """The length of the union of sorted ``(start, end)`` spans."""
    busy, reach = 0.0, float("-inf")
    for start, end in spans:
        busy += max(end, reach) - max(start, reach)
        reach = max(reach, end)
    return busy


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


def logmel_f32_costs(n_rows: int, n_bytes: float, frames, basis, fb, k_lo: int = 56, k_hi: int = 400 + 56):
    """The f32 log-mel of ``n_rows`` frames at TitaNet's frontend:
    ``(bound ms, bound_by, design bound ms, FP32-core bound ms, unfused
    library route ms, note)``. The work is the DFT of the 400 window taps (2
    x 400 x 514 a frame) and the dense mel product (2 x 257 x 80). The bound
    is split TF32's: both products three times at the TF32 tensor-core rate.
    The design bound is the f64 tensor-core design's own: the DFT at the f64
    tensor-core rate, the mel product three times at the TF32 rate over the
    filterbank tiles the kernels multiply (the non-zero (8-bin group, 8-mel)
    tiles of ``dmma_filterbank``). The FP32-core bound takes both products
    once at the FP32 rate. Each is held against ``n_bytes`` at the memory
    rate. The library route (``frames [..., n_fft]``, a view) is what the
    kernel fuses, as separate PyTorch calls: the two cuBLAS f32 products of
    the window taps (TF32 off), the power, the mel product, the log and the
    norm; its device time is all its kernels'."""
    import torch

    from titanet_torch.ops.kernels.melspec import dmma_filterbank

    dft_ops, mel_ops = 2 * n_rows * 400 * 2 * 257, 2 * n_rows * 257 * 80
    ops = dft_ops + mel_ops
    n_tiles = sum(bin(int(m)).count("1") for m in dmma_filterbank(fb)[1][0].tolist())
    tile_ops = 2 * n_rows * 8 * 8 * n_tiles
    t_bytes = n_bytes / HBM_BYTES_PER_S
    bms, by = bound_ms(n_bytes, 3 * ops, "tf32")
    design_ms = max(dft_ops / PEAK_OPS["float64_tc"] + 3 * tile_ops / PEAK_OPS["tf32"], t_bytes) * 1e3
    fp32_core_ms, _ = bound_ms(n_bytes, ops, "float32")

    def library_route():
        f = frames[..., k_lo:k_hi]
        re, im = f @ basis[0, k_lo:k_hi], f @ basis[1, k_lo:k_hi]
        db = 10.0 * torch.log10(torch.clamp((re * re + im * im) @ fb, min=1e-10))
        return db / torch.clamp(torch.linalg.vector_norm(db, dim=-1, keepdim=True), min=1e-12)

    lib_ms, _ = device_ms(library_route, iters=10)
    note = (f"3xTF32 bound {bms:.4f} ms ({by}; 3 x {ops / 1e9:.2f} GFLOP at 495 TFLOP/s TF32), design bound "
            f"{design_ms:.4f} ms ({dft_ops / 1e9:.2f} GFLOP at 67 TFLOP/s f64 tensor cores + 3 x "
            f"{tile_ops / 1e9:.3f} GFLOP over the {n_tiles} filterbank tiles at 495 TFLOP/s TF32), FP32-core "
            f"bound {fp32_core_ms:.4f} ms, unfused library route {lib_ms:.4f} ms (device time)")
    return bms, by, design_ms, fp32_core_ms, lib_ms, note


def ran_kernel(fn, kernel: str, counter, attr: str, iters: int = 10, attempts: int = 3) -> str:
    """Holds that ``fn()`` launched ``kernel``: its wrapper's ``attr``
    counter (``counter``) moved by one in one call, and a profiler trace of
    ``iters`` calls, after a traced warm-up cycle of as many, records
    log-mel kernels named ``kernel`` and no other, at most one a call. A
    trace can lose records (see :func:`device_profile`; after phase 8 a
    whole trace of ten calls was not always had in three attempts), so fewer
    than ``iters`` is no fault; a trace that records no log-mel kernel is
    taken again, ``attempts`` in all. Returns what the trace recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    before = getattr(counter, attr)
    fn()
    torch.cuda.synchronize()
    moved = getattr(counter, attr) - before
    names = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA and ("logmel" in e.name or "mel_frames" in e.name)]
        if names:
            break
    named = sum(kernel in n for n in names)
    if moved != 1 or not names or named != len(names) or len(names) > iters:
        raise AssertionError(f"expected one {kernel} launch a call: {attr} moved by {moved}; the profiler "
                             f"recorded {len(names)} log-mel kernels over {iters} calls, {named} named {kernel}")
    return f"{named} {kernel} launches recorded over {iters} calls in the profiler's trace, no other log-mel kernel"


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
    dmma_before = log_mel_fused.dmma_launches
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
    if log_mel_fused.dmma_launches - dmma_before != mel_calls:
        raise AssertionError(f"{label}: {log_mel_fused.dmma_launches - dmma_before} of {mel_calls} f32 log-mel "
                             "launches ran logmel_dmma_kernel")
    print(f"{label} kernels vs plain: log-mel f32 (logmel_dmma_kernel) on all {mel_calls} batches of the "
          f"trainer's train/validation/test loaders ({ragged} with ragged lengths), "
          f"max abs err {mel_err:.3e} (atol 1e-4) {tag}")

    # one train step and one eval_step, keeping what the pool and the
    # depthwise convs are given
    os.environ["TITANET_DW_BWD"] = "pallas"
    _, _, state = cli._new_state(cfg, n_speakers, dev, len(loaders["train"]))
    kept = {"pool": [], "dw": []}

    hooks = keep_pool_calls(state.model, kept["pool"]) + keep_dw_calls(state.model, kept["dw"])
    (wav, lengths, speakers), batch = staged["train"][0]
    uniform = int(batch.lengths.min()) == wav.shape[1]
    dw_before = dwconv.dw_bwd.launches
    ts.train_step(state, wav, None if uniform else lengths, speakers, frontend=frontend,
                  augment=cli._augment_config(cfg, None), capture=False)  # hooks run eagerly only
    dw_launches = dwconv.dw_bwd.launches - dw_before
    (vwav, vlengths, vspeakers), _ = staged["val"][0]
    ts.eval_step(state, vwav, vlengths, vspeakers, frontend=frontend, capture=False)  # hooks run eagerly only
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    if len(kept["pool"]) != 2 or "g" not in kept["pool"][0] or len(kept["dw"]) != dw_launches \
            or not all("g" in r for r in kept["dw"]):
        raise AssertionError(f"trainer kernels: kept {len(kept['pool'])} pool calls and {len(kept['dw'])} "
                             f"depthwise convs for {dw_launches} dw_bwd launches")

    for rec, where in zip(kept["pool"], ("train step", "eval_step")):
        print(f"{label} kernels vs plain: {replay_pool(rec, where)} {tag}")

    print(f"{label} kernels vs plain: {replay_dw(kept['dw'], 'the step')} {tag}")
    os.environ.pop("TITANET_DW_BWD", None)


def keep_dw_calls(model, kept: list) -> list:
    """Forward hooks on every depthwise conv of ``model`` that append to
    ``kept``, for each call whose backward the ``dw_bwd`` kernel takes, the
    input and the weight (cloned) and the output's gradient. Returns the
    hooks."""
    from titanet_torch.ops.conv import SamePadConv1d
    from titanet_torch.ops.kernels import dwconv

    def on_dw(mod, args, out):
        x = args[0].to(mod.dtype) if mod.dtype is not None else args[0]
        if not out.requires_grad or mod.groups != x.shape[-1] or not dwconv.kernel_supports(
                x.shape[1], x.shape[-1], mod.kernel_size, x.dtype):
            return
        rec = {"x": x.detach().contiguous().clone(), "w": mod.weight.detach().clone()}
        kept.append(rec)
        keep_grad(out, rec)

    return [m.register_forward_hook(on_dw) for m in model.modules()
            if isinstance(m, SamePadConv1d) and m.groups > 1]


def replay_dw(kept: list, where: str) -> str:
    """Every ``dw_bwd`` launch kept by :func:`keep_dw_calls` replayed on its
    operands against the plain version (phase 7's 3e-2 of each gradient's
    largest entry). Raises on a miss; returns the line to print."""
    import torch

    from titanet_torch.ops.kernels import dwconv

    worst = {"dx": 0.0, "dk": 0.0, "db": 0.0}
    shapes = set()
    for rec in kept:
        x, w = rec["x"], rec["w"]
        dy = rec["g"].to(x.dtype).contiguous()
        got, ref = dwconv.dw_bwd(x, w, dy), dwconv.dw_bwd_plain(x, w, dy)
        torch.cuda.synchronize()
        for gname, a_, r in zip(("dx", "dk", "db"), got, ref):
            err = (a_.float() - r.float()).abs().max().item() / r.float().abs().max().item()
            if not torch.isfinite(a_).all() or err > 3e-2:
                raise AssertionError(f"dw_bwd ({where}) {tuple(x.shape)} K={w.shape[-1]} {x.dtype}: {gname} "
                                     f"error / max {err} > 3e-2")
            worst[gname] = max(worst[gname], err)
        shapes.add((tuple(x.shape), w.shape[-1]))
    return (f"dw_bwd, every one of {where}'s {len(kept)} launches "
            f"({', '.join(f'{s} K={k}' for s, k in sorted(shapes))}, {kept[0]['x'].dtype}): worst error / "
            f"max {json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})} (tol 3e-2)")


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
    from titanet_torch.train.capture import GRAPHS

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
        captures = GRAPHS.captures
        t0 = time.perf_counter()
        _, counts = counted(lambda: cli.train(trainer_config(root, f"a-{route}", 2, augmented)))
        wall = time.perf_counter() - t0
        captures = GRAPHS.captures - captures
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
              f"validation and checkpoint); peak memory {peak / 2**30:.2f} GiB; {captures} CUDA graphs captured "
              f"(train_step, eval_step and embed_step, one a shape and model: the train steps, {steps} an epoch, "
              f"validation, {val_batches} batches an epoch, and verification, {test_batches}) {tag}")

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
    ``pooling.attentive_pool_fused``; ECAPA's context route, the names
    ``models.ecapa`` calls it by: ``context_stats`` and
    ``attentive_pool_fwd`` with a bias a row and the rows' lengths) and the
    output. On exit ``calls``, ``launches``, ``tc_launches``,
    ``dmma_launches``, ``pool_launches``, ``ctx_launches``, ``mel``,
    ``pool``, ``ctx`` and ``rows`` hold them. Inside, the embedding steps and
    ``eval_step`` run eagerly (``capture=False`` whatever the caller asks):
    a CUDA graph's replay runs no Python, so only the eager route hands each
    launch's operands to the wrappers; phase 18 holds the captured route,
    each launch of a replay on that graph's own operands. The train step
    keeps its default route (a graph on the card); the calls a capture
    makes launch nothing and are not kept."""

    def __enter__(self):
        from titanet_torch.models import ecapa
        from titanet_torch.ops import frontend, pooling
        from titanet_torch.ops.kernels.melspec import log_mel_fused
        from titanet_torch.ops.kernels.pool import attentive_pool_fwd, context_stats
        from titanet_torch.train import extractor, loop, state

        self.calls, self.mel, self.pool, self.ctx, self.rows, self._saved = 0, [], [], [], [], []
        for mod in (extractor, loop, state):
            for name in ("embed_step", "embed_step_quantized", "eval_step"):
                if getattr(mod, name, None) is not None:
                    self._wrap(mod, name, self._eager if name == "eval_step" else self._counted)
        self._wrap(frontend, "_log_mel_fused", self._keep_mel)
        self._wrap(pooling, "attentive_pool_fused", self._keep_pool)
        self._wrap(ecapa, "context_stats", self._keep_ctx)
        self._wrap(ecapa, "attentive_pool_fwd", self._keep_rows)
        self._mel_fn, self._pool_fn, self._ctx_fn = log_mel_fused, attentive_pool_fwd, context_stats
        log_mel_fused.launches = log_mel_fused.tc_launches = log_mel_fused.dmma_launches = 0
        attentive_pool_fwd.launches = context_stats.launches = 0
        return self

    def _wrap(self, mod, name, make):
        fn = getattr(mod, name)
        self._saved.append((mod, name, fn))
        setattr(mod, name, make(fn))

    def _counted(self, fn):
        def call(*a, **k):
            self.calls += 1
            return fn(*a, **{**k, "capture": False})
        return call

    @staticmethod
    def _eager(fn):
        return lambda *a, **k: fn(*a, **{**k, "capture": False})

    def _keep_mel(self, fn):
        import torch

        def call(waveform, cfg, lengths):
            out = fn(waveform, cfg, lengths)
            if torch.cuda.is_current_stream_capturing():
                return out
            self.mel.append(dict(waveform=waveform.clone(), cfg=cfg, out=out.clone(),
                                 lengths=None if lengths is None else lengths.clone()))
            return out
        return call

    def _keep_pool(self, fn):
        import torch

        def call(h, a, c, wa, ba, wb, bb, eps, fold):
            out = fn(h, a, c, wa, ba, wb, bb, eps, fold)
            if torch.cuda.is_current_stream_capturing():
                return out
            dt = h.dtype  # the operands as the pool's autograd function hands them to the kernel
            args = (h.contiguous(), a.float().contiguous(), c.float().contiguous(), wa.to(dt).contiguous(),
                    ba.float().contiguous(), wb.to(dt).contiguous(), bb.float().contiguous())
            self.pool.append(dict(args=tuple(t.clone() for t in args), eps=eps, fold=fold, out=out.clone()))
            return out
        return call

    def _keep_ctx(self, fn):
        import torch

        def call(h, lengths=None, eps=1e-6):
            out = fn(h, lengths, eps)
            if not torch.cuda.is_current_stream_capturing():
                self.ctx.append(dict(h=h.clone(), lengths=None if lengths is None else lengths.clone(), eps=eps,
                                     out=out.clone()))
            return out
        return call

    def _keep_rows(self, fn):
        import torch

        def call(h, a, c, wa, ba, wb, bb, eps, fold, lengths=None):
            out = fn(h, a, c, wa, ba, wb, bb, eps, fold, lengths)
            if not torch.cuda.is_current_stream_capturing():
                self.rows.append(dict(args=tuple(t.clone() for t in (h, a, c, wa, ba, wb, bb)), eps=eps, fold=fold,
                                      lengths=None if lengths is None else lengths.clone(), out=out.clone()))
            return out
        return call

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self.launches, self.tc_launches = self._mel_fn.launches, self._mel_fn.tc_launches
        self.dmma_launches = self._mel_fn.dmma_launches
        self.pool_launches, self.ctx_launches = self._pool_fn.launches, self._ctx_fn.launches
        return False


def replay_mel(records, what: str, dtype=None):
    """Every log-mel launch kept by :class:`embedding_calls` replayed on its
    own operands (the waveform, config and lengths the path turned into
    them): the replay gives the path's output bit for bit and matches
    ``log_mel_fused_plain`` within phase 2's tolerance (f32 atol 1e-4, bf16
    2e-3); ``dtype``, when given, is the operands' required dtype. Raises on
    a miss; returns ``(max abs err, (rows, filler rows of length 1) of
    each launch, buffer shapes)``."""
    import torch

    from titanet_torch.ops import frontend as tf
    from titanet_torch.ops.kernels.melspec import log_mel_fused, log_mel_fused_plain

    err, rows, widths = 0.0, [], set()
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
        rows.append((args[0].shape[0], int((args[1] == 1).sum().item()) if args[1] is not None else 0))
        widths.add(tuple(args[0].shape))
    return err, rows, widths


def check_command_kernels(calls: "embedding_calls", what: str, tag: str, *, mel: str = "f32",
                          fillers: bool = True, pool: bool = False, ctx: bool = False, echo: bool = True) -> dict:
    """The kernels a command's embedding calls went through, held against
    their plain versions on the tensors the command gave them; raises on a
    miss, returns the summary.

    ``mel`` ``"f32"`` or ``"bf16"``: every embedding call launched the fused
    log-mel kernel once (bf16: the bf16 tensor-core one, f32: the f64
    tensor-core one), and each launch,
    replayed on its own operands (the bucket width, the lengths, the filler
    rows of length 1 that ``SpeakerEmbedder`` pads a group with: ``fillers``
    requires each launch's rows to be the smallest row class that holds its
    real rows, ``batch_size`` halved down to 8, so a group that fills its
    class has none), gives the command's output bit
    for bit and matches ``log_mel_fused_plain``: f32 atol 1e-4, bf16 2e-3,
    as phase 2. ``mel`` None: no launch (a plain torch frontend).

    ``pool``: every embedding call pooled unmasked through the pool-forward
    kernel once, and each launch holds as phase 13's
    (:func:`pool_fwd_vs_plain`); ``ctx``: every embedding call pooled
    through ECAPA's context route once, one ``context_stats`` and one
    ``attentive_pool_fwd`` launch (a bias a row, the rows' lengths), each
    held by :func:`replay_ctx_route`; otherwise no launch of either."""
    import torch

    want_mel = calls.calls if mel else 0
    want_pool = calls.calls if pool else 0
    want_ctx = calls.calls if ctx else 0
    if calls.calls == 0 or calls.launches != want_mel or len(calls.mel) != want_mel \
            or calls.tc_launches != (want_mel if mel == "bf16" else 0) \
            or calls.dmma_launches != (want_mel if mel == "f32" else 0) \
            or calls.pool_launches != want_pool + want_ctx or len(calls.pool) != want_pool \
            or calls.ctx_launches != want_ctx or len(calls.ctx) != want_ctx or len(calls.rows) != want_ctx:
        raise AssertionError(f"{what}: {calls.calls} embedding calls; {calls.launches} log-mel launches "
                             f"({calls.tc_launches} bf16 tensor-core, {calls.dmma_launches} f64 tensor-core, "
                             f"{len(calls.mel)} kept), expected {want_mel} "
                             f"{mel}; {calls.pool_launches} pool-forward launches ({len(calls.pool)} kept unmasked, "
                             f"{len(calls.rows)} a bias a row), expected {want_pool} + {want_ctx}; "
                             f"{calls.ctx_launches} context launches ({len(calls.ctx)} kept), expected {want_ctx}")
    summary = {"calls": calls.calls, "launches": calls.launches, "pool_launches": calls.pool_launches,
               "ctx_launches": calls.ctx_launches}
    line = f"  {what}: {calls.calls} embedding calls"
    if mel:
        atol = 2e-3 if mel == "bf16" else 1e-4
        err, rows, widths = replay_mel(calls.mel, what, torch.bfloat16 if mel == "bf16" else torch.float32)
        n_fillers = sum(f for _, f in rows)
        # a smaller class (half the rows, 8 at least) would have held the real rows
        wasted = [(r, r - f) for r, f in rows if r - f <= r // 2 and r // 2 >= 8]
        if fillers and wasted:
            raise AssertionError(f"{what}: launches (rows, real rows) {wasted} not at the smallest row class "
                                 "that holds their real rows")
        summary["max_abs_err"] = err
        route = "logmel_tc_kernel, bf16" if mel == "bf16" else "logmel_dmma_kernel, f32"
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
    elif ctx:
        held = replay_ctx_route(calls.ctx, calls.rows, what)
        summary.update(ctx_max_abs_err=held["ctx_err"], rows_max_abs_err=held["rows_err"], ctx_line=held["line"])
        line += f"; ECAPA's context route, {held['line']}"
    else:
        line += "; masked pooling (plain torch), no pool-forward launch"
    if echo:
        print(f"{line} {tag}")
    return summary


def replay_ctx_route(ctx: list, rows: list, what: str) -> dict:
    """ECAPA's context route as :class:`embedding_calls` kept it (one
    ``context_stats`` and one ``attentive_pool_fwd`` launch a pooling call,
    paired in order), each launch replayed on its own operands: the replay
    gives the path's output bit for bit and matches its plain version,
    ``context_stats_plain`` at rtol and atol 1e-4 (f32 sums of bf16 values
    in other orders) and ``attentive_pool_fwd_plain(..., lengths)`` at
    phase 3's 2e-2 (bf16 output, the kernel's ex2.approx softmax). A pair
    shares one ``h`` and one ``lengths``, and the pool's bias is one row a
    row. Raises on a miss; returns both errors and a summary."""
    import torch

    from titanet_torch.ops.kernels.pool import (
        attentive_pool_fwd,
        attentive_pool_fwd_plain,
        context_stats,
        context_stats_plain,
    )

    if len(ctx) != len(rows) or not ctx:
        raise AssertionError(f"{what}: {len(ctx)} context and {len(rows)} pool launches kept")
    ctx_err = rows_err = 0.0
    shapes, ragged, least = set(), 0, None
    for c, r in zip(ctx, rows):
        h, lengths = c["h"], c["lengths"]
        b, t, ch = h.shape
        same = torch.equal(h, r["args"][0]) and (lengths is None) == (r["lengths"] is None) \
            and (lengths is None or torch.equal(lengths, r["lengths"]))
        if not same or tuple(r["args"][4].shape) != (b, r["args"][3].shape[1]):
            raise AssertionError(f"{what}: a context launch and its pool launch on other operands")
        got = context_stats(h, lengths, c["eps"])
        out = attentive_pool_fwd(*r["args"], r["eps"], r["fold"], r["lengths"])
        torch.cuda.synchronize()
        if not (torch.equal(got, c["out"]) and torch.equal(out, r["out"])):
            raise AssertionError(f"{what}: the context route's replay on {(b, t, ch)} differs from the path's output")
        ref_ctx = context_stats_plain(h, lengths, c["eps"])
        ref = attentive_pool_fwd_plain(*r["args"], r["eps"], r["fold"], r["lengths"]).float()
        torch.testing.assert_close(got, ref_ctx, rtol=1e-4, atol=1e-4, msg=lambda m: f"{what}: context_stats: {m}")
        torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2,
                                   msg=lambda m: f"{what}: attentive_pool_fwd (a bias a row): {m}")
        ctx_err = max(ctx_err, (got - ref_ctx).abs().max().item())
        rows_err = max(rows_err, (out.float() - ref).abs().max().item())
        shapes.add((b, t, ch, str(h.dtype).split(".")[1]))
        if lengths is not None:
            ragged += int(lengths.min().item() < lengths.max().item())
            n = int(lengths.min().item())
            least = n if least is None else min(least, n)
    line = (f"{len(ctx)} context_stats + {len(rows)} attentive_pool_fwd launches (h {sorted(shapes)}; "
            f"{sum(c['lengths'] is not None for c in ctx)} with lengths, {ragged} ragged, shortest row "
            f"{least} frames), replayed on every launch's operands, the path's output bit for bit, vs plain: "
            f"context max abs err {ctx_err:.3e} (1e-4), pool {rows_err:.3e} (2e-2)")
    return {"ctx_err": ctx_err, "rows_err": rows_err, "launches": len(ctx), "line": line}


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
ZOO_TURNS = 5  # more train steps of each route, graph and eager in turns


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
    (C = 1536, T' = 151) and of ``infer --split`` too. ECAPA's pooling in
    its bf16 model outside autograd (validation, verification,
    ``embed_step``, the embedder, ``infer``) takes the context route, one
    ``context_stats`` and one ``attentive_pool_fwd`` launch a call, each
    replayed on its own operands (C = 1536, H = 128; the embedder's rows
    ragged, up to its 38.4 s bucket) by :func:`replay_ctx_route`; its train
    steps and the f32 service pool plainly. Every other family launches no
    pool kernel. Raises on any failed check; returns each family's launches
    of the five kernels in its trainer run."""
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
    from titanet_torch.ops.kernels.pool import attentive_pool_bwd, attentive_pool_fwd, context_stats
    from titanet_torch.train import checkpoint as ckpt
    from titanet_torch.train import state as ts
    from titanet_torch.train.capture import GRAPHS
    from titanet_torch.train.extractor import SpeakerEmbedder

    dev = torch.device("cuda")
    counters = {"logmel": log_mel_fused, "pool_fwd": attentive_pool_fwd, "pool_bwd": attentive_pool_bwd,
                "dw_bwd": dwconv.dw_bwd, "ctx": context_stats}

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
            conformer, ecapa = "conformer" in model_cfg, "ecapa" in model_cfg
            cfg = trainer_config(root, name, 1, ("chunk",), model=model_cfg)
            run = os.path.join(root, name)
            os.environ["TITANET_DW_BWD"] = "pallas"

            # 1. the trainer: one epoch, its train steps through their CUDA
            # graphs (their launches held on the graphs' operands), then the
            # verification of its checkpoint
            zero()
            captures = GRAPHS.captures
            t0 = time.perf_counter()
            with embedding_calls() as calls, graph_operands() as ops:
                cli.train(cfg)
                train_s = time.perf_counter() - t0
                metrics = cli.evaluate_checkpoint(cfg, run)
            trainer = read()
            n_graphs = GRAPHS.captures - captures
            # ECAPA's validation and verification batches take the context route
            n_ctx = val_batches + 2 * test_batches if ecapa else 0
            want = {"logmel": steps + val_batches + 2 * test_batches,
                    "pool_fwd": (steps + val_batches if conformer else 0) + n_ctx,
                    "pool_bwd": steps if conformer else 0, "dw_bwd": 0, "ctx": n_ctx}
            # the calls kept on the eager route: all but the train graphs' replays
            if trainer != want or not 1 <= n_graphs < steps or len(calls.mel) != want["logmel"] - steps + n_graphs \
                    or len(calls.ctx) != n_ctx:
                raise AssertionError(f"zoo {name} trainer: launches {trainer} ({len(calls.mel)} log-mel, "
                                     f"{len(calls.ctx)} context kept, {n_graphs} train graphs), expected {want}")
            mel_err, _, _ = replay_mel(calls.mel, f"zoo {name} trainer", torch.float32)
            trainer_ctx = replay_ctx_route(calls.ctx, calls.rows, f"zoo {name} trainer")["line"] if ecapa else ""
            graph_held = hold_train_graph_kernels(ops, f"zoo {name} train graph", n_graphs, int(conformer), 0)
            del ops
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
            step = lambda c=None: ts.train_step(state, batch_wav, None, batch_spk, frontend=frontend,  # noqa: E731
                                                capture=c)
            losses, norms, step_ms = [], [], []
            torch.cuda.reset_peak_memory_stats()
            zero()
            for i in range(ZOO_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, met = step(False if hooks else None)  # the hooked first step eagerly, then the graph
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
                    "pool_bwd": ZOO_STEPS if conformer else 0, "dw_bwd": 0, "ctx": 0}
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
            step_med = statistics.median(step_ms[2:])
            turns = {None: [], False: []}
            for i in range(ZOO_TURNS):
                for c in ((None, False) if i % 2 == 0 else (False, None)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(c)
                    torch.cuda.synchronize()
                    turns[c].append((time.perf_counter() - t0) * 1e3)
            eager_dev, eager_busy, _, _ = device_profile(lambda: step(False), iters=3, warmup=1)
            turn_line = (f"; graph vs eager in turns ({ZOO_TURNS} steps each): median {statistics.median(turns[None]):.2f}"
                         f" vs {statistics.median(turns[False]):.2f} ms, device {step_dev:.2f} vs {eager_dev:.2f} ms, "
                         f"idle {1 - step_busy / statistics.median(turns[None]):.2f} vs "
                         f"{1 - eager_busy / statistics.median(turns[False]):.2f}")

            # 3. embedding: embed_step at B=128 x 3 s (the bf16 tensor-core
            # log-mel kernel; unmasked, so the Conformer pools through the
            # pool kernel) and the SpeakerEmbedder (masked, the CLI's f32
            # log-mel kernel); ECAPA through its context route in both
            model = state.model.eval()
            embed = lambda: ts.embed_step(model, wav, lengths, frontend=cfg16, device=dev)  # noqa: E731
            with embedding_calls() as calls:
                e = embed()
            if e.shape != (B, 192) or not torch.isfinite(e.float()).all() \
                    or (torch.linalg.vector_norm(e.float(), dim=-1) - 1).abs().max().item() > 1e-2:
                raise AssertionError(f"zoo {name} embed_step: not finite unit rows [B, 192]")
            embed_k = check_command_kernels(calls, f"zoo {name} embed_step", tag, mel="bf16", fillers=False,
                                            pool=conformer, ctx=ecapa, echo=False)
            emb_med, _, _ = median_ms(embed, runs=5, warmup=1)
            emb_dev, emb_busy, emb_kernels, _ = device_profile(embed, iters=3, warmup=1)
            embedder = SpeakerEmbedder(model, frontend, device=dev)
            with embedding_calls() as calls:
                batched = embedder.embed(reqs)
                solo = np.concatenate([embedder.embed([r]) for r in reqs])
            cos = np.sum(batched * solo, -1) / (np.linalg.norm(batched, axis=-1) * np.linalg.norm(solo, axis=-1))
            if batched.shape != (4, 192) or not np.isfinite(batched).all() or cos.min() <= 0.999:
                raise AssertionError(f"zoo {name} SpeakerEmbedder: padded vs solo cosines {cos}")
            embedder_k = check_command_kernels(calls, f"zoo {name} SpeakerEmbedder", tag, ctx=ecapa, echo=False)
            ctx_line = ""
            if ecapa:
                ctx_line = (f"; context route: trainer {trainer_ctx}; embed_step context err "
                            f"{embed_k['ctx_max_abs_err']:.2e}, pool {embed_k['rows_max_abs_err']:.2e}; "
                            f"SpeakerEmbedder {embedder_k['ctx_line']}")
            n_params = count_params(model)
            cls = type(model).__name__
            del state, model, embedder, step, embed

            # 4. the entry points on the trained checkpoint
            params = os.path.join(root, f"{name}.json")
            with open(params, "w") as f:
                json.dump(cfg.to_dict(), f)
            with embedding_calls() as calls:
                emb, labels = cli.main(["infer", "-p", params, "-c", run, "--audio", utt_dir])
            check_command_kernels(calls, f"zoo {name} infer --audio", tag, ctx=ecapa, echo=False)
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
            out[name] = {**trainer, "embed_step_ctx": embed_k["ctx_launches"]}
            print(f"zoo {name} ({cls}, {n_params / 1e6:.2f}M params, bf16): cli.train 1 epoch ({steps} steps of "
                  f"{TRAIN_BATCH}, [chunk]) {train_s:.2f} s, train/avg_loss {loss:.4f}, test/eer "
                  f"{metrics['test/eer']:.4f}, test/mindcf {metrics['test/mindcf']:.4f}, launches {trainer}, "
                  f"all {n_mel} log-mel launches replayed vs plain max abs err {mel_err:.3e} (atol 1e-4); "
                  f"{n_graphs} train graph(s): {graph_held}; "
                  f"train_step x{ZOO_STEPS} on B={TRAIN_BATCH} x {SECONDS} s (the first eagerly, then its graph): loss "
                  f"{losses[0]:.4f} -> {losses[-1]:.4f}, grad norms finite, median {step_med:.2f} ms a step (min "
                  f"{min(step_ms[2:]):.2f}, max {max(step_ms[2:]):.2f}), device {step_dev:.2f} ms, busy {step_busy:.2f} ms "
                  f"({timed_by}), "
                  f"{step_kernels} kernels a step, idle {1 - step_busy / step_med:.2f}, peak {peak / 2**30:.2f} GiB, launches "
                  f"{ {k: v // ZOO_STEPS for k, v in per_step.items()} } a step{pool_line}{turn_line}; embed_step B={B} x "
                  f"{SECONDS} s median {emb_med:.2f} ms, device {emb_dev:.2f} ms, busy {emb_busy:.2f} ms, {emb_kernels} kernels, idle "
                  f"{1 - emb_busy / emb_med:.2f}, log-mel bf16 err {embed_k['max_abs_err']:.2e}"
                  f"{', pool ' + format(embed_k['pool_max_abs_err'], '.2e') if conformer else ''}; SpeakerEmbedder "
                  f"padded vs solo min cosine {cos.min():.7f}{ctx_line}; infer --audio vs direct {infer_diff:.1e}"
                  f"{split_line}"
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
    from titanet_torch.ops.kernels import pool as pool_kernels_mod
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
        if op_launches != want or len(mel_kernels) != want or (fused and "logmel_dmma_kernel" not in mel_kernels[0]):
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

    # (b') run A as trained (bf16) exported with the fused frontend: the
    # graph holds the log-mel and pool-forward operators, each launched once
    # a call, and equals embed_step of the same model (the same kernels)
    cfg16 = trainer_config(root, "a-pallas", SERVE_EPOCHS, ("chunk", "specaugment", "noise"))
    state16, frontend16, epoch16 = cli._restore_for_eval(cfg16, n_speakers, run, None, "cuda")
    model16 = state16.model.eval()
    if model16.dtype != torch.bfloat16:
        raise AssertionError(f"export bf16: run A restored as {model16.dtype}")
    fe = frontend16._replace(use_pallas_fused=True)
    t0 = time.perf_counter()
    blob = tx.export_titanet_embedder(model16, None, fe, batch_size=EXPORT_B, num_samples=EXPORT_SAMPLES)
    export_s = time.perf_counter() - t0
    program = torch.export.load(io.BytesIO(blob))
    op_nodes = sorted(str(n.target) for n in program.graph.nodes
                      if n.op == "call_function" and "titanet_torch" in str(n.target))
    served = tx.load_embedder(blob)
    with torch.no_grad():
        out = served(wav8, len8)
        mel_before, pool_before = log_mel_fused.launches, attentive_pool_fwd.launches
        served(wav8, len8)
        torch.cuda.synchronize()
        per_call = {"logmel": log_mel_fused.launches - mel_before,
                    "pool_fwd": attentive_pool_fwd.launches - pool_before}
        names = traced_kernels(lambda: served(wav8, len8))
    ref = embed_step(model16, wav8, len8, frontend=fe, device=dev)
    cos = torch.nn.functional.cosine_similarity(out.float(), ref.float(), dim=-1)
    drift = (1.0 - cos).max().item()
    # the one-pass kernel, and its merge where T is split over several blocks
    kinds = ("pool_merge_kernel", "pool_onepass_kernel")
    pool_kernels = [n for n in names if any(k in n for k in kinds)]
    got_pool = sorted(k for n in pool_kernels for k in kinds if k in n)
    want_pool = sorted(["pool_onepass_kernel"] + ["pool_merge_kernel"] * (pool_kernels_mod.onepass_splits(EXPORT_B) > 1))
    mel_kernels = [n for n in names if "logmel" in n]
    if out.shape != (EXPORT_B, 192) or out.dtype != torch.bfloat16 or not torch.isfinite(out).all() \
            or drift >= 1e-5:
        raise AssertionError(f"export bf16: {out.dtype} {tuple(out.shape)}, cosine drift vs embed_step {drift}")
    if per_call != {"logmel": 1, "pool_fwd": 1} or len(mel_kernels) != 1 or len(op_nodes) != 2 \
            or got_pool != want_pool:
        raise AssertionError(f"export bf16: launches a call {per_call}, traced {mel_kernels + pool_kernels}, "
                             f"operator nodes {op_nodes}")
    med, lo, hi = median_ms(lambda: served(wav8, len8))
    print(f"export bf16 (run A epoch {epoch16} as trained, bf16 TitaNet-S, B={EXPORT_B} x {EXPORT_SAMPLES}, "
          f"use_pallas_fused=True): torch.export in {export_s:.2f} s, artifact {len(blob) / 1e6:.2f} MB; "
          f"operator nodes {op_nodes}; wrapper launches a call {per_call}; traced kernels of the two "
          f"{mel_kernels + pool_kernels}; cosine drift vs embed_step max {drift:.3e} (limit 1e-5); "
          f"{len(names)} kernels a call; median {med:.3f} ms a call ({lo:.3f}-{hi:.3f}) {tag}")
    del served, out, ref, program, model16, state16

    # (c) profiling
    logdir = os.path.join(root, "trace")
    with tp.trace(logdir):
        with tp.span("embed_step x3"):
            for _ in range(3):
                embed_step(model, wav8, len8, frontend=frontend, device=dev)
        torch.cuda.synchronize()
    traces = glob.glob(os.path.join(logdir, "*.json"))
    text = open(traces[0]).read() if len(traces) == 1 else ""
    if "logmel_dmma_kernel" not in text:
        raise AssertionError(f"profiling: trace files {traces} do not name logmel_dmma_kernel")
    sp, box = tp.StepProfiler(), {}
    for _ in range(10):
        with sp.step("embed_step_b8", lambda: box["e"]):
            box["e"] = embed_step(model, wav8, len8, frontend=frontend, device=dev)
    mem = tp.device_memory_stats()
    total = torch.cuda.get_device_properties(dev).total_memory
    if not (0 < mem["bytes_in_use"] <= mem["peak_bytes_in_use"] <= mem["bytes_limit"] == total):
        raise AssertionError(f"profiling: device_memory_stats {mem}, card memory {total}")
    print(f"profiling: trace() of 3 embed_step calls wrote {os.path.basename(traces[0])} "
          f"({len(text) / 1e6:.2f} MB, names logmel_dmma_kernel); StepProfiler over 10 steps {sp.summary()}; "
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


# Data-parallel phase (17): TitaNet-S at full width (17 mega-blocks, hidden
# 256, epilog 1536, embedding 192), bf16, CE, on phase 13's corpus with
# [chunk] (SpecAugment off), TITANET_DW_BWD=pallas. (a) two ranks on the one
# card over gloo (NCCL refuses two ranks on one device), 32 rows each of a
# global batch of 64, DDP_STEPS train steps with dropout 0.5, against this
# process fed the 64 rows; (b) the CLI under the launcher contract at world
# size 1 over NCCL, one epoch host-fed and one with generic.device_corpus,
# each against the same epoch without the contract.
DDP_RANKS, DDP_LOCAL_B, DDP_STEPS = 2, 32, 3
DDP_LR = 1e-2  # SGD: a step's update is lr x the gradient, so updates compare gradients
# the JAX package's dry run of one train step at its own shape (n_mega_blocks
# 2, hidden 32, 2-8 devices; MULTICHIP_r05.json)
JAX_DRYRUN = {"all_reduce": 46, "bytes": 99_460, "param_bytes": 88_704}
# (a)'s limits against the one process. Every process runs cuDNN's
# deterministic algorithms, so the one process equals itself to the bit
# (held). Two ranks still sum in another order and with other algorithms
# (32 rows, not 64), and this model's gradient is a sum that cancels deeply
# at its start: on an NVIDIA H100 80GB HBM3 at 700 W, with dropout 0, the
# one process fed the same 64 rows with the halves of each batch swapped
# differs from itself by 1.25e-2 of the largest f32 update entry after one
# step and by 0.63 after three (the phase prints this spread each run); the
# ranks read 8.9e-3 and 0.33. So the f32 run (the same steps; the pool
# kernel is bf16-only) holds step 1 tightly and steps 2-3 loosely:
# the loss (relative), the grad norm (relative, after the all-reduce) and
# the update difference over the largest update entry, each at about four
# to ten times that measurement, and the phase checks that every limit of
# an update-dependent reading lies below what a rank that never applied
# its update reads (the one process at learning rate 0). In bf16, the
# kernels' run, every activation is rounded to 8 bits and the gradients at
# this start are mostly rounding, so only the losses are held.
DDP_F32_LIMITS = {"loss_step1": 1e-5, "grad_norm_step1": 2e-3, "update_step1": 5e-2,
                  "loss_later": 2e-3, "grad_norm_later": 1e-2, "update_all": 0.6}
DDP_BF16_LOSS_RTOL = 1e-2


def ddp_config(root: str, run: str, batch_size: int = TRAIN_BATCH, device_corpus: bool = False):
    """Phase 17's trainer config: phase 13's with [chunk], SGD, one epoch."""
    from titanet_torch.config import Config

    d = trainer_config(root, run, 1, ("chunk",)).to_dict()
    d["training"]["optimizer"].update(type="sgd", start_lr=DDP_LR)
    d["training"]["batch_size"] = batch_size
    d["titanet"]["dropout"] = 0.5
    d["generic"]["device_corpus"] = device_corpus
    return Config.from_dict(d)


def ddp_steps(work: str, mesh=None, dtype: str = "bfloat16", lr=None, dropout=None, swap=False) -> dict:
    """DDP_STEPS train steps of phase 17 (a) on the batches in ``work``:
    under ``mesh`` this rank's rows, else the whole global batch (with
    ``swap``, its two halves swapped), with the model in ``dtype`` (SGD at
    ``lr`` and ``dropout`` in place of the config's when given). The kernel counts are set to 0 just before the
    steps and read just after; in bf16 the first step runs with hooks that
    keep what the pool and depthwise kernels were given, and after the
    steps each kept launch and the log-mel kernel of each step are
    replayed against their plain versions. Returns the losses, step
    times, counts, collectives, checks and the parameters before and
    after."""
    import numpy as np
    import torch

    from titanet_torch import cli
    from titanet_torch.config import Config
    from titanet_torch.ops import frontend as tf
    from titanet_torch.ops.conv import SamePadConv1d
    from titanet_torch.ops.kernels import dwconv
    from titanet_torch.ops.kernels.melspec import log_mel_fused, log_mel_fused_plain
    from titanet_torch.ops.kernels.pool import attentive_pool_bwd, attentive_pool_fwd
    from titanet_torch.parallel.distributed import collective_stats, reset_collective_stats
    from titanet_torch.parallel.shard_map_step import replicate_state
    from titanet_torch.train import state as ts

    with open(os.path.join(work, "config.json")) as f:
        meta = json.load(f)
    meta["config"]["training"]["dtype"] = dtype
    if lr is not None:
        meta["config"]["training"]["optimizer"]["start_lr"] = lr
    if dropout is not None:
        meta["config"]["titanet"]["dropout"] = dropout
    cfg = Config.from_dict(meta["config"])
    data = np.load(os.path.join(work, "batches.npz"))
    n = DDP_RANKS * DDP_LOCAL_B
    rows = slice(None) if mesh is None else mesh.rows(n)
    if swap:
        rows = np.concatenate([np.arange(n // 2, n), np.arange(n // 2)])
    dev = torch.device("cuda") if mesh is None else mesh.device
    frontend = cli._frontend(cfg)
    _, _, state = cli._new_state(cfg, meta["n_speakers"], dev, DDP_STEPS)
    if mesh is not None:
        replicate_state(state, mesh)
    before = [p.detach().clone() for p in state.params()]
    names = [f"model.{n}" for n, _ in state.model.named_parameters()] + \
        [f"head.{n}" for n, _ in state.head.named_parameters()]
    batches = [tuple(torch.from_numpy(data[k][i][rows]).to(dev) for k in ("wav", "lengths", "speakers"))
               for i in range(DDP_STEPS)]
    counters = {"logmel": log_mel_fused, "pool_fwd": attentive_pool_fwd, "pool_bwd": attentive_pool_bwd,
                "dw_bwd": dwconv.dw_bwd}
    kept = {"pool": [], "dw": []}
    hooks = keep_pool_calls(state.model, kept["pool"]) + keep_dw_calls(state.model, kept["dw"]) \
        if dtype == "bfloat16" else []
    losses, norms, step_ms, collectives, first = [], [], [], None, None
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    for i, (wav, lengths, speakers) in enumerate(batches):
        if i == 1:
            reset_collective_stats()
        t0 = time.perf_counter()
        # eager in the one process too: the ranks' step (P > 1) runs eagerly,
        # and the first step's hooks keep its kernels' operands
        state, m = ts.train_step(state, wav, lengths, speakers, frontend=frontend, mesh=mesh, capture=False)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        if i == 0:
            first = [p.detach().cpu() for p in state.params()]
            for h in hooks:
                h.remove()
        if i == 1:
            collectives = collective_stats()
    counts = {k: c.launches for k, c in counters.items()}
    after = [p.detach() for p in state.params()]
    out = {"losses": losses, "grad_norms": norms, "step_ms": step_ms, "counts": counts,
           "collectives": collectives, "checksum": sum(float(p.double().abs().sum()) for p in after),
           "param_bytes": sum(p.numel() * p.element_size() for p in after),
           "names": names, "before": [p.cpu() for p in before], "first": first,
           "after": [p.cpu() for p in after]}
    if dtype != "bfloat16":
        return out
    # the held kernels: the log-mel kernel on each step's operands, then the
    # pool forward/backward and every dw_bwd launch of the first step
    mel_err, dmma_before = 0.0, log_mel_fused.dmma_launches
    for wav, lengths, _ in batches:
        args, kw = tf.log_mel_fused_operands(ts._dequantize_waveform(wav), frontend, lengths)
        mel = log_mel_fused(*args, **kw)
        err = (mel - log_mel_fused_plain(*args, n_frames=kw["n_frames"], hop=kw["hop"])).abs().max().item()
        if not torch.isfinite(mel).all() or err > 1e-4:
            raise AssertionError(f"data-parallel log-mel f32 {tuple(wav.shape)}: max abs err {err} > 1e-4")
        mel_err = max(mel_err, err)
    n_dw = sum(isinstance(m, SamePadConv1d) and m.groups > 1 for m in state.model.modules())
    if len(kept["pool"]) != 1 or "g" not in kept["pool"][0] or len(kept["dw"]) != n_dw:
        raise AssertionError(f"data-parallel step: kept {len(kept['pool'])} pool calls, {len(kept['dw'])} "
                             "depthwise convs")
    if log_mel_fused.dmma_launches - dmma_before != len(batches):
        raise AssertionError("data-parallel log-mel f32: not every launch ran logmel_dmma_kernel")
    out["checks"] = [f"log-mel f32 (logmel_dmma_kernel) on the {DDP_STEPS} steps' rows, max abs err {mel_err:.3e} "
                     "(atol 1e-4)", replay_pool(kept["pool"][0], "first step"),
                     replay_dw(kept["dw"], "the first step")]
    return out


def ddp_readings(a, one) -> dict:
    """Phase 17's readings of ``a`` vs ``one`` (each with ``losses``,
    ``grad_norms`` and the parameters ``before``, after the ``first`` step
    and ``after`` every step): relative loss and grad-norm differences at
    step 1 and the largest at steps 2..; the update difference over the
    largest update entry after step 1 and after every step."""
    rel = lambda k: [abs(x - y) / abs(y) for x, y in zip(a[k], one[k])]  # noqa: E731

    def update(key):
        diff = max(((x - x0) - (y - x0)).abs().max().item()
                   for x, y, x0 in zip(a[key], one[key], one["before"]))
        return diff / max((y - y0).abs().max().item() for y, y0 in zip(one[key], one["before"]))

    loss, norm = rel("losses"), rel("grad_norms")
    return {"loss_step1": loss[0], "grad_norm_step1": norm[0], "update_step1": update("first"),
            "loss_later": max(loss[1:]), "grad_norm_later": max(norm[1:]), "update_all": update("after")}


def ddp_rank_main(argv) -> int:
    """A rank of phase 17 (a): ``python3 chip_smoke.py --ddp-rank <rank>
    <port> <work dir>``. Joins the group through the launcher contract with
    gloo (both ranks drive cuda:0) and saves :func:`ddp_steps`' results,
    bf16 (the kernels' run), then f32."""
    import torch

    rank, port, work = int(argv[0]), argv[1], argv[2]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    os.environ.update(TITANET_COORDINATOR=f"127.0.0.1:{port}", TITANET_NUM_PROCESSES=str(DDP_RANKS),
                      TITANET_PROCESS_ID=str(rank), TITANET_DW_BWD="pallas", TITANET_DIST_TIMEOUT="300")
    from titanet_torch.parallel import make_mesh, maybe_initialize_distributed
    from titanet_torch.parallel.distributed import destroy_process_group

    if not maybe_initialize_distributed(verbose=False, backend="gloo"):
        raise RuntimeError("the launcher contract did not start a group")
    try:
        mesh = make_mesh(DDP_RANKS)
        torch.save({dt: ddp_steps(work, mesh, dt) for dt in ("bfloat16", "float32")},
                   os.path.join(work, f"rank{rank}.pt"))
    finally:
        destroy_process_group()
    return 0


def run_processes(cmds, envs, timeout: float, what: str) -> list:
    """Start every command at once and wait for all (``timeout`` s each);
    kills them all on a timeout. Raises on a timeout or a non-zero exit;
    returns their outputs."""
    procs = [subprocess.Popen(c, env=e, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=os.path.dirname(os.path.abspath(__file__))) for c, e in zip(cmds, envs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        tails = []
        for p in procs:
            p.kill()
            tails.append((p.communicate()[0] or "")[-2000:])
        raise AssertionError(f"{what}: a process did not finish within {timeout} s; their last output:\n"
                             + "\n---\n".join(tails))
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"{what}: exit code {p.returncode}:\n{out[-4000:]}")
    return outs


def parallel_phase(root: str, tag: str) -> dict:
    """Phase 17; raises on any failed check. Returns the kernel launches of
    rank 0's DDP_STEPS steps (``ddp_trainer_launches``)."""
    import numpy as np
    import torch

    from titanet_torch import cli
    from titanet_torch.parallel.distributed import free_port
    from titanet_torch.train import checkpoint as ckpt

    t_phase = time.perf_counter()
    work = os.path.join(root, "ddp")
    os.makedirs(work, exist_ok=True)
    # set-up: each rank's first DDP_STEPS batches of the round-robin sharded
    # train loader (shard r of 2, 32 rows); the global batch of a step is
    # rank 0's rows then rank 1's (with chunking the shards share one width)
    cfg = ddp_config(root, "ddp", batch_size=DDP_LOCAL_B)
    train_ds, val_ds, test_ds, n_speakers = cli._datasets(cfg, True)
    parts = []
    for r in range(DDP_RANKS):
        loader = cli._loaders(cfg, train_ds, val_ds, test_ds, None, shard=(r, DDP_RANKS))[0]
        loader.set_epoch(1)
        it = iter(loader)
        parts.append([next(it) for _ in range(DDP_STEPS)])
    np.savez(os.path.join(work, "batches.npz"),
             wav=np.stack([np.concatenate([p[i].waveform for p in parts]) for i in range(DDP_STEPS)]),
             lengths=np.stack([np.concatenate([p[i].lengths for p in parts]) for i in range(DDP_STEPS)]),
             speakers=np.stack([np.concatenate([p[i].speaker_ids for p in parts]) for i in range(DDP_STEPS)]))
    with open(os.path.join(work, "config.json"), "w") as f:
        json.dump({"config": cfg.to_dict(), "n_speakers": n_speakers}, f)

    # (a) one process fed the 64 rows (twice in f32, and once at learning
    # rate 0: what a rank that never applies its update reads; with dropout
    # 0 once as fed and once with the halves of each batch swapped: the
    # model's own rounding spread), then the two ranks on the same card;
    # cuDNN deterministic in every process
    os.environ["TITANET_DW_BWD"] = "pallas"
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        refs = {dt: ddp_steps(work, dtype=dt) for dt in ("bfloat16", "float32")}
        again = ddp_steps(work, dtype="float32")
        frozen = ddp_steps(work, dtype="float32", lr=0.0)
        unswapped, swapped = (ddp_steps(work, dtype="float32", dropout=0.0, swap=sw) for sw in (False, True))
    finally:
        torch.backends.cudnn.deterministic = deterministic
        os.environ.pop("TITANET_DW_BWD", None)
    port = free_port()
    t0 = time.perf_counter()
    run_processes([[sys.executable, os.path.abspath(__file__), "--ddp-rank", str(r), str(port), work]
                   for r in range(DDP_RANKS)], [dict(os.environ)] * DDP_RANKS, 600, "data-parallel ranks")
    ranks_wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False) for r in range(DDP_RANKS)]
    got, ref = [r["bfloat16"] for r in ranks], refs["bfloat16"]
    for r, g in enumerate(got):
        for line in g["checks"]:
            print(f"data-parallel rank {r} kernels vs plain: {line} {tag}")
    expect = {"logmel": DDP_STEPS, "pool_fwd": DDP_STEPS, "pool_bwd": DDP_STEPS, "dw_bwd": 51 * DDP_STEPS}
    for who, counts in [("one process", ref["counts"])] + [(f"rank {r}", g["counts"]) for r, g in enumerate(got)]:
        if counts != expect:
            raise AssertionError(f"data-parallel {who}: launches {counts}, expected {expect}")

    for dt in ("bfloat16", "float32"):
        a, b = ranks[0][dt], ranks[1][dt]
        if a["checksum"] != b["checksum"] or any(not torch.equal(x, y) for x, y in zip(a["after"], b["after"])):
            raise AssertionError(f"data-parallel {dt}: the ranks' parameters differ ({a['checksum']!r} vs "
                                 f"{b['checksum']!r})")
        if not all(torch.equal(x, y) for x, y in zip(a["before"], refs[dt]["before"])):
            raise AssertionError(f"data-parallel {dt}: the ranks did not start from the one process's weights")
    one = refs["float32"]
    if again["losses"] != one["losses"] or not all(torch.equal(x, y) for x, y in zip(again["after"], one["after"])):
        raise AssertionError("data-parallel (a): the one process differs from itself under cuDNN's "
                             f"deterministic algorithms ({again['losses']} vs {one['losses']})")
    f32, idle, spread = (ddp_readings(ranks[0]["float32"], one), ddp_readings(frozen, one),
                         ddp_readings(swapped, unswapped))
    b_loss = max(abs(x - y) / abs(y) for x, y in zip(got[0]["losses"], ref["losses"]))
    col = got[0]["collectives"]
    sites = col["by_kind"]["batchnorm"]["count"]
    med = lambda xs: statistics.median(xs[1:])  # noqa: E731  (the first step warms up)
    fmt = lambda d: ", ".join(f"{k} {v:.3e}" for k, v in d.items())  # noqa: E731
    print(f"data-parallel (a) 2 ranks x {DDP_LOCAL_B} rows on one card (gloo) vs one process x "
          f"{DDP_RANKS * DDP_LOCAL_B} rows, TitaNet-S 17 blocks, dropout 0.5, SGD {DDP_LR}, {DDP_STEPS} steps, "
          f"same start weights, cuDNN deterministic: bf16 losses ranks {got[0]['losses']} / {got[1]['losses']} "
          f"vs one process {ref['losses']} (largest relative difference {b_loss:.3e}, limit "
          f"{DDP_BF16_LOSS_RTOL}); rank checksums {got[0]['checksum']!r} and {got[1]['checksum']!r} (equal "
          f"bits) {tag}")
    print(f"data-parallel (a) f32, the same steps (the pool kernel is bf16-only): losses ranks "
          f"{ranks[0]['float32']['losses']} vs one process {one['losses']}; grad norms "
          f"{ranks[0]['float32']['grad_norms']} vs {one['grad_norms']}; the ranks read {fmt(f32)}; limits "
          f"{fmt(DDP_F32_LIMITS)}; a rank that never updates (the one process at learning rate 0) reads "
          f"{fmt(idle)}; the one process with dropout 0 fed each batch with its halves swapped vs as fed (the model's "
          f"rounding spread) reads {fmt(spread)}; the one process run again: equal bits; rank checksums equal "
          f"bits {tag}")
    print(f"data-parallel (a) collectives a step (rank 0): {col['count']} all-reduces, {col['bytes']} B "
          f"({sites} BatchNorm sites: {sites} forward + {col['by_kind']['batchnorm_backward']['count']} "
          f"backward, {col['by_kind']['batchnorm']['bytes'] + col['by_kind']['batchnorm_backward']['bytes']} B; "
          f"gradient bucket {col['by_kind']['gradients']['count']} x {col['by_kind']['gradients']['bytes']} B = "
          f"the {got[0]['param_bytes']} parameter bytes; loss {col['by_kind']['loss']['count']}) beside the JAX "
          f"dry run at its own shape (n_mega_blocks 2, hidden 32: {JAX_DRYRUN['all_reduce']} all-reduces, "
          f"{JAX_DRYRUN['bytes']} B, parameters {JAX_DRYRUN['param_bytes']} B) {tag}")
    print(f"data-parallel (a) bf16 step ms (median of steps 2-{DDP_STEPS}): rank 0 {med(got[0]['step_ms']):.1f}, "
          f"rank 1 {med(got[1]['step_ms']):.1f} (two ranks sharing the card, gloo through the host) vs one "
          f"process {med(ref['step_ms']):.1f} on the 64 rows; ranks' wall {ranks_wall:.1f} s with start-up {tag}")
    if col["by_kind"]["gradients"]["bytes"] != got[0]["param_bytes"]:
        raise AssertionError(f"gradient bucket {col['by_kind']['gradients']} vs {got[0]['param_bytes']} B")
    # a limit that a rank which never updates would meet holds nothing (the
    # step-1 loss and grad norm come before any update: they hold the
    # gradient, and such a rank reads 0 there)
    blind = [k for k in ("update_step1", "loss_later", "grad_norm_later", "update_all")
             if DDP_F32_LIMITS[k] >= idle[k]]
    if blind:
        raise AssertionError(f"data-parallel (a): the limits {blind} would pass a rank that never updates "
                             f"({fmt(idle)})")
    over = [k for k, v in f32.items() if not v <= DDP_F32_LIMITS[k]]
    if over or not b_loss <= DDP_BF16_LOSS_RTOL:
        raise AssertionError(f"data-parallel (a): the ranks' steps differ from the one process's beyond the "
                             f"limits (f32 {over}, bf16 loss {b_loss:.3e})")

    # (b) the CLI under the launcher contract (world size 1, NCCL) vs without
    runs = {"host": ddp_config(root, "cli-host"), "dc": ddp_config(root, "cli-dc", device_corpus=True)}
    results = {}
    for contract in (True, False):
        paths = []
        for kind, c in runs.items():
            d = c.to_dict()
            d["training"]["run_name"] = f"{d['training']['run_name']}-{'contract' if contract else 'plain'}"
            paths.append(os.path.join(work, d["training"]["run_name"] + ".json"))
            with open(paths[-1], "w") as f:
                json.dump(d, f)
        env = dict(os.environ, TITANET_DW_BWD="pallas")
        if contract:
            env.update(TITANET_COORDINATOR=f"127.0.0.1:{free_port()}", TITANET_NUM_PROCESSES="1",
                       TITANET_PROCESS_ID="0")
        # cuDNN's deterministic algorithms: a nondeterministic weight
        # gradient would part two processes whatever the contract
        code = ("import sys, torch; from titanet_torch import cli; torch.backends.cudnn.deterministic = True; "
                "[cli.main(['train', '-p', p]) for p in sys.argv[1:]]")
        t0 = time.perf_counter()
        out = run_processes([[sys.executable, "-c", code, *paths]], [env], 600, "data-parallel CLI")[0]
        results[contract] = time.perf_counter() - t0
        if contract and "[distributed] rank 0/1 up (nccl)" not in out:
            raise AssertionError(f"the launcher contract did not start an NCCL group:\n{out[-2000:]}")
    lines = []
    for kind, c in runs.items():
        a, b = (os.path.join(root, f"{c.training.run_name}-{w}") for w in ("contract", "plain"))
        ra, rb = read_jsonl(os.path.join(a, "metrics.jsonl")), read_jsonl(os.path.join(b, "metrics.jsonl"))
        strip = lambda recs: [{k: v for k, v in r.items() if k != "ts" and "time" not in k} for r in recs]  # noqa: E731
        ca, cb = ckpt.read_checkpoint(a, 1), ckpt.read_checkpoint(b, 1)
        same = strip(ra) == strip(rb) and all(torch.equal(ca[p][k], cb[p][k]) for p in ("model", "head")
                                              for k in cb[p])
        if not same:
            raise AssertionError(f"data-parallel (b) {kind}: the epoch under the launcher contract differs from "
                                 f"the epoch without it: {strip(ra)} vs {strip(rb)}")
        tr = [epoch_record(r, 1, "train/") for r in (ra, rb)]
        steps = len(train_ds) // TRAIN_BATCH
        lines.append(f"{kind}: identical bits (metrics and epoch-1 checkpoint), train/avg_loss "
                     f"{tr[0]['train/avg_loss']:.4f}; model ms a step {tr[0]['train/total_model_time'] / steps * 1e3:.1f} "
                     f"with the contract vs {tr[1]['train/total_model_time'] / steps * 1e3:.1f} without")
    print(f"data-parallel (b) python -m titanet_torch train under TITANET_COORDINATOR/NUM_PROCESSES=1/"
          f"PROCESS_ID=0 (NCCL, world size 1) vs without, one epoch of {len(train_ds) // TRAIN_BATCH} steps: "
          f"{'; '.join(lines)}; process wall {results[True]:.1f} s vs {results[False]:.1f} s {tag}")
    print(f"data-parallel phase: {time.perf_counter() - t_phase:.1f} s wall {tag}")
    return got[0]["counts"]


# Capture phase (18): the steps the JAX package jits, as CUDA graphs
# (titanet_torch/train/capture.py), on TitaNet-S at full width (17
# mega-blocks, hidden 256, weights from seed 0) at B=128 x 3 s; each graph
# against the same step run eagerly (capture=False) in the same process.
CAPTURE_CALLS = 20  # timed calls of each route, graph and eager interleaved
# the runtime calls that launch work on the device, as the profiler names them
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
               "cudaMemcpyAsync", "cudaMemsetAsync")


def host_launches(fn, iters: int = 3) -> dict:
    """The host's launch calls (``LAUNCH_APIS``) a call of ``fn`` makes, by
    name, from a profiler trace of ``iters`` calls after one warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in LAUNCH_APIS:
            counts[e.name] = counts.get(e.name, 0) + 1
    return {k: v / iters for k, v in sorted(counts.items())}


class _KeepCall:
    """A kernel wrapper that keeps each call made while the current stream
    captures: its arguments by reference (a parameter cloned, inside the
    capture: a train step updates it after the kernel read it) and its
    output. ``launches`` reads and writes the wrapped function's counter,
    which the wrapper's own body increments through the module's name."""

    def __init__(self, fn, kept: list):
        self.fn, self.kept = fn, kept

    launches = property(lambda self: self.fn.launches, lambda self, v: setattr(self.fn, "launches", v))

    def __call__(self, *args):
        import torch

        out = self.fn(*args)
        if torch.cuda.is_current_stream_capturing():
            self.kept.append((tuple(a.detach().clone() if isinstance(a, torch.nn.Parameter) else a for a in args),
                              out))
        return out


class graph_operands:
    """While steps are captured, keeps what each launch of rows 1-4 in them
    was given and gave, at the names the path looks the kernels up by
    (``frontend._log_mel_fused``; ``attentive_pool_fwd``,
    ``attentive_pool_bwd`` and ``dw_bwd`` in their modules, where the
    autograd functions find them), by reference: a copy would be captured
    too. These are tensors of the graphs, which every replay rewrites:
    :meth:`snapshot` after a replay clones them into the records that
    :func:`hold_graph_kernels` and :func:`hold_train_graph_kernels` replay."""

    def __enter__(self):
        from titanet_torch.ops import frontend
        from titanet_torch.ops.kernels import dwconv
        from titanet_torch.ops.kernels import pool as pk

        self.kept = {"mel": [], "pool_fwd": [], "pool_bwd": [], "dw": []}
        self._saved = []
        for mod, name, key in ((frontend, "_log_mel_fused", "mel"), (pk, "attentive_pool_fwd", "pool_fwd"),
                               (pk, "attentive_pool_bwd", "pool_bwd"), (dwconv, "dw_bwd", "dw")):
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, _KeepCall(fn, self.kept[key]))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        return False

    def snapshot(self) -> dict:
        """Each kernel's calls as the last replays left them: ``mel`` as
        records of :func:`replay_mel`, the others ``(args, out)``."""
        import torch

        clone = lambda t: t.clone() if isinstance(t, torch.Tensor) else t  # noqa: E731
        out = {k: [(tuple(map(clone, a)), tuple(map(clone, o)) if isinstance(o, tuple) else clone(o))
                   for a, o in v] for k, v in self.kept.items()}
        out["mel"] = [dict(waveform=a[0], cfg=a[1], lengths=a[2], out=o) for a, o in out["mel"]]
        return out


def hold_graph_kernels(snap: dict, what: str, mel_dtype, n_pool: int, n_mel: int = 1) -> str:
    """Every log-mel and pool-forward launch of the graphs in ``snap``
    (:meth:`graph_operands.snapshot`), replayed on those graphs' operands:
    ``n_mel`` log-mel (``mel_dtype``; phase 2's tolerances) and ``n_pool``
    pool forwards (phase 3's). Each replay must give the graph's output bit
    for bit. Raises on a miss; returns the summary."""
    if len(snap["mel"]) != n_mel or len(snap["pool_fwd"]) != n_pool:
        raise AssertionError(f"{what}: the graphs hold {len(snap['mel'])} log-mel and {len(snap['pool_fwd'])} "
                             f"pool-forward calls, expected {n_mel} and {n_pool}")
    err, _, widths = replay_mel(snap["mel"], what, mel_dtype)
    line = f"log-mel on the graph's operands {sorted(widths)} max abs err {err:.3e}"
    for args, out in snap["pool_fwd"]:
        perr = pool_fwd_vs_plain(args[:7], args[7], args[8], out, f"{what}: pool forward")
        line += f", pool forward {tuple(args[0].shape)} max abs err {perr:.3e}"
    return line + ", each the graph's output bit for bit"


def capture_phase(root: str, n_speakers: int, tag: str) -> dict:
    """Phase 18: (a) ``embed_step`` bf16 and f32, unmasked and masked, and
    ``embed_step_quantized``, each through its CUDA graph against
    ``capture=False``: equal bits on the capture call and on replays of new
    inputs, median wall ms of graph and eager calls in turns, device ms,
    idle share, kernels and host launch calls a call, the capture's seconds
    and its graph pool's bytes; (b) ``SpeakerEmbedder`` at the service's
    buckets and at the default ten: ``warmup()``'s seconds and the pool's
    bytes after each bucket, then phase 5's requests through the graphs
    against an eager embedder, equal bits; (c) ``eval_step`` on phase 13's
    validation batches with run A, equal bits; (d) inside (a)-(c) every
    log-mel and pool-forward launch of each graph replayed on that graph's
    operands against its plain version; (e) a second process reuses the
    kernels a first one built into ``enable_compilation_cache``'s
    directory and runs no ``nvcc``. Every measured graph is captured into a
    ``StepGraphs`` of its own, so its pool holds only its memory. Returns
    the log-mel and pool-forward launches a captured call of each path
    counted (replay-aware counters)."""
    import numpy as np
    import torch

    from titanet_torch import cli, serve
    from titanet_torch.models import get_titanet
    from titanet_torch.models.quantized import quantize_titanet
    from titanet_torch.ops import frontend as tf
    from titanet_torch.ops.kernels.melspec import log_mel_fused
    from titanet_torch.ops.kernels.pool import attentive_pool_fwd
    from titanet_torch.train import capture, loop
    from titanet_torch.train import state as ts
    from titanet_torch.train.extractor import SpeakerEmbedder, geometric_buckets, row_classes, rows_for

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(18)
    n = SECONDS * SR
    wavs = [torch.from_numpy((rng.standard_normal((B, n)) * 0.1).astype(np.float32)).to(dev) for _ in range(2)]
    full = torch.full((B,), n, dtype=torch.int32, device=dev)
    ragged = torch.from_numpy(rng.integers(SR // 2, n + 1, B).astype(np.int32)).to(dev)
    cfg32 = tf.FrontendConfig.from_ms(use_pallas_fused=True)
    cfg16 = cfg32._replace(precision="default")
    m16 = get_titanet(n_mega_blocks=17, dtype=torch.bfloat16, device=dev, generator=torch.Generator().manual_seed(0))
    m32 = get_titanet(n_mega_blocks=17, device=dev, generator=torch.Generator().manual_seed(0))
    qtree = quantize_titanet(m32)
    graph_launches = {"logmel": {}, "pool_fwd": {}}

    def own_graphs():
        """A fresh graph cache for the steps (its own pool), restored by the caller."""
        graphs = capture.StepGraphs()
        ts.GRAPHS = graphs
        return graphs

    # (a) the serving steps
    variants = (
        ("embed_step bf16", lambda c, w, ln: ts.embed_step(m16, w, ln, frontend=cfg16, device=dev, capture=c),
         full, torch.bfloat16, 1),
        ("embed_step bf16 masked", lambda c, w, ln: ts.embed_step(m16, w, ln, frontend=cfg16, masked=True,
                                                                  device=dev, capture=c), ragged, torch.bfloat16, 0),
        ("embed_step f32", lambda c, w, ln: ts.embed_step(m32, w, ln, frontend=cfg32, device=dev, capture=c),
         full, torch.float32, 0),
        ("embed_step f32 masked", lambda c, w, ln: ts.embed_step(m32, w, ln, frontend=cfg32, masked=True,
                                                                 device=dev, capture=c), ragged, torch.float32, 0),
        ("embed_step_quantized", lambda c, w, ln: ts.embed_step_quantized(qtree, w, ln, frontend=cfg32, device=dev,
                                                                          capture=c), full, torch.float32, 0),
    )
    try:
        for label, step, lens, mel_dt, n_pool in variants:
            graphs = own_graphs()
            with graph_operands() as ops:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                first = step(None, wavs[0], lens)
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
            if graphs.captures != 1 or len(graphs) != 1:
                raise AssertionError(f"capture {label}: {graphs.captures} captures, {len(graphs)} graphs")
            entry, pool_b = graphs.graphs()[0], graphs.pool_bytes()
            equal = [torch.equal(first, step(False, wavs[0], lens))]
            for w in wavs + wavs:
                equal.append(torch.equal(step(None, w, lens), step(False, w, lens)))
            if not all(equal):
                raise AssertionError(f"capture {label}: graph vs eager bits {equal}")
            log_mel_fused.launches = log_mel_fused.tc_launches = log_mel_fused.dmma_launches = 0
            attentive_pool_fwd.launches = 0
            for w in wavs:
                step(None, w, lens)
            torch.cuda.synchronize()
            counts = {"logmel": log_mel_fused.launches / 2, "pool_fwd": attentive_pool_fwd.launches / 2,
                      "logmel on its tensor-core route": (log_mel_fused.tc_launches if mel_dt == torch.bfloat16
                                                          else log_mel_fused.dmma_launches) / 2}
            if counts != {"logmel": 1, "pool_fwd": n_pool, "logmel on its tensor-core route": 1}:
                raise AssertionError(f"capture {label}: launches a replay {counts}")
            graph_launches["logmel"][label], graph_launches["pool_fwd"][label] = 1, n_pool
            held = hold_graph_kernels(ops.snapshot(), f"capture {label}", mel_dt, n_pool)
            times = {"graph": [], "eager": []}
            for i in range(CAPTURE_CALLS):
                for route in (("graph", "eager") if i % 2 == 0 else ("eager", "graph")):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(None if route == "graph" else False, wavs[i % 2], lens)
                    torch.cuda.synchronize()
                    times[route].append((time.perf_counter() - t0) * 1e3)
            parts = []
            for route, c in (("graph", None), ("eager", False)):
                call = lambda: step(c, wavs[1], lens)  # noqa: E731
                dms, busy, n_k, timed_by = device_profile(call, iters=5, warmup=1)
                api = host_launches(call)
                med = statistics.median(times[route])
                parts.append(f"{route}: median {med:.3f} ms (min {min(times[route]):.3f}, max "
                             f"{max(times[route]):.3f}), device {dms:.3f} ms ({timed_by}), idle share "
                             f"{1 - busy / med:.3f}, {n_k} kernels a call, host launch calls a call {api}")
            print(f"capture {label} (TitaNet-S 17 blocks, B={B} x {SECONDS} s): graph == eager to the bit on the "
                  f"capture call and on 4 replays of 2 inputs; launches a replay {counts}; {held}; first call "
                  f"{first_s * 1e3:.1f} ms (warm-up and capture), capture {entry.capture_s * 1e3:.1f} ms, graph "
                  f"pool {pool_b / 2**20:.1f} MiB; {CAPTURE_CALLS} calls each, in turns: {' | '.join(parts)} {tag}")
            del graphs, entry, ops
    finally:
        ts.GRAPHS = capture.GRAPHS
    del qtree, m32
    torch.cuda.empty_cache()

    # (b) SpeakerEmbedder: the service's 4 buckets (batch 8, --fast-frontend's
    # bf16 log-mel) and the default 10 (batch 32), then phase 5's requests
    reqs = [(rng.standard_normal(int(s * SR)) * 0.1).astype(np.float32) for s in (1.2, 3, 7, 40)]
    parser_default = serve.build_parser().parse_args([]).batch_size
    for what, buckets, bs in (("service", list(serve.BUCKETS), parser_default),
                              ("default", geometric_buckets(), 32)):
        graphs = own_graphs()
        try:
            embedder = SpeakerEmbedder(m16, cfg16, buckets=buckets, batch_size=bs, device=dev)
            eager = SpeakerEmbedder(m16, cfg16, buckets=buckets, batch_size=bs, device=dev, capture=False)
            marks, padded = [], embedder._embed_padded

            def timed(group, bucket, _padded=padded):
                t1 = time.perf_counter()
                out = _padded(group, bucket)
                marks.append((bucket, rows_for(len(group), bs), time.perf_counter() - t1, graphs.pool_bytes()))
                return out

            embedder._embed_padded = timed
            t0 = time.perf_counter()
            embedder.warmup()
            warm_s = time.perf_counter() - t0
            del embedder._embed_padded
            shapes = len(buckets) * len(row_classes(bs))
            if graphs.captures != shapes:
                raise AssertionError(f"SpeakerEmbedder {what}: warmup captured {graphs.captures} graphs for "
                                     f"{len(buckets)} buckets x row classes {row_classes(bs)}")
            got = [embedder.embed(reqs), embedder.embed(reqs[::-1])]
            want = [eager.embed(reqs), eager.embed(reqs[::-1])]
            if graphs.captures != shapes or not all(np.array_equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"SpeakerEmbedder {what}: graph vs eager bits differ or a request captured "
                                     f"({graphs.captures} captures)")
            log_mel_fused.launches = 0
            embedder.embed(reqs)
            graph_launches["logmel"][f"SpeakerEmbedder {what}"] = log_mel_fused.launches
            steps = [f"{b} x {r}: {s * 1e3:.1f} ms, pool {p / 2**20:.1f} MiB" for b, r, s, p in marks]
            print(f"capture SpeakerEmbedder {what} buckets ({len(buckets)}, batch {bs}, bf16 fused log-mel): "
                  f"warmup() {warm_s:.3f} s, one graph a bucket and row class ({'; '.join(steps)}); pool after "
                  f"warmup "
                  f"{graphs.pool_bytes() / 2**20:.1f} MiB; phase 5's requests (1.2/3/7/40 s, both orders) equal "
                  f"to an eager embedder's to the bit, no capture at a request; {log_mel_fused.launches} log-mel "
                  f"launches a request set (replay-aware counters) {tag}")
            del embedder, eager, graphs
        finally:
            ts.GRAPHS = capture.GRAPHS
        torch.cuda.empty_cache()
    del m16

    # (c) eval_step on phase 13's validation batches, run A as served
    cfg = trainer_config(root, "a-pallas", SERVE_EPOCHS, ("chunk", "specaugment", "noise"))
    state, frontend, epoch = cli._restore_for_eval(cfg, n_speakers, os.path.join(root, "a-pallas"), None, "cuda")
    train_ds, val_ds, test_ds, _ = cli._datasets(cfg, True)
    val_loader = cli._loaders(cfg, train_ds, val_ds, test_ds, None)[1]
    batches = list(loop._staged_batches(val_loader, dev))
    graphs = own_graphs()
    try:
        held, shapes = [], set()
        for (wav, lengths, speakers), _ in batches:
            with graph_operands() as ops:
                first = ts.eval_step(state, wav, lengths, speakers, frontend=frontend)
            outs = [first, ts.eval_step(state, wav, lengths, speakers, frontend=frontend)]
            ref = ts.eval_step(state, wav, lengths, speakers, frontend=frontend, capture=False)
            for out in outs:
                if any(not torch.equal(out[k], ref[k]) for k in ("loss", "preds", "embeddings")):
                    raise AssertionError(f"capture eval_step on a validation batch {tuple(wav.shape)}: graph vs "
                                         "eager bits differ")
            if ops.kept["mel"]:
                held.append(hold_graph_kernels(ops.snapshot(), f"capture eval_step {tuple(wav.shape)}",
                                               torch.float32, 1))
            shapes.add(tuple(wav.shape))
        if graphs.captures != len(shapes):
            raise AssertionError(f"capture eval_step: {graphs.captures} graphs for shapes {sorted(shapes)}")
        print(f"capture eval_step (run A epoch {epoch}, phase 13's {len(batches)} validation batches, shapes "
              f"{sorted(shapes)}): loss, preds and embeddings equal to eager to the bit, {graphs.captures} graphs "
              f"(one a batch shape), pool {graphs.pool_bytes() / 2**20:.1f} MiB; {'; '.join(held)} {tag}")
        graph_launches["logmel"]["eval_step"] = graph_launches["pool_fwd"]["eval_step"] = 1
    finally:
        ts.GRAPHS = capture.GRAPHS
    del state, batches, graphs
    torch.cuda.empty_cache()

    # (e) the compilation cache across processes
    from titanet_torch.ops.kernels import _build
    from titanet_torch.utils import enable_compilation_cache

    cache = os.path.join(root, "kernel_cache")
    default_dir = _build.BUILD_DIR
    try:
        enable_compilation_cache(cache)
        t0 = time.perf_counter()
        built = _build.build()
        first_s = time.perf_counter() - t0
    finally:
        _build.set_build_dir(default_dir)
    child = ("import json, sys, time; sys.path.insert(0, sys.argv[2]); "
             "from titanet_torch.ops.kernels import _build; from titanet_torch.utils import enable_compilation_cache\n"
             "def no_nvcc():\n    raise RuntimeError('nvcc ran')\n"
             "_build.nvcc = no_nvcc; enable_compilation_cache(sys.argv[1]); t0 = time.perf_counter()\n"
             "built = _build.build(); load = {}\n"
             "for name in _build.SOURCES:\n    t1 = time.perf_counter(); _build.load(name); load[name] = time.perf_counter() - t1\n"
             "print(json.dumps({'nvcc_runs': len(built), 'build_s': time.perf_counter() - t0, 'load_s': load, "
             "'dir': str(_build.BUILD_DIR)}))")
    out = subprocess.run([sys.executable, "-c", child, cache, os.path.dirname(os.path.abspath(__file__))],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"compilation cache: the second process failed: {out.stderr[-2000:]}")
    second = json.loads(out.stdout.strip().splitlines()[-1])
    if second["nvcc_runs"] != 0 or sorted(second["load_s"]) != sorted(_build.SOURCES) \
            or os.path.realpath(second["dir"]) != os.path.realpath(cache):
        raise AssertionError(f"compilation cache: {second}")
    print(f"compilation cache: the first process built {len(built)} libraries into "
          f"enable_compilation_cache's directory in {first_s:.2f} s ({sorted(built)}); a second process "
          f"({sys.executable} -c) ran {second['nvcc_runs']} nvcc, build() {second['build_s']:.3f} s, loaded "
          f"{ {k: round(v, 4) for k, v in second['load_s'].items()} } s {tag}")
    print(f"capture phase: {time.perf_counter() - t_phase:.1f} s wall {tag}")
    return graph_launches


# Train-step capture phase (19): the JAX package's jitted, donated train
# step as one CUDA graph a step shape (titanet_torch/train/state.py), and
# the mega-blocks' rematerialization, on TitaNet-S at full width (17
# mega-blocks, hidden 256, epilog 1536, embedding 192), bf16, dropout 0.5,
# CE over TRAIN_CLASSES classes, Adam 1e-3 with clipping at 1.0, a linear
# warm-up over 2 steps and a cosine after it, a weight EMA, at B=128 x 3 s.
TRAIN_CLASSES = 251
TRAIN_GRAPH_STEPS = 5  # steps of each route in (a), from one initial state
TRAIN_TURNS = 20  # timed steps of each route in (b), graph and eager in turns


def train_capture_state(dev, *, head: str = "ce", accumulate: int = 1, batch: int = B, remat: bool = False,
                        remat_policy=None, axis_name=None, dtype: str = "bfloat16", sgd_lr=None):
    """Phase 19's train state, from seeds: weights 0, head 1, generators 0
    (phase 20: ``axis_name`` for the shard_map rule, ``dtype``, and SGD at
    ``sgd_lr`` in place of Adam when given)."""
    import torch

    from titanet_torch.losses.heads import build_head
    from titanet_torch.models import common
    from titanet_torch.models.titanet import TitaNet
    from titanet_torch.train import state as ts

    model = common.finish(TitaNet(n_mega_blocks=17, dropout=0.5, dtype=getattr(torch, dtype), remat=remat,
                                  remat_policy=remat_policy, axis_name=axis_name), dev,
                          torch.Generator().manual_seed(0))
    hd = build_head(head, 192, TRAIN_CLASSES, device=dev, generator=torch.Generator().manual_seed(1))
    if sgd_lr is not None:
        opt = ts.make_optimizer(name="sgd", start_lr=sgd_lr, accumulate_steps=accumulate)
    else:
        opt = ts.make_optimizer(start_lr=1e-3, scheduler=True, end_lr=1e-5, total_epochs=4, steps_per_epoch=2,
                                warmup_epochs=1, grad_clip_norm=1.0, accumulate_steps=accumulate)
    return ts.create_train_state(model, hd, opt, seed=0, ema=True)


def state_record(st) -> dict:
    """Every tensor a train step advances (parameters, running statistics,
    Adam's moments, the accumulator, the weight EMA), cloned, and the
    counters and each generator's state."""
    opt = st.opt_state
    rec = {f"model.{k}": v.detach().clone() for k, v in st.model.state_dict().items()}
    rec.update({f"head.{k}": v.detach().clone() for k, v in st.head.state_dict().items()})
    for name in ("mu", "nu", "acc"):
        rec.update({f"opt.{name}.{i}": t.clone() for i, t in enumerate(getattr(opt, name) or [])})
    rec.update({f"ema.{i}": t.clone() for i, t in enumerate(st.ema or [])})
    rec["counters"] = (st.step, opt.count, opt.mini_step)
    rec.update({f"generator.{k}": g.get_state() for k, g in st.generators().items()})
    return rec


def record_diff(got: dict, ref: dict) -> tuple:
    """``(tensors that differ, largest difference relative to the
    reference tensor's largest entry)`` over two records of :func:`state_record`
    and step metrics; generator states and counters must be equal."""
    import torch

    n, worst = 0, 0.0
    for k, r in ref.items():
        g = got[k]
        if k == "counters":
            if g != r:
                raise AssertionError(f"counters (step, count, mini_step) {g} != {r}")
        elif k.startswith("generator."):
            if not torch.equal(g, r):
                raise AssertionError(f"{k}: the generator's state differs")
        elif not torch.equal(g, r):
            n += 1
            worst = max(worst, ((g.float() - r.float()).abs().max() / r.float().abs().max().clamp(min=1e-30)).item())
    return n, worst


def train_graph_run(make_state, capture, steps: int, inputs: dict, step_kw: dict, graphs=None) -> tuple:
    """``steps`` train steps from ``make_state()``: (:func:`state_record`
    after them with every step's loss and grad norm, the graph cache's
    captures). ``graphs``: the cache the captured route uses."""
    import torch

    from titanet_torch.train import capture as cap
    from titanet_torch.train import state as ts

    st = make_state()
    metrics = {}
    ts.GRAPHS = graphs if graphs is not None else cap.StepGraphs()
    try:
        for i in range(steps):
            st, m = ts.train_step(st, **inputs, **step_kw, capture=capture)
            metrics[f"loss.{i}"], metrics[f"grad_norm.{i}"] = m["loss"].clone(), m["grad_norm"].clone()
        torch.cuda.synchronize()
        captures = ts.GRAPHS.captures
    finally:
        ts.GRAPHS = cap.GRAPHS
    rec = state_record(st)
    rec.update(metrics)
    del st
    return rec, captures


def hold_train_graph_kernels(ops: "graph_operands", what: str, n_graphs: int = 1, n_pool: int = 1,
                             n_dw: int = 51) -> str:
    """Every launch of rows 1-4 in ``n_graphs`` train steps' graphs (each
    one f32 log-mel, ``n_pool`` pool forwards and backwards and ``n_dw``
    ``dw_bwd`` calls), replayed on the operands their last replays left,
    against the graph's output (bit for bit) and its plain version: the
    log-mel and the pool forward as :func:`hold_graph_kernels` holds them,
    the pool backward at phase 6's limit (2e-2 of each gradient's largest
    entry), each ``dw_bwd`` at phase 7's (3e-2). Raises on a miss; returns
    the summary."""
    import torch

    from titanet_torch.ops.kernels import dwconv
    from titanet_torch.ops.kernels import pool as pk

    snap = ops.snapshot()
    if len(snap["pool_bwd"]) != n_graphs * n_pool or len(snap["dw"]) != n_graphs * n_dw:
        raise AssertionError(f"{what}: the graphs hold {len(snap['pool_bwd'])} pool-backward and "
                             f"{len(snap['dw'])} dw_bwd calls, expected {n_graphs * n_pool} and {n_graphs * n_dw}")
    line = hold_graph_kernels(snap, what, torch.float32, n_graphs * n_pool, n_graphs)
    errs = {}
    for args, out in snap["pool_bwd"]:
        got = pk.attentive_pool_bwd(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, out)):
            raise AssertionError(f"{what}: the pool backward's replay differs from the graph's output")
        for k, v in pool_bwd_errors(got, pk.attentive_pool_bwd_plain(*args), args[-1], 2e-2,
                                    f"{what}: pool backward").items():
            errs[k] = max(errs.get(k, 0.0), v)
    if errs:
        line += f"; pool backward error / max {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} (2e-2)"
    worst = {"dx": 0.0, "dk": 0.0, "db": 0.0}
    for (x, w, dy), out in snap["dw"]:
        got, ref = dwconv.dw_bwd(x, w, dy), dwconv.dw_bwd_plain(x, w, dy)
        if not all(torch.equal(a, b) for a, b in zip(got, out)):
            raise AssertionError(f"{what}: a dw_bwd replay {tuple(x.shape)} differs from the graph's output")
        for gname, a, r in zip(worst, got, ref):
            e = (a.float() - r.float()).abs().max().item() / r.float().abs().max().item()
            if not torch.isfinite(a).all() or e > 3e-2:
                raise AssertionError(f"{what}: dw_bwd {tuple(x.shape)} {gname} error / max {e} > 3e-2")
            worst[gname] = max(worst[gname], e)
    if snap["dw"]:
        line += (f"; all {len(snap['dw'])} dw_bwd launches {tuple(snap['dw'][0][0][0].shape)}: worst error / max "
                 f"{json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})} (3e-2)")
    return line


def train_capture_phase(tag: str) -> dict:
    """Phase 19: (a) each case's ``TRAIN_GRAPH_STEPS`` captured train steps
    against as many ``capture=False`` steps from the same initial state,
    after two eager runs against each other: losses, grad norms, every
    parameter, running statistic, Adam moment, weight EMA, the counters
    and each generator's state; (b) graph and eager in turns: wall, device
    time, idle share, host launch calls a step, capture seconds and the
    graph pool's MiB; (c) every launch of rows 1-4 in the pallas-route
    graph replayed on the graph's operands against its plain version; (d)
    remat (``remat=True``, ``remat_policy="dots_saveable"``) against the
    plain model at B=128 and B=512: peak memory, step ms, and the state
    after two captured steps equal to the plain model's. Returns the
    launches of rows 1-4 a replay of the pallas graph counted."""
    import numpy as np
    import torch

    from titanet_torch.ops import frontend as tf
    from titanet_torch.ops.augment import AugmentConfig
    from titanet_torch.ops.kernels import dwconv
    from titanet_torch.ops.kernels.melspec import log_mel_fused
    from titanet_torch.ops.kernels.pool import attentive_pool_bwd, attentive_pool_fwd
    from titanet_torch.train import capture as cap
    from titanet_torch.train import state as ts

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(19)
    n = SECONDS * SR
    tt = np.arange(n) / SR

    def batch(b, seed):
        r = np.random.default_rng(seed)
        wav = (r.uniform(0.05, 0.5, (b, 1)) * np.sin(2 * np.pi * r.uniform(100.0, 2000.0, (b, 1)) * tt)
               + 0.05 * r.standard_normal((b, n))).astype(np.float32)
        return torch.from_numpy(wav).to(dev), torch.from_numpy(r.integers(0, TRAIN_CLASSES, b)).to(dev)

    wav, spk = batch(B, 19)
    ragged = torch.from_numpy(rng.integers(SR, n + 1, B).astype(np.int32)).to(dev)
    frontend = tf.FrontendConfig.from_ms(use_pallas_fused=True)
    aug = AugmentConfig(noise_prob=0.5)
    counters = {"logmel": log_mel_fused, "pool_fwd": attentive_pool_fwd, "pool_bwd": attentive_pool_bwd,
                "dw_bwd": dwconv.dw_bwd}
    try:
        # (a) equal bits, case by case
        cases = (
            ("xla, no augmentation, uniform", "xla", {}, None, {}),
            ("pallas, no augmentation, uniform", "pallas", {}, None, {}),
            ("xla, SpecAugment + noise, ragged", "xla", dict(augment=aug), ragged, {}),
            ("pallas, SpecAugment + noise, ragged", "pallas", dict(augment=aug), ragged, {}),
            ("pallas, accumulate_steps=2", "pallas", {}, None, dict(accumulate=2)),
            ("pallas, ArcFace margin warm-up over 4 steps + renorm", "pallas",
             dict(margin_warmup_steps=4, renorm_head=True), ragged, dict(head="arc")),
        )
        spreads = {}
        for label, route, kw, lens, make_kw in cases:
            os.environ["TITANET_DW_BWD"] = route
            make = lambda: train_capture_state(dev, **make_kw)  # noqa: E731
            inputs = dict(waveform=wav, lengths=lens, speakers=spk)
            step_kw = dict(frontend=frontend, ema_decay=0.99, **kw)
            e1, _ = train_graph_run(make, False, TRAIN_GRAPH_STEPS, inputs, step_kw)
            e2, _ = train_graph_run(make, False, TRAIN_GRAPH_STEPS, inputs, step_kw)
            g, captures = train_graph_run(make, None, TRAIN_GRAPH_STEPS, inputs, step_kw)
            spread_n, spread = record_diff(e2, e1)
            diff_n, diff = record_diff(g, e1)
            want_graphs = 2 if make_kw.get("accumulate") else 1
            clipped = sum(e1[f"grad_norm.{i}"].item() >= 1.0 for i in range(TRAIN_GRAPH_STEPS))
            if captures != want_graphs or diff > spread:
                raise AssertionError(f"train capture {label}: {captures} graphs (expected {want_graphs}); graph vs "
                                     f"eager {diff_n} tensors differ, worst {diff:.3e} / max, eager vs eager "
                                     f"{spread_n} tensors, worst {spread:.3e}")
            spreads[label] = spread
            losses = [round(e1[f"loss.{i}"].item(), 4) for i in range(TRAIN_GRAPH_STEPS)]
            print(f"train capture (a) {label}: {TRAIN_GRAPH_STEPS} captured steps vs {TRAIN_GRAPH_STEPS} eager from "
                  f"one state: {'equal to the bit' if diff_n == 0 else f'{diff_n} tensors differ, worst {diff:.3e} / max'}"
                  f" ({len(e1) - 4} tensors and metrics, counters {e1['counters']}, the 3 generators' states equal); "
                  f"eager vs eager {'equal to the bit' if spread_n == 0 else f'{spread_n} tensors differ, worst {spread:.3e} / max'}"
                  f"; {captures} graph(s); losses {losses}, {clipped} of {TRAIN_GRAPH_STEPS} steps clipped {tag}")
        limit = max(spreads.values())

        # (c) the kernels inside the graph (a graph of its own: it clones the
        # parameters the kernels read, which the step then updates), and (b)
        # graph and eager in turns
        os.environ["TITANET_DW_BWD"] = "pallas"
        step_kw = dict(frontend=frontend, ema_decay=0.99)
        graphs = cap.StepGraphs()
        ts.GRAPHS = graphs
        try:
            st = train_capture_state(dev)
            with graph_operands() as ops:
                ts.train_step(st, wav, None, spk, **step_kw)
            for c in counters.values():
                c.launches = 0
            ts.train_step(st, wav, None, spk, **step_kw)
            torch.cuda.synchronize()
            replay = {k: c.launches for k, c in counters.items()}
            if replay != {"logmel": 1, "pool_fwd": 1, "pool_bwd": 1, "dw_bwd": 51} or graphs.captures != 1:
                raise AssertionError(f"train capture: launches a replay {replay}, {graphs.captures} captures")
            held = hold_train_graph_kernels(ops, "train capture (c)")
            print(f"train capture (c) kernels inside the train graph (pallas, B={B} x {SECONDS} s): launches a "
                  f"replay {replay}; {held} {tag}")
            del ops, st
        finally:
            ts.GRAPHS = cap.GRAPHS
        graphs = cap.StepGraphs()
        ts.GRAPHS = graphs
        try:
            st = train_capture_state(dev)
            run = lambda c: ts.train_step(st, wav, None, spk, **step_kw, capture=c)  # noqa: E731
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(None)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            entry, pool_b = graphs.graphs()[0], graphs.pool_bytes()
            times = {"graph": [], "eager": []}
            for i in range(TRAIN_TURNS):
                for route in (("graph", "eager") if i % 2 == 0 else ("eager", "graph")):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run(None if route == "graph" else False)
                    torch.cuda.synchronize()
                    times[route].append((time.perf_counter() - t0) * 1e3)
            parts = []
            for route, c in (("graph", None), ("eager", False)):
                dms, busy, n_k, timed_by = device_profile(lambda: run(c), iters=3, warmup=1)
                api = host_launches(lambda: run(c), iters=2)
                med = statistics.median(times[route])
                parts.append(f"{route}: median {med:.3f} ms (min {min(times[route]):.3f}, max "
                             f"{max(times[route]):.3f}), {B / med * 1e3:.1f} utt/s, device {dms:.3f} ms ({timed_by}), "
                             f"idle share {1 - busy / med:.3f}, {n_k} kernels a step, host launch calls a step {api}")
            print(f"train capture (b) TitaNet-S 17 blocks bf16, B={B} x {SECONDS} s, pallas, Adam + clip + cosine + "
                  f"EMA: first call {first_s:.3f} s (warm-up step and capture), capture {entry.capture_s:.3f} s, graph "
                  f"pool {pool_b / 2**20:.1f} MiB; {TRAIN_TURNS} steps each, in turns: {' | '.join(parts)} {tag}")
            del st, entry, run
        finally:
            ts.GRAPHS = cap.GRAPHS
        del graphs
        torch.cuda.empty_cache()

        # (d) remat against the plain model at B=128 and B=512
        for b in (B, 4 * B):
            wav_b, spk_b = batch(b, 20 + b)
            inputs = dict(waveform=wav_b, lengths=None, speakers=spk_b)
            ref, parts = None, []
            for label, mk in (("plain", {}), ("remat", dict(remat=True)),
                              ("remat dots_saveable", dict(remat=True, remat_policy="dots_saveable"))):
                torch.cuda.empty_cache()
                ts.GRAPHS = cap.StepGraphs()
                try:
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    st = train_capture_state(dev, batch=b, **mk)
                    for _ in range(2):
                        ts.train_step(st, **inputs, **step_kw)
                    torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated() - base
                    rec = state_record(st)
                    ms = median_ms(lambda: ts.train_step(st, **inputs, **step_kw), runs=5, warmup=1)[0]
                finally:
                    ts.GRAPHS = cap.GRAPHS
                del st
                if ref is None:
                    ref, diff_line = rec, ""
                else:
                    diff_n, diff = record_diff(rec, ref)
                    if diff > limit:
                        raise AssertionError(f"remat {label} B={b}: {diff_n} tensors differ from the plain model's, "
                                             f"worst {diff:.3e} / max > {limit:.3e}")
                    diff_line = (", state after 2 steps " + ("equal to plain to the bit" if diff_n == 0 else
                                 f"{diff_n} tensors differ, worst {diff:.3e} / max (eager spread {limit:.3e})"))
                parts.append(f"{label}: peak {peak / 2**30:.2f} GiB, {ms:.2f} ms a step{diff_line}")
                del rec
            del ref
            print(f"train capture (d) remat, TitaNet-S bf16 B={b} x {SECONDS} s, captured step (peak: warm-up, "
                  f"capture and replays, above what was allocated before): {' | '.join(parts)} {tag}")
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("TITANET_DW_BWD", None)
    print(f"train capture phase: {time.perf_counter() - t_phase:.1f} s wall {tag}")
    return {k: 1 if k != "dw_bwd" else 51 for k in counters}


# Data-parallel capture phase (20): the data-parallel train step as one CUDA
# graph on every rank over NCCL (the JAX package's jitted step on an
# N-device mesh), P = min(4, cards) ranks, one card each, this script
# re-entered as ``python3 chip_smoke.py --ddp-capture-rank <task> <rank>
# <world> <port> <dir>``. Phase 19's model and step: TitaNet-S at full width
# (17 mega-blocks, hidden 256, epilog 1536, embedding 192), bf16, dropout
# 0.5, CE over TRAIN_CLASSES classes, Adam 1e-3 with clipping at 1.0, a
# warm-up and a cosine, weight EMA, pallas route, 128 rows a rank x 3 s.
DDPC_B = B  # rows a rank in (a), (c), (d)
DDPC_STEPS = 4  # steps of each route in (a)
DDPC_TURNS = 20  # timed steps of each route in (d)
# (b) holds the ranks against one process at phase 17's limits, which were
# set for its SGD steps at 32 rows a rank: the same optimizer, learning
# rate, dropout and rows a rank here (Adam's first update is the sign of
# each gradient entry, which rounding flips where an entry is near 0)
DDPC_CHECK_B = DDP_LOCAL_B
DDPC_LOST_TIMEOUT = 30  # TITANET_DIST_TIMEOUT of (f), s
DDPC_LOST_MARGIN = 60  # s past it within which (f)'s surviving ranks must have exited
# (e): phase 13's trainer config with [chunk], 2 epochs, (d)'s 128 rows a
# rank (the global batch 128 x P), on 560 speakers x 16 utterances: 6688 to
# train on, 52 steps an epoch at P = 1 and 13 at P = 4; the second epoch
# reads every utterance from the ranks' caches
DDPC_CLI_B, DDPC_CLI_SPEAKERS = DDPC_B, 560


def ddpc_batch(size: int, rank: int, dev, seed: int, rows: int, ragged: bool = False):
    """``rank``'s ``rows`` rows of a global batch of ``size * rows`` rows x
    3 s (a tone and noise a row, class ids; with ``ragged``, lengths from
    1 s to 3 s), made from ``seed`` alike on every rank: ``(wav, lengths or
    None, speakers)`` on ``dev``."""
    import numpy as np
    import torch

    n, g = SECONDS * SR, size * rows
    r = np.random.default_rng(seed)
    tt = np.arange(n) / SR
    wav = (r.uniform(0.05, 0.5, (g, 1)) * np.sin(2 * np.pi * r.uniform(100.0, 2000.0, (g, 1)) * tt)
           + 0.05 * r.standard_normal((g, n))).astype(np.float32)
    spk, lens = r.integers(0, TRAIN_CLASSES, g), r.integers(SR, n + 1, g).astype(np.int32)
    part = slice(rank * rows, (rank + 1) * rows)
    return (torch.from_numpy(wav[part]).to(dev), torch.from_numpy(lens[part]).to(dev) if ragged else None,
            torch.from_numpy(spk[part]).to(dev))


def ddpc_run(mesh, capture, steps: int, inputs, make_kw: dict, step_kw: dict, shard_map: bool = False) -> tuple:
    """``steps`` steps of ``train_step(..., mesh=mesh)`` (or, with
    ``shard_map``, of the ``shard_map`` step with SpecAugment) from phase
    19's state: (:func:`state_record` with each step's loss and grad norm,
    ``collective_stats()`` of the steps)."""
    import torch

    from titanet_torch.parallel.distributed import collective_stats, reset_collective_stats
    from titanet_torch.parallel.shard_map_step import make_shard_map_train_step
    from titanet_torch.train import state as ts

    st = train_capture_state(mesh.device, axis_name="data" if shard_map else None, **make_kw)
    wav, lens, spk = inputs
    if shard_map:
        step = make_shard_map_train_step(mesh, model=st.model, head=st.head, optimizer=st.optimizer,
                                         frontend=step_kw["frontend"], augment=(0.35, 1, 0.15, 1, 0.5),
                                         capture=capture)
    reset_collective_stats()
    metrics = {}
    for i in range(steps):
        if shard_map:
            st, m = step(st, wav, lens, spk)
        else:
            st, m = ts.train_step(st, wav, lens, spk, mesh=mesh, capture=capture, **step_kw)
        metrics.update({f"{k}.{i}": m[k].clone() for k in ("loss", "grad_norm") if k in m})
    torch.cuda.synchronize()
    rec = state_record(st)
    rec.update(metrics)
    return rec, collective_stats()


def steps_profile(fn, iters: int = 3) -> dict:
    """Device ms (all kernels and NCCL's apart), busy ms, wall ms and
    kernels a call of ``fn`` from one profiler trace of ``iters`` calls
    after a traced warm-up cycle, without :func:`device_profile`'s retries:
    every rank makes the same calls. Busy and wall come from the same
    ``iters`` calls, so ``1 - busy / wall`` is their idle share. NCCL's
    kernels include the wait for the slowest rank."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.step()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    nccl = [e for e in events if "nccl" in e.name.lower()]
    return {"device_ms": sum(e - s for s, e in spans) / iters / 1e3, "busy_ms": union_us(spans) / iters / 1e3,
            "wall_ms": wall / iters * 1e3,
            "nccl_ms": sum(e.time_range.end - e.time_range.start for e in nccl) / iters / 1e3,
            "kernels": len(spans) / iters, "nccl_kernels": len(nccl) / iters}


def ddpc_exact(mesh) -> dict:
    """Phase 20 (a) under ``NCCL_ALGO=Ring``, the graph rank counts and (c),
    on this rank: raises on a miss."""
    import torch

    from titanet_torch.ops import frontend as tf
    from titanet_torch.ops.augment import AugmentConfig
    from titanet_torch.ops.kernels import dwconv
    from titanet_torch.ops.kernels.melspec import log_mel_fused
    from titanet_torch.ops.kernels.pool import attentive_pool_bwd, attentive_pool_fwd
    from titanet_torch.train import capture as cap
    from titanet_torch.train import state as ts

    dev, frontend = mesh.device, tf.FrontendConfig.from_ms(use_pallas_fused=True)
    wav, _, spk = ddpc_batch(mesh.size, mesh.rank, dev, 20, DDPC_B)
    ragged = ddpc_batch(mesh.size, mesh.rank, dev, 20, DDPC_B, ragged=True)[1]
    out = {"cases": []}
    for label, kw, lens, make_kw, sm in (
        ("global-batch step", {}, None, {}, False),
        ("global-batch step, SpecAugment + noise, ragged", dict(augment=AugmentConfig(noise_prob=0.5)), ragged, {},
         False),
        ("global-batch step, accumulate_steps=2", {}, None, dict(accumulate=2), False),
        ("shard_map step, SpecAugment", {}, None, {}, True),
    ):
        step_kw = dict(frontend=frontend, ema_decay=0.99, **kw)
        ts.GRAPHS = graphs = cap.StepGraphs()
        try:
            eager, e_stats = ddpc_run(mesh, False, DDPC_STEPS, (wav, lens, spk), make_kw, step_kw, sm)
            graph, g_stats = ddpc_run(mesh, None, DDPC_STEPS, (wav, lens, spk), make_kw, step_kw, sm)
            captures = graphs.captures
        finally:
            ts.GRAPHS = cap.GRAPHS
        n, worst = record_diff(graph, eager)
        want = 2 if make_kw.get("accumulate") else 1
        if n or captures != want or g_stats != e_stats:
            raise AssertionError(f"data-parallel capture (a) {label}, rank {mesh.rank}: {n} tensors differ from "
                                 f"eager (worst {worst:.3e} / max), {captures} graphs (expected {want}), "
                                 f"collectives {g_stats} vs eager {e_stats}")
        out["cases"].append({"label": label, "tensors": len(eager) - 4, "captures": captures, "stats": g_stats,
                             "counters": eager["counters"],
                             "losses": [round(eager[f"loss.{i}"].item(), 4) for i in range(DDPC_STEPS)]})
        del eager, graph
    # every rank captures on the same calls: two bucket widths in turns
    ts.GRAPHS = graphs = cap.StepGraphs()
    try:
        st = train_capture_state(dev)
        for i in range(4):
            ts.train_step(st, wav[:, :(SECONDS * SR, SECONDS * SR * 2 // 3)[i % 2]], None, spk, frontend=frontend,
                              mesh=mesh)
        torch.cuda.synchronize()
        out["width_captures"] = graphs.captures
        del st
    finally:
        ts.GRAPHS = cap.GRAPHS
    # (c) every launch of rows 1-4 inside this rank's graph, on its operands
    counters = {"logmel": log_mel_fused, "pool_fwd": attentive_pool_fwd, "pool_bwd": attentive_pool_bwd,
                "dw_bwd": dwconv.dw_bwd}
    ts.GRAPHS = graphs = cap.StepGraphs()
    try:
        st = train_capture_state(dev)
        with graph_operands() as ops:
            ts.train_step(st, wav, None, spk, frontend=frontend, ema_decay=0.99, mesh=mesh)
        for c in counters.values():
            c.launches = 0
        ts.train_step(st, wav, None, spk, frontend=frontend, ema_decay=0.99, mesh=mesh)
        torch.cuda.synchronize()
        out["launches"] = {k: c.launches for k, c in counters.items()}
        if out["launches"] != {"logmel": 1, "pool_fwd": 1, "pool_bwd": 1, "dw_bwd": 51} or graphs.captures != 1:
            raise AssertionError(f"data-parallel capture (c) rank {mesh.rank}: launches a replay "
                                 f"{out['launches']}, {graphs.captures} captures")
        out["held"] = hold_train_graph_kernels(ops, f"data-parallel capture (c) rank {mesh.rank}")
        del ops, st
    finally:
        ts.GRAPHS = cap.GRAPHS
    return out


def ddpc_timing(mesh, check: bool) -> dict:
    """Phase 20 (a) without the pin (the difference, printed), (d) graph and
    eager in turns and, with ``check``, (b)'s captured SGD steps, on this
    rank."""
    import torch

    from titanet_torch.ops import frontend as tf
    from titanet_torch.parallel.distributed import collective_stats, reset_collective_stats
    from titanet_torch.train import capture as cap
    from titanet_torch.train import state as ts

    dev, frontend = mesh.device, tf.FrontendConfig.from_ms(use_pallas_fused=True)
    wav, _, spk = ddpc_batch(mesh.size, mesh.rank, dev, 20, DDPC_B)
    step_kw = dict(frontend=frontend, ema_decay=0.99)
    out = {}
    ts.GRAPHS = graphs = cap.StepGraphs()
    try:
        eager, _ = ddpc_run(mesh, False, DDPC_STEPS, (wav, None, spk), {}, step_kw)
        graph, _ = ddpc_run(mesh, None, DDPC_STEPS, (wav, None, spk), {}, step_kw)
        out["unpinned"] = record_diff(graph, eager)
        del eager, graph
    finally:
        ts.GRAPHS = cap.GRAPHS
    ts.GRAPHS = graphs = cap.StepGraphs()
    try:
        st = train_capture_state(dev)
        run = lambda c: ts.train_step(st, wav, None, spk, mesh=mesh, capture=c, **step_kw)  # noqa: E731
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(None)
        torch.cuda.synchronize()
        out["first_s"] = time.perf_counter() - t0
        out["capture_s"], out["pool_mib"] = graphs.graphs()[0].capture_s, graphs.pool_bytes() / 2**20
        times = {"graph": [], "eager": []}
        for i in range(DDPC_TURNS):
            for route in (("graph", "eager") if i % 2 == 0 else ("eager", "graph")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(None if route == "graph" else False)
                torch.cuda.synchronize()
                times[route].append((time.perf_counter() - t0) * 1e3)
        out["routes"] = {}
        for route, c in (("graph", None), ("eager", False)):
            r = {"median": statistics.median(times[route]), "min": min(times[route]), "max": max(times[route])}
            r.update(steps_profile(lambda: run(c)))
            r["launch_calls"] = host_launches(lambda: run(c), iters=2)
            reset_collective_stats()
            run(c)
            torch.cuda.synchronize()
            r["collectives"] = collective_stats()
            out["routes"][route] = r
        del st, run
    finally:
        ts.GRAPHS = cap.GRAPHS
    if check:
        # (b) the captured SGD steps of phase 17's limits, bf16 and f32
        cw, _, cspk = ddpc_batch(mesh.size, mesh.rank, dev, 21, DDPC_CHECK_B)
        out["check"] = {dt: ddpc_check_steps(cw, cspk, frontend, dt, mesh) for dt in ("bfloat16", "float32")}
    return out


def ddpc_check_steps(wav, spk, frontend, dtype: str, mesh=None, lr=DDP_LR) -> dict:
    """(b): DDP_STEPS captured SGD steps (phase 17's learning rate, dropout
    0.5) from phase 19's weights in ``dtype`` on ``wav``'s rows, under
    ``mesh`` or in one process: losses, grad norms, the parameters before,
    after the first step and after every step (CPU), and their checksum."""
    import torch

    from titanet_torch.train import capture as cap
    from titanet_torch.train import state as ts

    ts.GRAPHS = cap.StepGraphs()
    try:
        st = train_capture_state(wav.device, dtype=dtype, sgd_lr=lr)
        cpu = lambda: [p.detach().cpu().clone() for p in st.params()]  # noqa: E731
        out = {"before": cpu(), "losses": [], "grad_norms": []}
        for i in range(DDP_STEPS):
            st, m = ts.train_step(st, wav, None, spk, frontend=frontend, mesh=mesh)
            out["losses"].append(m["loss"].item())
            out["grad_norms"].append(m["grad_norm"].item())
            if i == 0:
                out["first"] = cpu()
        out["after"] = cpu()
        out["checksum"] = sum(float(p.double().abs().sum()) for p in out["after"])
        del st
    finally:
        ts.GRAPHS = cap.GRAPHS
    return out


def ddpc_lost(mesh) -> dict:
    """Phase 20 (f) on this rank: captured steps until the last rank kills
    itself right after launching its fourth replay; the other ranks must
    fail (the replay watchdog, or c10d), never finish."""
    import signal

    from titanet_torch.ops import frontend as tf
    from titanet_torch.train import state as ts

    frontend = tf.FrontendConfig.from_ms(use_pallas_fused=True)
    wav, _, spk = ddpc_batch(mesh.size, mesh.rank, mesh.device, 22, DDPC_CHECK_B)
    st = train_capture_state(mesh.device)
    for i in range(100):
        st, m = ts.train_step(st, wav, None, spk, frontend=frontend, mesh=mesh)
        if i == 4 and mesh.rank == mesh.size - 1:
            print(f"rank {mesh.rank}: killed after launching replay 4", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        m["loss"].item()
    raise AssertionError(f"rank {mesh.rank} ran 100 steps with a rank lost")


def ddp_capture_rank_main(argv) -> int:
    """A rank of phase 20: ``python3 chip_smoke.py --ddp-capture-rank <task>
    <rank> <world> <port> <dir>``. Joins the group through the launcher
    contract (NCCL, one card a rank), runs ``task`` (``exact``,
    ``timing``, ``timing-check``, ``lost``) and saves its results to
    ``<dir>/<task>-rank<rank>.pt``."""
    import torch

    task, rank, world, port, work = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    os.environ.update(TITANET_COORDINATOR=f"127.0.0.1:{port}", TITANET_NUM_PROCESSES=str(world),
                      TITANET_PROCESS_ID=str(rank), TITANET_DW_BWD="pallas")
    from titanet_torch.parallel import make_mesh, maybe_initialize_distributed
    from titanet_torch.parallel.distributed import destroy_process_group

    if not maybe_initialize_distributed(verbose=False):
        raise RuntimeError("the launcher contract did not start a group")
    try:
        mesh = make_mesh(world)
        fn = {"exact": ddpc_exact, "timing": lambda m: ddpc_timing(m, False),
              "timing-check": lambda m: ddpc_timing(m, True), "lost": ddpc_lost}[task]
        torch.save(fn(mesh), os.path.join(work, f"{task}-rank{rank}.pt"))
    finally:
        destroy_process_group()
    return 0


def ddpc_ranks(task: str, world: int, work: str, timeout: float, **env) -> list:
    """Run ``task`` on ``world`` NCCL ranks (``env``: more environment for
    each); returns each rank's results."""
    import torch

    from titanet_torch.parallel.distributed import free_port

    port = free_port()
    run_processes([[sys.executable, os.path.abspath(__file__), "--ddp-capture-rank", task, str(r), str(world),
                    str(port), work] for r in range(world)], [dict(os.environ, **env)] * world, timeout,
                  f"data-parallel capture {task} ({world} ranks)")
    return [torch.load(os.path.join(work, f"{task}-rank{r}.pt"), weights_only=False) for r in range(world)]


def ddpc_cli(root: str, runs: list, tag: str) -> None:
    """Phase 20 (e): ``cli.train`` as users run it, ``mesh.num_devices: P``
    for each P of ``runs`` (``("mesh", P)``) or P processes under the
    launcher contract (``("contract", P)``), 2 epochs each; prints whole-loop
    utt/s, utt/s over the second epoch's steps and its wall."""
    import math

    from titanet_torch.parallel.distributed import free_port

    for how, p in runs:
        d = trainer_config(root, f"cli-{how}-{p}", 2, ("chunk",)).to_dict()
        d["dataset"]["synthetic_speakers"] = DDPC_CLI_SPEAKERS
        # mesh.num_devices splits training.batch_size over the ranks; under
        # the launcher contract each rank reads training.batch_size rows
        d["training"]["batch_size"] = DDPC_CLI_B * (p if how == "mesh" else 1)
        d["mesh"] = {"num_devices": p}
        path = os.path.join(root, f"cli-{how}-{p}.json")
        with open(path, "w") as f:
            json.dump(d, f)
        code = ("import json, sys, time; from titanet_torch import cli; from titanet_torch.train.capture import GRAPHS; "
                "t0 = time.perf_counter(); cli.main(['train', '-p'] + sys.argv[1:]); "
                "print('WALL', json.dumps({'wall': time.perf_counter() - t0, 'captures': GRAPHS.captures}))")
        # a lost rank fails the others within two minutes, not the default ten
        env = dict(os.environ, TITANET_DW_BWD="pallas", TITANET_DIST_TIMEOUT="120")
        if how == "contract":
            port = free_port()
            envs = [dict(env, TITANET_COORDINATOR=f"127.0.0.1:{port}", TITANET_NUM_PROCESSES=str(p),
                         TITANET_PROCESS_ID=str(r)) for r in range(p)]
        else:
            envs = [env]
        outs = run_processes([[sys.executable, "-c", code, path]] * len(envs), envs, 300, f"phase 20 (e) {how} {p}")
        got = json.loads(next(ln for ln in outs[0].splitlines() if ln.startswith("WALL "))[5:])
        if got["captures"] < 1:
            raise AssertionError(f"phase 20 (e) {how} {p}: rank 0 captured no graph")
        rec = read_jsonl(os.path.join(root, d["training"]["run_name"], "metrics.jsonl"))
        tr = [epoch_record(rec, e, "train/") for e in (1, 2)]
        steps = round(tr[1]["train/total_model_time"] / tr[1]["train/avg_model_time"])
        if not all(math.isfinite(r["train/avg_loss"]) for r in tr):
            raise AssertionError(f"phase 20 (e) {how} {p}: epoch losses {[r['train/avg_loss'] for r in tr]}")
        ts_ = [r["ts"] for r in rec if "train/avg_loss" in r]
        utt = steps * DDPC_CLI_B * p
        step_s = tr[1]["train/total_data_time"] + tr[1]["train/total_model_time"]
        print(f"data-parallel capture (e) python -m titanet_torch train, TitaNet-S bf16, [chunk], {DDPC_CLI_B} rows a "
              f"rank, {DDPC_CLI_SPEAKERS} speakers x {TRAIN_UTTERANCES} utterances: {how} P={p}: whole loop "
              f"{2 * utt / got['wall']:.1f} utt/s ({got['wall']:.2f} s, 2 epochs of {steps} steps of {DDPC_CLI_B * p}; "
              f"the other ranks' start, synthesis, validation and verification included); epoch 2 over its steps "
              f"{utt / step_s:.1f} utt/s (StepTimer data {tr[1]['train/total_data_time']:.3f} s / model "
              f"{tr[1]['train/total_model_time']:.3f} s), epoch 2 wall {ts_[1] - ts_[0]:.2f} s; rank 0 captured "
              f"{got['captures']} graphs; train/avg_loss {tr[1]['train/avg_loss']:.4f} {tag}", flush=True)


def ddp_capture_phase(tag: str):
    """Phase 20; raises on any failed check. On one card prints that it did
    not run and returns None; else returns rank 0's launches of rows 1-4
    inside its graph a step (``ddp_graph_launches``)."""
    import tempfile

    import torch

    from titanet_torch.ops import frontend as tf

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"phase 20 not run: {cards} card visible, needs 2")
        return None
    t_phase = time.perf_counter()
    world = min(4, cards)
    for q in (["--query-gpu=name,power.limit", "--format=csv,noheader"], ["topo", "-m"]):
        print(subprocess.run(["nvidia-smi", *q], capture_output=True, text=True, timeout=60).stdout.rstrip())
    work = tempfile.mkdtemp(prefix="titanet_torch_ddpc_")
    try:
        # (a) pinned, the graphs of every rank, (c)
        exact = ddpc_ranks("exact", world, work, 900, NCCL_ALGO="Ring")
        for i, case in enumerate(exact[0]["cases"]):
            print(f"data-parallel capture (a) {world} ranks x {DDPC_B} rows, NCCL_ALGO=Ring, {case['label']}: "
                  f"{DDPC_STEPS} captured steps vs {DDPC_STEPS} eager from one state on every rank: equal to the bit "
                  f"({case['tensors']} tensors and metrics, counters {case['counters']}, the generators' states); "
                  f"{case['captures']} graph(s) on each rank; collectives equal "
                  f"({case['stats']['count']} all-reduces, {case['stats']['bytes']} B over the steps); losses "
                  f"{case['losses']} {tag}")
        widths = [r["width_captures"] for r in exact]
        if widths != [2] * world:
            raise AssertionError(f"data-parallel capture: graphs captured over two bucket widths {widths}")
        print(f"data-parallel capture: two bucket widths in turns, graphs captured on each rank {widths} {tag}")
        for r, res in enumerate(exact):
            print(f"data-parallel capture (c) rank {r}: launches a replay {res['launches']}; {res['held']} {tag}")

        # (d) at P = world and P = 2, NCCL's own choice; (b) at P = world
        timing = {world: ddpc_ranks("timing-check", world, work, 900)}
        if world != 2:
            timing[2] = ddpc_ranks("timing", 2, work, 600)
        for p in sorted(timing):
            for r, res in enumerate(timing[p]):
                n, worst = res["unpinned"]
                parts = []
                for route in ("graph", "eager"):
                    x = res["routes"][route]
                    col = x["collectives"]
                    parts.append(
                        f"{route}: median {x['median']:.3f} ms (min {x['min']:.3f}, max {x['max']:.3f}), "
                        f"{DDPC_B * p / x['median'] * 1e3:.1f} utt/s over the {p} ranks, device {x['device_ms']:.3f} ms "
                        f"(NCCL {x['nccl_ms']:.3f} in {x['nccl_kernels']:.0f} kernels, their wait for the other ranks "
                        f"included; the rest {x['device_ms'] - x['nccl_ms']:.3f}), idle share "
                        f"{1 - x['busy_ms'] / x['wall_ms']:.3f} over the {x['wall_ms']:.3f} ms a step of the profiled "
                        f"steps (NCCL's waits busy), {x['kernels']:.0f} kernels a step, "
                        f"host launch calls "
                        f"a step {x['launch_calls']}, collectives a step {col['count']} ({col['bytes']} B)")
                print(f"data-parallel capture (d) P={p} rank {r}, TitaNet-S bf16 {DDPC_B} rows a rank x {SECONDS} s, "
                      f"pallas, Adam + clip + cosine + EMA: first call {res['first_s']:.3f} s, capture "
                      f"{res['capture_s']:.3f} s, pool {res['pool_mib']:.1f} MiB; {DDPC_TURNS} steps each, in turns: "
                      f"{' | '.join(parts)}; without NCCL_ALGO=Ring, {DDPC_STEPS} captured steps vs eager: "
                      f"{'equal to the bit' if n == 0 else f'{n} tensors differ, worst {worst:.3e} / max'} {tag}")

        # (b) the ranks' captured SGD steps against one process on their rows
        ranks = [res["check"] for res in timing[world]]
        dev = torch.device("cuda")
        frontend = tf.FrontendConfig.from_ms(use_pallas_fused=True)
        cw, _, cspk = ddpc_batch(1, 0, dev, 21, world * DDPC_CHECK_B)
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        os.environ["TITANET_DW_BWD"] = "pallas"
        try:
            one = {dt: ddpc_check_steps(cw, cspk, frontend, dt) for dt in ("bfloat16", "float32")}
            frozen = ddpc_check_steps(cw, cspk, frontend, "float32", lr=0.0)
        finally:
            torch.backends.cudnn.deterministic = deterministic
            os.environ.pop("TITANET_DW_BWD", None)
        del cw, cspk
        for dt in ("bfloat16", "float32"):
            a = ranks[0][dt]
            for r, b in enumerate((res[dt] for res in ranks[1:]), 1):
                if a["checksum"] != b["checksum"] or not all(torch.equal(x, y) for x, y in zip(a["after"], b["after"])):
                    raise AssertionError(f"data-parallel capture (b) {dt}: rank {r}'s parameters differ from rank 0's")
            if not all(torch.equal(x, y) for x, y in zip(a["before"], one[dt]["before"])):
                raise AssertionError(f"data-parallel capture (b) {dt}: the ranks did not start from the one "
                                     "process's weights")
        fmt = lambda d: ", ".join(f"{k} {v:.3e}" for k, v in d.items())  # noqa: E731
        f32, idle = ddp_readings(ranks[0]["float32"], one["float32"]), ddp_readings(frozen, one["float32"])
        b_loss = max(abs(x - y) / abs(y) for x, y in zip(ranks[0]["bfloat16"]["losses"], one["bfloat16"]["losses"]))
        print(f"data-parallel capture (b) {world} ranks x {DDPC_CHECK_B} rows vs one process x "
              f"{world * DDPC_CHECK_B} rows, both captured, TitaNet-S 17 blocks, dropout 0.5, SGD {DDP_LR}, "
              f"{DDP_STEPS} steps, same start weights, cuDNN deterministic: bf16 losses rank 0 "
              f"{ranks[0]['bfloat16']['losses']} vs one process {one['bfloat16']['losses']} (largest relative "
              f"difference {b_loss:.3e}, limit {DDP_BF16_LOSS_RTOL}); f32 the ranks read {fmt(f32)}; limits "
              f"{fmt(DDP_F32_LIMITS)}; a rank that never updates (the one process at learning rate 0) reads "
              f"{fmt(idle)}; the ranks' parameters equal to the bit {tag}")
        blind = [k for k in ("update_step1", "loss_later", "grad_norm_later", "update_all")
                 if DDP_F32_LIMITS[k] >= idle[k]]
        if blind:
            raise AssertionError(f"data-parallel capture (b): the limits {blind} would pass a rank that never "
                                 f"updates ({fmt(idle)})")
        over = [k for k, v in f32.items() if not v <= DDP_F32_LIMITS[k]]
        if over or not b_loss <= DDP_BF16_LOSS_RTOL:
            raise AssertionError(f"data-parallel capture (b): the ranks' steps differ from the one process's beyond "
                                 f"the limits (f32 {over}, bf16 loss {b_loss:.3e})")
        del one, frozen, ranks
        torch.cuda.empty_cache()

        # (f) a lost rank: the others fail within the timeout
        ddpc_lost_check(work, tag)

        # (e) the trainer as users run it
        ddpc_cli(work, [("mesh", 1), ("mesh", 2)] + ([("mesh", world)] if world != 2 else [])
                 + [("contract", world)], tag)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"data-parallel capture phase: {time.perf_counter() - t_phase:.1f} s wall {tag}")
    return exact[0]["launches"]


def ddpc_lost_check(work: str, tag: str, world: int = 2) -> None:
    """Phase 20 (f): ``world`` ranks of captured steps, the last killed
    after launching a replay; every other rank must exit non-zero within
    ``DDPC_LOST_TIMEOUT`` (its ``TITANET_DIST_TIMEOUT``) plus
    ``DDPC_LOST_MARGIN`` seconds of the kill."""
    from titanet_torch.parallel.distributed import free_port

    port = free_port()
    env = dict(os.environ, TITANET_DIST_TIMEOUT=str(DDPC_LOST_TIMEOUT))
    # each rank writes to a file: a pipe nobody drains could block a rank's
    # last words (c10d's reports are long) before it exits
    logs = [os.path.join(work, f"lost-rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--ddp-capture-rank", "lost", str(r), str(world),
                 str(port), work], env=env, stdout=log, stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__))))
    timed_out = False
    try:
        procs[-1].wait(timeout=600)
        t_kill = time.perf_counter()
        for p in procs[:-1]:
            p.wait(timeout=max(t_kill + DDPC_LOST_TIMEOUT + DDPC_LOST_MARGIN - time.perf_counter(), 0.1))
        waited = time.perf_counter() - t_kill
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for path in logs:
        with open(path) as f:
            outs.append(f.read())
    killed = outs.pop()
    if timed_out:
        raise AssertionError(f"data-parallel capture (f): a rank outlived its lost peer by more than "
                             f"{DDPC_LOST_TIMEOUT + DDPC_LOST_MARGIN} s:\n" + "\n".join(o[-3000:] for o in outs + [killed]))
    if procs[-1].returncode != -9 or "killed after launching replay 4" not in killed:
        raise AssertionError(f"data-parallel capture (f): the last rank exited {procs[-1].returncode}:\n{killed[-3000:]}")
    codes = [p.returncode for p in procs[:-1]]
    if any(c == 0 for c in codes):
        raise AssertionError(f"data-parallel capture (f): a surviving rank exited 0: {codes}")
    why = ["replay watchdog" if "a rank is lost" in o else "c10d" for o in outs]
    print(f"data-parallel capture (f) {world} ranks, the last killed after launching its fourth replay: the others "
          f"exited {codes} within {waited:.1f} s of the kill (TITANET_DIST_TIMEOUT {DDPC_LOST_TIMEOUT} s, margin "
          f"{DDPC_LOST_MARGIN} s), failed by {why} {tag}")


# ECAPA-TDNN's context route at the embedder's largest bucket: a full batch
# of 64 rows of 38.4 s (T = 3845 frames of the MFA's 1536 channels, H =
# 128), the rows' lengths drawn over [1, T], the first 1 and the last T
ECAPA_ROUTE_B, ECAPA_ROUTE_T = 64, 3845
CTX_KERNELS = ("ctx_stats_kernel", "ctx_finish_kernel")


def ecapa_route_phase(rng, dev, report: dict, tag: str) -> None:
    """Phase 3b: ECAPA's context route, ``context_stats`` (the two kernels
    of :data:`CTX_KERNELS`) and ``attentive_pool_fwd`` with a bias a row and
    the rows' lengths (``pool_onepass_kernel``'s per-row instantiation and
    ``pool_merge_kernel``), each against its plain version at
    :data:`ECAPA_ROUTE_B` x :data:`ECAPA_ROUTE_T`: one launch a call, two
    calls equal to the bit, rtol and atol 1e-4 (the context) and 2e-2 (the
    pool, as phase 3); each timed by device time beside its bound (h read
    once over the valid frames), which is also the least time
    ``ctx_pool_roofline.embed_ecapa`` counts, and its plain version. Fills
    ``report["ctx"]`` and ``report["pool_rows"]``."""
    import torch

    from titanet_torch.ops.kernels.pool import (
        attentive_pool_fwd,
        attentive_pool_fwd_plain,
        context_stats,
        context_stats_plain,
    )

    b, t, ch, hid = ECAPA_ROUTE_B, ECAPA_ROUTE_T, 1536, 128
    n = rng.integers(1, t + 1, b)
    n[0], n[-1] = 1, t
    lengths = torch.as_tensor(n, dtype=torch.int32, device=dev)
    valid = int(n.sum())
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    h = torch.relu(torch.randn(b, t, ch, generator=g, device=dev)).to(torch.bfloat16)

    def uniform(shape, fan_in):
        return (torch.rand(*shape, generator=g, device=dev) * 2 - 1) / fan_in ** 0.5

    zeros = torch.zeros(ch, device=dev)
    args = (h, zeros, zeros, uniform((ch, hid), ch).to(torch.bfloat16), uniform((b, hid), ch),
            uniform((hid, ch), hid).to(torch.bfloat16), uniform((ch,), hid))
    runs = {"ctx": (lambda: context_stats(h, lengths), lambda: context_stats_plain(h, lengths), context_stats,
                    1e-4, CTX_KERNELS),
            "pool_rows": (lambda: attentive_pool_fwd(*args, 1e-6, False, lengths),
                          lambda: attentive_pool_fwd_plain(*args, 1e-6, False, lengths), attentive_pool_fwd,
                          2e-2, ("pool_onepass_kernel", "pool_merge_kernel"))}
    parts = []
    for key, (run, plain, fn, tol, names) in runs.items():
        before = fn.launches
        out, again, ref = run(), run(), plain()
        torch.cuda.synchronize()
        if fn.launches - before != 2 or not torch.equal(out, again):
            raise AssertionError(f"ECAPA route {key}: two calls count {fn.launches - before} launches or differ")
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
        err = (out.float() - ref.float()).abs().max().item()
        del ref
        ms, timed_by = device_ms(run, names=names, iters=20)
        pms = cuda_ms(plain, iters=3, warmup=1)
        # h once over the valid frames and the output; the pool also reads
        # its weights and biases and does its two products
        nbytes = valid * ch * 2 + out.numel() * out.element_size() + 4 * b
        ops = 3 * valid * ch
        if key == "pool_rows":
            nbytes += 2 * 2 * ch * hid + 4 * (b * hid + ch)
            ops = 4 * valid * ch * hid
        bms, by = bound_ms(nbytes, ops, "bfloat16" if key == "pool_rows" else "float32")
        report[key] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by, timed_by=timed_by)
        parts.append(f"{'context_stats' if key == 'ctx' else 'attentive_pool_fwd (a bias a row, lengths)'}: "
                     f"max_abs_err {err:.3e} (rtol {tol}), two calls equal bits; kernels {ms:.4f} ms (device time, "
                     f"{timed_by}), bound {bms:.4f} ms ({by}, {bms / ms * 100:.1f}%), plain {pms:.4f} ms")
    print(f"ECAPA context route at B={b}, T={t}, C={ch}, H={hid}, {valid} valid frames (lengths 1-{t}): "
          + "; ".join(parts) + f" {tag}")


def pool_phase(rng, t_frames: int, dev, report: dict, tag: str):
    """Phase 3: the attentive-pool forward kernel vs its plain version at
    B=128, T=``t_frames``, C=1536, H=128 (see the module docstring). Draws
    its inputs from ``rng`` and returns the f32 fold vectors and weights
    ``(a, c, wa32, ba, wb32, bb)`` that phase 6 reuses. To run it alone on
    the card: build the kernels (``titanet_torch.ops.kernels._build.build()``)
    and call ``pool_phase(np.random.default_rng(0), 301, torch.device("cuda"),
    {}, "")``."""
    import numpy as np
    import torch

    from titanet_torch.ops.kernels import pool as pool_kernels
    from titanet_torch.ops.kernels.pool import attentive_pool_fwd, attentive_pool_fwd_plain

    ch, hid = 1536, 128
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
            before = attentive_pool_fwd.launches
            out, again, ref = attentive_pool_fwd(*args), attentive_pool_fwd(*args), attentive_pool_fwd_plain(*args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=rtol)
            if attentive_pool_fwd.launches - before != 2 or not torch.equal(out, again):
                raise AssertionError(f"attn_pool {dt} fold={fold}: two calls count "
                                     f"{attentive_pool_fwd.launches - before} launches or differ")
            ms, timed_by = device_ms(lambda: attentive_pool_fwd(*args), names=POOL_KERNELS, iters=20)
            pms = cuda_ms(lambda: attentive_pool_fwd_plain(*args), iters=5)
            ops = 4 * B * t_frames * ch * hid
            nbytes = (h.numel() + wa.numel() + wb.numel()) * h.element_size() + 4 * (3 * ch + hid) \
                + out.numel() * out.element_size()
            bms, by = bound_ms(nbytes, ops, str(dt).split(".")[1])
            report[("pool", dt, fold)] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                                              timed_by=timed_by)
            design = ""
            if dt == torch.bfloat16:
                # the one-pass kernel: its distance to its decomposition in
                # plain torch, and the bytes it moves through L2 (weights once
                # a 128-frame tile, h twice, the running states)
                split = pool_kernels.attentive_pool_fwd_split(*args)
                split_err = (out.float() - split.float()).abs().max().item()
                torch.testing.assert_close(out.float(), split.float(), rtol=rtol, atol=rtol)
                tiles = -(-t_frames // pool_kernels.ONEPASS_ROWS)
                halves = [i * 128 + 64 * f < t_frames for i in range(tiles) for f in (0, 1)]
                l2 = B * tiles * 2 * ch * hid * 2 + 2 * h.numel() * 2 + B * (2 * sum(halves) - sum(halves[:2])) * ch * 16
                report[("pool", dt, fold)].update(split_err=split_err, l2_bytes=l2)
                design = (f"; vs the split plain version {split_err:.3e}; replaced two-pass design: "
                          f"{PREV_MS['pool', fold]} ms; one pass: {pool_kernels.ONEPASS_ROWS}-frame tiles, "
                          f"{pool_kernels.onepass_splits(B)} block(s) an utterance, no cluster, "
                          f"{l2 / 1e6:.1f} MB through L2 a call")
            print(f"attn_pool {dt} fold={fold}: max_abs_err {err:.3e} (rtol {rtol}); kernel {ms:.4f} ms "
                  f"(device time, {timed_by}), plain {pms:.4f} ms, bound {bms:.4f} ms ({by}; {ops / 1e9:.2f} GFLOP, "
                  f"{nbytes / 1e6:.1f} MB){design} {tag}")
    return a, c, wa32, ba, wb32, bb


def check_embeddings(e, tol, what):
    """Finite unit-norm ``[B, 192]`` embeddings, or raise."""
    import torch

    if e.shape != (B, 192) or not torch.isfinite(e).all():
        raise AssertionError(f"{what}: embeddings are not finite [B, 192]")
    norm_err = (torch.linalg.vector_norm(e.float(), dim=-1) - 1).abs().max().item()
    if norm_err > tol:
        raise AssertionError(f"{what}: embeddings are not unit norm: {norm_err}")


def megablock_errors(out, ref, t_len, edge, dt):
    """Per-row error, edge rows and interior apart, against the limit: f32
    1e-4 of the largest entry, bf16 one bf16 ulp of it."""
    import numpy as np
    import torch

    top = ref.float().abs().max().item()
    tol = 1e-4 * top if dt == torch.float32 else 2.0 ** (np.floor(np.log2(top)) - 7)
    per_row = (out.float() - ref.float()).abs().amax(dim=(0, 2))
    e_edge = max(per_row[:edge].max().item(), per_row[t_len - edge:].max().item())
    e_in = per_row[edge:t_len - edge].max().item() if t_len > 2 * edge else 0.0
    return e_edge, e_in, tol, top


def megablock_phase(rng, dev, shapes, t_frames: int, report: dict, tag: str) -> None:
    """Phase 10 at ``shapes`` ((C, k) pairs), B=128, T=``t_frames``, S=3
    (see the module docstring), with the ragged cases at (256, 3) and
    (1024, 11); fills ``report[("megablock", C, dtype)]``. Draws its inputs
    from ``rng`` in a fixed order."""
    import numpy as np
    import torch

    from titanet_torch.models.titanet import MegaBlock
    from titanet_torch.ops.kernels.megablock import (
        fused_sub_blocks,
        fused_sub_blocks_plain,
        kernel_design,
        max_active_clusters,
        tile_rows,
    )

    n_sub = 3
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    for c_, k_ in shapes:
        pad = (k_ - 1) // 2
        edge = (n_sub - 1) * pad
        x32 = torch.from_numpy(rng.standard_normal((B, t_frames, c_)).astype(np.float32)).to(dev)
        dw_w = f32(rng.standard_normal((n_sub, k_, c_)) * 0.5)
        dw_b = f32(rng.standard_normal((n_sub, c_)) * 0.3)
        pw32 = f32(rng.standard_normal((n_sub, c_, c_)) / np.sqrt(c_))
        pw_b = f32(rng.standard_normal((n_sub, c_)) * 0.3)
        bn = f32(np.stack([rng.uniform(0.5, 1.5, (n_sub, c_)), rng.standard_normal((n_sub, c_)) * 0.3], axis=1))
        for dt in (torch.float32, torch.bfloat16):
            design = kernel_design(dt, c_)
            args = (x32.to(dt), dw_w, dw_b, pw32.to(dt), pw_b, bn)
            out, ref = fused_sub_blocks(*args, kernel_size=k_), fused_sub_blocks_plain(*args, kernel_size=k_)
            again = fused_sub_blocks(*args, kernel_size=k_)
            torch.cuda.synchronize()
            e_edge, e_in, tol, top = megablock_errors(out, ref, t_frames, edge, dt)
            if not torch.isfinite(out).all() or max(e_edge, e_in) > tol:
                raise AssertionError(f"megablock C={c_} k={k_} {dt}: error edge {e_edge}, interior {e_in} > {tol}")
            if not torch.equal(out, again):
                raise AssertionError(f"megablock C={c_} k={k_} {dt}: two calls differ")
            unfused = MegaBlock(c_, k_, n_sub, dtype=None if dt == torch.float32 else dt).to(dev).eval()

            def library_route(x=args[0], mod=unfused):
                with torch.no_grad():
                    for i in range(n_sub):
                        x = getattr(mod, f"sub_block_{i}")(x)
                return x

            product_ops = 2 * B * t_frames * n_sub * c_ * c_
            ops = product_ops + 2 * B * t_frames * n_sub * c_ * k_
            nbytes = 2 * args[0].numel() * args[0].element_size() + pw32.numel() * args[0].element_size() \
                + 4 * (dw_w.numel() + dw_b.numel() + pw_b.numel() + bn.numel())
            fp32_core_ms, _ = bound_ms(nbytes, ops, "float32")
            if "3xTF32" in design:
                # the work this design does: three products on the TF32 tensor
                # cores, the depthwise taps (2k + 1) and the epilogue (bias,
                # scale, shift, relu) on the FP32 cores, one after the other
                cuda_ops = B * t_frames * n_sub * c_ * (2 * k_ + 1 + 4)
                t_ops = 3 * product_ops / PEAK_OPS["tf32"] + cuda_ops / PEAK_OPS["float32"]
                t_bytes = nbytes / HBM_BYTES_PER_S
                bms, by = max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
                bound_note = (f"bound {bms:.4f} ms ({by}; 3 x {product_ops / 1e9:.2f} GFLOP at 495 TFLOP/s TF32 + "
                              f"{cuda_ops / 1e9:.3f} GFLOP at 67 TFLOP/s), FP32-core bound {fp32_core_ms:.4f} ms")
            else:
                bms, by = bound_ms(nbytes, ops, str(dt).split(".")[1])
                bound_note = f"bound {bms:.4f} ms ({by}; {ops / 1e9:.2f} GFLOP)"
            iters = 20 if c_ == 256 else 5
            ms, timed_by = device_ms(lambda: fused_sub_blocks(*args, kernel_size=k_), names=("megablock",),
                                     iters=iters)
            pms = cuda_ms(lambda: fused_sub_blocks_plain(*args, kernel_size=k_), iters=3)
            ums, _ = device_ms(library_route, iters=iters)
            report[("megablock", c_, dt)] = dict(max_abs_err=max(e_edge, e_in), ms=ms, plain_ms=pms,
                                                 bound_ms=bms, bound_by=by, timed_by=timed_by, design=design,
                                                 fp32_core_bound_ms=fp32_core_ms, unfused_ms=ums)
            if c_ == 1024:
                clusters = max_active_clusters(dt, k_)
                tile = tile_rows(c_, dt) - 2 * pad * (n_sub - 1)
                was = (f"; {tile}-row tiles, {clusters} clusters on the card at once "
                       f"(cudaOccupancyMaxActiveClusters); before: ")
                was += (f"the fp32-core design {PREV_MS['megablock_f32', c_]} ms" if dt == torch.float32 else
                        f"the mma.sync design of 12-row tiles {PREV_MS['megablock_tc', c_]} ms, the fp32-core "
                        f"design {PREV_MS['megablock', c_]} ms by events")
                report[("megablock", c_, dt)]["max_active_clusters"] = clusters
            elif dt == torch.bfloat16:
                was = f"; fp32-core design: {PREV_MS['megablock', c_]} ms by events"
            else:
                was = f"; replaced fp32-core design: {PREV_MS['megablock_f32', c_]} ms"
            print(f"megablock C={c_} k={k_} {dt} ({design}): max abs err first/last {edge} rows {e_edge:.3e}, interior "
                  f"{e_in:.3e} (tol {tol:.3e}, largest entry {top:.3f}; relative {max(e_edge, e_in) / top:.3e}); "
                  f"two calls equal bits; kernel {ms:.4f} ms (device time, {timed_by}{was}), "
                  f"plain {pms:.4f} ms, unfused library route {ums:.4f} ms (device time), {bound_note}, "
                  f"{nbytes / 1e6:.1f} MB {tag}")
            del args, out, again, ref, unfused
        if c_ in (256, 1024):
            # ragged: at (256, 3) 9 tiles of 124 rows (bf16) and 14 of 76 (f32),
            # the last one partial; at (1024, 11) B=3, T=1000 (10 tiles of 108
            # rows) and T = one tile - 1, one tile, one tile + 1
            tiles = {dt: tile_rows(c_, dt) - 2 * pad * (n_sub - 1) for dt in (torch.bfloat16, torch.float32)}
            xr = torch.from_numpy(rng.standard_normal((3, 1000, c_)).astype(np.float32)).to(dev)
            for dt in (torch.bfloat16, torch.float32):
                cases = [1000] if c_ == 256 else [1000, tiles[dt] - 1, tiles[dt], tiles[dt] + 1]
                for t_len in cases:
                    args = (xr[:, :t_len].to(dt).contiguous(), dw_w, dw_b, pw32.to(dt), pw_b, bn)
                    out, ref = fused_sub_blocks(*args, kernel_size=k_), fused_sub_blocks_plain(*args, kernel_size=k_)
                    again = fused_sub_blocks(*args, kernel_size=k_)
                    torch.cuda.synchronize()
                    e_edge, e_in, tol, top = megablock_errors(out, ref, t_len, edge, dt)
                    if not torch.isfinite(out).all() or max(e_edge, e_in) > tol:
                        raise AssertionError(f"megablock ragged C={c_} {dt} B=3 T={t_len}: error edge {e_edge}, "
                                             f"interior {e_in} > {tol}")
                    if not torch.equal(out, again):
                        raise AssertionError(f"megablock ragged C={c_} {dt} B=3 T={t_len}: two calls differ")
                    print(f"megablock C={c_} k={k_} {dt} ({kernel_design(dt, c_)}) ragged B=3 T={t_len} (tiles of "
                          f"{tiles[dt]} rows): max abs err first/last {edge} rows {e_edge:.3e}, interior {e_in:.3e} "
                          f"(tol {tol:.3e}, largest entry {top:.3f}); two calls equal bits {tag}")
                    del args, out, again, ref
            del xr
        del x32, pw32


def fused_phase(wav, lengths, n_frames: int, size: str, n_mega_blocks: int, limits: dict, tag: str):
    """Phase 11 on TitaNet-``size`` (``get_titanet``, ``n_mega_blocks``,
    random weights from seed 0), bf16 then f32: wav ->
    ``log_mel_spectrogram_pallas`` -> ``titanet_apply_fused`` ->
    ``l2_normalize`` (see the module docstring). ``limits[label]``: the
    least cosine against ``embed_step``. Returns ``({label: launches a
    call}, the f32 model)``."""
    import torch

    from titanet_torch.models import fused_inference, get_titanet, l2_normalize
    from titanet_torch.ops import frontend as tf
    from titanet_torch.ops.kernels.megablock import fused_sub_blocks, fused_sub_blocks_plain
    from titanet_torch.ops.kernels.melspec import log_mel_frames, log_mel_frames_plain, log_mel_spectrogram_pallas
    from titanet_torch.train.state import embed_step

    dev = wav.device
    cosine_rows = torch.nn.functional.cosine_similarity
    cfg32 = tf.FrontendConfig.from_ms(use_pallas_fused=True)
    cfg16 = tf.FrontendConfig.from_ms(precision="default", use_pallas_fused=True)
    name = f"TitaNet-{size.upper()}"

    def fused_serve(model, cfg):
        mel, _ = log_mel_spectrogram_pallas(wav, cfg)
        return l2_normalize(fused_inference.titanet_apply_fused(model, mel))

    fused_launches = {}
    for label, dt, cfg, tol in (("bf16", torch.bfloat16, cfg16, 1e-2), ("f32", None, cfg32, 1e-5)):
        model = get_titanet(model_size=size, n_mega_blocks=n_mega_blocks, dtype=dt, device=dev,
                            generator=torch.Generator().manual_seed(0))
        log_mel_frames.launches = log_mel_frames.dmma_launches = fused_sub_blocks.launches = 0
        emb = fused_serve(model, cfg)
        torch.cuda.synchronize()
        counts = {"mel_frames": log_mel_frames.launches, "megablock": fused_sub_blocks.launches}
        if counts != {"mel_frames": 1, "megablock": n_mega_blocks} or log_mel_frames.dmma_launches != (dt is None):
            raise AssertionError(f"fused serving {name} {label}: launches {counts}, f64 tensor-core frames launches "
                                 f"{log_mel_frames.dmma_launches}")
        fused_launches[label] = counts
        check_embeddings(emb, tol, f"fused serving {name} {label}")
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
        min_cos = limits[label]
        if cos < min_cos or cos_plain_ref < min_cos:
            raise AssertionError(f"fused serving {name} {label}: cosine vs embed_step {cos} (kernel route), "
                                 f"{cos_plain_ref} (all-plain route) < {min_cos}")
        if cos_plain <= (0.99999 if dt is None else 0.999):
            raise AssertionError(f"fused serving {name} {label}: kernel route vs all-plain route cosine {cos_plain}")
        med, lo, hi = median_ms(lambda: fused_serve(model, cfg))
        emed, elo, ehi = median_ms(lambda: embed_step(model, wav, lengths, frontend=cfg, device=dev))
        dev_ms, timed_by = device_ms(lambda: fused_serve(model, cfg), iters=5)
        edev_ms, etimed_by = device_ms(lambda: embed_step(model, wav, lengths, frontend=cfg, device=dev), iters=5)
        was = "" if dt is not None or size != "s" else (
            f" (with the replaced FP32-core frames kernel: median {PREV_MS['fused_f32', 'median']} ms, device "
            f"{PREV_MS['fused_f32', 'device']} ms)")
        print(f"fused serving {name} ({n_mega_blocks} mega-blocks) {label}: launches per call {counts}; min cosine vs "
              f"embed_step {cos:.7f} (all-plain fused route vs embed_step {cos_plain_ref:.7f}; limit {min_cos}); "
              f"kernel route vs all-plain route {cos_plain:.9f}; median {med:.3f} ms per batch of {B} x {SECONDS} s "
              f"(min {lo:.3f}, max {hi:.3f}, 10 runs); device time {dev_ms:.3f} ms a call ({timed_by}, 5 calls){was}; "
              f"embed_step beside it {emed:.3f} ms (min {elo:.3f}, max {ehi:.3f}), device time {edev_ms:.3f} ms "
              f"({etimed_by}) {tag}")
        del emb, ref, mel_plain, plain_emb
        if dt is not None:
            del model
    return fused_launches, model


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from titanet_torch.models import get_titanet
    from titanet_torch.ops import frontend as tf
    from titanet_torch.models.quantized import quantize_titanet
    from titanet_torch.ops.kernels import _build, dwconv
    from titanet_torch.ops.kernels import pool as pool_kernels
    from titanet_torch.ops.kernels.melspec import (
        KERNEL_DESIGNS,
        frames_kernel,
        fused_kernel,
        log_mel_frames,
        log_mel_frames_plain,
        log_mel_fused,
        log_mel_fused_plain,
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
    for cfg, dt, atol, want, attr in ((cfg32, torch.float32, 1e-4, "logmel_dmma_kernel", "dmma_launches"),
                                      (cfg16, torch.bfloat16, 2e-3, "logmel_tc_kernel", "tc_launches")):
        buf = buf32.to(dt).contiguous()
        _, _, _, basis, fb = tf._constants(cfg, dev, dt)
        kernel = fused_kernel(dt, 512, 400, 160, 80)
        if kernel != want:
            raise AssertionError(f"log-mel {dt}: the router names {kernel}, expected {want}")
        run = lambda: log_mel_fused(buf, lengths, basis, fb, n_frames=n_frames, hop=160, win_length=400)  # noqa: E731
        plain = lambda: log_mel_fused_plain(buf, lengths, basis, fb, n_frames=n_frames, hop=160)  # noqa: E731
        traced = ran_kernel(run, kernel, log_mel_fused, attr)
        out, again, ref = run(), run(), plain()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not torch.isfinite(out).all() or err > atol:
            raise AssertionError(f"log-mel {dt}: max abs err {err} > {atol}")
        if dt == torch.float32 and not torch.equal(out, again):
            raise AssertionError("log-mel f32: two calls differ")
        n_bins, n_mels = 257, 80
        ops = 2 * B * n_frames * (400 * 2 * n_bins + n_bins * n_mels)
        # the buffer, the basis rows of the 400 window taps, fb, the output
        nbytes = buf.numel() * buf.element_size() + out.numel() * 4 \
            + (2 * 400 * n_bins + fb.numel()) * basis.element_size()
        bms, by = bound_ms(nbytes, ops, str(dt).split(".")[1])
        ms, timed_by = device_ms(run, names=(kernel,), iters=20)
        pms = cuda_ms(plain, iters=5)
        report[("logmel", dt)] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                                      timed_by=timed_by, design=KERNEL_DESIGNS[kernel])
        if dt == torch.float32:
            frames_view = buf.unfold(1, 512, 160)[:, :n_frames]
            t3, by3, design_ms, fp32_core_ms, lib_ms, note = logmel_f32_costs(B * n_frames, nbytes, frames_view,
                                                                              basis, fb)
            report[("logmel", dt)].update(bound_ms=t3, bound_by=by3, design_bound_ms=design_ms,
                                          fp32_core_bound_ms=fp32_core_ms, unfused_ms=lib_ms)
            print(f"logmel f32 ({kernel}: {KERNEL_DESIGNS[kernel]}; {traced}): max_abs_err {err:.3e} "
                  f"(atol {atol}); two calls equal bits; kernel {ms:.4f} ms (device time, {timed_by}; replaced "
                  f"FP32-core design: {PREV_MS['logmel', 'f32']} ms), plain {pms:.4f} ms, {note}; "
                  f"{nbytes / 1e6:.1f} MB {tag}")
            continue
        print(f"logmel {dt} ({kernel}; {traced}): max_abs_err {err:.3e} (atol {atol}); kernel {ms:.4f} "
              f"ms (device time, {timed_by}; FP32-core design: {PREV_MS['logmel', 'bf16']} ms by events), plain "
              f"{pms:.4f} ms, bound {bms:.4f} ms ({by}; {ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) {tag}")

    # 3. attentive-pool kernel vs plain; 3b. ECAPA's context route
    a, c, wa32, ba, wb32, bb = pool_phase(rng, n_frames, dev, report, tag)
    ecapa_route_phase(rng, dev, report, tag)
    t_frames, ch, hid = n_frames, 1536, 128
    del buf32

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
        print(f"embed_step {label} (CUDA graph): median {med:.3f} ms per batch of {B} x {SECONDS} s "
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
        log_mel_fused.dmma_launches = 0
        torch.cuda.reset_peak_memory_stats()
        st, met = ts.train_step(st, wav_t, lengths, spk, frontend=cfg_train)  # the warm-up step and the capture
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in counters.items()}
        counts["logmel_dmma"] = log_mel_fused.dmma_launches
        expect = {"logmel": 1, "pool_fwd": 1, "pool_bwd": 1, "dw_bwd": 51 if route == "pallas" else 0,
                  "logmel_dmma": 1}
        if counts != expect:
            raise AssertionError(f"train_step {route}: launches {counts}, expected {expect}")
        train_launches[route] = counts
        _, grads, _, _ = ts.loss_and_grads(st, wav_t, lengths, spk, frontend=cfg_train)
        names = [n for n, _ in st.model.named_parameters()] + [n for n, _ in st.head.named_parameters()]
        bad = [n for n, gr in zip(names, grads) if gr is None or not torch.isfinite(gr).all()]
        if bad:
            raise AssertionError(f"train_step {route}: parameters without a finite gradient: {bad[:5]}")
        del grads
        losses, times = [], []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, met = ts.train_step(st, wav_t, lengths, spk, frontend=cfg_train)
            losses.append(met["loss"].item())
            times.append((time.perf_counter() - t0) * 1e3)
        if not all(np.isfinite(losses)) or not np.mean(losses[-5:]) < losses[0]:
            raise AssertionError(f"train_step {route}: loss did not fall over 20 steps: {losses}")
        med = statistics.median(times[3:])

        def step():
            nonlocal st
            st, _ = ts.train_step(st, wav_t, lengths, spk, frontend=cfg_train)

        dev_ms, timed_by = device_ms(step, iters=3, warmup=1)
        dw_ms, _ = device_ms(step, names=DW_KERNELS, iters=3, warmup=0) if route == "pallas" else (0.0, None)
        print(f"train_step {route} (its CUDA graph, the default on the card): launches per step {counts}; every "
              f"parameter has a finite gradient; loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} over 20 steps; median {med:.3f} ms per step "
              f"(min {min(times[3:]):.3f}, max {max(times[3:]):.3f}, steps 4-20), {B / med * 1e3:.1f} utt/s, "
              f"peak memory {peak / 2**30:.2f} GiB (the first call: its warm-up step and the capture; the "
              f"replays allocate nothing); device time {dev_ms:.3f} ms a step ({timed_by}, 3 steps)"
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
        kernel = frames_kernel(cfg.precision, 512, 400, 80)
        want = "mel_frames_dmma_kernel" if dt == torch.float32 else "mel_frames_tc_kernel"
        if kernel != want:
            raise AssertionError(f"mel_frames {cfg.precision}: the router names {kernel}, expected {want}")
        run = lambda: log_mel_frames(frames, basis, fb, precision=cfg.precision, win_length=400)  # noqa: E731
        plain = lambda: log_mel_frames_plain(frames, basis, fb, precision=cfg.precision)  # noqa: E731
        fused = lambda: log_mel_fused(buf, lengths, basis, fb, n_frames=n_frames, hop=160, win_length=400)  # noqa: E731
        traced = ran_kernel(run, kernel, log_mel_frames, "dmma_launches") if dt == torch.float32 else \
            ran_kernel(run, kernel, log_mel_frames, "launches")
        out, again, ref, other = run(), run(), plain(), fused().reshape(B * n_frames, 80)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        err_fused = (out - other).abs().max().item()
        if not torch.isfinite(out).all() or err > atol or err_fused > atol:
            raise AssertionError(f"mel_frames {cfg.precision}: max abs err {err} vs plain, {err_fused} vs the "
                                 f"fused kernel > {atol}")
        # "highest": the frames and fused kernels run one device function on
        # the same f32 operands (the waveforms' full lengths mask nothing)
        if dt == torch.float32 and not (torch.equal(out, other) and torch.equal(out, again)):
            raise AssertionError(f"mel_frames highest: equal to the fused kernel's output {torch.equal(out, other)}, "
                                 f"two calls equal {torch.equal(out, again)}")
        ops = 2 * B * n_frames * (400 * 2 * 257 + 257 * 80)
        # the function reads the 400 window taps of each frame and their
        # basis rows, fb, and writes the output
        nbytes = B * n_frames * 400 * 4 + out.numel() * 4 + (2 * 400 * 257 + fb.numel()) * basis.element_size()
        bms, by = bound_ms(nbytes, ops, str(dt).split(".")[1])
        ms, timed_by = device_ms(run, names=(kernel,), iters=20)
        fms, _ = device_ms(fused, names=(fused_kernel(dt, 512, 400, 160, 80),), iters=20)
        pms = cuda_ms(plain, iters=5)
        report[("mel_frames", dt)] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                                          timed_by=timed_by, design=KERNEL_DESIGNS[kernel])
        was = PREV_MS.get(("mel_frames", cfg.precision))
        if dt == torch.float32:
            t3, by3, design_ms, fp32_core_ms, lib_ms, note = logmel_f32_costs(B * n_frames, nbytes, frames, basis,
                                                                              fb)
            report[("mel_frames", dt)].update(bound_ms=t3, bound_by=by3, design_bound_ms=design_ms,
                                              fp32_core_bound_ms=fp32_core_ms, unfused_ms=lib_ms)
            print(f"mel_frames highest ({kernel}: {KERNEL_DESIGNS[kernel]}; {traced}): N={B * n_frames}; "
                  f"max_abs_err {err:.3e} vs plain (atol {atol}); equal to the fused kernel's output on the same "
                  f"waveforms to the bit; two calls equal bits; kernel {ms:.4f} ms (device time, {timed_by}; "
                  f"replaced FP32-core design: {was} ms), plain {pms:.4f} ms, fused kernel on the same waveforms "
                  f"{fms:.4f} ms (device time), {note}; {nbytes / 1e6:.1f} MB {tag}")
            continue
        print(f"mel_frames {cfg.precision} ({kernel}; {traced}): N={B * n_frames}; max_abs_err {err:.3e} vs "
              f"plain, {err_fused:.3e} vs the fused kernel (atol {atol}); kernel {ms:.4f} ms (device time, "
              f"{timed_by}{f'; FP32-core design: {was} ms by events' if was else ''}), plain {pms:.4f} ms, fused "
              f"kernel on the same waveforms {fms:.4f} ms (device time), bound {bms:.4f} ms ({by}; "
              f"{ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) {tag}")
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
    del frames, buf32, buf, out, again, ref, other, one_tap, once, apart, re, im, db

    # 10. mega-block kernel vs plain; the unfused library route beside it
    megablock_phase(rng, dev, ((256, 3), (512, 7), (1024, 11)), t_frames, report, tag)

    # 11. fused serving path: TitaNet-S (17 mega-blocks), then TitaNet-L (5), B=128 x 3 s
    fused_launches, m32 = fused_phase(wav, lengths, n_frames, "s", 17, FUSED_VS_EMBED_STEP, tag)
    fused_l_launches, _ = fused_phase(wav, lengths, n_frames, "l", 5, FUSED_L_VS_EMBED_STEP, tag)

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
    del embedder, qtree, m32

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

        # 17. data-parallel training: two ranks on the card, the CLI under the launcher contract
        ddp_launches = parallel_phase(root, tag)

        # 18. step capture: the serving steps, the embedder and eval_step as CUDA graphs
        graph_launches = capture_phase(root, n_speakers, tag)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # 19. the train step as one CUDA graph, and remat
    train_graph_launches = train_capture_phase(tag)

    # 20. the data-parallel train step as one CUDA graph on every rank over NCCL (two cards or more)
    torch.cuda.empty_cache()
    ddp_graph_launches = ddp_capture_phase(tag) or {}

    # the f32 log-mel routes' launches on their paths: the train step's
    # (its frontend is "highest"), the f32 fused serving call's
    f32_launches = {"logmel": train_launches["pallas"]["logmel_dmma"],
                    "mel_frames": fused_launches["f32"]["mel_frames"]}
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
        extra = {}
        if key[0] in ("logmel", "mel_frames"):  # the f32 route at the same shape
            f = report[key[0], torch.float32]
            extra = {"f32_design": f["design"], "f32_launches": f32_launches[key[0]],
                     "f32_max_abs_err": f["max_abs_err"], "f32_ms": f["ms"], "f32_plain_ms": f["plain_ms"],
                     "f32_bound_ms": f["bound_ms"], "f32_bound_by": f["bound_by"],
                     "f32_design_bound_ms": f["design_bound_ms"],
                     "f32_fp32_core_bound_ms": f["fp32_core_bound_ms"], "f32_unfused_library_ms": f["unfused_ms"]}
        if key[0] == "megablock":  # the f32 route at the same shape, its launches those of the f32 fused call
            f = report["megablock", key[1], torch.float32]
            extra = {"f32_design": f["design"], "f32_launches": fused_launches["f32"]["megablock"],
                     "f32_max_abs_err": f["max_abs_err"], "f32_ms": f["ms"], "f32_plain_ms": f["plain_ms"],
                     "f32_bound_ms": f["bound_ms"], "f32_bound_by": f["bound_by"],
                     "f32_fp32_core_bound_ms": f["fp32_core_bound_ms"], "f32_unfused_library_ms": f["unfused_ms"],
                     "titanet_l": megablock_l_record(report, fused_l_launches)}
        kernels.append({
            "name": name_, "route": "cuda", "source": src, "replaces": line,
            "launches": path_launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "timed_by": r.get("timed_by", "events"),
            "zoo_trainer_launches": zoo,
            "device_corpus_trainer_launches": dc_launches[zoo_key] if zoo_key else None,
            "ddp_trainer_launches": ddp_launches[zoo_key] if zoo_key else None,
            "graph_launches": graph_launches.get(zoo_key, {}),
            "train_graph_launches": train_graph_launches.get(zoo_key),
            "ddp_graph_launches": ddp_graph_launches.get(zoo_key),
            **extra,
        })
    kernels += ecapa_route_records(report, zoo_launches)
    print(json.dumps({"kernels": kernels}))
    print(name)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def ecapa_route_records(report: dict, zoo_launches: dict) -> list:
    """The ``kernels`` line's records of ECAPA's context route (phase 3b's
    errors and times; ``launches``: ECAPA-1024's ``embed_step`` call in
    phase 15; each ECAPA family's launches in its phase-15 trainer run)."""
    ecapa = {fam: n for fam, n in zoo_launches.items() if fam.startswith("ecapa")}
    return [{
        "name": name_, "route": "cuda", "source": "titanet_torch/csrc/attn_pool.cu",
        "replaces": "titanet_tpu/models/ecapa.py::ChannelContextAttentivePooling (plain jnp)",
        "launches": ecapa["ecapa1024"]["embed_step_ctx"], **report[key],
        "zoo_trainer_launches": {fam: n["ctx"] for fam, n in ecapa.items()},
    } for key, name_ in (("ctx", "context_stats"), ("pool_rows", "attentive_pool_fwd_rows"))]


def megablock_l_record(report: dict, launches: dict) -> dict:
    """The mega-block kernel at (1024, 11) for the ``kernels`` line: each
    dtype's design, error, ms, plain ms, bound, FP32-core bound, unfused
    library route and clusters at once (phase 10), and its launches a
    TitaNet-L fused call (phase 11)."""
    import torch

    rec = {}
    for label, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        r = report["megablock", 1024, dt]
        rec[label] = {"design": r["design"], "launches": launches[label]["megablock"],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                      "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                      "fp32_core_bound_ms": r["fp32_core_bound_ms"], "unfused_library_ms": r["unfused_ms"],
                      "max_active_clusters": r["max_active_clusters"], "timed_by": r["timed_by"]}
    return rec


def main_only_megablock_l() -> int:
    """``--only megablock-l``: phase 1's build, phase 10 at (1024, 11) and
    phase 11 on TitaNet-L (the waveforms of the whole run), then the
    mega-block record at (1024, 11), the card's name and the last line."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from titanet_torch.ops import frontend as tf
    from titanet_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = card()
    tag = f"| card: {name}"
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall for {sorted(built)} {tag}")
    for src, (secs, log) in built.items():
        info = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln or "C75" in ln]
        print(f"  nvcc {src}: {secs:.2f} s; " + " / ".join(info))
    rng = np.random.default_rng(0)
    n_samples = SECONDS * SR
    wav = torch.from_numpy((rng.standard_normal((B, n_samples)) * 0.1).astype(np.float32)).to(dev)
    lengths = torch.full((B,), n_samples, dtype=torch.int32, device=dev)
    _, n_frames, _ = tf._framing_buffer(wav, 512, 160, lengths)
    report = {}
    megablock_phase(rng, dev, ((1024, 11),), n_frames, report, tag)
    launches, _ = fused_phase(wav, lengths, n_frames, "l", 5, FUSED_L_VS_EMBED_STEP, tag)
    print(json.dumps({"megablock_titanet_l": megablock_l_record(report, launches)}))
    print(name)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def main_only_ddp_capture() -> int:
    """``--only ddp-capture``: phase 1's build, then phase 20 alone (a
    four-card call spends its time there), the card's name and the last
    line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from titanet_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    tag = f"| card: {name}"
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall for {sorted(built)} {tag}")
    launches = ddp_capture_phase(tag)
    if launches is not None:
        print(json.dumps({"ddp_graph_launches": launches}))
    print(name)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-rank"]:
        sys.exit(ddp_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--ddp-capture-rank"]:
        sys.exit(ddp_capture_rank_main(sys.argv[2:]))
    if sys.argv[1:] == ["--only", "ddp-capture"]:
        sys.exit(main_only_ddp_capture())
    if sys.argv[1:] == ["--only", "megablock-l"]:
        sys.exit(main_only_megablock_l())
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]} (none, --only ddp-capture or --only megablock-l)",
              file=sys.stderr)
        sys.exit(2)
    sys.exit(main())
