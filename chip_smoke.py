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
     (> 0.999).

The line before the last is the card's name and power limit; before it, a
JSON line with each kernel's launches on its path (serving for the forward
kernels, the pallas-route training step for the backward kernels, the
fused serving call for the frames and mega-block kernels), error
vs its plain version, time, plain time, bound and library time, every number
from this run, and ``timed_by``: ``"profiler"`` (device time of the
kernel's launches), or ``"events"`` (CUDA events around its wrapper) where
the profiler saw no device time. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
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


def device_ms(fn, names=None, iters=10, warmup=3, attempts=3):
    """Device time of one ``fn()`` in ms: the CUDA kernels that
    ``torch.profiler`` records over ``iters`` calls (those whose name holds
    one of ``names``, or all), summed and divided by ``iters``. A trace can
    lose kernel records: after a large one (phase 8's train steps) each
    trace lost its first two (18 of 20 single-launch calls recorded,
    NVIDIA H100 80GB HBM3), and now and then one loses more. So the calls
    are traced after a traced warm-up cycle of as many calls, which takes the
    first loss, and a trace is taken again (``attempts`` in all) unless it
    holds the same whole number of records for every call. Returns
    ``(ms, "profiler")``, or CUDA-event time and ``"events"`` where no trace
    was whole."""
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
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and (names is None or any(n in e.name for n in names))]
        if us and len(us) % iters == 0:
            return sum(us) / iters / 1e3, "profiler"
    return cuda_ms(fn, iters=iters, warmup=0), "events"


def library_dw_conv(x, w, b):
    """The library's depthwise same-pad conv (cuDNN grouped conv), f32
    parameters cast to x's dtype, as the port's xla route runs it."""
    from titanet_torch.ops.conv import conv1d_same

    return conv1d_same(x, w.to(x.dtype), b.to(x.dtype), groups=x.shape[-1])


def bound_ms(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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
    grad_names = ("dh", "da", "dc", "dwa", "dba", "dwb", "dbb")
    g32 = torch.from_numpy(rng.standard_normal((B, 2 * ch)).astype(np.float32)).to(dev)
    h32 = torch.from_numpy(rng.standard_normal((B, t_frames, ch)).astype(np.float32)).to(dev)
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        h, wa, wb, g = h32.to(dt), wa32.to(dt).contiguous(), wb32.to(dt).contiguous(), g32.to(dt)
        for fold in (True, False):
            args = (h, a, c, wa, ba, wb, bb, g, 1e-6, fold)
            got, ref = attentive_pool_bwd(*args), attentive_pool_bwd_plain(*args)
            torch.cuda.synchronize()
            errs = {}
            for gname, x, r in zip(grad_names, got, ref):
                if not torch.isfinite(x).all() or x.shape != r.shape or x.dtype != r.dtype:
                    raise AssertionError(f"pool backward {dt} fold={fold}: {gname} bad shape, dtype or value")
                if gname in ("da", "dc") and not fold:
                    if x.any() or r.any():
                        raise AssertionError(f"pool backward {dt}: {gname} not zero without the fold")
                    continue
                # dbb is zero in exact arithmetic (softmax over T ignores a
                # per-channel shift): both are noise, held below tol of max |dWb|
                scale = ref[5].abs().max().item() if gname == "dbb" else r.float().abs().max().item()
                err = (x.float() - r.float()).abs().max().item()
                errs[gname] = err / scale
                if gname == "dbb":
                    err = max(x.abs().max().item(), r.abs().max().item())
                if err > tol * scale:
                    raise AssertionError(f"pool backward {dt} fold={fold}: {gname} error {err} > {tol} x {scale}")
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

    def median_ms(fn, runs=10, warmup=3):
        times = []
        for i in range(warmup + runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i >= warmup:
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), min(times), max(times)

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

    kernels = []
    for key, name_, src, line, path_launches in (
        (("logmel", torch.bfloat16), "logmel_fused", "titanet_torch/csrc/logmel.cu",
         "titanet_tpu/ops/pallas/melspec.py:271", launches["logmel"]),
        (("pool", torch.bfloat16, True), "attentive_pool_fwd", "titanet_torch/csrc/attn_pool.cu",
         "titanet_tpu/ops/pallas/pool.py:234", launches["pool"]),
        (("pool_bwd", torch.bfloat16, True), "attentive_pool_bwd", "titanet_torch/csrc/attn_pool.cu",
         "titanet_tpu/ops/pallas/pool.py:270", train_launches["pallas"]["pool_bwd"]),
        (("dw_bwd", 3), "dw_bwd", "titanet_torch/csrc/dw_bwd.cu",
         "titanet_tpu/ops/pallas/dwconv.py:102", train_launches["pallas"]["dw_bwd"]),
        (("megablock", 256, torch.bfloat16), "fused_sub_blocks", "titanet_torch/csrc/megablock.cu",
         "titanet_tpu/ops/pallas/megablock.py:110", fused_launches["bf16"]["megablock"]),
        (("mel_frames", torch.bfloat16), "log_mel_frames", "titanet_torch/csrc/mel_frames.cu",
         "titanet_tpu/ops/pallas/melspec.py:109", fused_launches["bf16"]["mel_frames"]),
    ):
        r = report[key]
        kernels.append({
            "name": name_, "route": "cuda", "source": src, "replaces": line,
            "launches": path_launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "timed_by": r.get("timed_by", "events"),
        })
    print(json.dumps({"kernels": kernels}))
    print(name)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
