#!/usr/bin/env python3
"""Where the time of the port's serving and training steps goes, on one GPU.

    python3 bench_torch.py [--batch 128] [--seconds 3] [--model-size s] [--blocks 17]
                           [--runs 20] [--variant embed|fused|int8|frames|all ...]
                           [--train] [--tree DIR]

Serving (default): for the serving (bf16, fused frontend) and parity (f32,
TF32 off) modes of ``titanet_torch.train.state.embed_step`` on TitaNet-S
(random weights from seed 0; ``--model-size l --blocks 5`` for TitaNet-L). ``--variant fused`` times the fused serving
variant instead (wav -> ``log_mel_spectrogram_pallas`` ->
``titanet_apply_fused`` -> ``l2_normalize``, bf16 and f32), ``int8`` the
quantized one (``embed_step_quantized`` on the f32 model's tree), ``all``
the three in turn; ``frames`` the frames log-mel wrapper alone
(``log_mel_frames`` on the batch's B x 301 frames, "default" and
"highest"). ``--train``: ``train_step`` on TitaNet-S
(bf16, dropout 0.5, fused f32 mel, CE over 251 classes, Adam 1e-3), through
its CUDA graph (the default on the card), under ``TITANET_DW_BWD`` = xla,
pallas, pallas, xla in turn, on one fixed batch.

For each mode: the median wall time per call (host clock around
synchronized calls) with quartiles, the median host time per call (the
call's return after an empty queue, not synchronized: what the host spends
issuing it), then a ``torch.profiler`` trace of 3
calls giving device time per kernel and the hand-written kernels' times;
training adds the peak device memory. Prints one JSON line per
mode, with the card's name and power limit.

``--tree DIR`` imports ``titanet_torch`` from another checkout (its kernels
built there), so that two versions are timed by one script in one session:
run it for the parent's tree and this one in turn, e.g. parent, this, this,
parent.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# the hand-written kernels by name; "megablock_kernel" is the FP32-core
# mega-block that the cluster design replaced, for an older --tree
OWN_KERNELS = (
    "logmel_kernel", "logmel_tc_kernel", "logmel_dmma_kernel", "attn_u_kernel", "attn_stats_kernel", "attn_de_kernel", "gemm_kernel",
    "pool_onepass_kernel", "pool_merge_kernel", "tc_de_kernel", "tc_dh_kernel", "tc_atb_kernel",
    "sum_parts_kernel", "dw_bwd_kernel", "dw_reduce_kernel", "megablock_cluster_kernel", "megablock_kernel",
    "megablock_tc_kernel", "mel_frames_tc_kernel", "mel_frames_dmma_kernel", "mel_frames_kernel",
)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def short(name: str) -> str:
    for k in OWN_KERNELS:
        if k in name:
            return k
    return name[:90]


def run_mode(label, step, runs):
    """Time ``step`` (one call, any return) and trace 3 calls of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    host = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()

    n_traced = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        for _ in range(n_traced):
            step()
        torch.cuda.synchronize()
    per_kernel = {}
    launches = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = short(ev.name)
            per_kernel[k] = per_kernel.get(k, 0.0) + ev.time_range.elapsed_us() / 1e3 / n_traced
            launches += 1
    device_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {
        "mode": label,
        "median_ms": statistics.median(times),
        "quartiles_ms": [statistics.quantiles(times, n=4)[0], statistics.quantiles(times, n=4)[2]],
        "host_ms_median": statistics.median(host),
        "device_ms_per_call": device_ms,
        "device_kernels_per_call": launches / n_traced,
        "own_kernels_ms": {k: per_kernel.get(k, 0.0) for k in OWN_KERNELS},
        "top_kernels_ms": top,
    }


def bench_train(args, dev, n, name) -> int:
    import numpy as np
    import torch

    from titanet_torch.losses.heads import build_head
    from titanet_torch.models import get_titanet
    from titanet_torch.ops.frontend import FrontendConfig
    from titanet_torch.train import state as ts

    n_cls = 251
    rng = np.random.default_rng(0)
    t = np.arange(n) / 16000.0
    f0 = rng.uniform(100.0, 2000.0, (args.batch, 1))
    amp = rng.uniform(0.05, 0.5, (args.batch, 1))
    wav = amp * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal((args.batch, n))
    wav = torch.from_numpy(wav.astype(np.float32)).to(dev)
    lengths = torch.full((args.batch,), n, dtype=torch.int32, device=dev)
    spk = torch.from_numpy(rng.integers(0, n_cls, args.batch)).to(dev)
    fe = FrontendConfig.from_ms(use_pallas_fused=True)
    for route in ("xla", "pallas", "pallas", "xla"):
        os.environ["TITANET_DW_BWD"] = route
        model = get_titanet(n_mega_blocks=args.blocks, dtype=torch.bfloat16, dropout=0.5, device=dev,
                            generator=torch.Generator().manual_seed(0))
        head = build_head("ce", 192, n_cls, device=dev, generator=torch.Generator().manual_seed(1))
        state = ts.create_train_state(model, head, ts.make_optimizer(start_lr=1e-3), seed=0)
        torch.cuda.reset_peak_memory_stats()

        def step():
            _, met = ts.train_step(state, wav, lengths, spk, frontend=fe)
            return met

        res = run_mode(f"bf16 train TITANET_DW_BWD={route}", step, args.runs)
        res.update(batch=args.batch, seconds=args.seconds, blocks=args.blocks, card=name,
                   utt_per_s=args.batch / res["median_ms"] * 1e3,
                   peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
        print(json.dumps(res))
        del state, model, head
    return 0


def main() -> int:
    import numpy as np
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--model-size", choices=("s", "m", "l"), default="s", help="the serving modes' TitaNet size")
    p.add_argument("--blocks", type=int, default=17)
    p.add_argument("--runs", type=int, default=20)
    p.add_argument("--variant", choices=("embed", "fused", "int8", "frames", "all"), nargs="+",
                   default=["embed"], help="serving variants: embed_step, the fused path, the int8 path, "
                   "the frames log-mel wrapper alone, or the first three")
    p.add_argument("--train", action="store_true", help="time train_step instead of embed_step")
    p.add_argument("--tree", help="import titanet_torch from this checkout instead")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device", file=sys.stderr)
        return 1
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    import titanet_torch
    from titanet_torch.models import get_titanet
    from titanet_torch.ops.frontend import FrontendConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    n = int(args.seconds * 16000)
    rng = np.random.default_rng(0)
    wav = torch.from_numpy((rng.standard_normal((args.batch, n)) * 0.1).astype(np.float32)).to(dev)
    lengths = torch.full((args.batch,), n, dtype=torch.int32, device=dev)
    name = f"{card()}; titanet_torch from {os.path.dirname(os.path.abspath(titanet_torch.__file__))}"
    if args.train:
        return bench_train(args, dev, n, name)
    from titanet_torch.models import l2_normalize
    from titanet_torch.models.fused_inference import titanet_apply_fused
    from titanet_torch.models.quantized import quantize_titanet
    from titanet_torch.ops import frontend as tf
    from titanet_torch.ops.kernels.melspec import log_mel_frames, log_mel_spectrogram_pallas
    from titanet_torch.train.state import embed_step, embed_step_quantized

    def embed(model, fe):
        return lambda: embed_step(model, wav, lengths, frontend=fe, device=dev)

    def fused(model, fe):
        def step():
            mel, _ = log_mel_spectrogram_pallas(wav, fe)
            return l2_normalize(titanet_apply_fused(model, mel))

        return step

    def int8(model, fe):
        qtree = quantize_titanet(model)
        return lambda: embed_step_quantized(qtree, wav, lengths, frontend=fe, device=dev)

    bf16 = ("bf16", torch.bfloat16, FrontendConfig.from_ms(precision="default", use_pallas_fused=True))
    f32 = ("f32", None, FrontendConfig.from_ms(use_pallas_fused=True))
    modes = {
        "embed": [("bf16 serving", embed, bf16), ("f32 parity", embed, f32)],
        "fused": [("fused bf16", fused, bf16), ("fused f32", fused, f32)],
        "int8": [("int8 (f32 model)", int8, f32)],
    }
    for variant in ("embed", "fused", "int8") if "all" in args.variant else args.variant:
        if variant == "frames":
            for _, dtype, fe in (bf16, f32):
                frames = tf.frame_signal(wav, fe.n_fft, fe.hop_length).reshape(-1, fe.n_fft).contiguous()
                _, _, _, basis, fb = tf._constants(fe, dev, dtype or torch.float32)

                def call(frames=frames, basis=basis, fb=fb, fe=fe):
                    return log_mel_frames(frames, basis, fb, precision=fe.precision, win_length=fe.win_length)

                res = run_mode(f"log_mel_frames {fe.precision}", call, args.runs)
                res.update(n_frames=frames.shape[0], card=name)
                print(json.dumps(res))
            continue
        for label, make, (_, dtype, fe) in modes[variant]:
            model = get_titanet(model_size=args.model_size, n_mega_blocks=args.blocks, dtype=dtype, device=dev,
                                generator=torch.Generator().manual_seed(0))
            res = run_mode(label, make(model, fe), args.runs)
            res.update(batch=args.batch, seconds=args.seconds, model_size=args.model_size, blocks=args.blocks,
                       card=name)
            print(json.dumps(res))
            del model
    return 0


if __name__ == "__main__":
    sys.exit(main())
