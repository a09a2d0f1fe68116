"""Design sweep of the f32 log-mel kernels (``csrc/logmel_common.cuh``,
``dmma_logmel_tile``; ``logmel_dmma_kernel`` and ``mel_frames_dmma_kernel``)
on one card: what the split-TF32 DFT the design replaced costs and
misses.

    python3 -m titanet_torch.ops.kernels.logmel_sweep

Builds ``csrc/logmel.cu`` and ``csrc/mel_frames.cu`` once for each variant
(its ``-D`` flags to ``nvcc``; the sources themselves are not changed) into
``titanet_torch/_build/sweep_logmel/``, one ``nvcc`` each, all started
together, and times each route at TitaNet's frontend, B=128 x 3 s (N =
38,528 frames), with CUDA events on seeded noise (std 0.1; ``chip_smoke.py``
phases 2 and 9), beside its largest error against the plain version there
and, for the fused route, on every batch of the trainer's loaders as
``chip_smoke.py`` phase 13 builds them (its synthetic corpus of 64
speakers x 16 utterances, staged as int16 and widened: clean speech whose
mel bands under the pitch sit at the 16-bit quantization floor, 100 dB
below the loudest). The variants:

- ``design``: the shipped kernels;
- ``split-tf32``: the DFT as split TF32 (``hi = rna(x)``, ``lo = rna(x -
  hi)``, ``a_lo*b_hi + a_hi*b_lo + a_hi*b_hi`` a k8 step on
  ``mma.sync.m16n8k8.tf32``, f32 sums; ``TITANET_DMMA_SPLIT_TF32_DFT``) on
  the same tiles, the basis pack split into TF32 hi and lo in its 16 bytes
  a lane: the design this one replaced (its error on the trainer's batches
  is what the f32 routes' 1e-4 limit could not hold).

Prints the card's name and power limit first. Nothing of the package calls
this module.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

B, SECONDS, SR = 128, 3, 16000

# (name, nvcc defines)
VARIANTS = [
    ("design", []),
    ("split-tf32", ["-DTITANET_DMMA_SPLIT_TF32_DFT"]),
]


def build_all(out_dir: str) -> dict:
    """Every variant's two libraries, ``{(name, source): (path, registers,
    spill bytes)}``; one nvcc each, all started together."""
    from titanet_torch.ops.kernels import _build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, defines in VARIANTS:
        for src in ("logmel", "mel_frames"):
            lib = os.path.join(out_dir, f"lib{src}-{name}.so")
            cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *defines, "-o", lib, str(_build.CSRC_DIR / f"{src}.cu")]
            procs[name, src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                                lib)
    out = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {key}: nvcc failed\n{log}")
        kernel = "logmel_dmma_kernel" if key[1] == "logmel" else "mel_frames_dmma_kernel"
        regs = spills = None
        for block in log.split("Compiling entry function")[1:]:
            if kernel in block.splitlines()[0]:
                regs = re.search(r"Used (\d+) registers", block).group(1)
                spills = re.search(r"(\d+) bytes spill stores", block).group(1)
        out[key] = (lib, regs, spills)
    return out


def events_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def trainer_batches(device):
    """The fused log-mel operands of every batch of ``chip_smoke.py`` phase
    13's train, validation and test loaders (the lengths each step passes:
    none for a uniform train batch), as ``(args, kwargs)`` of
    ``log_mel_fused``."""
    import tempfile

    from titanet_torch import cli
    from titanet_torch.config import Config
    from titanet_torch.ops import frontend as tf
    from titanet_torch.train import loop
    from titanet_torch.train import state as ts

    with tempfile.TemporaryDirectory() as root:
        cfg = Config.from_dict({
            "dataset": {"name": "synthetic", "synthetic_speakers": 64, "synthetic_utterances": 16},
            "training": {"batch_size": 64, "epochs": 1, "dtype": "bfloat16", "loss": "ce",
                         "checkpoints_path": root, "run_name": "sweep"},
            "validation": {"every": 1, "batch_size": 64, "num_utterances_per_speaker": 4},
            "test": {"num_speakers": 8, "num_utterances_per_speaker": 4},
            "generic": {"seed": 0, "workers": 2, "embedding_size": 192},
            "augmentation": {"enable": ["chunk", "specaugment", "noise"]},
        })
        train_ds, val_ds, test_ds, _ = cli._datasets(cfg, True)
        frontend = cli._frontend(cfg)
        loaders = dict(zip(("train", "val", "test"), cli._loaders(cfg, train_ds, val_ds, test_ds, None)))
        loaders["train"].set_epoch(1)
        out = []
        for kind, ld in loaders.items():
            for (wav, lengths, _), batch in loop._staged_batches(ld, device):
                uniform = int(batch.lengths.min()) == wav.shape[1]
                lens = None if kind == "train" and uniform else lengths
                out.append(tf.log_mel_fused_operands(ts._dequantize_waveform(wav), frontend, lens))
        return out


def main() -> int:
    import numpy as np
    import torch

    from titanet_torch.ops import frontend as tf
    from titanet_torch.ops.kernels import _build
    from titanet_torch.ops.kernels import melspec as ms

    if not torch.cuda.is_available():
        print("logmel_sweep: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    libs = build_all(str(_build.BUILD_DIR / "sweep_logmel"))
    dev = torch.device("cuda")
    cfg = tf.FrontendConfig.from_ms()
    _, _, _, basis, fb = tf._constants(cfg, dev, torch.float32)
    k0, taps = ms.tc_taps(*ms._window_taps(cfg.n_fft, cfg.win_length))
    design_pack = ms.dmma_basis(basis, k0, k0 + taps)
    fbp, table = ms.dmma_filterbank(fb)
    v, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    n = SECONDS * SR
    wav = torch.from_numpy((np.random.default_rng(0).standard_normal((B, n)) * 0.1).astype(np.float32)).to(dev)
    lengths = torch.full((B,), n, dtype=torch.int32, device=dev)
    buf, n_frames, _ = tf._framing_buffer(wav, cfg.n_fft, cfg.hop_length, lengths)
    buf = buf.contiguous()
    frames = tf.frame_signal(wav, cfg.n_fft, cfg.hop_length, lengths=lengths).reshape(-1, cfg.n_fft).contiguous()
    plain = ms.log_mel_fused_plain(buf, lengths, basis, fb, n_frames=n_frames, hop=cfg.hop_length)
    corpus = [(args, kw, ms.log_mel_fused_plain(*args, n_frames=kw["n_frames"], hop=kw["hop"]))
              for args, kw in trainer_batches(dev)]
    stream = torch.cuda.current_stream().cuda_stream
    for name, _ in VARIANTS:
        pack = design_pack
        if name == "split-tf32":  # each f32 entry split into TF32 hi and lo: (b0_hi, b1_hi, b0_lo, b1_lo)
            hi, lo = ms.tf32_split(pack.float().reshape(-1, 2))
            pack = torch.cat((hi, lo), dim=1).contiguous()
        fused_lib, fused_regs, fused_spill = libs[name, "logmel"]
        frames_lib, frames_regs, frames_spill = libs[name, "mel_frames"]
        fused_fn = ctypes.CDLL(fused_lib).titanet_logmel_f32_dmma
        fused_fn.argtypes = [v, i64, i32, i32, v, v, v, v, i32, v, i32, i32, i32, i32, i32, i32, v]
        frames_fn = ctypes.CDLL(frames_lib).titanet_mel_frames_dmma
        frames_fn.argtypes = [v, i32, v, v, v, i32, v, i32, i32, i32, i32, i32, v]

        def fused(b, lens, nf, out):
            code = fused_fn(b.data_ptr(), b.stride(0), b.shape[1], b.shape[0],
                            None if lens is None else lens.data_ptr(), pack.data_ptr(), fbp.data_ptr(),
                            table.data_ptr(), table.shape[1], out.data_ptr(), nf, cfg.hop_length, k0, taps,
                            basis.shape[2], cfg.n_mels, stream)
            if code:
                raise RuntimeError(f"variant {name}: fused launch failed ({code})")

        out_f = torch.empty(B, n_frames, cfg.n_mels, device=dev)
        out_r = torch.empty_like(out_f)

        def own():
            code = frames_fn(frames.data_ptr(), frames.shape[0], pack.data_ptr(), fbp.data_ptr(),
                             table.data_ptr(), table.shape[1], out_r.data_ptr(), cfg.n_fft, k0, taps,
                             basis.shape[2], cfg.n_mels, stream)
            if code:
                raise RuntimeError(f"variant {name}: frames launch failed ({code})")

        fused(buf, lengths, n_frames, out_f)
        own()
        torch.cuda.synchronize()
        err_f = (out_f - plain).abs().max().item()
        err_r = (out_r.reshape(out_f.shape) - plain).abs().max().item()
        equal = torch.equal(out_f, out_r.reshape(out_f.shape))
        t_f = events_ms(lambda: fused(buf, lengths, n_frames, out_f))
        t_r = events_ms(own)
        err_c = 0.0
        for (b, lens, _, _), kw, ref in corpus:
            got = torch.empty_like(ref)
            fused(b, lens, kw["n_frames"], got)
            err_c = max(err_c, (got - ref).abs().max().item())
        print(f"{name}: registers fused {fused_regs} (spill {fused_spill} B), frames {frames_regs} (spill "
              f"{frames_spill} B); fused {t_f:.4f} ms, frames {t_r:.4f} ms (events); noise: max abs err vs plain "
              f"{err_f:.3e} / {err_r:.3e}, routes equal bits {equal}; the trainer's {len(corpus)} batches "
              f"(fused): max abs err vs plain {err_c:.3e}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    sys.exit(main())
