#!/usr/bin/env python3
"""Where the time of the fused log-mel's tensor-core kernel goes, on one GPU.

    python3 bench_logmel_tc.py [--batch 128] [--seconds 3]

Builds copies of ``titanet_torch/csrc/logmel.cu`` with one part of
``logmel_tc_kernel`` taken out or changed (below), each with ``nvcc`` into
``titanet_torch/_build/variants/`` (git-ignored), and times every copy and
the kernel itself by profiler device time (``chip_smoke.device_ms``) on the
serving shapes (TitaNet frontend, bf16, random waveforms from seed 0), in
turns: all once, then all again in reverse order, and once more by CUDA
events around 20 calls (a check on the profiler's reading). A copy without
a part computes a wrong result; only its time is read. The copies that
compute the same function (``SAME_RESULT``) must give the kernel's bits.
Prints one line a variant and, last, one JSON object with every time and
the card's name and power limit. Variants:

- ``kernel``: the source as it is;
- ``warp_branch``: the first design's branch on the warp index around the
  products (in the first design's single loop over all slabs, with the
  accumulators zeroed by a loop, it made ptxas serialize every ``wgmma``:
  note C7518);
- ``no_mel_product``: no power and mel product (the accumulators are still
  read, so the DFT products stay);
- ``no_basis_copies``: the basis slabs are not copied after the first ring
  fill (the products read stale slabs);
- ``no_frames_copies``: the frames tile is zero-filled, nothing read;
- ``dft_only``: the three above together: the DFT products, the pipeline's
  waits and barriers, the epilogue;
- ``ring3``: a 3-stage basis ring (one slab in flight) in place of 4.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

KEEP_DFT = ("      if (grp >= groups) continue;",
            "      if (grp >= 0) { macc[0][0] += acc[4 * grp] + acc[4 * grp + 64]; continue; }")
NO_BASIS = ("      if (g + AHEAD < total) load_slab(g + AHEAD, (g + AHEAD) % STAGES);", "")
NO_FRAMES = ("const int n_valid = src ? max(0, min(8, taps - k)) : 0;", "const int n_valid = 0;")
VARIANTS = {
    "kernel": [],
    "warp_branch": [("      // every warp runs the products, the rows past the end on zeros\n",
                    "      if (rows <= wgm * 64) continue;  // a branch on the warp index\n")],
    "no_mel_product": [KEEP_DFT],
    "no_basis_copies": [NO_BASIS],
    "no_frames_copies": [NO_FRAMES],
    "dft_only": [KEEP_DFT, NO_BASIS, NO_FRAMES],
    "ring3": [("for (int s = 4; s >= 3; --s)", "for (int s = 3; s >= 3; --s)")],
}
SAME_RESULT = ("kernel", "warp_branch", "ring3")


def ptxas_notes(log):
    """The ptxas lines about ``logmel_tc_kernel``: its registers, spills and
    performance notes (C75xx), shortened."""
    notes, current = [], ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            current = ln
        elif "logmel_tc_kernel" in ln and "C75" in ln:
            notes.append(ln.split("ptxas info    : ")[-1].split(" in function")[0])
        elif "logmel_tc_kernel" in current and ("registers" in ln or "spill" in ln):
            notes.append(ln.split("ptxas info    : ")[-1].strip())
    return sorted(set(notes))


def build_variants(names):
    """``{name: (ctypes library, ptxas notes)}``, one ``nvcc`` a variant,
    all started together."""
    from titanet_torch.ops.kernels import _build

    src = (_build.CSRC_DIR / "logmel.cu").read_text()
    procs = {}
    for name in names:
        out = _build.BUILD_DIR / "variants" / name
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        for header in _build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(header, out)
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the source no longer holds {old.strip()!r}")
            text = text.replace(old, new)
        (out / "logmel.cu").write_text(text)
        lib = out / "liblogmel.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(out / "logmel.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc exited {proc.returncode}\n{log}")
        built[name] = (ctypes.CDLL(str(lib)), ptxas_notes(log))
    return built


def main() -> int:
    import numpy as np
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("bench_logmel_tc: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import card, cuda_ms, device_ms
    from titanet_torch.ops import frontend as tf
    from titanet_torch.ops.kernels import melspec as ms

    dev = torch.device("cuda")
    name = card()
    n = int(args.seconds * 16000)
    wav = torch.from_numpy((np.random.default_rng(0).standard_normal((args.batch, n)) * 0.1)
                           .astype(np.float32)).to(dev)
    cfg = tf.FrontendConfig.from_ms(precision="default", use_pallas_fused=True)
    buf, n_frames, _ = tf._framing_buffer(wav, cfg.n_fft, cfg.hop_length, None)
    buf = buf.bfloat16().contiguous()
    _, _, _, basis, fb = tf._constants(cfg, dev, torch.bfloat16)

    def run():
        return ms.log_mel_fused(buf, None, basis, fb, n_frames=n_frames, hop=cfg.hop_length,
                                win_length=cfg.win_length)

    built = build_variants(VARIANTS)
    orig = ms._lib
    own = orig()
    for lib, _ in built.values():
        for fn in ("titanet_logmel_bf16_tc", "titanet_logmel_error_string"):
            getattr(lib, fn).argtypes = getattr(own, fn).argtypes
            getattr(lib, fn).restype = getattr(own, fn).restype
    times, events, outs = {v: [] for v in VARIANTS}, {}, {}
    try:
        for v in list(VARIANTS) + list(reversed(VARIANTS)):
            ms._lib = lambda lib=built[v][0]: lib
            times[v].append(device_ms(run, names=("logmel_tc_kernel",), iters=20)[0])
        for v in VARIANTS:
            ms._lib = lambda lib=built[v][0]: lib
            events[v] = cuda_ms(run, iters=20)
            outs[v] = run()
        err = (outs["kernel"] - ms.log_mel_fused_plain(buf, None, basis, fb, n_frames=n_frames,
                                                       hop=cfg.hop_length)).abs().max().item()
    finally:
        ms._lib = orig
    same = {v: torch.equal(outs[v], outs["kernel"]) for v in SAME_RESULT}
    for v, t in times.items():
        print(f"{v}: {t[0]:.4f} / {t[1]:.4f} ms (device time, two turns), {events[v]:.4f} ms (CUDA events)"
              f"{f'; same bits as the kernel: {same[v]}' if v in same else ''}; ptxas: {'; '.join(built[v][1])} "
              f"| card: {name}")
    print(json.dumps({"batch": args.batch, "seconds": args.seconds, "kernel_max_abs_err_vs_plain": err,
                      "ms": times, "events_ms": events, "same_bits": same, "card": name}))
    if not all(same.values()):
        print("bench_logmel_tc: a variant that computes the kernel's function gave other bits", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
