"""Where the bf16 one-pass pool forward (``csrc/attn_pool.cu``,
``pool_onepass_kernel``) spends its time, on one card.

    python3 -m titanet_torch.ops.kernels.pool_sweep

Builds variants of the source with one part taken out into
``titanet_torch/_build/pool_sweep/``, one ``nvcc`` each, all started
together, and times each at TitaNet-S's training and serving shape (B=128,
T=301, C=1536, H=128, bf16), fold on and off, with CUDA events (30 calls,
two rounds), beside the design's error against the plain version. A variant
that takes a part out computes garbage; only its time means something. The
parts:

- ``no weight loads``: the Wa / Wb stages are not requested (the L2 stream
  of the weights, 768 KB a 128-frame tile);
- ``no h re-read``: step E does not read its h stage again (step U's read
  stays);
- ``no weights, no re-read``: both, so that only step U's one read of h is
  left;
- ``no softmax``: step E's products run, its online softmax does not;
- ``no products``: no ``wgmma`` in either step.

Prints the card's name and power limit first. Nothing of the package calls
this module.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

B, T, C, H = 128, 301, 1536, 128

_EXPECT = "      mbar_expect_tx(full + sl, kOpStageBytes);"
_WA0 = "        tma_2d(w, &tm_wa, 0, ch0, full + sl, keep);"
_WA1 = "        tma_2d(w + 4096, &tm_wa, 64, ch0, full + sl, keep);"
_WB = "        tma_2d(w, &tm_wb, ch0, 0, full + sl, keep);"
_H = "      tma_3d(w + kOpWBytes / 2, &tm_h, ch0, ld_t0, b, full + sl, ld_r < NH ? keep : l2_policy(false));"
_SOFTMAX = ("          onepass_softmax<kFold, false>(acc, st, hs, f, wq, lane, fvalid);",
            "          onepass_softmax<kFold, true>(acc, st, hs, f, wq, lane, fvalid);")
_NO_WEIGHTS = [(_EXPECT, "      mbar_expect_tx(full + sl, kOpHBytes);")] + [(x, "if (0) " + x.lstrip()) for x in (_WA0, _WA1, _WB)]
_NO_REREAD = [(_EXPECT, "      mbar_expect_tx(full + sl, ld_r < NH ? kOpStageBytes : kOpWBytes);"),
              (_H, "      if (ld_r < NH) " + _H.lstrip())]
VARIANTS = {
    "design": [],
    "no weight loads": _NO_WEIGHTS,
    "no h re-read": _NO_REREAD,
    "no weights, no re-read": [(_EXPECT, "      mbar_expect_tx(full + sl, ld_r < NH ? kOpHBytes : 0);")]
    + [(x, "if (0) " + x.lstrip()) for x in (_WA0, _WA1, _WB)] + [(_H, "      if (ld_r < NH) " + _H.lstrip())],
    "no softmax": [(x, "          if (i < 0) " + x.lstrip()) for x in _SOFTMAX],
    "no products": [("tc::wgmma_m64n128k16_rs(acc_u", "if (0) tc::wgmma_m64n128k16_rs(acc_u"),
                    ("tc::wgmma_m64n64k16_tn(acc,", "if (0) tc::wgmma_m64n64k16_tn(acc,")],
}


def variant_source(src: str, subs) -> str:
    """``src`` with each (old, new) replaced once; raises if an anchor is
    missing (the source moved on)."""
    for old, new in subs:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


def build_all(out_dir: str) -> dict:
    from titanet_torch.ops.kernels import _build

    os.makedirs(out_dir, exist_ok=True)
    src = (_build.CSRC_DIR / "attn_pool.cu").read_text()
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        path = os.path.join(out_dir, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(variant_source(src, subs))
        lib = os.path.join(out_dir, f"libv{i}.so")
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", lib, path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc exited {proc.returncode}\n{log}")
        cdll = ctypes.CDLL(lib)
        cdll.titanet_attn_pool_fwd_bf16.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        cdll.titanet_attn_pool_fwd_bf16.restype = ctypes.c_int
        cdll.titanet_attn_pool_fwd_scratch_bytes.argtypes = [ctypes.c_int] * 5
        cdll.titanet_attn_pool_fwd_scratch_bytes.restype = ctypes.c_longlong
        libs[name] = cdll
    return libs


def events_ms(fn, iters: int = 30) -> float:
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


def main() -> int:
    import numpy as np
    import torch

    from titanet_torch.ops.kernels import _build
    from titanet_torch.ops.kernels.pool import attentive_pool_fwd_plain

    if not torch.cuda.is_available():
        print("pool_sweep: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    libs = build_all(str(_build.BUILD_DIR / "pool_sweep"))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)  # noqa: E731
    args = (f32(rng.standard_normal((B, T, C))).bfloat16(), f32(rng.uniform(0.5, 1.5, C)),
            f32(rng.standard_normal(C) * 0.2), f32(rng.uniform(-1, 1, (C, H)) / np.sqrt(C)).bfloat16(),
            f32(rng.uniform(-1, 1, H) / np.sqrt(C)), f32(rng.uniform(-1, 1, (H, C)) / np.sqrt(H)).bfloat16(),
            f32(rng.uniform(-1, 1, C) / np.sqrt(H)))
    out = torch.empty(B, 2 * C, device=dev, dtype=torch.bfloat16)
    for rnd in range(2):
        for name, lib in libs.items():
            scratch = torch.empty(lib.titanet_attn_pool_fwd_scratch_bytes(B, T, C, H, 2), device=dev,
                                  dtype=torch.uint8)
            for fold in (True, False):
                def call(lib=lib, fold=fold, scratch=scratch):
                    code = lib.titanet_attn_pool_fwd_bf16(
                        *(x.data_ptr() for x in args), scratch.data_ptr(), out.data_ptr(), B, T, C, H, 1e-6,
                        int(fold), torch.cuda.current_stream().cuda_stream)
                    if code:
                        raise RuntimeError(f"variant {name}: launch failed ({code})")

                ms = events_ms(call)
                note = ""
                if name == "design":
                    call()
                    ref = attentive_pool_fwd_plain(*args, 1e-6, fold)
                    note = f"; error vs plain {(out.float() - ref.float()).abs().max().item():.3e}"
                print(f"round {rnd} {name:24s} fold={fold!s:5s}: {ms:.4f} ms (CUDA events, 30 calls){note} | {card}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
