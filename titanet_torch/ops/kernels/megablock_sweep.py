"""Design sweep of the f32 mega-block kernel (``csrc/megablock.cu``,
``Tf32Cfg``) on one card: where its time goes and which tile is fastest.

    python3 -m titanet_torch.ops.kernels.megablock_sweep

Builds variants of the source (a tile of ``Tf256`` / ``Tf512``, or one part
of the split product changed) into ``titanet_torch/_build/sweep/``, one
``nvcc`` each, all started together, and times each at TitaNet-S's and
TitaNet-M's serving shapes (B=128, T=301, S=3; (C, k) = (256, 3), (512, 7))
with CUDA events, beside its error against the plain version and whether
two calls give the same bits. The parts changed:

- ``cvt``: the split with ``cvt.rna.tf32.f32`` in place of the integer
  rounding (the same values);
- ``trunc``: ``hi`` truncated, ``lo = x - hi`` handed to the mma unrounded;
- ``nosplit``: ``hi = x``, ``lo = 0``, three products (the split's cost;
  the result is single-pass TF32 and misses the limit by design);
- ``onepass``: one product of unsplit operands (one pass's cost; likewise).

It also measures what ``mma.sync.m16n8k8`` on TF32 gives on this card:
independent products from registers at 4 to 32 warps an SM. Prints the
card's name and power limit first. Nothing of the package calls this
module.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

SHAPES = ((256, 3), (512, 7))
B, T, S = 128, 301, 3

# (name, Tf256 arguments, Tf512 arguments, the changed part or None)
TILES = [
    ("design", None, None, None),
    ("256:ks16-nst3 512:nc256-w8", "256, 64, 256, 2, 4, 16, 3, 1", "512, 32, 256, 1, 8, 16, 3, 1", None),
    ("256:w16 512:nc512-w16", "256, 64, 256, 2, 8, 32, 2, 1", "512, 32, 512, 1, 16, 16, 2, 1", None),
    ("256:w4-64x64 512:nc256-w4", "256, 64, 256, 1, 4, 32, 2, 1", "512, 32, 256, 1, 4, 32, 2, 1", None),
    ("256:nc128 512:nc128", "256, 64, 128, 2, 4, 32, 3, 1", "512, 32, 128, 1, 8, 32, 3, 1", None),
    ("256:rm64-ks32", "256, 64, 256, 2, 4, 32, 2, 1", None, None),
    ("256:rm80-nst3", "256, 80, 256, 1, 8, 16, 3, 1", None, None),
    ("in place 256:rm80 512:rm48", "256, 80, 256, 1, 8, 32, 2, 1, true", "512, 48, 512, 1, 8, 16, 2, 1, true", None),
    ("in place 256:rm112 512:rm64", "256, 112, 256, 1, 8, 32, 2, 1, true", "512, 64, 512, 1, 8, 16, 2, 1, true",
     None),
    ("in place 256:rm128", "256, 128, 256, 1, 8, 32, 2, 1, true", None, None),
    ("cvt", None, None, "cvt"),
    ("trunc", None, None, "trunc"),
    ("nosplit", None, None, "nosplit"),
    ("onepass", None, None, "onepass"),
]

_RNA = "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;"
_SPLIT = "  hi = tf32_rna(x);\n  lo = tf32_rna(x - __uint_as_float(hi));"
_PARTS = {
    "cvt": [(_RNA, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n  return r;')],
    "trunc": [(_SPLIT, "  hi = __float_as_uint(x) & 0xFFFFE000u;\n  lo = __float_as_uint(x - __uint_as_float(hi));")],
    "nosplit": [(_SPLIT, "  hi = __float_as_uint(x);\n  lo = 0u;")],
}
# the two small passes of warp_mma_3xtf32, dropped for "onepass"
_SMALL_PASSES = re.compile(
    r"#pragma unroll\n    for \(int i = 0; i < MT; \+\+i\)\n      if \(i \* 16 < m_rows\)\n#pragma unroll\n"
    r"        for \(int j = 0; j < NT; \+\+j\) mma_1688_tf32\(acc\[i\]\[j\], (al\[i\], bh|ah\[i\], bl)\[j\]\[0\], "
    r"(bh|bl)\[j\]\[1\]\);\n")

_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void probe(float* out, int iters) {
  float acc[8][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u}, b0 = threadIdx.x, b1 = 5u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
                   "{%0,%1,%2,%3};\n"
                   : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int q = 0; q < 4; ++q) s += acc[j][q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_probe(float* out, int blocks, int threads, int iters) {
  probe<<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def variant_source(src: str, tf256, tf512, part) -> str:
    """``src`` with the tiles and the part of the split product replaced;
    raises if an anchor is missing (the source moved on)."""
    for name, args in (("Tf256", tf256), ("Tf512", tf512)):
        if args is not None:
            src, n = re.subn(rf"using {name} = Tf32Cfg<[^>]*>;", f"using {name} = Tf32Cfg<{args}>;", src)
            assert n == 1, name
    if part == "onepass":
        src = variant_source(src, None, None, "nosplit")
        src, n = _SMALL_PASSES.subn("", src)
        assert n == 2, "the two small passes"
    for old, new in _PARTS.get(part, []):
        assert old in src, part
        src = src.replace(old, new)
    return src


def build_all(out_dir: str) -> dict:
    from titanet_torch.ops.kernels import _build

    os.makedirs(out_dir, exist_ok=True)
    src = (_build.CSRC_DIR / "megablock.cu").read_text()
    sources = {name: variant_source(src, a, b, part) for name, a, b, part in TILES}
    sources["probe"] = _PROBE
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        path = os.path.join(out_dir, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libv{i}.so")
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", lib, path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc exited {proc.returncode}\n{log}")
        regs = re.findall(r"Tf32CfgILi(\d+)E.*?\n.*?\n.*?Used (\d+) registers", log)
        print(f"built {name}: registers " + ", ".join(f"C={c}: {r}" for c, r in regs))
        libs[name] = ctypes.CDLL(lib)
    return libs


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


def main() -> int:
    import numpy as np
    import torch

    from titanet_torch.ops.kernels import _build
    from titanet_torch.ops.kernels.megablock import fused_sub_blocks_plain

    if not torch.cuda.is_available():
        print("megablock_sweep: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    libs = build_all(str(_build.BUILD_DIR / "sweep"))
    dev = torch.device("cuda")

    probe = libs.pop("probe")
    probe.run_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for warps in (4, 8, 16, 32):
        out = torch.empty(n_sm * warps * 32, device=dev)
        iters = 4000
        ms = events_ms(lambda: probe.run_probe(out.data_ptr(), n_sm, warps * 32, iters), iters=1)
        n = n_sm * warps * iters * 8
        print(f"mma.sync.m16n8k8 tf32 from registers, {warps} warps an SM: "
              f"{n * 2048 / (ms * 1e-3) / 1e12:.1f} TFLOP/s ({n / n_sm / (ms * 1e-3) / 1e9:.3f} G products/s an SM)")

    for lib in libs.values():
        lib.titanet_megablock_f32.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.titanet_megablock_f32.restype = ctypes.c_int
    rng = np.random.default_rng(0)
    for c, k in SHAPES:
        f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
        args = (f32(rng.standard_normal((B, T, c))), f32(rng.standard_normal((S, k, c)) * 0.5),
                f32(rng.standard_normal((S, c)) * 0.3), f32(rng.standard_normal((S, c, c)) / np.sqrt(c)),
                f32(rng.standard_normal((S, c)) * 0.3),
                f32(np.stack([rng.uniform(0.5, 1.5, (S, c)), rng.standard_normal((S, c)) * 0.3], axis=1)))
        ref = fused_sub_blocks_plain(*args, kernel_size=k)
        top = ref.abs().max().item()
        for name, lib in libs.items():
            out = torch.empty_like(args[0])

            def call(lib=lib, out=out):
                code = lib.titanet_megablock_f32(*(t.data_ptr() for t in args), out.data_ptr(), B, T, c, S, k,
                                                 torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"variant {name} C={c}: launch failed ({code})")

            call()
            first = out.clone()
            call()
            torch.cuda.synchronize()
            err = (out - ref).abs().amax(dim=(0, 2)).max().item() / top
            print(f"{name:28s} (C, k) = ({c}, {k}): {events_ms(call):.4f} ms (CUDA events, 20 calls); error "
                  f"{err:.2e} of the largest entry ({'within' if err <= 1e-4 else 'OVER'} 1e-4); "
                  f"repeat {'equal bits' if torch.equal(first, out) else 'DIFFERS'} | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
