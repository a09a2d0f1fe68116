"""Design sweep of the mega-block kernel (``csrc/megablock.cu``) on one
card: where its time goes and which tile is fastest.

    python3 -m titanet_torch.ops.kernels.megablock_sweep [256-512 | 1024]

Builds variants of the source (one ``nvcc`` each, all started together, into
``titanet_torch/_build/sweep/``) and times each with CUDA events, beside its
error against the plain version and whether two calls give the same bits.

``256-512``: the f32 tiles (``Tf32Cfg``) at TitaNet-S's and TitaNet-M's
serving shapes (B=128, T=301, S=3; (C, k) = (256, 3), (512, 7)): a tile of
``Tf256`` / ``Tf512``, or one part of the split product changed:

- ``cvt``: the split with ``cvt.rna.tf32.f32`` in place of the integer
  rounding (the same values);
- ``trunc``: ``hi`` truncated, ``lo = x - hi`` handed to the mma unrounded;
- ``nosplit``: ``hi = x``, ``lo = 0``, three products (the split's cost;
  the result is single-pass TF32 and misses the limit by design);
- ``onepass``: one product of unsplit operands (one pass's cost; likewise);

and what ``mma.sync.m16n8k8`` on TF32 gives on this card: independent
products from registers at 4 to 32 warps an SM.

``1024``: the cluster design (``Cl1024F32``: ``ClCfg``, ``Cl1024Bf16``:
``ClWgCfg``) at TitaNet-L's (B=128, T=301, S=3, (C, k) = (1024, 11)), f32
and bf16: blocks a cluster, warps, K chunk and ring depth, bf16 on
``mma.sync`` with two buffers or ``wgmma`` in place, each with its registers and spills
(``ptxas -v``) and the clusters the card holds at once
(``cudaOccupancyMaxActiveClusters``); and the design with one part taken
out (reads from the block's own shared memory in place of its peers', no
depthwise pass, no products, no weight copies): where its time goes.

Without an argument both run. Prints the card's name and power limit
first. Nothing of the package calls this module.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

SHAPES = ((256, 3), (512, 7))
B, T, S = 128, 301, 3

# (name, {alias in the source: its template arguments}, the changed part or None)
TILES = [
    ("design", {}, None),
    ("256:ks16-nst3 512:nc256-w8", {"Tf256": "256, 64, 256, 2, 4, 16, 3, 1", "Tf512": "512, 32, 256, 1, 8, 16, 3, 1"},
     None),
    ("256:w16 512:nc512-w16", {"Tf256": "256, 64, 256, 2, 8, 32, 2, 1", "Tf512": "512, 32, 512, 1, 16, 16, 2, 1"},
     None),
    ("256:w4-64x64 512:nc256-w4", {"Tf256": "256, 64, 256, 1, 4, 32, 2, 1", "Tf512": "512, 32, 256, 1, 4, 32, 2, 1"},
     None),
    ("256:nc128 512:nc128", {"Tf256": "256, 64, 128, 2, 4, 32, 3, 1", "Tf512": "512, 32, 128, 1, 8, 32, 3, 1"}, None),
    ("256:rm64-ks32", {"Tf256": "256, 64, 256, 2, 4, 32, 2, 1"}, None),
    ("256:rm80-nst3", {"Tf256": "256, 80, 256, 1, 8, 16, 3, 1"}, None),
    ("in place 256:rm80 512:rm48", {"Tf256": "256, 80, 256, 1, 8, 32, 2, 1, true",
                                    "Tf512": "512, 48, 512, 1, 8, 16, 2, 1, true"}, None),
    ("in place 256:rm112 512:rm64", {"Tf256": "256, 112, 256, 1, 8, 32, 2, 1, true",
                                     "Tf512": "512, 64, 512, 1, 8, 16, 2, 1, true"}, None),
    ("in place 256:rm128", {"Tf256": "256, 128, 256, 1, 8, 32, 2, 1, true"}, None),
    ("cvt", {}, "cvt"),
    ("trunc", {}, "trunc"),
    ("nosplit", {}, "nosplit"),
    ("onepass", {}, "onepass"),
]
# the cluster design at C = 1024: ClCfg<T, 1024, N, RM, WM, WN, KC, NST>
# (mma.sync) or ClWgCfg<1024, N, WGN, NST> (bf16 wgmma, one buffer in place)
_F32, _BF16 = "ClCfg<float, 1024, ", "ClCfg<__nv_bfloat16, 1024, "
CLUSTER_TILES = [
    ("design", {}, None),
    ("f32:w2x4 bf16:mma.sync-w2x4", {"Cl1024F32": _F32 + "8, 128, 2, 4, 32, 2>",
                                     "Cl1024Bf16": _BF16 + "4, 128, 2, 4, 32, 3>"}, None),
    ("f32:kc16-nst3 bf16:mma.sync-n8-kc64", {"Cl1024F32": _F32 + "8, 128, 4, 2, 16, 3>",
                                             "Cl1024Bf16": _BF16 + "8, 128, 4, 2, 64, 2>"}, None),
    ("f32:w4x4 bf16:wgmma-wgn2", {"Cl1024F32": _F32 + "8, 128, 4, 4, 32, 2>",
                                  "Cl1024Bf16": "ClWgCfg<1024, 4, 2, 3>"}, None),
    ("f32:w8x1 bf16:wgmma-n8-nst4", {"Cl1024F32": _F32 + "8, 128, 8, 1, 32, 2>",
                                     "Cl1024Bf16": "ClWgCfg<1024, 8, 1, 4>"}, None),
    ("bf16:mma.sync-w4x4", {"Cl1024Bf16": _BF16 + "4, 128, 4, 4, 32, 3>"}, None),
    # the design with one part taken out (the results are wrong by design):
    # where its time goes
    ("no peer reads", {}, "local"),
    ("no depthwise", {}, "nodw"),
    ("no products", {}, "nomma"),
    ("no weight copies", {}, "nocopy"),
]

_RNA = "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;"
_SPLIT = "  hi = tf32_rna(x);\n  lo = tf32_rna(x - __uint_as_float(hi));"
_PARTS = {
    "cvt": [(_RNA, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n  return r;')],
    "trunc": [(_SPLIT, "  hi = __float_as_uint(x) & 0xFFFFE000u;\n  lo = __float_as_uint(x - __uint_as_float(hi));")],
    "nosplit": [(_SPLIT, "  hi = __float_as_uint(x);\n  lo = 0u;")],
}
# the cluster kernel's parts, each dropped by one variant: the chunks read
# from the block's own dw instead of their owners', the depthwise pass, the
# products, the weight slabs' copies
_CLUSTER_PARTS = {
    "local": ("cluster_addr(dw + kk % CH, kk / CH)", "cluster_addr(dw + kk % CH, rank)"),
    "nodw": ("    depthwise_stage<Cfg>(in, dw, dw_w + (long long)s * k * C + c0, dw_b + s * C + c0, rows, k, tid);\n", ""),
    "nomma": ("      prod.multiply(chunks + (j % SLOTS) * Cfg::CHUNK, ring + (g % NST) * Cfg::SLAB, rows);\n", ""),
    "nocopy": ("      for (int i = tid; i < KC * CV; i += NTHR) {\n        const int r = i / CV, v = i % CV;\n"
               "        tc::cp_async16(dst + Cfg::slab_offset(r, v * VEC), src + (long long)r * C + v * VEC);\n",
               "      for (int i = tid; i < 0; i += NTHR) {\n        const int r = i / CV, v = i % CV;\n"
               "        tc::cp_async16(dst + Cfg::slab_offset(r, v * VEC), src + (long long)r * C + v * VEC);\n"),
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


def variant_source(src: str, tiles: dict, part) -> str:
    """``src`` with the tiles and the part of the split product replaced;
    raises if an anchor is missing (the source moved on)."""
    for name, args in tiles.items():  # Cl*: a whole type; Tf*: Tf32Cfg's arguments
        new = args if name.startswith("Cl") else f"Tf32Cfg<{args}>"
        src, n = re.subn(rf"using {name} = \w+<[^;]*>;", f"using {name} = {new};", src)
        assert n == 1, name
    if part == "onepass":
        src = variant_source(src, {}, "nosplit")
        src, n = _SMALL_PASSES.subn("", src)
        assert n == 2, "the two small passes"
    for old, new in _PARTS.get(part, []) + ([_CLUSTER_PARTS[part]] if part in _CLUSTER_PARTS else []):
        assert src.count(old) == 1, part
        src = src.replace(old, new)
    return src


def kernel_resources(log: str) -> dict:
    """``{kernel's config in the mangled name: "N registers, <spill line>"}``
    from ``ptxas -v``."""
    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            key = ("cluster " + ("f32" if "ClCfgIf" in name else "bf16")) if "megablock_cluster" in name else name
            found[key] = f"{regs} registers, {spill}"
            name = None
    return found


def build_all(out_dir: str, sources: dict) -> dict:
    """``{name: source text}`` -> ``{name: (loaded library, ptxas log)}``."""
    from titanet_torch.ops.kernels import _build

    os.makedirs(out_dir, exist_ok=True)
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
        if proc.returncode != 0:  # a variant that does not build is reported and left out
            print(f"variant {name}: nvcc exited {proc.returncode}\n" + "\n".join(log.splitlines()[-30:]))
            continue
        libs[name] = (ctypes.CDLL(lib), log)
    if "design" not in libs:
        raise RuntimeError("the design does not build")
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


def chain_args(rng, c: int, k: int, dev):
    import numpy as np
    import torch

    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    return (f32(rng.standard_normal((B, T, c))), f32(rng.standard_normal((S, k, c)) * 0.5),
            f32(rng.standard_normal((S, c)) * 0.3), f32(rng.standard_normal((S, c, c)) / np.sqrt(c)),
            f32(rng.standard_normal((S, c)) * 0.3),
            f32(np.stack([rng.uniform(0.5, 1.5, (S, c)), rng.standard_normal((S, c)) * 0.3], axis=1)))


def time_variant(name: str, fn, args, c: int, k: int, ref, card: str) -> None:
    """Run ``fn`` (a library's C entry point) on ``args`` twice, then 20
    times under CUDA events; print the error against ``ref`` (f32 1e-4 of
    the largest entry, bf16 one ulp of it), the equal-bits check and the
    time."""
    import numpy as np
    import torch

    out = torch.empty_like(args[0])

    def call():
        code = fn(*(t.data_ptr() for t in args), out.data_ptr(), B, T, c, S, k,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"variant {name} C={c}: launch failed ({code})")

    call()
    first = out.clone()
    call()
    torch.cuda.synchronize()
    top = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().amax(dim=(0, 2)).max().item()
    tol = 1e-4 * top if out.dtype == torch.float32 else 2.0 ** (np.floor(np.log2(top)) - 7)
    dt = "f32" if out.dtype == torch.float32 else "bf16"
    print(f"{name:28s} {dt} (C, k) = ({c}, {k}): {events_ms(call):.4f} ms (CUDA events, 20 calls); error "
          f"{err / top:.2e} of the largest entry ({'within' if err <= tol else 'OVER'} the limit); "
          f"repeat {'equal bits' if torch.equal(first, out) else 'DIFFERS'} | {card}", flush=True)


def set_argtypes(lib) -> None:
    for fn in (lib.titanet_megablock_f32, lib.titanet_megablock_bf16):
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.titanet_megablock_max_active_clusters.argtypes = [ctypes.c_int] * 3
    lib.titanet_megablock_max_active_clusters.restype = ctypes.c_int


def sweep_f32_tiles(src: str, dev, card: str) -> None:
    import numpy as np

    from titanet_torch.ops.kernels import _build
    from titanet_torch.ops.kernels.megablock import fused_sub_blocks_plain

    sources = {name: variant_source(src, tiles, part) for name, tiles, part in TILES}
    sources["probe"] = _PROBE
    libs = build_all(str(_build.BUILD_DIR / "sweep"), sources)
    probe = libs.pop("probe")[0]
    for name, (lib, log) in libs.items():
        regs = re.findall(r"Tf32CfgILi(\d+)E.*?\n.*?\n.*?Used (\d+) registers", log)
        print(f"built {name}: registers " + ", ".join(f"C={c}: {r}" for c, r in regs))
    probe.run_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    import torch

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for warps in (4, 8, 16, 32):
        out = torch.empty(n_sm * warps * 32, device=dev)
        iters = 4000
        ms = events_ms(lambda: probe.run_probe(out.data_ptr(), n_sm, warps * 32, iters), iters=1)
        n = n_sm * warps * iters * 8
        print(f"mma.sync.m16n8k8 tf32 from registers, {warps} warps an SM: "
              f"{n * 2048 / (ms * 1e-3) / 1e12:.1f} TFLOP/s ({n / n_sm / (ms * 1e-3) / 1e9:.3f} G products/s an SM)")
    rng = np.random.default_rng(0)
    for c, k in SHAPES:
        args = chain_args(rng, c, k, dev)
        ref = fused_sub_blocks_plain(*args, kernel_size=k)
        for name, (lib, _) in libs.items():
            set_argtypes(lib)
            time_variant(name, lib.titanet_megablock_f32, args, c, k, ref, card)


def sweep_cluster_tiles(src: str, dev, card: str) -> None:
    import numpy as np
    import torch

    from titanet_torch.ops.kernels import _build
    from titanet_torch.ops.kernels.megablock import fused_sub_blocks_plain

    libs = build_all(str(_build.BUILD_DIR / "sweep1024"),
                     {name: variant_source(src, tiles, part) for name, tiles, part in CLUSTER_TILES})
    c, k = 1024, 11
    for name, (lib, log) in libs.items():
        set_argtypes(lib)
        tiles = next(t for n, t, _ in CLUSTER_TILES if n == name)
        for f32, dt, alias in ((1, "f32", "Cl1024F32"), (0, "bf16", "Cl1024Bf16")):
            cfg = tiles.get(alias) or re.search(rf"using {alias} = (\w+<[^;]*>);", src).group(1)
            n = lib.titanet_megablock_max_active_clusters(f32, k, S)
            print(f"built {name} {dt}: {cfg}: {kernel_resources(log).get(f'cluster {dt}')}; clusters at once {n}")
    rng = np.random.default_rng(0)
    args32 = chain_args(rng, c, k, dev)
    for dt in (torch.float32, torch.bfloat16):
        args = (args32[0].to(dt), *args32[1:3], args32[3].to(dt), *args32[4:])
        ref = fused_sub_blocks_plain(*args, kernel_size=k)
        for name, (lib, _) in libs.items():
            fn = lib.titanet_megablock_f32 if dt == torch.float32 else lib.titanet_megablock_bf16
            time_variant(name, fn, args, c, k, ref, card)


def main() -> int:
    import torch

    from titanet_torch.ops.kernels import _build

    which = sys.argv[1:] or ["256-512", "1024"]
    if not torch.cuda.is_available():
        print("megablock_sweep: no CUDA device", file=sys.stderr)
        return 1
    if not set(which) <= {"256-512", "1024"}:
        print(f"megablock_sweep: unknown arguments {which} (256-512 and/or 1024)", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    src = (_build.CSRC_DIR / "megablock.cu").read_text()
    dev = torch.device("cuda")
    if "256-512" in which:
        sweep_f32_tiles(src, dev, card)
    if "1024" in which:
        sweep_cluster_tiles(src, dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
