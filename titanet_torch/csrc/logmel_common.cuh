// Device functions shared by the two log-mel kernels (logmel.cu: implicit
// framing from the padded waveform; mel_frames.cu: materialized frames).
// Two designs:
// - FP32 cores (logmel_kernel, mel_frames_kernel: the geometries the
//   tensor-core design does not take, and the fused route's bf16 where its
//   bf16 tensor-core kernel does not): the register-tiled windowed DFT of a
//   warp's 8 frames, and the tile's mel product -> dB -> L2 -> store. A
//   frame is `stride` floats after the previous one in shared memory (the
//   hop for implicit framing, the row length for materialized frames).
// - f64 on the tensor cores (logmel_dmma_kernel, mel_frames_dmma_kernel:
//   f32 at the geometries ops/kernels/melspec.py::fused_dmma_supports and
//   frames_dmma_supports take, TitaNet's among them): dmma_logmel_tile,
//   below.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {


constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFramesPerWarp = 8;
constexpr int kTileFrames = kWarps * kFramesPerWarp;  // 64; ops/kernels/melspec.py::TILE_FRAMES
constexpr int kBinsPerLane = 4;
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ float round_as(float v) { return v; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T>
__device__ __forceinline__ void store_power(float* pw, int idx, float re, float im) {
  pw[idx] = round_as<T>(re * re) + round_as<T>(im * im);
}

// A warp's 8 frames x Q bins per lane: bins j, j+32, ..., j+32*(Q-1).
// Per tap: 8 shared-memory broadcasts and 2Q L1 loads feed 16Q FMAs.
template <typename T, int Q>
__device__ __forceinline__ void dft_pass(const float* __restrict__ x, int stride,
                                         const T* __restrict__ cos_b,
                                         const T* __restrict__ sin_b, int n_bins, int j,
                                         int k_lo, int k_hi, float* __restrict__ pw) {
  float re[kFramesPerWarp][Q], im[kFramesPerWarp][Q];
#pragma unroll
  for (int f = 0; f < kFramesPerWarp; ++f)
#pragma unroll
    for (int q = 0; q < Q; ++q) re[f][q] = im[f][q] = 0.f;
  for (int k = k_lo; k < k_hi; ++k) {
    float c[Q], s[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const long long at = (long long)k * n_bins + j + 32 * q;
      c[q] = to_f(cos_b[at]);
      s[q] = to_f(sin_b[at]);
    }
#pragma unroll
    for (int f = 0; f < kFramesPerWarp; ++f) {
      const float v = x[f * stride + k];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        re[f][q] = fmaf(v, c[q], re[f][q]);
        im[f][q] = fmaf(v, s[q], im[f][q]);
      }
    }
  }
#pragma unroll
  for (int f = 0; f < kFramesPerWarp; ++f)
#pragma unroll
    for (int q = 0; q < Q; ++q) store_power<T>(pw, f * n_bins + j + 32 * q, re[f][q], im[f][q]);
}

// One bin for a warp's 8 frames, the taps split over the 32 lanes and
// summed with shuffles (so a lone bin does not leave 31 lanes idle).
template <typename T>
__device__ __forceinline__ void dft_bin_warp(const float* __restrict__ x, int stride,
                                             const T* __restrict__ cos_b,
                                             const T* __restrict__ sin_b, int n_bins, int j,
                                             int k_lo, int k_hi, float* __restrict__ pw,
                                             int lane) {
  float re[kFramesPerWarp], im[kFramesPerWarp];
#pragma unroll
  for (int f = 0; f < kFramesPerWarp; ++f) re[f] = im[f] = 0.f;
  for (int k = k_lo + lane; k < k_hi; k += 32) {
    const float c = to_f(cos_b[(long long)k * n_bins + j]);
    const float s = to_f(sin_b[(long long)k * n_bins + j]);
#pragma unroll
    for (int f = 0; f < kFramesPerWarp; ++f) {
      const float v = x[f * stride + k];
      re[f] = fmaf(v, c, re[f]);
      im[f] = fmaf(v, s, im[f]);
    }
  }
#pragma unroll
  for (int f = 0; f < kFramesPerWarp; ++f) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      re[f] += __shfl_xor_sync(0xffffffffu, re[f], o);
      im[f] += __shfl_xor_sync(0xffffffffu, im[f], o);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int f = 0; f < kFramesPerWarp; ++f) store_power<T>(pw, f * n_bins + j, re[f], im[f]);
  }
}

// power [kTileFrames][n_bins] -> db [kTileFrames][n_mels] (both in shared
// memory), then rows [0, rows) of the tile L2-normalized over the mels to
// out_tile [rows][n_mels]; rows at or after `valid` are written as zeros.
// Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ void mel_db_l2_store(const float* __restrict__ power,
                                                float* __restrict__ db,
                                                const T* __restrict__ fb, int n_bins,
                                                int n_mels, float* __restrict__ out_tile,
                                                int rows, int valid) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int db_len = kTileFrames * n_mels;
  for (int idx = threadIdx.x; idx < db_len; idx += kThreads) {
    const int f = idx / n_mels;
    const int m = idx - f * n_mels;
    const float* p = power + f * n_bins;
    float acc = 0.f;
    for (int j = 0; j < n_bins; ++j) acc = fmaf(p[j], to_f(fb[j * n_mels + m]), acc);
    db[idx] = 10.f * log10f(fmaxf(acc, 1e-10f));
  }
  __syncthreads();
  for (int f = warp; f < rows; f += kWarps) {
    const float* d = db + f * n_mels;
    float ss = 0.f;
    for (int m = lane; m < n_mels; m += 32) ss = fmaf(d[m], d[m], ss);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float nrm = fmaxf(sqrtf(ss), 1e-12f);
    float* o = out_tile + (long long)f * n_mels;
    for (int m = lane; m < n_mels; m += 32) o[m] = f < valid ? d[m] / nrm : 0.f;
  }
}


// ----------------------------------------------- f64 tensor-core design
//
// The f32 routes of both kernels on the tensor cores. Bound on the H100:
// operations. At B=128 x 3 s (N = 38,528 frames) the DFT is 2*N*400*514 =
// 15.84 GFLOP and the dense mel product 2*N*257*80 = 1.58 GFLOP: 0.26 ms
// on the FP32 cores at their peak. The DFT runs on the f64 tensor cores
// (mma.sync.m16n8k8.f64, 67 TFLOP/s: 0.236 ms at the peak): the f32
// operands are exact in f64 and so are their products, and the sums carry
// 53 bits, so the DFT is exact to f32's last bit, and the kernel sits as
// far from the plain version as the plain version's own f32 rounding. Split
// TF32 ("3xTF32": three TF32 products a k8 step into f32 accumulators;
// built with -DTITANET_DMMA_SPLIT_TF32_DFT, ops/kernels/logmel_sweep.py
// times it) was built first: its
// f32 sums, rounded every 8 taps (and truncated inside each product), land
// as far from the exact DFT as f32 does, elsewhere, so on clean 16-bit
// speech, whose mel bands under the pitch sit at the quantization floor
// 100 dB below the loudest, it lands past the f32 routes' 1e-4 from the
// plain version. What the design does:
// - kDmRows = 64 frame rows a block, 8 warps: a pair of warps takes 16
//   rows, each warp half the 128 columns of a basis panel of 64 bins (32
//   f64 accumulators a thread), so that a block of 64 rows keeps 8 warps
//   busy. The power and the partial mel sums of a row stay in its warp's
//   registers (no power tile); the pair adds its two partial sums once,
//   through shared memory, after the walk.
// - The basis: the bf16 routes' panel layout (ops/kernels/melspec.py::
//   tc_basis: each 8-bin group as 8 cos then 8 sin columns, the Nyquist
//   bin's cos in bin 0's zero sin column) in panels of 64 bins, built in
//   f64 once per (tensor, window) by the wrapper (dmma_basis) and stored in
//   fragment order: for each panel and k8 step, 16 n8 tiles x 32 lanes x
//   {b0, b1}. Two k8 steps a stage (16 KB) stream through a cp.async ring
//   of kDmStages = 4 stages (a geometry whose block does not fit with them
//   goes to the FP32-core kernels: melspec.py::fused_dmma_supports);
//   a lane reads its tile's two words with one 16-byte load (no bank
//   conflict).
// - The A operand (the frames) is f32 in shared memory, widened as each
//   fragment is loaded. The fused route stages the tile's sample span once
//   and keeps it for the whole walk: tap k of tile row r at x[r * stride +
//   k + kDmPad * (k / kdiv)], kDmPad floats after every hop (stride hop +
//   4, kdiv hop). The frames route streams its frames' taps beside the
//   basis, a stage's 16 taps of the 64 rows in the same ring slot (rows
//   padded by kDmPad: stride 20), read again from L2 for each panel: a
//   resident 64-row f32 tile (105 KB) would leave room for one block an
//   SM. A row stride of 4 mod 8 words puts an A fragment's 32 words in 32
//   banks.
// - Power and mel: re^2 + im^2 in f64, rounded once to f32 (the plain
//   version's power is f32), straight from the accumulators: the 16 x 8
//   power tile of an 8-bin group is an m16n8k8 A fragment with its k slots
//   permuted (slot t <- bin 2t, slot t + 4 <- bin 2t + 1), split into TF32
//   hi + lo in registers, against the filterbank in the same permuted
//   fragment order, split once by the wrapper (dmma_filterbank, with each
//   group's offset into the pack, since a warp walks half the groups): a
//   k8 step adds a_lo*b_hi, a_hi*b_lo, a_hi*b_hi (mma.sync.m16n8k8.tf32)
//   into f32 sums of positive terms. Only the (group, 8-mel tile) pairs where the
//   filterbank is not zero are stored and multiplied (45 of 320 and the
//   Nyquist bin's at TitaNet's frontend): a skipped product adds exact
//   zeros. The Nyquist bin's power (its cos only; the sin residue, ~1e-16
//   t, is left out) goes through a fragment of its own after panel 0.
// - Epilogue in registers, after the pair's sum (the lower columns' warp's
//   partial plus the other's): 10*log10(max(mel, 1e-10)), the L2 norm over
//   the mels by shuffles among the 4 lanes of a row, 16-byte stores; rows
//   at or after `valid` written as zeros, rows at or after `rows` never
//   stored.
// Both routes run this one function, so the same rows give the same bits.
// The products sit in loops nested by panel and stage with no branch on
// the warp index (a warp's columns are an offset).

constexpr int kDmHalves = 2;                 // warps sharing a row group, a column half each
constexpr int kDmWarps = 4 * kDmHalves;
constexpr int kDmThreads = kDmWarps * 32;
constexpr int kDmRows = 64;                  // 4 row groups of 16; ops/kernels/melspec.py::DMMA_ROWS
constexpr int kDmTiles = 16;                 // n8 tiles a panel: 8 groups x (cos, sin)
constexpr int kDmWarpTiles = kDmTiles / kDmHalves;
constexpr int kDmStep = kDmTiles * 32 * 2;   // doubles of one k8 step of a panel (8 KB)
constexpr int kDmSteps = 2;                  // k8 steps a ring stage (melspec.py::DMMA_STEPS)
constexpr int kDmStage = kDmSteps * kDmStep;
constexpr int kDmStages = 4;                 // ring depth (melspec.py::DMMA_STAGES)
constexpr int kDmChunk = 4;                  // n8 tiles whose B fragments are loaded at once
constexpr int kDmPad = 4;                    // floats after each row (each hop) of the A operand

// d += a (16 x 8, row) * b (8 x 8, col) in f64. A: a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); B: b0 (k = t, n = g), b1 (k = t + 4,
// n = g); d as tc::frag_row, tc::frag_col (g = lane / 4, t = lane % 4)
__device__ __forceinline__ void mma_1688_f64(double (&d)[4], const double (&a)[4], double b0,
                                             double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds a finite x, on the integer pipe
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
// x = hi + lo + (x - hi - lo), hi and lo TF32; x - hi is exact in f32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
// d += a (16 x 8 tf32, row) * b (8 x 8 tf32, col), f32 accumulation; the
// fragments as mma_1688_f64's
__device__ __forceinline__ void mma_1688_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of the power tile p (accumulator order: (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)), k slot t <- column 2t, slot
// t + 4 <- column 2t + 1, rounded to f32 once and split
__device__ __forceinline__ void split_power(const double (&p)[4], uint32_t (&ah)[4],
                                            uint32_t (&al)[4]) {
  split_tf32(__double2float_rn(p[0]), ah[0], al[0]);
  split_tf32(__double2float_rn(p[2]), ah[1], al[1]);
  split_tf32(__double2float_rn(p[1]), ah[2], al[2]);
  split_tf32(__double2float_rn(p[3]), ah[3], al[3]);
}

// One 8-bin group's power against the filterbank: the 8-mel tiles set in
// `mask`, each a packed fragment {b0_hi, b1_hi, b0_lo, b1_lo} per lane from
// fbp on
template <int NTM>
__device__ __forceinline__ void mel_group(float (&macc)[NTM][4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], int mask, const float4* fbp) {
#pragma unroll
  for (int mt = 0; mt < NTM; ++mt) {
    if ((mask >> mt) & 1) {
      const float4 b = __ldg(fbp);
      fbp += 32;
      mma_1688_tf32(macc[mt], al, __float_as_uint(b.x), __float_as_uint(b.y));
      mma_1688_tf32(macc[mt], ah, __float_as_uint(b.z), __float_as_uint(b.w));
      mma_1688_tf32(macc[mt], ah, __float_as_uint(b.x), __float_as_uint(b.y));
    }
  }
}

// The DFT's accumulators: f64. Built with -DTITANET_DMMA_SPLIT_TF32_DFT
// (ops/kernels/logmel_sweep.py; nothing else builds it) the DFT is instead
// split TF32 into f32 accumulators, the design this one replaced: each
// lane's 16 bytes of the basis pack then hold {b0_hi, b1_hi, b0_lo, b1_lo}.
#ifdef TITANET_DMMA_SPLIT_TF32_DFT
using DmAcc = float;
#else
using DmAcc = double;
#endif

// The log-mel of a block's kDmRows frame rows (warps w and w + 4: rows
// 16 w .. 16 w + 15, the lower and the upper half of each panel's columns),
// from the DFT to the stores. Every thread calls it. x: the A operand in
// shared memory. Resident (STREAM_A false): tap k, 0 <= k < 8 * steps, of
// row r at x[r * stride + k + kDmPad * (k / kdiv)], kdiv a multiple of 8,
// stored by stage_a() once the basis prologue is in flight. Streamed
// (STREAM_A true): kDmStages slots of kDmRows * stride floats, stride 8
// kDmSteps + kDmPad; load_a(i) copies walk stage i's taps (k = 8 kDmSteps
// (i % (steps / kDmSteps)) ..) into slot i % kDmStages, tap k0 + k of row
// r at r * stride + k, kDmStages - 1 stages ahead with the basis. Either's
// stores are read after a stage's barrier. ring: kDmStages x kDmStage doubles
// of shared memory. basis:
// [n_panels][steps][kDmStep], steps a multiple of kDmSteps (dmma_basis).
// fb: the packed filterbank tiles; fb_table: in shared memory, stored
// before the call, n_walk masks of 8-mel tiles, then each group's offset
// in tiles into fb, in walk order: panel 0's 8 groups, the Nyquist bin,
// then the other panels' groups (dmma_filterbank). out: row 0 of the tile,
// rows n_mels = 8 NTM floats apart.
template <int NTM, bool STREAM_A, class StageA, class LoadA>
__device__ __forceinline__ void dmma_logmel_tile(const float* x, int stride, int kdiv,
                                                 double* ring, const int* fb_table, int n_walk,
                                                 const double* __restrict__ basis,
                                                 const float* __restrict__ fb, int steps,
                                                 int n_panels, StageA&& stage_a, LoadA&& load_a,
                                                 float* __restrict__ out, int rows, int valid) {
  constexpr int AHEAD = kDmStages - 1;  // the stage refilled at a barrier was read before it
  constexpr int n_mels = NTM * 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int rg = warp & 3, half = warp >> 2;  // row group, column half
  const int spp = steps / kDmSteps;           // stages a panel
  const int total = n_panels * spp;
  auto load_stage = [&](int i) {  // stage i of the walk -> ring slot i % kDmStages
    const double* src = basis + (long long)i * kDmStage;
    double* dst = ring + (i % kDmStages) * kDmStage;
#pragma unroll
    for (int c = 2 * tid; c < kDmStage; c += 2 * kDmThreads) tc::cp_async16(dst + c, src + c);
  };
  const int a_stages = STREAM_A ? total : 0;  // stages that copy A
#pragma unroll
  for (int j = 0; j < AHEAD; ++j) {
    if (j < total) load_stage(j);
    if (j < a_stages) load_a(j);
    tc::cp_async_commit();
  }
  stage_a();

  float macc[NTM][4];
#pragma unroll
  for (int j = 0; j < NTM; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) macc[j][e] = 0.f;
  const float* xr = x + (rg * 16 + (lane >> 2)) * stride + t;
  const float4* fb4 = reinterpret_cast<const float4*>(fb) + lane;
  double nyq[2] = {0.0, 0.0};
  for (int panel = 0, i = 0; panel < n_panels; ++panel) {
    DmAcc acc[kDmWarpTiles][4];
#pragma unroll
    for (int j = 0; j < kDmWarpTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0;
    for (int js = 0; js < spp; ++js, ++i) {
      tc::cp_async_wait<AHEAD - 1>();
      __syncthreads();
      if (i + AHEAD < a_stages) load_a(i + AHEAD);
      if (i + AHEAD < total) load_stage(i + AHEAD);
      tc::cp_async_commit();
      const float* xs = STREAM_A ? xr + (i % kDmStages) * (kDmRows * stride) : xr;
#pragma unroll
      for (int u = 0; u < kDmSteps; ++u) {
        const int s = js * kDmSteps + u;
        const int k = STREAM_A ? 8 * u : 8 * s + kDmPad * (8 * s / kdiv);
#ifdef TITANET_DMMA_SPLIT_TF32_DFT
        uint32_t ah[4], al[4];
        split_tf32(xs[k], ah[0], al[0]);
        split_tf32(xs[8 * stride + k], ah[1], al[1]);
        split_tf32(xs[k + 4], ah[2], al[2]);
        split_tf32(xs[8 * stride + k + 4], ah[3], al[3]);
        const float4* st = reinterpret_cast<const float4*>(ring + (i % kDmStages) * kDmStage +
                                                           u * kDmStep) +
                           half * kDmWarpTiles * 32 + lane;
#pragma unroll
        for (int j0 = 0; j0 < kDmWarpTiles; j0 += kDmChunk) {
          float4 b[kDmChunk];
#pragma unroll
          for (int j = 0; j < kDmChunk; ++j) b[j] = st[(j0 + j) * 32];
#pragma unroll
          for (int j = 0; j < kDmChunk; ++j)
            mma_1688_tf32(acc[j0 + j], al, __float_as_uint(b[j].x), __float_as_uint(b[j].y));
#pragma unroll
          for (int j = 0; j < kDmChunk; ++j)
            mma_1688_tf32(acc[j0 + j], ah, __float_as_uint(b[j].z), __float_as_uint(b[j].w));
#pragma unroll
          for (int j = 0; j < kDmChunk; ++j)
            mma_1688_tf32(acc[j0 + j], ah, __float_as_uint(b[j].x), __float_as_uint(b[j].y));
        }
#else
        const double a[4] = {(double)xs[k], (double)xs[8 * stride + k], (double)xs[k + 4],
                             (double)xs[8 * stride + k + 4]};
        const double2* st = reinterpret_cast<const double2*>(ring + (i % kDmStages) * kDmStage +
                                                             u * kDmStep) +
                            half * kDmWarpTiles * 32 + lane;
#pragma unroll
        for (int j0 = 0; j0 < kDmWarpTiles; j0 += kDmChunk) {
          double2 b[kDmChunk];
#pragma unroll
          for (int j = 0; j < kDmChunk; ++j) b[j] = st[(j0 + j) * 32];
#pragma unroll
          for (int j = 0; j < kDmChunk; ++j) mma_1688_f64(acc[j0 + j], a, b[j].x, b[j].y);
        }
#endif
      }
    }

    // the power of this warp's groups (tile 2 grp: re, tile 2 grp + 1: im);
    // in panel 0 bin 0's sin column (the lower half's) holds the Nyquist
    // bin's cos
    const int g0 = panel * 8 + (panel > 0) + half * (kDmWarpTiles / 2);  // walk index of group 0
#pragma unroll
    for (int grp = 0; grp < kDmWarpTiles / 2; ++grp) {
      double p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const double re = acc[2 * grp][e];
        double im = acc[2 * grp + 1][e];
        if (grp == 0 && panel == 0 && half == 0 && t == 0 && (e & 1) == 0) {
          nyq[e >> 1] = __dmul_rn(im, im);
          im = 0.0;
        }
        p[e] = __dadd_rn(__dmul_rn(re, re), __dmul_rn(im, im));
      }
      uint32_t ah[4], al[4];
      split_power(p, ah, al);
      const int gi = g0 + grp;
      mel_group<NTM>(macc, ah, al, fb_table[gi], fb4 + 32 * fb_table[n_walk + gi]);
    }
    if (panel == 0) {  // the Nyquist bin (walk index 8): k slot 0 of lanes t = 0, lower half
      const double p[4] = {nyq[0], 0.0, nyq[1], 0.0};
      uint32_t ah[4], al[4];
      split_power(p, ah, al);
      mel_group<NTM>(macc, ah, al, half == 0 ? fb_table[8] : 0, fb4 + 32 * fb_table[n_walk + 8]);
    }
  }
  tc::cp_async_wait<0>();

  // the pair's partial mel sums: the upper half's through the (idle) ring,
  // added to the lower half's
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring) + (rg * 32 + lane) * (NTM * 4);
  if (half == 1) {
#pragma unroll
    for (int j = 0; j < NTM; ++j)
      *reinterpret_cast<float4*>(red + 4 * j) = make_float4(macc[j][0], macc[j][1], macc[j][2], macc[j][3]);
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int j = 0; j < NTM; ++j) {
      const float4 o = *reinterpret_cast<const float4*>(red + 4 * j);
      macc[j][0] = __fadd_rn(macc[j][0], o.x);
      macc[j][1] = __fadd_rn(macc[j][1], o.y);
      macc[j][2] = __fadd_rn(macc[j][2], o.z);
      macc[j][3] = __fadd_rn(macc[j][3], o.w);
    }
  }

  // dB, L2 over the mels (the 4 lanes of a row), the mask, 16-byte stores
  // (the lower half's warps)
  float ss[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NTM; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = 10.f * log10f(fmaxf(macc[j][e], 1e-10f));
      macc[j][e] = d;
      ss[e >> 1] = fmaf(d, d, ss[e >> 1]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 1);
    ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 2);
    ss[h] = fmaxf(sqrtf(ss[h]), 1e-12f);
  }
  // lanes t, t ^ 1 of a row quad swap halves: an even t stores 4 columns of
  // row g, an odd t 4 columns of row g + 8
  const bool even = (lane & 1) == 0;
  const int row = rg * 16 + tc::frag_row(lane) + (even ? 0 : 8);
  const bool store = half == 0 && row < rows, masked = row >= valid;
#pragma unroll
  for (int j = 0; j < NTM; ++j) {
    const float a0 = macc[j][0] / ss[0], a1 = macc[j][1] / ss[0];
    const float b0 = macc[j][2] / ss[1], b1 = macc[j][3] / ss[1];
    const float rx = __shfl_xor_sync(0xffffffffu, even ? b0 : a0, 1);
    const float ry = __shfl_xor_sync(0xffffffffu, even ? b1 : a1, 1);
    const int col = j * 8 + tc::frag_col(lane) - (even ? 0 : 2);
    if (store)
      *reinterpret_cast<float4*>(out + (long long)row * n_mels + col) =
          masked ? make_float4(0.f, 0.f, 0.f, 0.f)
                 : (even ? make_float4(a0, a1, rx, ry) : make_float4(rx, ry, b0, b1));
  }
}

// Shared memory of the two kernels: the ring (at least the pair sums'
// kDmRows * NTM * 4 floats), the A operand in floats, the filterbank table
// (2 n_walk ints): ops/kernels/melspec.py::dmma_smem_bytes mirrors it.
__host__ __device__ inline int dmma_span_floats(int hop, int steps) {  // fused: the sample span
  const int span = (kDmRows - 1) * hop + 8 * steps;
  return hop % 8 == 0 ? span + kDmPad * ((span + hop - 1) / hop) : span;
}
constexpr int kDmStreamFloats = kDmStages * kDmRows * (8 * kDmSteps + kDmPad);  // frames: the A slots
inline size_t dmma_smem_bytes(int a_floats, int n_walk) {
  return (size_t)kDmStages * kDmStage * sizeof(double) + (size_t)a_floats * sizeof(float) +
         (size_t)2 * n_walk * sizeof(int);
}

}  // namespace
