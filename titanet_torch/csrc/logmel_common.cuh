// Device functions shared by the two log-mel kernels (logmel.cu: implicit
// framing from the padded waveform; mel_frames.cu: materialized frames):
// the register-tiled windowed DFT of a warp's 8 frames, and the tile's
// mel product -> dB -> L2 -> store. A frame is `stride` floats after the
// previous one in shared memory (the hop for implicit framing, the row
// length for materialized frames).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace
