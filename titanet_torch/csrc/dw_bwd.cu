// Depthwise conv1d backward (same padding, stride 1, odd K) in one pass over
// (x, dy).
//
// Replaces titanet_tpu/ops/pallas/dwconv.py::_dw_bwd_pallas (kernel body
// _bwd_kernel), reached through depthwise_conv1d_fused_bwd when
// TITANET_DW_BWD=pallas. For out[t, c] = sum_i w[c, i] x[t + i - pad, c] + b[c]
// with x, dy [B, T, C]:
//   dx[t, c] = sum_i w[c, i] dy[t + pad - i, c]           f32 sum, x's dtype
//   dk[c, i] = sum_{b,t} dt(x[t + i - pad, c] dy[t, c])    f32 sum
//   db[c]    = sum_{b,t} dy[t, c]                          f32 sum
// where dt() rounds the product to x's dtype, as the TPU kernel's bf16
// multiply does.
//
// Bound on the H100: bytes. x and dy read and dx written once: 3 x 19.7 MB at
// B=128, T=301, C=256 bf16, ~0.018 ms at 3.35 TB/s; the 4 K B T C operations
// are far below the bf16 rate.
//
// Design (first version; correct and simple): one block per (128 channels,
// 64 frames, utterance) stages x and dy for its frames plus a K-1 frame halo
// in shared memory (f32, zero outside the utterance: the same padding), so
// each element is read from device memory about once. Two thread groups of
// one channel per thread split the frames: each computes dx for its frames
// and sums dk (16 taps at a time in registers) and db over them. The TPU
// kernel added dk and db into one output in grid order; here every thread
// group writes its own partial sums and dw_reduce_kernel adds them in a fixed
// order, so the gradients are deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCh = 128;     // channels per block (one per thread of a group)
constexpr int kFr = 64;      // frames per block
constexpr int kGroups = 2;   // thread groups splitting the frames
constexpr int kTaps = 16;    // dk taps accumulated in registers at a time
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ float round_as(float v) { return to_f(from_f<T>(v)); }

size_t smem_bytes(int K) { return (size_t)2 * (kFr + K - 1) * kCh * sizeof(float); }

// part: [B * n_chunks * kGroups][K + 1][C]: dk taps, then db
template <typename T>
__global__ void __launch_bounds__(kCh * kGroups) dw_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ w,
    T* __restrict__ dx, float* __restrict__ part, int n_t, int C, int K) {
  extern __shared__ __align__(16) float smem[];
  const int pad = (K - 1) / 2;
  const int rows = kFr + K - 1;
  float* xs = smem;               // [rows][kCh]: frames t0 - pad .. t0 + kFr - 1 + pad
  float* ds = smem + rows * kCh;  // the same frames of dy
  const int tc = threadIdx.x % kCh;
  const int grp = threadIdx.x / kCh;
  const int c0 = blockIdx.x * kCh;
  const int ch = c0 + tc;
  const int chunk = blockIdx.y;
  const int b = blockIdx.z;
  const int t0 = chunk * kFr;
  const long long base = (long long)b * n_t * C;
  for (int i = threadIdx.x; i < rows * kCh; i += kCh * kGroups) {
    const int t = t0 - pad + i / kCh;
    const bool in = t >= 0 && t < n_t;
    const long long o = base + (long long)t * C + c0 + i % kCh;
    xs[i] = in ? to_f(x[o]) : 0.f;
    ds[i] = in ? to_f(dy[o]) : 0.f;
  }
  __syncthreads();
  const int nt = min(kFr, n_t - t0);

  // dx[t] = sum_i w[i] dy[t + pad - i]; dy[t'] sits at row t' - t0 + pad
  for (int f = grp; f < nt; f += kGroups) {
    float s = 0.f;
    for (int i = 0; i < K; ++i) s = fmaf(ds[(f + 2 * pad - i) * kCh + tc], w[ch * K + i], s);
    dx[base + (long long)(t0 + f) * C + ch] = from_f<T>(s);
  }

  float* p = part + ((long long)(b * gridDim.y + chunk) * kGroups + grp) * (K + 1) * C + ch;
  // dk[i] = sum_t dt(x[t + i - pad] dy[t]); x[t + i - pad] sits at row f + i
  for (int i0 = 0; i0 < K; i0 += kTaps) {
    float acc[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) acc[j] = 0.f;
    for (int f = grp; f < nt; f += kGroups) {
      const float d = ds[(f + pad) * kCh + tc];
#pragma unroll
      for (int j = 0; j < kTaps; ++j)
        if (i0 + j < K) acc[j] += round_as<T>(xs[(f + i0 + j) * kCh + tc] * d);
    }
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
      if (i0 + j < K) p[(long long)(i0 + j) * C] = acc[j];
  }
  float db = 0.f;
  for (int f = grp; f < nt; f += kGroups) db += ds[(f + pad) * kCh + tc];
  p[(long long)K * C] = db;
}

// dk[c][i] and db[c] = sums over the S partials, in order: 32 outputs a block,
// 8 warps over the partials, then the 8 warp sums in order.
__global__ void __launch_bounds__(256) dw_reduce_kernel(const float* __restrict__ part,
                                                        float* __restrict__ dk,
                                                        float* __restrict__ db, int S, int C,
                                                        int K) {
  __shared__ float red[8][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int N = (K + 1) * C;
  const int n = blockIdx.x * 32 + lane;  // n = tap * C + channel
  float s = 0.f;
  if (n < N)
    for (int k = w; k < S; k += 8) s += part[(long long)k * N + n];
  red[w][lane] = s;
  __syncthreads();
  if (w != 0 || n >= N) return;
  float sum = 0.f;
  for (int k = 0; k < 8; ++k) sum += red[k][lane];
  const int tap = n / C, c = n % C;
  if (tap < K)
    dk[c * K + tap] = sum;
  else
    db[c] = sum;
}

template <typename T>
int launch(const void* x, const void* dy, const void* w, void* dx, void* dk, void* db,
           void* work, int B, int n_t, int C, int K, void* stream) {
  const size_t smem = smem_bytes(K);
  const int n_chunks = (n_t + kFr - 1) / kFr;
  if (B < 1 || B > 65535 || n_t < 1 || n_chunks > 65535 || C % kCh || K < 1 || K % 2 == 0 ||
      smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dw_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  float* part = (float*)work;
  dw_bwd_kernel<T><<<dim3(C / kCh, n_chunks, B), kCh * kGroups, smem, st>>>(
      (const T*)x, (const T*)dy, (const float*)w, (T*)dx, part, n_t, C, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int S = B * n_chunks * kGroups;
  dw_reduce_kernel<<<((K + 1) * C + 31) / 32, 256, 0, st>>>(part, (float*)dk, (float*)db, S, C,
                                                             K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int titanet_dw_bwd_f32(const void* x, const void* dy, const void* w, void* dx, void* dk,
                       void* db, void* work, int B, int n_t, int C, int K, void* stream) {
  return launch<float>(x, dy, w, dx, dk, db, work, B, n_t, C, K, stream);
}

int titanet_dw_bwd_bf16(const void* x, const void* dy, const void* w, void* dx, void* dk,
                        void* db, void* work, int B, int n_t, int C, int K, void* stream) {
  return launch<__nv_bfloat16>(x, dy, w, dx, dk, db, work, B, n_t, C, K, stream);
}

long long titanet_dw_bwd_workspace_bytes(int B, int n_t, int C, int K) {
  const long long n_chunks = (n_t + kFr - 1) / kFr;
  return (long long)B * n_chunks * kGroups * (K + 1) * C * (long long)sizeof(float);
}

const char* titanet_dw_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
