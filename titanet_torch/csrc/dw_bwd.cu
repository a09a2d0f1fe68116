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
// B=128, T=301, C=256 bf16, ~0.018 ms at 3.35 TB/s; the ~4 K B T C operations
// are far below the FP32 cores' rate. To run near the memory rate an SM
// needs ~20 KB of loads in flight, and the next tile's loads must overlap
// the current tile's arithmetic.
//
// Design: persistent blocks, a two-stage cp.async pipeline, 16-byte accesses.
// - Grid: C / 128 channel slices x G blocks a slice, G = ceil(264 / slices)
//   (two blocks on each of the H100's 132 SMs) capped at the work items.
//   Block j of a slice walks the (utterance, time tile) pairs j, j + G, ...
//   in that order; the walk depends on the block index only.
// - A tile is kFr frames (64 bf16 / 32 f32) plus a K-1 frame halo of x and
//   dy for 128 channels, copied as 16-byte cp.async chunks into a stage of
//   shared memory in x's own dtype (zero-filled outside [0, T): the same
//   padding). While a block computes on one stage, the next pair's tile is
//   in flight into the other: 2 blocks x ~34 KB (bf16, K=3) a SM.
// - A thread owns 16 bytes of channels (8 bf16 / 4 f32; neighbouring threads
//   on neighbouring channels) of a subset of the tile's frames. Warps 0-3
//   compute dx (w's taps for the thread's channels held in registers) and
//   store it with 16-byte stores; warps 4-7 accumulate dk and db in f32
//   registers across every tile the block walks. The two roles share one
//   register array (w's taps or the dk sums), which keeps a thread near the
//   128 registers that two blocks an SM allow, up to K = 11 (TitaNet L).
//   That is the widest K built: a wider conv keeps the library backward
//   (ops/kernels/dwconv.py::kernel_supports).
// - After its walk a block adds its threads' dk/db partials over the frame
//   groups in a fixed order and writes one partial [K+1][128] for its slice;
//   dw_reduce_kernel adds the G partials of each channel in a fixed order.
//   The workspace is G x (K+1) x C f32; repeated calls give identical bits,
//   on any card (G does not depend on the card).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kCh = 128;        // channels of a slice
constexpr int kThreads = 256;   // 8 warps: 4 for dx, 4 for dk/db
constexpr int kGridTarget = 264;  // blocks in all: 2 on each of 132 SMs
constexpr int kMaxSmem = 232448;
constexpr int kMaxK = 11;       // the widest tap count built (TitaNet L)

template <typename T>
struct Geo {
  static constexpr int kVec = 16 / sizeof(T);           // channels a thread
  static constexpr int kLanes = kCh / kVec;             // threads a frame row
  static constexpr int kRowsPerWarp = 32 / kLanes;      // frame rows a warp at once
  static constexpr int kGroups = 4 * kRowsPerWarp;      // frame groups of each role
  static constexpr int kFr = sizeof(T) == 2 ? 64 : 32;  // frames a tile
};

__host__ __device__ constexpr int stage_elems(int fr, int k) { return 2 * (fr + k - 1) * kCh; }

template <typename T>
size_t smem_bytes(int K) {
  const size_t stages = (size_t)2 * stage_elems(Geo<T>::kFr, K) * sizeof(T);
  const size_t red = (size_t)Geo<T>::kGroups * (K + 1) * kCh * sizeof(float);
  return stages > red ? stages : red;
}

int grid_blocks(int B, int n_t, int C, int fr) {
  const int slices = C / kCh;
  const long long items = (long long)B * ((n_t + fr - 1) / fr);
  long long g = (kGridTarget + slices - 1) / slices;
  if (g > items) g = items;
  return (int)(g < 1 ? 1 : g);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(&u);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  return u;
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return *reinterpret_cast<const uint4*>(v);
}

// acc[v] += dt(x[v] d[v]) for the 16 bytes of x and d. bf16: one packed
// multiply rounds each exact product to bf16 once (as the f32 product
// rounded to bf16 would), then the halves widen to f32 by a shift / a mask
__device__ __forceinline__ void add_products(float (&acc)[8], const uint4& x, const uint4& d) {
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const __nv_bfloat162 p = __hmul2(x2[q], d2[q]);
    const uint32_t u = *reinterpret_cast<const uint32_t*>(&p);
    acc[2 * q] += __uint_as_float(u << 16);
    acc[2 * q + 1] += __uint_as_float(u & 0xffff0000u);
  }
}
__device__ __forceinline__ void add_products(float (&acc)[4], const uint4& x, const uint4& d) {
  const float4 a = *reinterpret_cast<const float4*>(&x);
  const float4 b = *reinterpret_cast<const float4*>(&d);
  acc[0] += a.x * b.x;
  acc[1] += a.y * b.y;
  acc[2] += a.z * b.z;
  acc[3] += a.w * b.w;
}

// part: [G][K + 1][C]: block j of slice s writes columns s*128 .. s*128+127
// of row j: dk taps, then db
template <typename T, int KMAX>
__global__ void __launch_bounds__(kThreads, 2) dw_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ w,
    T* __restrict__ dx, float* __restrict__ part, int B, int n_t, int C, int K) {
  using G = Geo<T>;
  constexpr int V = G::kVec;
  constexpr int FR = G::kFr;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int pad = (K - 1) / 2;
  const int rows = FR + K - 1;
  const int stage = stage_elems(FR, K);
  const int n_tiles = (n_t + FR - 1) / FR;
  const int items = B * n_tiles;
  const int c0 = blockIdx.y * kCh;
  const int j = blockIdx.x;
  const int nblk = gridDim.x;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool dk_role = warp >= 4;
  const int grp = (warp & 3) * G::kRowsPerWarp + lane / G::kLanes;  // frame group
  const int cl = (lane % G::kLanes) * V;                            // channel in the slice

  // 16-byte chunks of one tile: 2 arrays x rows x 128 channels
  constexpr int kChunksPerRow = kCh * sizeof(T) / 16;
  auto load_tile = [&](int item, int s) {
    const int b = item / n_tiles;
    const int t0 = (item - b * n_tiles) * FR - pad;
    T* dst = smem + s * stage;
    const int n = 2 * rows * kChunksPerRow;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int arr = i / (rows * kChunksPerRow);
      const int rem = i - arr * rows * kChunksPerRow;
      const int r = rem / kChunksPerRow;
      const int ch = (rem - r * kChunksPerRow) * (16 / sizeof(T));
      const int t = t0 + r;
      const bool in = t >= 0 && t < n_t;
      const T* src = (arr ? dy : x) + ((long long)b * n_t + (in ? t : 0)) * C + c0 + ch;
      tc::cp_async16_zfill(dst + arr * rows * kCh + r * kCh + ch, src, in ? 16 : 0);
    }
  };

  // one register array for either role (both live in one loop, so two
  // arrays would cost their sum): dx role, w[c, i] of the thread's channels;
  // dk role, the sums of dt(x dy) per tap
  float reg[KMAX][V];
  float dbs[V];
#pragma unroll
  for (int i = 0; i < KMAX; ++i)
#pragma unroll
    for (int v = 0; v < V; ++v)
      reg[i][v] = (!dk_role && i < K) ? w[(long long)(c0 + cl + v) * K + i] : 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) dbs[v] = 0.f;

  if (j < items) load_tile(j, 0);
  tc::cp_async_commit();
  int s = 0;
  for (int item = j; item < items; item += nblk, s ^= 1) {
    if (item + nblk < items) load_tile(item + nblk, s ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const T* xs = smem + s * stage;  // row r holds frame t0 - pad + r
    const T* ds = xs + rows * kCh;
    const int b = item / n_tiles;
    const int t0 = (item - b * n_tiles) * FR;
    const int nt = min(FR, n_t - t0);
    if (!dk_role) {
      // dx[t0 + f] = sum_i w[i] dy[t0 + f + pad - i]: stage row f + 2 pad - i
      T* out = dx + ((long long)b * n_t + t0) * C + c0 + cl;
      for (int f = grp; f < nt; f += G::kGroups) {
        float o[V];
#pragma unroll
        for (int v = 0; v < V; ++v) o[v] = 0.f;
#pragma unroll
        for (int i = 0; i < KMAX; ++i) {
          if (i < K) {
            float d[V];
            unpack(*reinterpret_cast<const uint4*>(ds + (f + 2 * pad - i) * kCh + cl), d);
#pragma unroll
            for (int v = 0; v < V; ++v) o[v] = fmaf(d[v], reg[i][v], o[v]);
          }
        }
        *reinterpret_cast<uint4*>(out + (long long)f * C) = pack(o);
      }
    } else {
      // dk[i] += dt(x[t + i - pad] dy[t]): x at stage row f + i, dy at f + pad
      for (int f = grp; f < nt; f += G::kGroups) {
        const uint4 du = *reinterpret_cast<const uint4*>(ds + (f + pad) * kCh + cl);
        float d[V];
        unpack(du, d);
#pragma unroll
        for (int v = 0; v < V; ++v) dbs[v] += d[v];
#pragma unroll
        for (int i = 0; i < KMAX; ++i)
          if (i < K) add_products(reg[i], *reinterpret_cast<const uint4*>(xs + (f + i) * kCh + cl), du);
      }
    }
    __syncthreads();  // the stage is refilled two items on
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // partials of the frame groups -> red[g][tap][channel] -> summed in order g
  float* red = reinterpret_cast<float*>(smem_raw);
  if (dk_role) {
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      if (i < K)
#pragma unroll
        for (int v = 0; v < V; ++v) red[(grp * (K + 1) + i) * kCh + cl + v] = reg[i][v];
#pragma unroll
    for (int v = 0; v < V; ++v) red[(grp * (K + 1) + K) * kCh + cl + v] = dbs[v];
  }
  __syncthreads();
  for (int n = threadIdx.x; n < (K + 1) * kCh; n += kThreads) {
    float sum = 0.f;
    for (int g = 0; g < G::kGroups; ++g) sum += red[g * (K + 1) * kCh + n];
    const int tap = n / kCh;
    part[((long long)j * (K + 1) + tap) * C + c0 + n - tap * kCh] = sum;
  }
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

template <typename T, int KMAX>
int launch_k(const void* x, const void* dy, const void* w, void* dx, float* part, int B,
             int n_t, int C, int K, int G, cudaStream_t st) {
  const size_t smem = smem_bytes<T>(K);
  cudaError_t err = cudaFuncSetAttribute(
      dw_bwd_kernel<T, KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dw_bwd_kernel<T, KMAX><<<dim3(G, C / kCh), kThreads, smem, st>>>(
      (const T*)x, (const T*)dy, (const float*)w, (T*)dx, part, B, n_t, C, K);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* dy, const void* w, void* dx, void* dk, void* db,
           void* work, int B, int n_t, int C, int K, void* stream) {
  if (B < 1 || n_t < 1 || C < kCh || C % kCh || C / kCh > 65535 || K < 1 || K % 2 == 0 ||
      K > kMaxK || smem_bytes<T>(K) > (size_t)kMaxSmem ||
      (long long)B * ((n_t + Geo<T>::kFr - 1) / Geo<T>::kFr) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* part = (float*)work;
  const int G = grid_blocks(B, n_t, C, Geo<T>::kFr);
  int code;
  if (K <= 3)
    code = launch_k<T, 3>(x, dy, w, dx, part, B, n_t, C, K, G, st);
  else if (K <= 7)
    code = launch_k<T, 7>(x, dy, w, dx, part, B, n_t, C, K, G, st);
  else
    code = launch_k<T, kMaxK>(x, dy, w, dx, part, B, n_t, C, K, G, st);
  if (code != 0) return code;
  dw_reduce_kernel<<<((K + 1) * C + 31) / 32, 256, 0, st>>>(part, (float*)dk, (float*)db, G, C,
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

// bytes of the partials workspace for x of `elem_size` bytes (2 or 4)
long long titanet_dw_bwd_workspace_bytes(int B, int n_t, int C, int K, int elem_size) {
  const int fr = elem_size == 2 ? Geo<__nv_bfloat16>::kFr : Geo<float>::kFr;
  return (long long)grid_blocks(B, n_t, C, fr) * (K + 1) * C * (long long)sizeof(float);
}

const char* titanet_dw_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
