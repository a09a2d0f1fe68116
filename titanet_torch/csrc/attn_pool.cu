// Attentive-statistics pooling with the epilog-BN fold: forward and backward.
//
// The forward replaces titanet_tpu/ops/pallas/pool.py::_fwd_impl (kernel body
// _fwd_kernel, _row_forward), reached through attentive_pool_fused(...,
// fold=True) when a bf16 TitaNet runs without a mask; the backward replaces
// pool.py::_bwd_impl (body _bwd_kernel), documented below the forward.
// Forward, per utterance, h [T, C] ->
//   y     = fold ? relu(a*h + c) : h            (f32; rounded to the input
//                                                dtype as a matmul operand)
//   u     = tanh(y @ Wa + ba)                   [T, H], f32 accumulation
//   e     = dt(u) @ Wb + bb                     [T, C], f32 accumulation
//   alpha = softmax over T of e                 f32
//   out   = [sum alpha*y | sqrt(max(sum alpha*y^2 - mean^2, eps))]  [2C]
//
// Bound on the H100: bytes. At B=128, T=301, C=1536, H=128 the input h is
// ~118 MB of bf16 (~35 us at 3.35 TB/s) against ~30 GFLOP (~31 us at the
// bf16 tensor-core rate).
//
// Design (first version; correct and simple, not yet at the bound):
//  1. attn_u_kernel: one block per 64 rows of the flattened [B*T] and 128
//     hidden units. y is recomputed from h and the fold while it is staged
//     through shared memory in 32-channel chunks with the matching rows of
//     Wa; each thread accumulates an 8x4 tile in registers. u goes to a
//     [B*T, H] f32 scratch, 1/12 of h's bytes at H=128, C=1536.
//  2. attn_stats_kernel: one block per (utterance, 128 channels), 4 thread
//     groups of one channel per thread. The block keeps its Wb columns in
//     shared memory and stages 32 frames of u at a time; each group computes
//     e for 8 of them and runs an online (max-rescaled) softmax that
//     accumulates sum(w), sum(w*y) and sum(w*y^2) in f32 with y recomputed
//     from h; the groups' states are merged at the end. The [B, T, C] energies
//     never reach device memory; h is read twice (once per kernel), the
//     known cost of this version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreadsU = 256;
constexpr int kRows = 64;     // rows of [B*T] per attn_u_kernel block
constexpr int kCChunk = 32;   // channels staged per step
constexpr int kHTile = 128;   // hidden units per attn_u_kernel block
constexpr int kChan = 128;    // channels per attn_stats_kernel block (= threads)
constexpr int kTT = 32;       // frames of u staged per step
constexpr int kGroups = 4;    // thread groups splitting each staged chunk
constexpr int kFG = kTT / kGroups;
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

// relu(a*h + c) with the multiply and the add rounded separately, as the
// plain version computes it
__device__ __forceinline__ float fold_relu(float h, float a, float c) {
  return fmaxf(__fadd_rn(__fmul_rn(h, a), c), 0.f);
}

template <typename T>
__global__ void __launch_bounds__(kThreadsU) attn_u_kernel(
    const T* __restrict__ h, const float* __restrict__ a, const float* __restrict__ c,
    const T* __restrict__ wa, const float* __restrict__ ba, float* __restrict__ u,
    int rows, int C, int H, int fold) {
  __shared__ float ys[kRows][kCChunk];
  __shared__ float ws[kCChunk][kHTile];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;  // rows ty*8 .. ty*8+7
  const int r0 = blockIdx.x * kRows;
  const int j0 = blockIdx.y * kHTile;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCChunk) {
    for (int i = threadIdx.x; i < kRows * kCChunk; i += kThreadsU) {
      const int r = i / kCChunk, cc = i % kCChunk;
      const int row = r0 + r, ch = c0 + cc;
      float v = 0.f;
      if (row < rows) {
        v = to_f(h[(long long)row * C + ch]);
        if (fold) v = round_as<T>(fold_relu(v, a[ch], c[ch]));
      }
      ys[r][cc] = v;
    }
    for (int i = threadIdx.x; i < kCChunk * kHTile; i += kThreadsU) {
      const int cc = i / kHTile, jj = i % kHTile;
      ws[cc][jj] = to_f(wa[(long long)(c0 + cc) * H + j0 + jj]);
    }
    __syncthreads();
#pragma unroll 4
    for (int cc = 0; cc < kCChunk; ++cc) {
      float w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = ws[cc][tx + 32 * q];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float y = ys[ty * 8 + i][cc];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(y, w[q], acc[i][q]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + ty * 8 + i;
    if (row >= rows) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx + 32 * q;
      u[(long long)row * H + j] = tanhf(acc[i][q] + ba[j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kChan * kGroups) attn_stats_kernel(
    const T* __restrict__ h, const float* __restrict__ a, const float* __restrict__ c,
    const float* __restrict__ u, const T* __restrict__ wb, const float* __restrict__ bb,
    T* __restrict__ out, int n_t, int C, int H, float eps, int fold,
    float* __restrict__ stats) {
  // out: [B, 2C] mean | std, or null; stats: [4][B][C] softmax max, sum of
  // exp(e - max), mean and E[y^2] for the backward, or null
  extern __shared__ __align__(16) float smem[];
  float* wbs = smem;              // [H][kChan]
  float* us = smem + H * kChan;   // [kTT][H]; the merge buffer at the end
  const int tc = threadIdx.x % kChan;  // channel within the tile
  const int g = threadIdx.x / kChan;   // frame group: frames g*kFG .. of each chunk
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChan;
  const int ch = c0 + tc;
  for (int i = threadIdx.x; i < H * kChan; i += kChan * kGroups)
    wbs[i] = to_f(wb[(long long)(i / kChan) * C + c0 + i % kChan]);
  const float bbc = bb[ch];
  const float ac = fold ? a[ch] : 1.f;
  const float cc = fold ? c[ch] : 0.f;
  const T* hb = h + (long long)b * n_t * C + ch;
  const float* ub = u + (long long)b * n_t * H;

  // online softmax state of this thread's frames: max, sum w, sum w*y, sum w*y^2
  float m = -INFINITY, s = 0.f, sy = 0.f, syy = 0.f;
  for (int t0 = 0; t0 < n_t; t0 += kTT) {
    const int nt = min(kTT, n_t - t0);
    __syncthreads();  // wbs written / previous chunk of us consumed
    for (int i = threadIdx.x; i < nt * H; i += kChan * kGroups)
      us[i] = round_as<T>(ub[(long long)t0 * H + i]);
    __syncthreads();
    const int tg = g * kFG;  // first frame of this group in the chunk
    float e[kFG];
#pragma unroll
    for (int t = 0; t < kFG; ++t) e[t] = 0.f;
    for (int j = 0; j < H; j += 4) {
      const float w0 = wbs[(j + 0) * kChan + tc];
      const float w1 = wbs[(j + 1) * kChan + tc];
      const float w2 = wbs[(j + 2) * kChan + tc];
      const float w3 = wbs[(j + 3) * kChan + tc];
#pragma unroll
      for (int t = 0; t < kFG; ++t) {
        if (tg + t < nt) {
          const float4 uv = *reinterpret_cast<const float4*>(us + (tg + t) * H + j);
          e[t] = fmaf(uv.x, w0, e[t]);
          e[t] = fmaf(uv.y, w1, e[t]);
          e[t] = fmaf(uv.z, w2, e[t]);
          e[t] = fmaf(uv.w, w3, e[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kFG; ++t) {
      if (tg + t < nt) {
        const float et = e[t] + bbc;
        const float hv = to_f(hb[(long long)(t0 + tg + t) * C]);
        const float y = fold ? fold_relu(hv, ac, cc) : hv;
        if (et > m) {
          const float r = expf(m - et);
          s = fmaf(s, r, 1.f);
          sy = fmaf(sy, r, y);
          syy = fmaf(syy, r, y * y);
          m = et;
        } else {
          const float w = expf(et - m);
          s += w;
          sy = fmaf(w, y, sy);
          syy = fmaf(w * y, y, syy);
        }
      }
    }
  }
  // merge the groups' states (a group that saw no frame has s == 0)
  __syncthreads();
  float* red = us;  // [4][kGroups][kChan] <= kTT*H floats
  red[(0 * kGroups + g) * kChan + tc] = m;
  red[(1 * kGroups + g) * kChan + tc] = s;
  red[(2 * kGroups + g) * kChan + tc] = sy;
  red[(3 * kGroups + g) * kChan + tc] = syy;
  __syncthreads();
  if (g != 0) return;
  float mx = red[tc];
#pragma unroll
  for (int k = 1; k < kGroups; ++k) mx = fmaxf(mx, red[k * kChan + tc]);
  float S = 0.f, SY = 0.f, SYY = 0.f;
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const float gs = red[(1 * kGroups + k) * kChan + tc];
    if (gs == 0.f) continue;
    const float r = expf(red[k * kChan + tc] - mx);
    S = fmaf(gs, r, S);
    SY = fmaf(red[(2 * kGroups + k) * kChan + tc], r, SY);
    SYY = fmaf(red[(3 * kGroups + k) * kChan + tc], r, SYY);
  }
  const float mean = SY / S;
  const float q = SYY / S;
  if (out) {
    const float sd = sqrtf(fmaxf(q - mean * mean, eps));
    out[(long long)b * 2 * C + ch] = from_f<T>(mean);
    out[(long long)b * 2 * C + C + ch] = from_f<T>(sd);
  }
  if (stats) {
    const long long bc = (long long)b * C + ch, n = (long long)gridDim.y * C;
    stats[bc] = mx;
    stats[n + bc] = S;
    stats[2 * n + bc] = mean;
    stats[3 * n + bc] = q;
  }
}

size_t stats_smem_bytes(int H) { return (size_t)(H * kChan + kTT * H) * sizeof(float); }

template <typename T>
int launch(const void* h, const void* a, const void* c, const void* wa, const void* ba,
           const void* wb, const void* bb, void* u_scratch, void* out, int B, int n_t,
           int C, int H, float eps, int fold, void* stream) {
  const size_t smem = stats_smem_bytes(H);
  if (B < 1 || B > 65535 || n_t < 1 || C % kChan || H % kHTile || smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attn_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = B * n_t;
  const cudaStream_t st = (cudaStream_t)stream;
  attn_u_kernel<T><<<dim3((rows + kRows - 1) / kRows, H / kHTile), kThreadsU, 0, st>>>(
      (const T*)h, (const float*)a, (const float*)c, (const T*)wa, (const float*)ba,
      (float*)u_scratch, rows, C, H, fold);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_stats_kernel<T><<<dim3(C / kChan, B), kChan * kGroups, smem, st>>>(
      (const T*)h, (const float*)a, (const float*)c, (const float*)u_scratch,
      (const T*)wb, (const float*)bb, (T*)out, n_t, C, H, eps, fold, nullptr);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward
//
// Gradients of the forward for the output gradient g [B, 2C] (h's dtype), as
// _bwd_kernel computes them: y, u, e and alpha are recomputed from h; with
// dm, ds = g[:C], g[C:], resid = E[y^2] - mean^2, std = sqrt(max(resid, eps)),
//   dresid = resid > eps ? ds / (2 std) : 0,  dmt = dm - 2 mean dresid
//   dalpha = y dmt + y^2 dresid,  de = alpha (dalpha - sum_t alpha dalpha)
//   dy     = alpha (dmt + 2 y dresid) + dt(dz) @ Wa^T
//   du     = dt(de) @ Wb^T,  dz = du (1 - u^2)
//   dWb    = sum_bt dt(u)^T dt(de),  dbb = sum_bt de
//   dWa    = sum_bt y^T dt(dz),      dba = sum_bt dz
//   fold:  dpre = y > 0 ? dy : 0,  dh = dt(a dpre),  da = sum_bt dpre h,
//          dc = sum_bt dpre;  else dh = dt(dy)
// with dt() the rounding to h's dtype and every sum in f32. sum_t alpha dalpha
// is taken in closed form, dmt mean + dresid E[y^2].
//
// Bound on the H100: operations. 12 B T C H = 90.9 GFLOP at B=128, T=301,
// C=1536, H=128 (~0.09 ms at the bf16 tensor-core rate) against h read and
// dh written once (~0.07 ms).
//
// Design (first version; correct and simple, on CUDA cores): the blocks of a
// TPU grid that added into one output in order become per-block partial sums
// reduced in a fixed order by a second pass, so the gradients are
// deterministic. Passes, each one launch:
//  1. attn_u_kernel (the forward's): u [B*T, H] f32;
//  2. attn_stats_kernel (the forward's) with the per-(b, c) softmax max, sum,
//     mean and E[y^2] written out instead of the output;
//  3. attn_de_kernel, one block per (utterance, 128 channels): recomputes e
//     and alpha chunk by chunk as the forward does and writes dt(de) and the
//     f32 first term of dy ([B*T, C] each) and per-utterance sums of de;
//  4-7. one tiled CUDA-core product kernel (gemm_kernel, 64 x 128 x 32 tiles,
//     operands staged through shared memory by loader functors that also
//     round, transpose and fold) for du -> dz (epilogue: dz and per-block
//     sums for dba), dz @ Wa^T -> dy -> dh (epilogue: the fold backward and
//     per-block sums for da, dc), and split-K partials of dWb and dWa over
//     B*T rows;
//  8. sum_parts_kernel reduces every partial in a fixed order.
// Every product of _bwd_kernel's body (du, dWb, dz @ Wa^T, dWa) and of the
// recomputed forward runs in these kernels. The [B*T, C] intermediates
// (dt(de), f32 dy term) cross device memory: the known cost of this version.

constexpr int kBM = 64;   // product tile rows
constexpr int kBN = 128;  // product tile columns
constexpr int kBK = 32;   // product tile depth
constexpr int kThreadsG = 256;
constexpr int kSplits = 32;  // split-K partials of the weight gradients

template <typename T>
__global__ void __launch_bounds__(kChan * kGroups) attn_de_kernel(
    const T* __restrict__ h, const float* __restrict__ a, const float* __restrict__ c,
    const float* __restrict__ u, const T* __restrict__ wb, const float* __restrict__ bb,
    const float* __restrict__ stats, const T* __restrict__ g, T* __restrict__ de_out,
    float* __restrict__ dy0, float* __restrict__ dbb_part, int n_t, int C, int H, float eps,
    int fold) {
  extern __shared__ __align__(16) float smem[];
  float* wbs = smem;
  float* us = smem + H * kChan;
  const int tc = threadIdx.x % kChan;
  const int grp = threadIdx.x / kChan;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChan;
  const int ch = c0 + tc;
  for (int i = threadIdx.x; i < H * kChan; i += kChan * kGroups)
    wbs[i] = to_f(wb[(long long)(i / kChan) * C + c0 + i % kChan]);
  const float bbc = bb[ch];
  const float ac = fold ? a[ch] : 1.f;
  const float cc = fold ? c[ch] : 0.f;
  const long long bc = (long long)b * C + ch, nbc = (long long)gridDim.y * C;
  const float m = stats[bc], S = stats[nbc + bc], mean = stats[2 * nbc + bc];
  const float q = stats[3 * nbc + bc];
  const float resid = q - mean * mean;
  const float sd = sqrtf(fmaxf(resid, eps));
  const float dm = to_f(g[(long long)b * 2 * C + ch]);
  const float ds = to_f(g[(long long)b * 2 * C + C + ch]);
  const float dresid = resid > eps ? ds * 0.5f / sd : 0.f;
  const float dmt = dm - 2.f * mean * dresid;
  const float tsum = dmt * mean + dresid * q;
  const T* hb = h + (long long)b * n_t * C + ch;
  const float* ub = u + (long long)b * n_t * H;
  const long long row0 = (long long)b * n_t;

  float dbb = 0.f;
  for (int t0 = 0; t0 < n_t; t0 += kTT) {
    const int nt = min(kTT, n_t - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < nt * H; i += kChan * kGroups)
      us[i] = round_as<T>(ub[(long long)t0 * H + i]);
    __syncthreads();
    const int tg = grp * kFG;
    float e[kFG];
#pragma unroll
    for (int t = 0; t < kFG; ++t) e[t] = 0.f;
    for (int j = 0; j < H; j += 4) {
      const float w0 = wbs[(j + 0) * kChan + tc];
      const float w1 = wbs[(j + 1) * kChan + tc];
      const float w2 = wbs[(j + 2) * kChan + tc];
      const float w3 = wbs[(j + 3) * kChan + tc];
#pragma unroll
      for (int t = 0; t < kFG; ++t) {
        if (tg + t < nt) {
          const float4 uv = *reinterpret_cast<const float4*>(us + (tg + t) * H + j);
          e[t] = fmaf(uv.x, w0, e[t]);
          e[t] = fmaf(uv.y, w1, e[t]);
          e[t] = fmaf(uv.z, w2, e[t]);
          e[t] = fmaf(uv.w, w3, e[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kFG; ++t) {
      if (tg + t < nt) {
        const int tt = t0 + tg + t;
        const float hv = to_f(hb[(long long)tt * C]);
        const float y = fold ? fold_relu(hv, ac, cc) : hv;
        const float alpha = expf(e[t] + bbc - m) / S;
        const float dalpha = y * dmt + (y * y) * dresid;
        const float de = alpha * (dalpha - tsum);
        dbb += de;
        const long long o = (row0 + tt) * C + ch;
        de_out[o] = from_f<T>(de);
        dy0[o] = alpha * (dmt + 2.f * y * dresid);
      }
    }
  }
  __syncthreads();
  float* red = us;  // [kGroups][kChan]
  red[grp * kChan + tc] = dbb;
  __syncthreads();
  if (grp != 0) return;
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kGroups; ++k) sum += red[k * kChan + tc];
  dbb_part[bc] = sum;
}

// Operand loaders of gemm_kernel: (first, second) -> f32 value, already
// rounded or folded. kSecondContig says which index is contiguous in memory,
// so that the tile load walks it with neighbouring threads.
template <typename T>
struct Mat {  // row-major [rows][ld] in T
  static constexpr bool kSecondContig = true;
  const T* p;
  int ld;
  __device__ float operator()(int r, int s) const { return to_f(p[(long long)r * ld + s]); }
};

template <typename T>
struct MatRound {  // row-major f32 [rows][ld], rounded to T
  static constexpr bool kSecondContig = true;
  const float* p;
  int ld;
  __device__ float operator()(int r, int s) const {
    return round_as<T>(p[(long long)r * ld + s]);
  }
};

template <typename T>
struct FoldY {  // y[row, ch] = dt(fold ? relu(a*h + c) : h)
  static constexpr bool kSecondContig = true;
  const T* h;
  const float* a;
  const float* c;
  int C, fold;
  __device__ float operator()(int row, int ch) const {
    const float v = to_f(h[(long long)row * C + ch]);
    return fold ? round_as<T>(fold_relu(v, a[ch], c[ch])) : v;
  }
};

template <class L>
struct Tr {  // the transposed view of L
  static constexpr bool kSecondContig = !L::kSecondContig;
  L l;
  __device__ float operator()(int r, int s) const { return l(s, r); }
};

// Sum a 64 x 128 block's per-thread column sums (8 rows each) over the 8
// row groups, in order; thread i < 128 returns column i's sum.
__device__ __forceinline__ float block_column_sum(const float s[4], float* red) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < 4; ++q) red[ty * kBN + tx + 32 * q] = s[q];
  __syncthreads();
  float sum = 0.f;
  if (threadIdx.x < kBN) {
    for (int k = 0; k < kThreadsG / 32; ++k) sum += red[k * kBN + threadIdx.x];
  }
  __syncthreads();
  return sum;
}

struct EpiDz {  // dz = du (1 - u^2); per-block column sums for dba
  const float* u;
  float* dz;
  float* dba_part;
  int M, H;
  __device__ void operator()(int r0, int n0, const float (&acc)[8][4], float* red) const {
    const int tx = threadIdx.x & 31;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = r0 + i;
      if (row >= M) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long o = (long long)row * H + n0 + tx + 32 * q;
        const float uu = u[o];
        const float v = acc[i][q] * (1.f - uu * uu);
        dz[o] = v;
        s[q] += v;
      }
    }
    const float sum = block_column_sum(s, red);
    if (threadIdx.x < kBN) dba_part[(long long)blockIdx.x * H + n0 + threadIdx.x] = sum;
  }
};

template <typename T>
struct EpiDy {  // dy = dy0 + acc; fold backward; dh; per-block sums for da, dc
  const float* dy0;
  const T* h;
  const float* a;
  const float* c;
  T* dh;
  float* da_part;
  float* dc_part;
  int M, C, fold;
  __device__ void operator()(int r0, int n0, const float (&acc)[8][4], float* red) const {
    const int tx = threadIdx.x & 31;
    float sa[4] = {0.f, 0.f, 0.f, 0.f}, sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = r0 + i;
      if (row >= M) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = n0 + tx + 32 * q;
        const long long o = (long long)row * C + col;
        const float dy = dy0[o] + acc[i][q];
        if (fold) {
          const float hv = to_f(h[o]);
          const float dpre = fold_relu(hv, a[col], c[col]) > 0.f ? dy : 0.f;
          sa[q] += dpre * hv;
          sc[q] += dpre;
          dh[o] = from_f<T>(dpre * a[col]);
        } else {
          dh[o] = from_f<T>(dy);
        }
      }
    }
    const float suma = block_column_sum(sa, red);
    const float sumc = block_column_sum(sc, red);
    if (threadIdx.x < kBN) {
      da_part[(long long)blockIdx.x * C + n0 + threadIdx.x] = suma;
      dc_part[(long long)blockIdx.x * C + n0 + threadIdx.x] = sumc;
    }
  }
};

struct EpiPartial {  // split-K partial: part[split][M][N]
  float* part;
  int M, N;
  __device__ void operator()(int r0, int n0, const float (&acc)[8][4], float*) const {
    const int tx = threadIdx.x & 31;
    float* p = part + (long long)blockIdx.z * M * N;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = r0 + i;
      if (row >= M) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) p[(long long)row * N + n0 + tx + 32 * q] = acc[i][q];
    }
  }
};

// acc[M, N] = sum over k in this block's split of A(m, k) B(k, n), one
// 64 x 128 tile a block; thread (ty, tx) owns rows ty*8.. and columns tx+32q.
template <class LA, class LB, class Epi>
__global__ void __launch_bounds__(kThreadsG) gemm_kernel(LA la, LB lb, Epi epi, int M, int N,
                                                        int K, int k_split) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN + 1];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int kb = blockIdx.z * k_split;
  const int ke = min(K, kb + k_split);
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  for (int k0 = kb; k0 < ke; k0 += kBK) {
    for (int i = threadIdx.x; i < kBK * kBM; i += kThreadsG) {
      const int kk = LA::kSecondContig ? i % kBK : i / kBM;
      const int mm = LA::kSecondContig ? i / kBK : i % kBM;
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < M && k < ke) ? la(m, k) : 0.f;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreadsG) {
      const int kk = LB::kSecondContig ? i / kBN : i % kBK;
      const int nn = LB::kSecondContig ? i % kBN : i / kBK;
      const int n = n0 + nn, k = k0 + kk;
      Bs[kk][nn] = (n < N && k < ke) ? lb(k, n) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = Bs[kk][tx + 32 * q];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float y = As[kk][ty * 8 + i];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(y, w[q], acc[i][q]);
      }
    }
    __syncthreads();
  }
  epi(m0 + ty * 8, n0, acc, &Bs[0][0]);
}

// out[n] = sum_s part[s][n], s in order: 32 columns a block, 8 warps over s.
__global__ void __launch_bounds__(256) sum_parts_kernel(const float* __restrict__ part,
                                                        float* __restrict__ out, int S, int N) {
  __shared__ float red[8][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (n < N)
    for (int k = w; k < S; k += 8) s += part[(long long)k * N + n];
  red[w][lane] = s;
  __syncthreads();
  if (w == 0 && n < N) {
    float sum = 0.f;
    for (int k = 0; k < 8; ++k) sum += red[k][lane];
    out[n] = sum;
  }
}

struct BwdWorkspace {  // byte offsets of the backward's scratch buffers
  size_t u, stats, de, dy0, dz, dba, dbb, da, dc, dwb, dwa, total;
  BwdWorkspace(int B, int n_t, int C, int H, int elem) {
    const size_t rows = (size_t)B * n_t, rb = (rows + kBM - 1) / kBM;
    size_t off = 0;
    auto take = [&off](size_t bytes) {
      const size_t at = off;
      off += (bytes + 255) / 256 * 256;
      return at;
    };
    u = take(rows * H * 4);
    stats = take((size_t)4 * B * C * 4);
    de = take(rows * C * elem);
    dy0 = take(rows * C * 4);
    dz = take(rows * H * 4);
    dba = take(rb * H * 4);
    dbb = take((size_t)B * C * 4);
    da = take(rb * C * 4);
    dc = take(rb * C * 4);
    dwb = take((size_t)kSplits * H * C * 4);
    dwa = take((size_t)kSplits * C * H * 4);
    total = off;
  }
};

int sum_parts(const float* part, float* out, int S, int N, cudaStream_t st) {
  sum_parts_kernel<<<(N + 31) / 32, 256, 0, st>>>(part, out, S, N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* h_, const void* a_, const void* c_, const void* wa_, const void* ba_,
               const void* wb_, const void* bb_, const void* g_, void* dh, void* da, void* dc,
               void* dwa, void* dba, void* dwb, void* dbb, void* work, int B, int n_t, int C,
               int H, float eps, int fold, void* stream) {
  const size_t smem = stats_smem_bytes(H);
  if (B < 1 || B > 65535 || n_t < 1 || C % kChan || H % kHTile || smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const T* h = (const T*)h_;
  const float* a = (const float*)a_;
  const float* c = (const float*)c_;
  const T* wa = (const T*)wa_;
  const T* wb = (const T*)wb_;
  const BwdWorkspace ws(B, n_t, C, H, (int)sizeof(T));
  char* base = (char*)work;
  float* u = (float*)(base + ws.u);
  float* stats = (float*)(base + ws.stats);
  T* de = (T*)(base + ws.de);
  float* dy0 = (float*)(base + ws.dy0);
  float* dz = (float*)(base + ws.dz);
  float* dba_part = (float*)(base + ws.dba);
  float* dbb_part = (float*)(base + ws.dbb);
  float* da_part = (float*)(base + ws.da);
  float* dc_part = (float*)(base + ws.dc);
  float* dwb_part = (float*)(base + ws.dwb);
  float* dwa_part = (float*)(base + ws.dwa);
  const int rows = B * n_t;
  const int rb = (rows + kBM - 1) / kBM;
  const int k_split = ((rows + kSplits - 1) / kSplits + kBK - 1) / kBK * kBK;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  err = cudaFuncSetAttribute(attn_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_de_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_u_kernel<T><<<dim3(rb, H / kHTile), kThreadsU, 0, st>>>(h, a, c, wa, (const float*)ba_,
                                                               u, rows, C, H, fold);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  attn_stats_kernel<T><<<dim3(C / kChan, B), kChan * kGroups, smem, st>>>(
      h, a, c, u, wb, (const float*)bb_, nullptr, n_t, C, H, eps, fold, stats);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  attn_de_kernel<T><<<dim3(C / kChan, B), kChan * kGroups, smem, st>>>(
      h, a, c, u, wb, (const float*)bb_, stats, (const T*)g_, de, dy0, dbb_part, n_t, C, H, eps,
      fold);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // du = dt(de) @ Wb^T -> dz
  gemm_kernel<<<dim3(rb, H / kBN, 1), kThreadsG, 0, st>>>(
      Mat<T>{de, C}, Tr<Mat<T>>{Mat<T>{wb, C}}, EpiDz{u, dz, dba_part, rows, H}, rows, H, C, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // dy = dy0 + dt(dz) @ Wa^T -> dh
  gemm_kernel<<<dim3(rb, C / kBN, 1), kThreadsG, 0, st>>>(
      MatRound<T>{dz, H}, Tr<Mat<T>>{Mat<T>{wa, H}},
      EpiDy<T>{dy0, h, a, c, (T*)dh, da_part, dc_part, rows, C, fold}, rows, C, H, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // dWb = dt(u)^T @ dt(de), split over rows
  gemm_kernel<<<dim3(H / kBM, C / kBN, kSplits), kThreadsG, 0, st>>>(
      Tr<MatRound<T>>{MatRound<T>{u, H}}, Mat<T>{de, C}, EpiPartial{dwb_part, H, C}, H, C, rows,
      k_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // dWa = y^T @ dt(dz), split over rows
  gemm_kernel<<<dim3(C / kBM, H / kBN, kSplits), kThreadsG, 0, st>>>(
      Tr<FoldY<T>>{FoldY<T>{h, a, c, C, fold}}, MatRound<T>{dz, H}, EpiPartial{dwa_part, C, H}, C,
      H, rows, k_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int code;
  if ((code = sum_parts(dwb_part, (float*)dwb, kSplits, H * C, st))) return code;
  if ((code = sum_parts(dwa_part, (float*)dwa, kSplits, C * H, st))) return code;
  if ((code = sum_parts(dba_part, (float*)dba, rb, H, st))) return code;
  if ((code = sum_parts(dbb_part, (float*)dbb, B, C, st))) return code;
  if ((code = sum_parts(da_part, (float*)da, rb, C, st))) return code;
  return sum_parts(dc_part, (float*)dc, rb, C, st);
}

}  // namespace

extern "C" {

int titanet_attn_pool_fwd_f32(const void* h, const void* a, const void* c, const void* wa,
                              const void* ba, const void* wb, const void* bb,
                              void* u_scratch, void* out, int B, int n_t, int C, int H,
                              float eps, int fold, void* stream) {
  return launch<float>(h, a, c, wa, ba, wb, bb, u_scratch, out, B, n_t, C, H, eps, fold,
                       stream);
}

int titanet_attn_pool_fwd_bf16(const void* h, const void* a, const void* c, const void* wa,
                               const void* ba, const void* wb, const void* bb,
                               void* u_scratch, void* out, int B, int n_t, int C, int H,
                               float eps, int fold, void* stream) {
  return launch<__nv_bfloat16>(h, a, c, wa, ba, wb, bb, u_scratch, out, B, n_t, C, H, eps,
                               fold, stream);
}

int titanet_attn_pool_bwd_f32(const void* h, const void* a, const void* c, const void* wa,
                              const void* ba, const void* wb, const void* bb, const void* g,
                              void* dh, void* da, void* dc, void* dwa, void* dba, void* dwb,
                              void* dbb, void* work, int B, int n_t, int C, int H, float eps,
                              int fold, void* stream) {
  return launch_bwd<float>(h, a, c, wa, ba, wb, bb, g, dh, da, dc, dwa, dba, dwb, dbb, work, B,
                           n_t, C, H, eps, fold, stream);
}

int titanet_attn_pool_bwd_bf16(const void* h, const void* a, const void* c, const void* wa,
                               const void* ba, const void* wb, const void* bb, const void* g,
                               void* dh, void* da, void* dc, void* dwa, void* dba, void* dwb,
                               void* dbb, void* work, int B, int n_t, int C, int H, float eps,
                               int fold, void* stream) {
  return launch_bwd<__nv_bfloat16>(h, a, c, wa, ba, wb, bb, g, dh, da, dc, dwa, dba, dwb, dbb,
                                   work, B, n_t, C, H, eps, fold, stream);
}

long long titanet_attn_pool_bwd_workspace_bytes(int B, int n_t, int C, int H, int elem_size) {
  return (long long)BwdWorkspace(B, n_t, C, H, elem_size).total;
}

long long titanet_attn_pool_smem_bytes(int H) { return (long long)stats_smem_bytes(H); }

const char* titanet_attn_pool_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
