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
// Two designs. bf16 at H == 128 (every TitaNet) runs pool_onepass_kernel
// (below the FP32-core backward: one pass over h, u and the energies kept on
// the chip). f32, the parity surface, runs two FP32-core passes:
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
//     known cost of both designs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cuda.h>  // CUtensorMap; the encoder comes from the driver at run time

#include "mma_bf16.cuh"

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

// bf16 at H == 128 runs the tensor-core kernels further down
inline bool use_tc(int H, int elem) { return elem == 2 && H == 128; }
int launch_tc_fwd(const void* h, const void* a, const void* c, const void* wa, const void* ba,
                  const void* wb, const void* bb, void* u_scratch, void* out, int B, int n_t, int C,
                  float eps, int fold, cudaStream_t st);

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
  if (use_tc(H, (int)sizeof(T)))
    return launch_tc_fwd(h, a, c, wa, ba, wb, bb, u_scratch, out, B, n_t, C, eps, fold, st);
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
// Both designs turn the blocks of a TPU grid that added into one output in
// order into per-block partial sums reduced in a fixed order by a second
// pass (sum_parts_kernel), so the gradients are deterministic: no float
// atomics.
//
// bf16 at H == 128: the tensor-core design (launch_bwd_tc and the tc_*
// kernels further down). What bounds it: six products of B*T x C x H and a
// softmax epilogue of ~30 operations on every element of [B*T, C]. What the
// design does: every product is an mma.sync tile fed by cp.async
// (mma_bf16.cuh), but the first stage's; the operand roundings of the TPU
// kernel (y, u, de, dz to bf16) happen as the tiles are staged; and no f32
// [B*T, C] array exists:
//  1. pool_onepass_kernel (the forward's one pass): u in f32 (for 1 - u^2)
//     and bf16 (the operand), and the softmax max, sum, mean and E[y^2] per
//     (b, c);
//  2. tc_de_kernel, a block (16 warps: the softmax epilogue is what it
//     spends its time on) per 64 frames of an utterance, looping over the
//     channels in tiles of 128: e recomputed (K = 128) -> alpha -> de, bf16
//     to device memory (once written, read once by dWb); du = de @ Wb^T
//     accumulates in registers over the loop; then dz, bf16;
//  3. tc_dh_kernel, same blocks: e recomputed again -> alpha; the first
//     term of dy is formed in registers and added to dz @ Wa^T from the
//     accumulators; fold backward; dh;
//  4-5. tc_atb_kernel: dWb = u^T de and dWa = y^T dz, split over 32 row
//     ranges (y recomputed from h as its tile is staged);
//  6. sum_parts_kernel over every partial.
// The workspace holds u (f32, bf16), de and dz (bf16), the partials and
// the first stage's running states: 266.1 MB at B=128, T=301, C=1536
// against 574.9 MB for the design below.
//
// f32 (and bf16 at other H): the FP32-core design. Passes, each one launch:
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
// (dt(de), f32 dy term) cross device memory: the known cost of this design.

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

// ------------------------------------------------ bf16: tensor-core passes
//
// H == 128 in bf16. Every product runs on mma.sync from ldmatrix fragments
// (mma_bf16.cuh); operand tiles are [rows][128 + pad] bf16 in shared memory,
// filled by cp.async, or through registers where y = relu(a*h + c) is
// computed on the way. A block is kWM x 4 warps over a 64 x 128 (or 128 x
// 128) tile of the product.

using bf16 = __nv_bfloat16;
constexpr int kWM = 2;                    // warp rows of a block (x 4 warp columns of 32)
constexpr int kTcThreads = kWM * 128;
constexpr int kMT = 64 / (16 * kWM);      // m tiles of a warp over a 64-row tile
constexpr int kWR = kMT * 16;             // rows of a warp's tile
// tc_de_kernel and tc_dh_kernel spend their time in the per-element softmax
// epilogue: twice the warps, half the rows each
constexpr int kEWM = 4;
constexpr int kEThreads = kEWM * 128;
constexpr int kEMT = 64 / (16 * kEWM);
constexpr int kEWR = kEMT * 16;
constexpr int kTcRows = 64;               // rows of [B*T] (or of one utterance) a block owns
constexpr int kTcLd = 128 + tc::kPad;     // row stride of a 128-wide tile
constexpr int kTcTile64 = kTcRows * kTcLd;   // elements of a [64][128] tile
constexpr int kTcTile128 = 128 * kTcLd;      // elements of a [128][128] tile
constexpr int kKR = 32;                   // rows a step of tc_atb_kernel

// rows x 128 bf16 from global (row stride ld) into a [rows][kTcLd] tile;
// rows >= valid are zero-filled
template <int NTHR = kTcThreads>
__device__ __forceinline__ void tile_async(bf16* dst, const bf16* src, long long ld, int rows,
                                           int valid, int tid) {
  for (int i = tid; i < rows * 16; i += NTHR) {
    const int r = i >> 4, v = i & 15;
    bf16* d = dst + r * kTcLd + v * 8;
    if (r < valid)
      tc::cp_async16(d, src + (long long)r * ld + v * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// 8 values of h -> dt(y) (the operand rounding of the fold)
__device__ __forceinline__ uint4 fold_chunk(uint4 raw, const float* a, const float* c, int fold) {
  if (!fold) return raw;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 v = __bfloat1622float2(p[q]);
    const float2 av = *reinterpret_cast<const float2*>(a + 2 * q);
    const float2 cv = *reinterpret_cast<const float2*>(c + 2 * q);
    p[q] = __floats2bfloat162_rn(fold_relu(v.x, av.x, cv.x), fold_relu(v.y, av.y, cv.y));
  }
  return raw;
}

// ------------------------------------------------ bf16: the one-pass forward
//
// pool_onepass_kernel replaces titanet_tpu/ops/pallas/pool.py::_fwd_impl
// (_fwd_kernel, _row_forward) in bf16 at H == 128, and is the backward's
// first stage. What bounds it: one read of h (118 MB at B=128, T=301,
// C=1536: 0.0358 ms at 3.35 TB/s) against 30.3 GFLOP (0.0306 ms on the bf16
// tensor cores): nearly balanced; and every element of [T, C] also takes a
// softmax update (~10 operations, one exp). What the design does: h is read
// once from device memory, and u, e and alpha never leave the chip.
//
// A block owns whole rows: tiles of kOpRows = 128 frames of one utterance
// across all C channels, 64 frames a warpgroup (frame half f); it walks the
// tiles s, s + S, ... of utterance b (grid (S, B), S = onepass_splits(B):
// one block an SM of an H100 at B >= 132 / 2). Its four warpgroups are two
// pairs, each pair (one warpgroup a frame half) taking every other
// 64-channel chunk (pair p: chunks p, p + 2, ...), so that one pair's
// softmax runs while the other's products do. For a tile:
//  U. u = y @ Wa: K = C in 64-channel stages, a pair's half of K; the A
//     operand y = dt(relu(a*h + c)) made in registers from the staged h
//     (ldmatrix, fold, round: wgmma.m64n128k16 with A from registers), B
//     the stage's 64 rows of Wa. Pair 1 hands its sums to pair 0 through
//     shared memory (added in that order), pair 0 takes tanh(. + ba) and
//     rounds u to bf16 into the frame half's [64][128] tile (step E's B
//     operand) and, for the backward, writes u in f32 and bf16.
//  E. per 64-channel stage: e^T = Wb[:, chunk]^T @ u^T (wgmma.m64n64k16:
//     channels on M and frames on N, so that each channel's 64 frames sit
//     in one quad of lanes: a thread sums 16 of them, two shuffles finish),
//     then the online softmax: the tile's max per channel, p = exp(e - m),
//     sum p, sum p*yf and sum p*yf^2 with yf recomputed in f32 from the
//     stage's h (ldmatrix.trans gives h^T in the accumulator's layout),
//     merged into the frame half's running state of the channel, rescaled
//     by exp(m_old - m_new). A warpgroup with no frame in the tile (T's
//     last tile) skips its products and softmax.
// Loads: TMA (cp.async.bulk.tensor, 128-byte swizzled by the tensor maps),
// one thread a pair requesting a stage, an mbarrier a slot; a stage is 16
// KB of weights (Wa rows or Wb columns) and the tile's 128 frames x 64
// channels of h (rows past the utterance zero), 3 slots a pair, 2 stages in
// flight. Step E reads its h stage a second time, one tile after step U read
// it, through L2 (step U's loads evict-last, step E's evict-first). The
// weights stream through L2 once a tile and are not shared across blocks:
// no cluster. At B=128, T=301 a call moves through L2 ~302 MB of weights
// (384 tiles x 768 KB), 2 x 118 MB of h and ~25 MB of running states
// (564 MB). Taking the weight loads out saves 0.006 ms of the kernel's
// 0.169, and the h re-reads too 0.009 (ops/kernels/pool_sweep.py; H100
// 80GB HBM3, 700 W), so a 2-block cluster multicasting the weights (half
// their L2 bytes) would not pay for its barriers: the kernel is bound by
// issue (the softmax and the fold, ~10 operations an element; each pair's
// barrier and product wait a stage), not by L2.
// Running states live in the scratch `part` ([2S][4][B][C]: max, sum, sum
// p*yf, sum p*yf^2 of (split, frame half)); at the end the 2S states of
// each (b, c) are merged in slot order (in the block when S == 1, else by
// pool_merge_kernel): no float atomics, the same bits every call.
constexpr int kOpRows = 128;         // frames of one utterance a tile, 64 a warpgroup
constexpr int kOpThreads = 512;      // two pairs of warpgroups
constexpr int kOpChunk = 64;         // channels a stage
constexpr int kOpSlots = 3;          // ring slots a pair
constexpr int kOpWBytes = 16384;     // Wa [64][128] or Wb [128][64], bf16
constexpr int kOpHBytes = kOpRows * kOpChunk * 2;  // h [128][64], bf16
constexpr int kOpStageBytes = kOpWBytes + kOpHBytes;
constexpr int kOpUElems = 64 * 128;  // a frame half's u tile, bf16
constexpr size_t kOpSmem = (size_t)2 * kOpSlots * kOpStageBytes + 2 * kOpUElems * sizeof(bf16) +
                           2 * kOpSlots * sizeof(uint64_t);  // slots, u tiles, a full-barrier a slot
// splits of T: one block an SM of an H100 (132) at most, every utterance at
// least one block; ops/kernels/pool.py::onepass_splits mirrors it
constexpr int kOpBlockTarget = 132;
constexpr int kOpMaxSplits = 64;
inline int onepass_splits(int B) {
  const int s = kOpBlockTarget / B;
  return s < 1 ? 1 : (s > kOpMaxSplits ? kOpMaxSplits : s);
}
// bytes of the running states: [2 S][4][B][C] f32
inline size_t onepass_part_bytes(int B, int C) {
  return (size_t)2 * onepass_splits(B) * 4 * B * C * sizeof(float);
}

// element (r, c) of a [rows][64] bf16 tile, 128-byte swizzled
__device__ __forceinline__ int sw64(int r, int c) { return r * 64 + ((((c >> 3) ^ (r & 7))) << 3) + (c & 7); }

// the merged statistics of (b, ch) from the nslots running states
__device__ __forceinline__ void merge_slots(const float* __restrict__ part, int nslots, long long n,
                                            long long bc, int C, int b, int ch, bf16* __restrict__ out,
                                            float* __restrict__ stats, float eps) {
  float mx = -INFINITY;
  for (int k = 0; k < nslots; ++k) mx = fmaxf(mx, part[4 * k * n + bc]);
  float S = 0.f, SY = 0.f, SYY = 0.f;
  for (int k = 0; k < nslots; ++k) {
    const float gs = part[(4 * k + 1) * n + bc];
    if (gs == 0.f) continue;  // a state that saw no frame
    const float r = __expf(part[4 * k * n + bc] - mx);
    S = fmaf(gs, r, S);
    SY = fmaf(part[(4 * k + 2) * n + bc], r, SY);
    SYY = fmaf(part[(4 * k + 3) * n + bc], r, SYY);
  }
  const float mean = SY / S, q = SYY / S;
  if (out) {
    out[(long long)b * 2 * C + ch] = __float2bfloat16(mean);
    out[(long long)b * 2 * C + C + ch] = __float2bfloat16(sqrtf(fmaxf(q - mean * mean, eps)));
  }
  if (stats) {
    stats[bc] = mx;
    stats[n + bc] = S;
    stats[2 * n + bc] = mean;
    stats[3 * n + bc] = q;
  }
}

// Step E's softmax update of one 64-channel stage for this thread's two
// channels q (lo = 16 wq + lane/4, hi = lo + 8) over its 16 frames of the
// warpgroup's 64 (frame half f); the quad of lanes sharing lane/4 holds the
// channel's 64. st: running max, sum p, sum p*yf, sum p*yf^2 of each
// channel, updated; then bb, a and c of the two channels.
template <bool kFold, bool kMasked>
__device__ __forceinline__ void onepass_softmax(const float (&acc)[32], float (&st)[14], const bf16* hs, int f,
                                                int wq, int lane, int fvalid) {
  constexpr float kLog2e = 1.4426950408889634f;
  const int qc = 2 * (lane & 3);
  float mt[2], base[2], av[2], cv[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    av[q] = kFold ? st[10 + q] : 1.f;
    cv[q] = kFold ? st[12 + q] : 0.f;
    float m4[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};  // four chains (max is exact in any order)
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (!kMasked || 8 * jn + qc + e < fvalid)
          m4[(2 * jn + e) & 3] = fmaxf(m4[(2 * jn + e) & 3], acc[4 * jn + 2 * q + e]);
    float m = fmaxf(fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    mt[q] = m + st[8 + q];  // the tile's max of e (-inf: no frame of this warpgroup in the tile)
    const float mn = mt[q] > -INFINITY ? fmaxf(st[4 * q], mt[q]) : 0.f;
    base[q] = (st[8 + q] - mn) * kLog2e;  // p = 2^(acc log2e + base) = exp(acc + bb - mn)
    mt[q] = mt[q] > -INFINITY ? mn : -INFINITY;
  }
  // partial sums by frame parity e (two dependency chains a quantity)
  float ps[2][2] = {}, py[2][2] = {}, pyy[2][2] = {};
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    // h^T of frames 16 jj ..: (2jj, lo), (2jj, hi), (2jj+1, lo), (2jj+1, hi)
    uint32_t hf[4];
    const int fr = 64 * f + 16 * jj + ((lane >> 4) << 3) + (lane & 7);
    const int chunk = 2 * wq + ((lane >> 3) & 1);
    tc::ldmatrix_x4_trans(hf, hs + fr * 64 + ((chunk ^ (fr & 7)) << 3));
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int jn = 2 * jj + x;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float2 hv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hf[2 * x + q]));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float hq = e ? hv.y : hv.x;
          const float yv = kFold ? fold_relu(hq, av[q], cv[q]) : hq;
          float p;
          asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(p) : "f"(fmaf(acc[4 * jn + 2 * q + e], kLog2e, base[q])));
          if (kMasked && 8 * jn + qc + e >= fvalid) p = 0.f;  // a frame past the end
          const float pyv = p * yv;
          ps[q][e] += p;
          py[q][e] += pyv;
          pyy[q][e] = fmaf(pyv, yv, pyy[q][e]);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    float s1 = ps[q][0] + ps[q][1], s2 = py[q][0] + py[q][1], s3 = pyy[q][0] + pyy[q][1];
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {  // the quad's 64 frames, in a fixed order
      s1 += __shfl_xor_sync(0xffffffffu, s1, m);
      s2 += __shfl_xor_sync(0xffffffffu, s2, m);
      s3 += __shfl_xor_sync(0xffffffffu, s3, m);
    }
    if (mt[q] > -INFINITY) {
      const float r = __expf(st[4 * q] - mt[q]);  // 0 while the state is empty
      st[4 * q] = mt[q];
      st[4 * q + 1] = fmaf(st[4 * q + 1], r, s1);
      st[4 * q + 2] = fmaf(st[4 * q + 2], r, s2);
      st[4 * q + 3] = fmaf(st[4 * q + 3], r, s3);
    }
  }
}

// mbarriers and TMA (cp.async.bulk.tensor): one thread requests a stage's
// tiles, the hardware writes them (128-byte swizzled by the tensor map) and
// counts their bytes on the slot's barrier, which the consumers wait on
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(tc::smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(tc::smem_addr(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(tc::smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// L2 policies of the loads: evict-last (read again soon), evict-first
__device__ __forceinline__ uint64_t l2_policy(bool keep) {
  uint64_t pol;
  if (keep)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(pol));
  else
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int x, int y, uint64_t* bar,
                                       uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(tc::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(tc::smem_addr(bar)), "l"(pol)
      : "memory");
}
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, int x, int y, int z, uint64_t* bar,
                                       uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(tc::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(tc::smem_addr(bar)), "l"(pol)
      : "memory");
}

__device__ __forceinline__ void pair_sync(int pair) {  // the 256 threads of warpgroup pair `pair`
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + pair) : "memory");
}

// Writes the pooled output `out` [B, 2C] and/or the backward's `stats`
// [4][B][C] (softmax max, sum, mean, E[y^2]); u32 / ub ([B*T, 128]) when
// not null.
template <bool kFold>
__global__ void __launch_bounds__(kOpThreads, 1) pool_onepass_kernel(
    const bf16* __restrict__ h, const float* __restrict__ a, const float* __restrict__ c,
    const bf16* __restrict__ wa, const float* __restrict__ ba, const bf16* __restrict__ wb,
    const float* __restrict__ bb, float* __restrict__ part, bf16* __restrict__ out,
    float* __restrict__ stats, float* __restrict__ u32, bf16* __restrict__ ub, int n_t, int C,
    float eps, const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_wa,
    const __grid_constant__ CUtensorMap tm_wb) {
  extern __shared__ __align__(1024) unsigned char op_smem[];  // wgmma tiles: 1 KB aligned
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pair = warp >> 3, f = (warp >> 2) & 1, wq = warp & 3;  // pair, frame half, warp of the warpgroup
  const int ptid = tid & 255;  // thread of the pair
  const int s = blockIdx.x, S = gridDim.x, b = blockIdx.y, B = gridDim.y;
  const int tiles = (n_t + kOpRows - 1) / kOpRows;
  const int my_tiles = s < tiles ? (tiles - s + S - 1) / S : 0;
  const int NC = C / kOpChunk, NH = NC / 2;  // a pair's stages a step: channel chunks pair, pair + 2, ...
  const int total = my_tiles * NC;           // this pair's stages (NH of step U, then NH of step E, a tile)
  const long long n = (long long)B * C;
  float* state = part + (long long)(2 * s + f) * 4 * n + (long long)b * C;  // + q * n + ch
  bf16* u_all = reinterpret_cast<bf16*>(op_smem + 2 * kOpSlots * kOpStageBytes);
  bf16* us = u_all + f * kOpUElems;  // this frame half's u tile
  uint64_t* full = reinterpret_cast<uint64_t*>(u_all + 2 * kOpUElems);  // a barrier a slot

  if (my_tiles == 0) {  // a split past the last tile: empty states
    for (int i = tid; i < 2 * C; i += kOpThreads) {
      float* st = part + (long long)(2 * s + i / C) * 4 * n + (long long)b * C + i % C;
      st[0] = -INFINITY;
      st[n] = st[2 * n] = st[3 * n] = 0.f;
    }
    return;
  }

  // this pair's stage j: step U's chunk 2 r + pair (r < NH) or step E's
  // chunk 2 (r - NH) + pair of tile j / NC, r = j % NC, in slot pair + 2 (j
  // % 3). Thread 0 of the pair requests the stages in order (running
  // counters): the weight slab and the tile's 128 frames x 64 channels of h,
  // rows past the utterance zero (the tensor map's bounds)
  int ld_j = 0, ld_r = 0, ld_slot = 0, ld_t0 = s * kOpRows;
  auto load_stage = [&]() {
    if (ptid == 0 && ld_j < total) {
      const int ch0 = (2 * (ld_r < NH ? ld_r : ld_r - NH) + pair) * kOpChunk;
      const int sl = pair + 2 * ld_slot;
      bf16* w = reinterpret_cast<bf16*>(op_smem + sl * kOpStageBytes);
      mbar_expect_tx(full + sl, kOpStageBytes);
      // the weights (every block reads them) and step U's h (step E reads
      // it again) are kept in L2; step E's h is read for the last time
      const uint64_t keep = l2_policy(true);
      if (ld_r < NH) {  // Wa rows ch0.. as B [k = 64 channels][n = 128], MN-major: two 64-column boxes
        tma_2d(w, &tm_wa, 0, ch0, full + sl, keep);
        tma_2d(w + 4096, &tm_wa, 64, ch0, full + sl, keep);
      } else {  // Wb columns ch0.. as A^T [k = 128][m = 64 channels], MN-major
        tma_2d(w, &tm_wb, ch0, 0, full + sl, keep);
      }
      tma_3d(w + kOpWBytes / 2, &tm_h, ch0, ld_t0, b, full + sl, ld_r < NH ? keep : l2_policy(false));
    }
    if (ld_j < total) {
      ++ld_j;
      ld_slot = ld_slot == kOpSlots - 1 ? 0 : ld_slot + 1;
      if (++ld_r == NC) {
        ld_r = 0;
        ld_t0 += S * kOpRows;
      }
    }
  };
  // stage j + 2 requested into the slot of stage j - 1, which the pair has
  // finished; then stage j waited for
  int slot_j = 0, phases = 0;  // slot of stage j (j % 3); the parity of each slot's next use
  auto begin_stage = [&]() {
    pair_sync(pair);
    load_stage();
    mbar_wait(full + pair + 2 * slot_j, (phases >> slot_j) & 1);
  };
  auto end_stage = [&]() {
    phases ^= 1 << slot_j;
    slot_j = slot_j == kOpSlots - 1 ? 0 : slot_j + 1;
  };
  auto slot = [&]() { return reinterpret_cast<const bf16*>(op_smem + (pair + 2 * slot_j) * kOpStageBytes); };

  if (tid == 0) {
    for (int i = 0; i < 2 * kOpSlots; ++i) mbar_init(full + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load_stage();
  load_stage();

  const int qc = 2 * (lane & 3);  // this thread's first accumulator column of an 8-column tile
  for (int i = 0; i < my_tiles; ++i) {
    const int t0 = (s + i * S) * kOpRows;
    const int fvalid = n_t - t0 - 64 * f;  // frames of this warpgroup's 64 that exist

    // ---- U: this pair's half of K of u = y @ Wa, 64 frames x 128 a warpgroup
    float acc_u[64];
    // the products start their sums with scale-d = 0; this definition ends
    // the previous tile's accumulator here (an asm operand "+f" would keep
    // it live across step E)
#pragma unroll
    for (int x = 0; x < 64; ++x) acc_u[x] = 0.f;
    for (int r = 0; r < NH; ++r, end_stage()) {
      begin_stage();
      const bf16* w = slot();
      const bf16* hs = w + kOpWBytes / 2;
      if (fvalid <= 0) continue;  // a warpgroup with no frame in the tile (T's last tile)
      const int row = 64 * f + 16 * wq + (lane & 15);
      const int ch0 = (2 * r + pair) * kOpChunk;
      uint32_t af[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int chunk = 2 * k + (lane >> 4);
        tc::ldmatrix_x4(af[k], hs + row * 64 + ((chunk ^ (row & 7)) << 3));
        if (kFold) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int ch = ch0 + 16 * k + (q >> 1) * 8 + qc;
            const float2 av = __ldg(reinterpret_cast<const float2*>(a + ch));
            const float2 cv = __ldg(reinterpret_cast<const float2*>(c + ch));
            const float2 v = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&af[k][q]));
            __nv_bfloat162 y = __floats2bfloat162_rn(fold_relu(v.x, av.x, cv.x), fold_relu(v.y, av.y, cv.y));
            af[k][q] = *reinterpret_cast<uint32_t*>(&y);
          }
        }
      }
      tc::fence_operand(acc_u);
      tc::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        tc::wgmma_m64n128k16_rs(acc_u, af[k], tc::wgmma_desc_b(w + k * 1024, 8), r > 0 || k > 0);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_operand(acc_u);
    }
    // u = tanh(pair 0's sum + pair 1's sum + ba): pair 1 hands its sums over
    // through the u tiles' memory, 64 columns at a time
    float* xs = reinterpret_cast<float*>(u_all) + f * 64 * 64;  // [64 rows][64 columns] f32, this frame half
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      __syncthreads();  // both pairs are past step U (and the previous tile's step E), or pair 0 has read
      if (pair == 1) {
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = 16 * wq + (lane >> 2) + 8 * hr, col = 8 * jn + qc;
            *reinterpret_cast<float2*>(xs + r * 64 + (col ^ ((r & 7) << 3))) =
                make_float2(acc_u[32 * half + 4 * jn + 2 * hr], acc_u[32 * half + 4 * jn + 2 * hr + 1]);
          }
      }
      __syncthreads();
      if (pair == 0) {
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = 16 * wq + (lane >> 2) + 8 * hr, col = 8 * jn + qc;
            const float2 o = *reinterpret_cast<const float2*>(xs + r * 64 + (col ^ ((r & 7) << 3)));
            acc_u[32 * half + 4 * jn + 2 * hr] += o.x;
            acc_u[32 * half + 4 * jn + 2 * hr + 1] += o.y;
          }
      }
    }
    __syncthreads();  // pair 0 has read the last sums
    if (pair == 0) {
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        const int col = 8 * jn + qc;
        const float2 bav = __ldg(reinterpret_cast<const float2*>(ba + col));
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = 16 * wq + (lane >> 2) + 8 * hr;
          const float u0 = tanhf(acc_u[4 * jn + 2 * hr] + bav.x);
          const float u1 = tanhf(acc_u[4 * jn + 2 * hr + 1] + bav.y);
          const __nv_bfloat162 u2 = __floats2bfloat162_rn(u0, u1);
          *reinterpret_cast<__nv_bfloat162*>(us + (col >> 6) * 4096 + sw64(r, col & 63)) = u2;
          if (u32 && r < fvalid) {
            const long long o = ((long long)b * n_t + t0 + 64 * f + r) * 128 + col;
            *reinterpret_cast<float2*>(u32 + o) = make_float2(u0, u1);
            *reinterpret_cast<__nv_bfloat162*>(ub + o) = u2;
          }
        }
      }
    }
    tc::fence_proxy_async();  // the u tiles (over pair 1's sums), for step E's products
    __syncthreads();

    // ---- E: e^T = Wb[:, chunk]^T @ u^T per 64 channels (this pair's
    // chunks) and the online softmax. st: this thread's two channels'
    // running states (max, sum p, sum p*yf, sum p*yf^2), then their bb, a, c
    for (int r = 0; r < NH; ++r, end_stage()) {
      const int kk = 2 * r + pair;
      begin_stage();
      const bf16* w = slot();
      if (fvalid > 0) {  // a warpgroup with no frame in the tile (T's last tile) has nothing to add
        float acc[32];
#pragma unroll
        for (int x = 0; x < 32; ++x) acc[x] = 0.f;
        tc::fence_operand(acc);
        tc::wgmma_fence();
#pragma unroll
        for (int k = 0; k < 8; ++k)
          tc::wgmma_m64n64k16_tn(acc, tc::wgmma_desc(w + k * 1024, 16384, 1024),
                                 tc::wgmma_desc_a(us + (k >> 2) * 4096 + (k & 3) * 16), k > 0);
        tc::wgmma_commit();
        float st[14];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int ch = kk * kOpChunk + 16 * wq + (lane >> 2) + 8 * q;
#pragma unroll
          for (int v = 0; v < 4; ++v) st[4 * q + v] = i == 0 ? (v ? 0.f : -INFINITY) : state[v * n + ch];
          st[8 + q] = __ldg(bb + ch);
          st[10 + q] = kFold ? __ldg(a + ch) : 1.f;
          st[12 + q] = kFold ? __ldg(c + ch) : 0.f;
        }
        tc::wgmma_wait<0>();
        tc::fence_operand(acc);
        const bf16* hs = w + kOpWBytes / 2;
        if (fvalid >= 64)
          onepass_softmax<kFold, false>(acc, st, hs, f, wq, lane, fvalid);
        else
          onepass_softmax<kFold, true>(acc, st, hs, f, wq, lane, fvalid);
        if ((lane & 3) == 0) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int ch = kk * kOpChunk + 16 * wq + (lane >> 2) + 8 * q;
#pragma unroll
            for (int v = 0; v < 4; ++v) state[v * n + ch] = st[4 * q + v];
          }
        }
      } else if (i == 0 && (lane & 3) == 0) {  // its states stay empty
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int ch = kk * kOpChunk + 16 * wq + (lane >> 2) + 8 * q;
          state[ch] = -INFINITY;
          state[n + ch] = state[2 * n + ch] = state[3 * n + ch] = 0.f;
        }
      }
    }
  }
  if (S == 1) {  // this block holds both states of every channel of utterance b
    __syncthreads();
    for (int ch = tid; ch < C; ch += kOpThreads)
      merge_slots(part, 2, n, (long long)b * C + ch, C, b, ch, out, stats, eps);
  }
}

// the 2S states of each (b, c) -> out and/or stats, slots in order
__global__ void __launch_bounds__(256) pool_merge_kernel(const float* __restrict__ part, int nslots,
                                                         int B, int C, bf16* __restrict__ out,
                                                         float* __restrict__ stats, float eps) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)B * C) return;
  merge_slots(part, nslots, (long long)B * C, i, C, (int)(i / C), (int)(i % C), out, stats, eps);
}

// Per-column constants of the backward for 128 channels, written by threads
// 0..127 into cst[8][128]: bb, softmax max, 1 / softmax sum, dmt, dresid,
// sum_t alpha dalpha, a, c.
__device__ __forceinline__ void column_constants(float* cst, int tid, int b, int ch, int B, int C,
                                                 const float* stats, const bf16* g,
                                                 const float* bb, const float* a, const float* c,
                                                 float eps, int fold) {
  if (tid >= 128) return;
  const long long bc = (long long)b * C + ch, n = (long long)B * C;
  const float mean = stats[2 * n + bc], q = stats[3 * n + bc];
  const float resid = q - mean * mean;
  const float sd = sqrtf(fmaxf(resid, eps));
  const float dm = __bfloat162float(g[(long long)b * 2 * C + ch]);
  const float ds = __bfloat162float(g[(long long)b * 2 * C + C + ch]);
  const float dresid = resid > eps ? ds * 0.5f / sd : 0.f;
  const float dmt = dm - 2.f * mean * dresid;
  cst[0 * 128 + tid] = bb[ch];
  cst[1 * 128 + tid] = stats[bc];
  cst[2 * 128 + tid] = 1.f / stats[n + bc];
  cst[3 * 128 + tid] = dmt;
  cst[4 * 128 + tid] = dresid;
  cst[5 * 128 + tid] = dmt * mean + dresid * q;
  cst[6 * 128 + tid] = fold ? a[ch] : 1.f;
  cst[7 * 128 + tid] = fold ? c[ch] : 0.f;
}

// a warp's column sums (this thread's 8 columns over its rows) -> the
// partial row `part` of a [.., C] array; lanes that share lane % 4 are added
// in a fixed order
__device__ __forceinline__ void store_column_sums(float (&sum)[4][2], float* part, int col0,
                                                  int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float v = sum[j][q];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) part[col0 + j * 8 + lane * 2 + q] = v;
    }
}

// Pass 3: per (64 frames of an utterance), over the channels in tiles of
// 128: e = ub @ Wb recomputed -> alpha -> de (rounded to bf16: to device
// memory for dWb, and to shared memory as the operand of du); du += de @
// Wb^T accumulates in registers over all the channel tiles; then dz = du
// (1 - u^2), rounded to bf16, and the column sums for dbb and dba.
__global__ void __launch_bounds__(kEThreads) tc_de_kernel(
    const bf16* __restrict__ h, const float* __restrict__ a, const float* __restrict__ c,
    const float* __restrict__ u32, const bf16* __restrict__ ub, const bf16* __restrict__ wb,
    const float* __restrict__ bb, const float* __restrict__ stats, const bf16* __restrict__ g,
    bf16* __restrict__ de_out, bf16* __restrict__ dz_out, float* __restrict__ dbb_part,
    float* __restrict__ dba_part, int n_t, int C, float eps, int fold) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* us = reinterpret_cast<bf16*>(smem_raw);  // [64][kTcLd] ub tile
  bf16* des = us + kTcTile64;                    // [64][kTcLd] de tile
  bf16* stage = des + kTcTile64;                 // [2]{Wb [128][kTcLd], h [64][kTcLd]}
  float* cst = reinterpret_cast<float*>(stage + 2 * (kTcTile128 + kTcTile64));  // [2][8][128]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int b = blockIdx.y, B = gridDim.y, t0 = blockIdx.x * kTcRows;
  const int valid = min(kTcRows, n_t - t0);
  const long long row0 = (long long)b * n_t + t0;
  const int blk = (b * gridDim.x + blockIdx.x) * kEWM + wm;  // row of the partial-sum arrays
  auto prefetch = [&](int buf, int ct) {
    bf16* s = stage + buf * (kTcTile128 + kTcTile64);
    tile_async<kEThreads>(s, wb + ct * 128, C, 128, 128, tid);
    tile_async<kEThreads>(s + kTcTile128, h + row0 * C + ct * 128, C, kTcRows, valid, tid);
    tc::cp_async_commit();
    column_constants(cst + buf * 1024, tid, b, ct * 128 + tid, B, C, stats, g, bb, a, c, eps, fold);
  };
  tile_async<kEThreads>(us, ub + row0 * 128, 128, kTcRows, valid, tid);
  prefetch(0, 0);
  float du[kEMT][4][4];
  tc::zero_acc(du);
  const int tiles = C / 128;
  for (int ct = 0; ct < tiles; ++ct) {
    const int buf = ct & 1;
    tc::cp_async_wait<0>();
    __syncthreads();  // tile ct is staged; tile ct-1 (its de tile too) is consumed
    if (ct + 1 < tiles) prefetch(buf ^ 1, ct + 1);
    const bf16* wbs = stage + buf * (kTcTile128 + kTcTile64);
    const bf16* hs = wbs + kTcTile128;
    const float* k = cst + buf * 1024;
    float acc[kEMT][4][4];
    tc::zero_acc(acc);
    tc::warp_mma<kEMT, 4, 128, false, true>(acc, us + wm * kEWR * kTcLd, kTcLd, wbs + wn * 32, kTcLd,
                                         lane);
    float sum[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = wn * 32 + j * 8 + tc::frag_col(lane);
      sum[j][0] = sum[j][1] = 0.f;
#pragma unroll
      for (int i = 0; i < kEMT; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm * kEWR + i * 16 + half * 8 + tc::frag_row(lane);
          const float2 hv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hs + r * kTcLd + col));
          float de[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int cq = col + q;
            const float hq = q ? hv.y : hv.x;
            const float y = fold ? fold_relu(hq, k[6 * 128 + cq], k[7 * 128 + cq]) : hq;
            const float alpha = expf(acc[i][j][half * 2 + q] + k[cq] - k[128 + cq]) * k[256 + cq];
            const float dalpha = y * k[3 * 128 + cq] + (y * y) * k[4 * 128 + cq];
            de[q] = r < valid ? alpha * (dalpha - k[5 * 128 + cq]) : 0.f;
            sum[j][q] += de[q];
          }
          *reinterpret_cast<__nv_bfloat162*>(des + r * kTcLd + col) =
              __floats2bfloat162_rn(de[0], de[1]);
        }
    }
    store_column_sums(sum, dbb_part + (long long)blk * C, ct * 128 + wn * 32, lane);
    __syncthreads();  // the de tile is complete
    // du += de @ Wb[:, tile]^T: B[k = channel][n = hidden] is the Wb tile read as [n][k]
    tc::warp_mma<kEMT, 4, 128, false, false>(du, des + wm * kEWR * kTcLd, kTcLd,
                                          wbs + wn * 32 * kTcLd, kTcLd, lane);
    for (int i = tid; i < valid * 16; i += kEThreads) {
      const int r = i >> 4, v = i & 15;
      *reinterpret_cast<uint4*>(de_out + (row0 + r) * C + ct * 128 + v * 8) =
          *reinterpret_cast<const uint4*>(des + r * kTcLd + v * 8);
    }
  }
  float sum[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = wn * 32 + j * 8 + tc::frag_col(lane);
    sum[j][0] = sum[j][1] = 0.f;
#pragma unroll
    for (int i = 0; i < kEMT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * kEWR + i * 16 + half * 8 + tc::frag_row(lane);
        if (r < valid) {
          const float2 uu = *reinterpret_cast<const float2*>(u32 + (row0 + r) * 128 + col);
          const float z0 = du[i][j][half * 2] * (1.f - uu.x * uu.x);
          const float z1 = du[i][j][half * 2 + 1] * (1.f - uu.y * uu.y);
          sum[j][0] += z0;
          sum[j][1] += z1;
          *reinterpret_cast<__nv_bfloat162*>(dz_out + (row0 + r) * 128 + col) =
              __floats2bfloat162_rn(z0, z1);
        }
      }
  }
  store_column_sums(sum, dba_part + (long long)blk * 128, wn * 32, lane);
}
constexpr size_t kTcDeSmem =
    (size_t)(2 * kTcTile64 + 2 * (kTcTile128 + kTcTile64)) * sizeof(bf16) + 2 * 1024 * sizeof(float);

// Pass 4: per (64 frames of an utterance), over the channels in tiles of
// 128: e = ub @ Wb recomputed -> alpha; dy = alpha (dmt + 2 y dresid) +
// dz @ Wa^T; the fold backward; dh, and the column sums for da and dc. The
// f32 first term of dy never leaves the registers.
__global__ void __launch_bounds__(kEThreads) tc_dh_kernel(
    const bf16* __restrict__ h, const float* __restrict__ a, const float* __restrict__ c,
    const bf16* __restrict__ ub, const bf16* __restrict__ dz, const bf16* __restrict__ wa,
    const bf16* __restrict__ wb, const float* __restrict__ bb, const float* __restrict__ stats,
    const bf16* __restrict__ g, bf16* __restrict__ dh, float* __restrict__ da_part,
    float* __restrict__ dc_part, int n_t, int C, float eps, int fold) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kStage = 2 * kTcTile128 + kTcTile64;
  bf16* us = reinterpret_cast<bf16*>(smem_raw);  // [64][kTcLd] ub tile
  bf16* dzs = us + kTcTile64;                    // [64][kTcLd] dz tile
  bf16* stage = dzs + kTcTile64;  // [2]{Wb [128][kTcLd], Wa [128][kTcLd], h [64][kTcLd]}
  float* cst = reinterpret_cast<float*>(stage + 2 * kStage);  // [2][8][128]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int b = blockIdx.y, B = gridDim.y, t0 = blockIdx.x * kTcRows;
  const int valid = min(kTcRows, n_t - t0);
  const long long row0 = (long long)b * n_t + t0;
  const int blk = (b * gridDim.x + blockIdx.x) * kEWM + wm;
  auto prefetch = [&](int buf, int ct) {
    bf16* s = stage + buf * kStage;
    tile_async<kEThreads>(s, wb + ct * 128, C, 128, 128, tid);
    tile_async<kEThreads>(s + kTcTile128, wa + (long long)ct * 128 * 128, 128, 128, 128, tid);
    tile_async<kEThreads>(s + 2 * kTcTile128, h + row0 * C + ct * 128, C, kTcRows, valid, tid);
    tc::cp_async_commit();
    column_constants(cst + buf * 1024, tid, b, ct * 128 + tid, B, C, stats, g, bb, a, c, eps, fold);
  };
  tile_async<kEThreads>(us, ub + row0 * 128, 128, kTcRows, valid, tid);
  tile_async<kEThreads>(dzs, dz + row0 * 128, 128, kTcRows, valid, tid);
  prefetch(0, 0);
  const int tiles = C / 128;
  for (int ct = 0; ct < tiles; ++ct) {
    const int buf = ct & 1;
    tc::cp_async_wait<0>();
    __syncthreads();  // tile ct is staged; tile ct-1 is consumed and stored
    if (ct + 1 < tiles) prefetch(buf ^ 1, ct + 1);
    bf16* wbs = stage + buf * kStage;
    const bf16* was = wbs + kTcTile128;
    bf16* hs = wbs + 2 * kTcTile128;
    const float* k = cst + buf * 1024;
    float acc[kEMT][4][4], dya[kEMT][4][4];
    tc::zero_acc(acc);
    tc::zero_acc(dya);
    tc::warp_mma<kEMT, 4, 128, false, true>(acc, us + wm * kEWR * kTcLd, kTcLd, wbs + wn * 32, kTcLd,
                                         lane);
    // dz @ Wa[tile]^T: B[k = hidden][n = channel] is the Wa tile read as [n][k]
    tc::warp_mma<kEMT, 4, 128, false, false>(dya, dzs + wm * kEWR * kTcLd, kTcLd,
                                          was + wn * 32 * kTcLd, kTcLd, lane);
    float sa[4][2], sc[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = wn * 32 + j * 8 + tc::frag_col(lane);
      sa[j][0] = sa[j][1] = sc[j][0] = sc[j][1] = 0.f;
#pragma unroll
      for (int i = 0; i < kEMT; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm * kEWR + i * 16 + half * 8 + tc::frag_row(lane);
          __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(hs + r * kTcLd + col);
          const float2 hv = __bfloat1622float2(*hp);
          float o[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int cq = col + q;
            const float hq = q ? hv.y : hv.x;
            const float y = fold ? fold_relu(hq, k[6 * 128 + cq], k[7 * 128 + cq]) : hq;
            const float alpha = expf(acc[i][j][half * 2 + q] + k[cq] - k[128 + cq]) * k[256 + cq];
            const float dy = alpha * (k[3 * 128 + cq] + 2.f * y * k[4 * 128 + cq]) +
                             dya[i][j][half * 2 + q];
            if (fold) {
              const float dpre = (y > 0.f && r < valid) ? dy : 0.f;
              sa[j][q] += dpre * hq;
              sc[j][q] += dpre;
              o[q] = dpre * k[6 * 128 + cq];
            } else {
              o[q] = dy;
            }
          }
          *hp = __floats2bfloat162_rn(o[0], o[1]);  // dh over the h it came from
        }
    }
    if (fold) {
      store_column_sums(sa, da_part + (long long)blk * C, ct * 128 + wn * 32, lane);
      store_column_sums(sc, dc_part + (long long)blk * C, ct * 128 + wn * 32, lane);
    }
    __syncthreads();  // the dh tile is complete
    for (int i = tid; i < valid * 16; i += kEThreads) {
      const int r = i >> 4, v = i & 15;
      *reinterpret_cast<uint4*>(dh + (row0 + r) * C + ct * 128 + v * 8) =
          *reinterpret_cast<const uint4*>(hs + r * kTcLd + v * 8);
    }
  }
}
constexpr size_t kTcDhSmem =
    (size_t)(2 * kTcTile64 + 2 * (2 * kTcTile128 + kTcTile64)) * sizeof(bf16) +
    2 * 1024 * sizeof(float);

// Weight gradients: part[split][m][n] = sum over this split's rows k of
// A[k][m] B[k][n], a 128 x 128 tile a block, rows in steps of kKR. A is ub
// (kFromH = false; cp.async) or y recomputed from h (kFromH = true; through
// registers, with the fold); B is de or dz. Both are stored [k][.], so both
// fragments come through ldmatrix.trans.
template <bool kFromH>
__global__ void __launch_bounds__(kTcThreads) tc_atb_kernel(
    const bf16* __restrict__ A, int lda, const bf16* __restrict__ Bm, int ldb,
    const float* __restrict__ a, const float* __restrict__ c, int fold, float* __restrict__ part,
    int out_rows, int out_cols, int a_tiled, int rows, int k_split) {
  // a_tiled: blockIdx.x walks A's columns (dWa: out rows); else B's (dWb: out columns)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [2][kKR][kTcLd]
  bf16* Bs = As + 2 * kKR * kTcLd;               // [2][kKR][kTcLd]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int a0 = a_tiled ? blockIdx.x * 128 : 0, b0 = a_tiled ? 0 : blockIdx.x * 128;
  const int kb = blockIdx.y * k_split, ke = min(rows, kb + k_split);
  uint4 hreg[512 / kTcThreads];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int n = 0; n < 512 / kTcThreads; ++n) {
      const int i = tid + n * kTcThreads, r = i >> 4, v = i & 15;
      hreg[n] = k0 + r < ke
                    ? *reinterpret_cast<const uint4*>(A + (long long)(k0 + r) * lda + a0 + v * 8)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int n = 0; n < 512 / kTcThreads; ++n) {
      const int i = tid + n * kTcThreads, r = i >> 4, v = i & 15;
      *reinterpret_cast<uint4*>(As + (buf * kKR + r) * kTcLd + v * 8) =
          fold_chunk(hreg[n], a + a0 + v * 8, c + a0 + v * 8, fold);
    }
  };
  auto prefetch = [&](int buf, int k0) {
    const int valid = min(kKR, ke - k0);
    if (!kFromH) tile_async(As + buf * kKR * kTcLd, A + (long long)k0 * lda + a0, lda, kKR, valid, tid);
    tile_async(Bs + buf * kKR * kTcLd, Bm + (long long)k0 * ldb + b0, ldb, kKR, valid, tid);
    tc::cp_async_commit();
  };
  constexpr int kMT2 = 2 * kMT;  // m tiles of a warp over the 128-row tile
  float acc[kMT2][4][4];
  tc::zero_acc(acc);
  if (kFromH) fetch(kb);
  prefetch(0, kb);
  if (kFromH) stash(0);
  const int steps = (ke - kb + kKR - 1) / kKR;
  for (int st = 0; st < steps; ++st) {
    const int buf = st & 1, k0 = kb + st * kKR;
    tc::cp_async_wait<0>();
    __syncthreads();
    if (st + 1 < steps) {
      prefetch(buf ^ 1, k0 + kKR);
      if (kFromH) fetch(k0 + kKR);
    }
    tc::warp_mma<kMT2, 4, kKR, true, true>(acc, As + buf * kKR * kTcLd + wm * 2 * kWR, kTcLd,
                                        Bs + buf * kKR * kTcLd + wn * 32, kTcLd, lane);
    if (kFromH && st + 1 < steps) stash(buf ^ 1);
  }
  float* p = part + (long long)blockIdx.y * out_rows * out_cols;
#pragma unroll
  for (int i = 0; i < kMT2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = a0 + wm * 2 * kWR + i * 16 + half * 8 + tc::frag_row(lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = b0 + wn * 32 + j * 8 + tc::frag_col(lane);
        *reinterpret_cast<float2*>(p + (long long)m * out_cols + n) =
            make_float2(acc[i][j][half * 2], acc[i][j][half * 2 + 1]);
      }
    }
}
constexpr size_t kTcAtbSmem = (size_t)(4 * kKR * kTcLd) * sizeof(bf16);

struct BwdWorkspace {  // byte offsets of the backward's scratch buffers
  // ops/kernels/pool.py::bwd_workspace_bytes mirrors this
  size_t u, ub, stats, de, dy0, dz, dba, dbb, da, dc, dwb, dwa, part, total;
  BwdWorkspace(int B, int n_t, int C, int H, int elem) {
    const size_t rows = (size_t)B * n_t;
    size_t off = 0;
    auto take = [&off](size_t bytes) {
      const size_t at = off;
      off += (bytes + 255) / 256 * 256;
      return at;
    };
    u = take(rows * H * 4);
    stats = take((size_t)4 * B * C * 4);
    de = take(rows * C * elem);
    if (use_tc(H, elem)) {
      // bf16 u and dz beside the f32 u; no f32 [B*T, C] array; partial sums
      // by (utterance, 64-frame tile, warp row)
      const size_t pb = (size_t)B * ((n_t + kTcRows - 1) / kTcRows) * kEWM;
      ub = take(rows * H * 2);
      dy0 = 0;
      dz = take(rows * H * 2);
      dba = take(pb * H * 4);
      dbb = take(pb * C * 4);
      da = take(pb * C * 4);
      dc = take(pb * C * 4);
    } else {
      const size_t rb = (rows + kBM - 1) / kBM;
      ub = 0;
      dy0 = take(rows * C * 4);
      dz = take(rows * H * 4);
      dba = take(rb * H * 4);
      dbb = take((size_t)B * C * 4);
      da = take(rb * C * 4);
      dc = take(rb * C * 4);
    }
    dwb = take((size_t)kSplits * H * C * 4);
    dwa = take((size_t)kSplits * C * H * 4);
    // the running softmax states of the first stage (pool_onepass_kernel)
    part = use_tc(H, elem) ? take(onepass_part_bytes(B, C)) : 0;
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

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the bf16 forward at H == 128: pool_onepass_kernel, and pool_merge_kernel
// when T is split over several blocks; out or stats may be null (the
// backward's first stage gives stats, u32 and ub; the forward out only)
// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links no libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a bf16 tensor map of `rank` dims (innermost first), 128-byte swizzled
// boxes, zeros outside the bounds
bool bf16_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  const EncodeTiled enc = encode_tiled();
  const cuuint32_t ones[3] = {1, 1, 1};
  return enc && enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides, box, ones,
                    CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_onepass(const bf16* h, const float* a, const float* c, const bf16* wa, const float* ba,
                   const bf16* wb, const float* bb, float* part, bf16* out, float* stats, float* u32,
                   bf16* ub, int B, int n_t, int C, float eps, int fold, cudaStream_t st) {
  if (B < 1 || B > 65535 || n_t < 1 || C % 128) return (int)cudaErrorInvalidValue;
  // h [B][T][C]: boxes of 64 channels x 128 frames of one utterance; Wa
  // [C][128]: 64 x 64; Wb [128][C]: 64 channels x 128
  CUtensorMap tm_h, tm_wa, tm_wb;
  const cuuint64_t h_dims[3] = {(cuuint64_t)C, (cuuint64_t)n_t, (cuuint64_t)B};
  const cuuint64_t h_strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)n_t * C * 2};
  const cuuint32_t h_box[3] = {kOpChunk, kOpRows, 1};
  const cuuint64_t wa_dims[2] = {128, (cuuint64_t)C}, wa_strides[1] = {256};
  const cuuint32_t wa_box[2] = {64, 64};
  const cuuint64_t wb_dims[2] = {(cuuint64_t)C, 128}, wb_strides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t wb_box[2] = {kOpChunk, 128};
  if (!bf16_map(&tm_h, h, 3, h_dims, h_strides, h_box) || !bf16_map(&tm_wa, wa, 2, wa_dims, wa_strides, wa_box) ||
      !bf16_map(&tm_wb, wb, 2, wb_dims, wb_strides, wb_box))
    return (int)cudaErrorNotSupported;
  cudaError_t err;
  const auto kernel = fold ? pool_onepass_kernel<true> : pool_onepass_kernel<false>;
  if ((err = allow_smem(kernel, kOpSmem)) != cudaSuccess) return (int)err;
  const int S = onepass_splits(B);
  kernel<<<dim3(S, B), kOpThreads, kOpSmem, st>>>(h, a, c, wa, ba, wb, bb, part, out, stats, u32, ub, n_t,
                                                  C, eps, tm_h, tm_wa, tm_wb);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (S == 1) return 0;
  const long long bc = (long long)B * C;
  pool_merge_kernel<<<(unsigned)((bc + 255) / 256), 256, 0, st>>>(part, 2 * S, B, C, out, stats, eps);
  return (int)cudaGetLastError();
}

int launch_tc_fwd(const void* h, const void* a, const void* c, const void* wa, const void* ba,
                  const void* wb, const void* bb, void* scratch, void* out, int B, int n_t, int C,
                  float eps, int fold, cudaStream_t st) {
  // the wrapper's scratch (fwd_scratch_bytes) holds the running states
  return launch_onepass((const bf16*)h, (const float*)a, (const float*)c, (const bf16*)wa,
                        (const float*)ba, (const bf16*)wb, (const float*)bb, (float*)scratch,
                        (bf16*)out, nullptr, nullptr, nullptr, B, n_t, C, eps, fold, st);
}

size_t fwd_scratch_bytes(int B, int n_t, int C, int H, int elem) {
  return use_tc(H, elem) ? onepass_part_bytes(B, C) : (size_t)B * n_t * H * sizeof(float);
}

// The bf16 backward at H == 128: six launches of tensor-core kernels, then
// the fixed-order reductions of the partial sums.
int launch_bwd_tc(const void* h_, const void* a_, const void* c_, const void* wa_, const void* ba_,
                  const void* wb_, const void* bb_, const void* g_, void* dh, void* da, void* dc,
                  void* dwa, void* dba, void* dwb, void* dbb, void* work, int B, int n_t, int C,
                  float eps, int fold, void* stream) {
  constexpr int H = 128;
  if (B < 1 || B > 65535 || n_t < 1 || C % 128) return (int)cudaErrorInvalidValue;
  const bf16* h = (const bf16*)h_;
  const float* a = (const float*)a_;
  const float* c = (const float*)c_;
  const bf16* wa = (const bf16*)wa_;
  const bf16* wb = (const bf16*)wb_;
  const float* bb = (const float*)bb_;
  const bf16* g = (const bf16*)g_;
  const BwdWorkspace ws(B, n_t, C, H, 2);
  char* base = (char*)work;
  float* u32 = (float*)(base + ws.u);
  bf16* ub = (bf16*)(base + ws.ub);
  float* stats = (float*)(base + ws.stats);
  bf16* de = (bf16*)(base + ws.de);
  bf16* dz = (bf16*)(base + ws.dz);
  float* dba_part = (float*)(base + ws.dba);
  float* dbb_part = (float*)(base + ws.dbb);
  float* da_part = (float*)(base + ws.da);
  float* dc_part = (float*)(base + ws.dc);
  float* dwb_part = (float*)(base + ws.dwb);
  float* dwa_part = (float*)(base + ws.dwa);
  float* part = (float*)(base + ws.part);
  const int rows = B * n_t;
  const int tiles = (n_t + kTcRows - 1) / kTcRows;
  const int pb = B * tiles * kEWM;
  const int k_split = ((rows + kSplits - 1) / kSplits + kKR - 1) / kKR * kKR;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  int code;
  if ((code = launch_onepass(h, a, c, wa, (const float*)ba_, wb, bb, part, nullptr, stats, u32, ub, B,
                             n_t, C, eps, fold, st)))
    return code;
  if ((err = allow_smem(tc_de_kernel, kTcDeSmem)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(tc_dh_kernel, kTcDhSmem)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(tc_atb_kernel<false>, kTcAtbSmem)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(tc_atb_kernel<true>, kTcAtbSmem)) != cudaSuccess) return (int)err;
  tc_de_kernel<<<dim3(tiles, B), kEThreads, kTcDeSmem, st>>>(
      h, a, c, u32, ub, wb, bb, stats, g, de, dz, dbb_part, dba_part, n_t, C, eps, fold);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tc_dh_kernel<<<dim3(tiles, B), kEThreads, kTcDhSmem, st>>>(
      h, a, c, ub, dz, wa, wb, bb, stats, g, (bf16*)dh, da_part, dc_part, n_t, C, eps, fold);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // dWb = ub^T @ de, split over rows
  tc_atb_kernel<false><<<dim3(C / 128, kSplits), kTcThreads, kTcAtbSmem, st>>>(
      ub, H, de, C, a, c, 0, dwb_part, H, C, 0, rows, k_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // dWa = y^T @ dz, split over rows
  tc_atb_kernel<true><<<dim3(C / 128, kSplits), kTcThreads, kTcAtbSmem, st>>>(
      h, C, dz, H, a, c, fold, dwa_part, C, H, 1, rows, k_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((code = sum_parts(dwb_part, (float*)dwb, kSplits, H * C, st))) return code;
  if ((code = sum_parts(dwa_part, (float*)dwa, kSplits, C * H, st))) return code;
  if ((code = sum_parts(dba_part, (float*)dba, pb, H, st))) return code;
  if ((code = sum_parts(dbb_part, (float*)dbb, pb, C, st))) return code;
  if (!fold) {
    if ((err = cudaMemsetAsync(da, 0, (size_t)C * 4, st)) != cudaSuccess) return (int)err;
    return (int)cudaMemsetAsync(dc, 0, (size_t)C * 4, st);
  }
  if ((code = sum_parts(da_part, (float*)da, pb, C, st))) return code;
  return sum_parts(dc_part, (float*)dc, pb, C, st);
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
  if (use_tc(H, 2))
    return launch_bwd_tc(h, a, c, wa, ba, wb, bb, g, dh, da, dc, dwa, dba, dwb, dbb, work, B, n_t,
                         C, eps, fold, stream);
  return launch_bwd<__nv_bfloat16>(h, a, c, wa, ba, wb, bb, g, dh, da, dc, dwa, dba, dwb, dbb,
                                   work, B, n_t, C, H, eps, fold, stream);
}

long long titanet_attn_pool_bwd_workspace_bytes(int B, int n_t, int C, int H, int elem_size) {
  return (long long)BwdWorkspace(B, n_t, C, H, elem_size).total;
}

long long titanet_attn_pool_smem_bytes(int H) { return (long long)stats_smem_bytes(H); }

long long titanet_attn_pool_fwd_scratch_bytes(int B, int n_t, int C, int H, int elem_size) {
  return (long long)fwd_scratch_bytes(B, n_t, C, H, elem_size);
}

const char* titanet_attn_pool_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
