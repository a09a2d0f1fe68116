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
// Two designs. bf16 at H == 128 (every TitaNet) runs tc_u_kernel and
// tc_stats_kernel (the tensor-core passes, below the FP32-core backward):
// the same two passes as here with both products on mma.sync tiles, u kept
// in bf16, and the softmax state merged over 16 row slots in a fixed order.
// f32, the parity surface, runs the FP32-core passes:
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
// (mma_bf16.cuh); the operand roundings of the TPU kernel (y, u, de, dz to
// bf16) happen as the tiles are staged; and no f32 [B*T, C] array exists:
//  1. tc_u_kernel: u in f32 (for 1 - u^2) and bf16 (the operand);
//  2. tc_stats_kernel: the softmax max, sum, mean and E[y^2] per (b, c);
//  3. tc_de_kernel, a block (16 warps: the softmax epilogue is what it
//     spends its time on) per 64 frames of an utterance, looping over the
//     channels in tiles of 128: e recomputed (K = 128) -> alpha -> de, bf16
//     to device memory (once written, read once by dWb); du = de @ Wb^T
//     accumulates in registers over the loop; then dz, bf16;
//  4. tc_dh_kernel, same blocks: e recomputed again -> alpha; the first
//     term of dy is formed in registers and added to dz @ Wa^T from the
//     accumulators; fold backward; dh;
//  5-6. tc_atb_kernel: dWb = u^T de and dWa = y^T dz, split over 32 row
//     ranges (y recomputed from h as its tile is staged);
//  7. sum_parts_kernel over every partial.
// The workspace holds u (f32, bf16), de and dz (bf16) and the partials:
// 259.8 MB at B=128, T=301, C=1536 against 574.9 MB for the design below.
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
constexpr int kKC = 64;                   // channels a step of tc_u_kernel
constexpr int kKCLd = kKC + tc::kPad;
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

// Pass 1: u = tanh(y @ Wa + ba) for 64 rows of [B*T]; K = C in steps of kKC.
// Writes u in f32 (for 1 - u^2; may be null) and rounded to bf16 (the
// operand of every later product).
__global__ void __launch_bounds__(kTcThreads) tc_u_kernel(
    const bf16* __restrict__ h, const float* __restrict__ a, const float* __restrict__ c,
    const bf16* __restrict__ wa, const float* __restrict__ ba, float* __restrict__ u32,
    bf16* __restrict__ ub, int rows, int C, int fold) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [2][64][kKCLd]
  bf16* Bs = As + 2 * kTcRows * kKCLd;           // [2][kKC][kTcLd]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int r0 = blockIdx.x * kTcRows;
  uint4 hreg[512 / kTcThreads];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int n = 0; n < 512 / kTcThreads; ++n) {
      const int i = tid + n * kTcThreads, r = i >> 3, v = i & 7;
      hreg[n] = r0 + r < rows
                    ? *reinterpret_cast<const uint4*>(h + (long long)(r0 + r) * C + c0 + v * 8)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto stash = [&](int buf, int c0) {
#pragma unroll
    for (int n = 0; n < 512 / kTcThreads; ++n) {
      const int i = tid + n * kTcThreads, r = i >> 3, v = i & 7;
      *reinterpret_cast<uint4*>(As + (buf * kTcRows + r) * kKCLd + v * 8) =
          fold_chunk(hreg[n], a + c0 + v * 8, c + c0 + v * 8, fold);
    }
  };
  auto fetch_b = [&](int buf, int c0) {
    tile_async(Bs + buf * kKC * kTcLd, wa + (long long)c0 * 128, 128, kKC, kKC, tid);
    tc::cp_async_commit();
  };
  float acc[kMT][4][4];
  tc::zero_acc(acc);
  fetch(0);
  fetch_b(0, 0);
  stash(0, 0);
  const int steps = C / kKC;
  for (int kc = 0; kc < steps; ++kc) {
    const int buf = kc & 1;
    tc::cp_async_wait<0>();
    __syncthreads();  // step kc is staged; step kc-1 is consumed
    if (kc + 1 < steps) {
      fetch_b(buf ^ 1, (kc + 1) * kKC);
      fetch((kc + 1) * kKC);
    }
    tc::warp_mma<kMT, 4, kKC, false, true>(acc, As + (buf * kTcRows + wm * kWR) * kKCLd, kKCLd,
                                         Bs + buf * kKC * kTcLd + wn * 32, kTcLd, lane);
    if (kc + 1 < steps) stash(buf ^ 1, (kc + 1) * kKC);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = wn * 32 + j * 8 + tc::frag_col(lane);
    const float2 bav = *reinterpret_cast<const float2*>(ba + col);
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + wm * kWR + i * 16 + half * 8 + tc::frag_row(lane);
        if (row < rows) {
          const float u0 = tanhf(acc[i][j][half * 2] + bav.x);
          const float u1 = tanhf(acc[i][j][half * 2 + 1] + bav.y);
          if (u32) *reinterpret_cast<float2*>(u32 + (long long)row * 128 + col) = make_float2(u0, u1);
          *reinterpret_cast<__nv_bfloat162*>(ub + (long long)row * 128 + col) =
              __floats2bfloat162_rn(u0, u1);
        }
      }
    }
  }
}
constexpr size_t kTcUSmem = (size_t)(2 * kTcRows * kKCLd + 2 * kKC * kTcLd) * sizeof(bf16);

// Pass 2: per (utterance, 128 channels), e = ub @ Wb + bb in chunks of 64
// frames, an online softmax over T and the weighted moments of y; the
// threads' states are merged in a fixed order. Writes the pooled output
// (forward) or the softmax max, sum, mean and E[y^2] (backward).
__global__ void __launch_bounds__(kTcThreads) tc_stats_kernel(
    const bf16* __restrict__ h, const float* __restrict__ a, const float* __restrict__ c,
    const bf16* __restrict__ ub, const bf16* __restrict__ wb, const float* __restrict__ bb,
    bf16* __restrict__ out, int n_t, int C, float eps, int fold, float* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* wbs = reinterpret_cast<bf16*>(smem_raw);  // [128 (H)][kTcLd]: Wb[:, c0 : c0 + 128]
  bf16* stage = wbs + kTcTile128;                 // [2]{ub [64][kTcLd], h [64][kTcLd]}
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int b = blockIdx.y, c0 = blockIdx.x * 128;
  const bf16* hb = h + (long long)b * n_t * C + c0;
  const bf16* ubb = ub + (long long)b * n_t * 128;
  auto prefetch = [&](int buf, int t0) {
    const int valid = min(kTcRows, n_t - t0);
    bf16* s = stage + buf * 2 * kTcTile64;
    tile_async(s, ubb + (long long)t0 * 128, 128, kTcRows, valid, tid);
    tile_async(s + kTcTile64, hb + (long long)t0 * C, C, kTcRows, valid, tid);
    tc::cp_async_commit();
  };
  tile_async(wbs, wb + c0, C, 128, 128, tid);
  prefetch(0, 0);
  // this thread's 8 columns: (j, q) -> c0 + wn*32 + j*8 + frag_col + q
  float bbv[4][2], av[4][2], cv[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int ch = c0 + wn * 32 + j * 8 + tc::frag_col(lane) + q;
      bbv[j][q] = bb[ch];
      av[j][q] = fold ? a[ch] : 1.f;
      cv[j][q] = fold ? c[ch] : 0.f;
    }
  float m[4][2], s[4][2], sy[4][2], syy[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) m[j][q] = -INFINITY, s[j][q] = sy[j][q] = syy[j][q] = 0.f;

  const int chunks = (n_t + kTcRows - 1) / kTcRows;
  for (int ck = 0; ck < chunks; ++ck) {
    const int buf = ck & 1, t0 = ck * kTcRows;
    const int valid = min(kTcRows, n_t - t0);
    tc::cp_async_wait<0>();
    __syncthreads();
    if (ck + 1 < chunks) prefetch(buf ^ 1, t0 + kTcRows);
    const bf16* us = stage + buf * 2 * kTcTile64;
    const bf16* hs = us + kTcTile64;
    float acc[kMT][4][4];
    tc::zero_acc(acc);
    tc::warp_mma<kMT, 4, 128, false, true>(acc, us + wm * kWR * kTcLd, kTcLd, wbs + wn * 32, kTcLd,
                                         lane);
    // per column: rescale the state to the chunk's max once, then one exp a frame
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = wn * 32 + j * 8 + tc::frag_col(lane);
      float et[2][kMT * 2], y[2][kMT * 2];
      float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm * kWR + i * 16 + half * 8 + tc::frag_row(lane);
          const float2 hv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hs + r * kTcLd + col));
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float hq = q ? hv.y : hv.x;
            y[q][i * 2 + half] = fold ? fold_relu(hq, av[j][q], cv[j][q]) : hq;
            et[q][i * 2 + half] = r < valid ? acc[i][j][half * 2 + q] + bbv[j][q] : -INFINITY;
            cm[q] = fmaxf(cm[q], et[q][i * 2 + half]);
          }
        }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (cm[q] > m[j][q]) {
          const float r_ = expf(m[j][q] - cm[q]);
          s[j][q] *= r_;
          sy[j][q] *= r_;
          syy[j][q] *= r_;
          m[j][q] = cm[q];
        }
        if (cm[q] == -INFINITY) continue;  // no frame of this chunk in this thread's rows
#pragma unroll
        for (int t = 0; t < kMT * 2; ++t) {
          const float w = expf(et[q][t] - m[j][q]);  // 0 for a row past the end
          s[j][q] += w;
          sy[j][q] = fmaf(w, y[q][t], sy[j][q]);
          syy[j][q] = fmaf(w * y[q][t], y[q][t], syy[j][q]);
        }
      }
    }
  }
  // merge the kSlots row slots of each column (a slot that saw no frame has s == 0)
  __syncthreads();
  float* red = reinterpret_cast<float*>(stage);  // [4][kSlots][128] floats
  constexpr int kSlots = kWM * 8;
  const int slot = wm * 8 + tc::frag_row(lane);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = wn * 32 + j * 8 + tc::frag_col(lane) + q;
      red[(0 * kSlots + slot) * 128 + col] = m[j][q];
      red[(1 * kSlots + slot) * 128 + col] = s[j][q];
      red[(2 * kSlots + slot) * 128 + col] = sy[j][q];
      red[(3 * kSlots + slot) * 128 + col] = syy[j][q];
    }
  __syncthreads();
  if (tid >= 128) return;
  float mx = red[tid];
  for (int k = 1; k < kSlots; ++k) mx = fmaxf(mx, red[k * 128 + tid]);
  float S = 0.f, SY = 0.f, SYY = 0.f;
  for (int k = 0; k < kSlots; ++k) {
    const float gs = red[(kSlots + k) * 128 + tid];
    if (gs == 0.f) continue;
    const float r = expf(red[k * 128 + tid] - mx);
    S = fmaf(gs, r, S);
    SY = fmaf(red[(2 * kSlots + k) * 128 + tid], r, SY);
    SYY = fmaf(red[(3 * kSlots + k) * 128 + tid], r, SYY);
  }
  const float mean = SY / S;
  const float q = SYY / S;
  const int ch = c0 + tid;
  if (out) {
    const float sd = sqrtf(fmaxf(q - mean * mean, eps));
    out[(long long)b * 2 * C + ch] = __float2bfloat16(mean);
    out[(long long)b * 2 * C + C + ch] = __float2bfloat16(sd);
  }
  if (stats) {
    const long long bc = (long long)b * C + ch, n = (long long)gridDim.y * C;
    stats[bc] = mx;
    stats[n + bc] = S;
    stats[2 * n + bc] = mean;
    stats[3 * n + bc] = q;
  }
}
constexpr size_t kTcStatsSmem = (size_t)(kTcTile128 + 4 * kTcTile64) * sizeof(bf16);

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
  size_t u, ub, stats, de, dy0, dz, dba, dbb, da, dc, dwb, dwa, total;
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

// passes 1-2 of the bf16 tensor-core route; u32 and stats may be null
// (forward), out may be null (backward)
int launch_tc_stats(const bf16* h, const float* a, const float* c, const bf16* wa, const float* ba,
                    const bf16* wb, const float* bb, float* u32, bf16* ub, bf16* out, float* stats,
                    int B, int n_t, int C, float eps, int fold, cudaStream_t st) {
  cudaError_t err;
  if ((err = allow_smem(tc_u_kernel, kTcUSmem)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(tc_stats_kernel, kTcStatsSmem)) != cudaSuccess) return (int)err;
  const int rows = B * n_t;
  tc_u_kernel<<<(rows + kTcRows - 1) / kTcRows, kTcThreads, kTcUSmem, st>>>(h, a, c, wa, ba, u32,
                                                                          ub, rows, C, fold);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tc_stats_kernel<<<dim3(C / 128, B), kTcThreads, kTcStatsSmem, st>>>(h, a, c, ub, wb, bb, out,
                                                                      n_t, C, eps, fold, stats);
  return (int)cudaGetLastError();
}

int launch_tc_fwd(const void* h, const void* a, const void* c, const void* wa, const void* ba,
                  const void* wb, const void* bb, void* u_scratch, void* out, int B, int n_t, int C,
                  float eps, int fold, cudaStream_t st) {
  // the f32 [B*T, H] scratch of the wrapper holds the bf16 u
  return launch_tc_stats((const bf16*)h, (const float*)a, (const float*)c, (const bf16*)wa,
                         (const float*)ba, (const bf16*)wb, (const float*)bb, nullptr,
                         (bf16*)u_scratch, (bf16*)out, nullptr, B, n_t, C, eps, fold, st);
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
  const int rows = B * n_t;
  const int tiles = (n_t + kTcRows - 1) / kTcRows;
  const int pb = B * tiles * kEWM;
  const int k_split = ((rows + kSplits - 1) / kSplits + kKR - 1) / kKR * kKR;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  int code;
  if ((code = launch_tc_stats(h, a, c, wa, (const float*)ba_, wb, bb, u32, ub, nullptr, stats, B,
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

const char* titanet_attn_pool_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
