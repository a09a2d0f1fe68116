// Fused mega-block sub-chain kernel (inference): x [B, T, C] -> [B, T, C],
//
//   (depthwise k + bias -> pointwise C x C product + bias -> folded-BN
//    affine -> relu) x S
//
// in one pass over time tiles; the intermediate activations never reach
// device memory.
//
// Replaces titanet_tpu/ops/pallas/megablock.py::fused_sub_blocks (kernel
// body _kernel) and computes what that body computes: the depthwise sum in
// f32, rounded to the activation type T before the product; the product
// with f32 accumulation; bias, affine and relu in f32, rounded to T as the
// next stage's input. Only the kernel's INPUT is zero outside [0, T): the
// stages are evaluated on the halo rows too and not re-zeroed there, so
// the first and last (S-1)*pad output rows differ from a chain of
// zero-padded convolutions, exactly as in the kernel this replaces.
//
// Bound on the H100: operations. One call at B=128, T=301, C=256, k=3, S=3
// is 2*B*T*S*(C*C + C*k) = 15.3 GFLOP against 2 x 19.7 MB (bf16) of
// activations and 0.4 MB of weights.
//
// Design. The TPU kernel keeps all S*C*C pointwise weights resident in its
// fast memory; they do not fit a block's shared memory here (768 KB in f32
// at C=256), so the roles are swapped: the ACTIVATION tile stays resident
// and the weights stream through shared memory in slabs of KS rows (they
// stay in L2). One block owns one utterance's tile of tb output rows and
// holds (tb + 2*halo) x C floats, halo = S*pad, zero where the row is
// outside [0, T). Each stage works in place on that one buffer:
//   - depthwise: thread c walks down the rows of channel c; output row r
//     reads rows r..r+k-1 and overwrites row r, which no later row reads;
//   - pointwise: every thread keeps an 8 x 8 block of the RM x C product in
//     registers over the whole K loop, then all write their blocks back
//     over the rows they were computed from, with bias, affine and relu.
// tb = RM - 2*pad*(S-1), so that the largest stage output is RM rows and
// the product is one pass (RM = 64; 32 at C=1024, where 64 rows of
// accumulators do not fit the register file). The halo rows are computed
// again by the neighbouring tile: 3% more rows at (C, k) = (256, 3), 11%
// at (512, 7), 83% at (1024, 11).
// Both types run on the FP32 cores: T = bf16 rounds where the TPU kernel
// rounds and multiplies the (exact) widened values with f32 accumulation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;
constexpr int kTM = 8;  // rows of a thread's block of the product
constexpr int kTN = 8;  // columns of it, strided by C/8 across the row

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

template <int C>
__host__ __device__ constexpr int slab_rows() { return (C <= 256 ? 4096 : 8192) / C; }

template <int C, int RM>
size_t smem_bytes(int pad) {
  return ((size_t)(RM + 2 * pad) * C + (size_t)slab_rows<C>() * C) * sizeof(float);
}

template <typename T, int C, int RM>
__global__ void __launch_bounds__((RM / kTM) * (C / kTN), (C <= 256 ? 2 : 1)) megablock_kernel(
    const T* __restrict__ x,         // [B, T, C]
    const float* __restrict__ dw_w,  // [S, k, C]
    const float* __restrict__ dw_b,  // [S, C]
    const T* __restrict__ pw_w,      // [S, C, C] (in, out)
    const float* __restrict__ pw_b,  // [S, C]
    const float* __restrict__ bn,    // [S, 2, C] folded (scale, shift)
    T* __restrict__ out,             // [B, T, C]
    int t_len, int n_stages, int k, int tb) {
  constexpr int NTX = C / kTN;
  constexpr int NT = (RM / kTM) * NTX;
  constexpr int KS = slab_rows<C>();
  extern __shared__ __align__(16) float smem[];
  const int pad = (k - 1) / 2;
  const int halo = n_stages * pad;
  float* buf = smem;                        // [tb + 2*halo = RM + 2*pad][C]
  float* slab = smem + (RM + 2 * pad) * C;  // [KS][C]

  const int tid = threadIdx.x;
  const int tx = tid % NTX;
  const int ty = tid / NTX;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tb;
  const T* xb = x + (long long)b * t_len * C;

  int rows = tb + 2 * halo;
  for (int i = tid; i < rows * C; i += NT) {
    const int t = t0 - halo + i / C;
    buf[i] = (t >= 0 && t < t_len) ? to_f(xb[(long long)t * C + (i % C)]) : 0.f;
  }
  __syncthreads();

  for (int s = 0; s < n_stages; ++s) {
    rows -= 2 * pad;  // this stage's output rows; row r is time t0 - halo + (s+1)*pad + r
    for (int c = tid; c < C; c += NT) {
      const float* w = dw_w + (long long)s * k * C + c;
      const float bias = dw_b[s * C + c];
      for (int r = 0; r < rows; ++r) {
        float acc = 0.f;
        for (int j = 0; j < k; ++j) acc = fmaf(buf[(r + j) * C + c], w[j * C], acc);
        buf[r * C + c] = round_as<T>(acc + bias);
      }
    }

    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
    const T* wmat = pw_w + (long long)s * C * C;
    const float* arow = buf + ty * kTM * C;
    for (int k0 = 0; k0 < C; k0 += KS) {
      __syncthreads();  // the depthwise rows are written; the last slab is consumed
      for (int i = tid; i < KS * C; i += NT) slab[i] = to_f(wmat[(long long)k0 * C + i]);
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < KS; kk += 4) {
        float4 a[kTM];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
          a[i] = *reinterpret_cast<const float4*>(arow + i * C + k0 + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float w[kTN];
#pragma unroll
          for (int j = 0; j < kTN; ++j) w[j] = slab[(kk + q) * C + tx + j * NTX];
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const float av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
#pragma unroll
            for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av, w[j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();  // every thread has read its rows: write the product over them
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = tx + j * NTX;
      const float pb = pw_b[s * C + c];
      const float scale = bn[(s * 2) * C + c];
      const float shift = bn[(s * 2 + 1) * C + c];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int r = ty * kTM + i;
        if (r < rows) {
          const float v = (acc[i][j] + pb) * scale + shift;
          buf[r * C + c] = round_as<T>(fmaxf(v, 0.f));
        }
      }
    }
    __syncthreads();
  }

  // rows == tb: row r is time t0 + r
  T* ob = out + (long long)b * t_len * C;
  for (int i = tid; i < tb * C; i += NT) {
    const int t = t0 + i / C;
    if (t < t_len) ob[(long long)t * C + (i % C)] = from_f<T>(buf[i]);
  }
}

template <typename T, int C, int RM>
int launch(const void* x, const void* dw_w, const void* dw_b, const void* pw_w,
           const void* pw_b, const void* bn, void* out, int batch, int t_len, int n_stages,
           int k, void* stream) {
  const int pad = (k - 1) / 2;
  const int tb = RM - 2 * pad * (n_stages - 1);
  const size_t smem = smem_bytes<C, RM>(pad);
  if (tb < 1 || smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(megablock_kernel<T, C, RM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t_len + tb - 1) / tb, batch);
  megablock_kernel<T, C, RM><<<grid, (RM / kTM) * (C / kTN), smem, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)dw_w, (const float*)dw_b, (const T*)pw_w, (const float*)pw_b,
      (const float*)bn, (T*)out, t_len, n_stages, k, tb);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* dw_w, const void* dw_b, const void* pw_w,
             const void* pw_b, const void* bn, void* out, int batch, int t_len, int channels,
             int n_stages, int k, void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 1 || n_stages < 1 || k < 1 || k % 2 == 0)
    return (int)cudaErrorInvalidValue;
  switch (channels) {  // ops/kernels/megablock.py::TILE_ROWS
    case 128:
      return launch<T, 128, 64>(x, dw_w, dw_b, pw_w, pw_b, bn, out, batch, t_len, n_stages, k, stream);
    case 256:
      return launch<T, 256, 64>(x, dw_w, dw_b, pw_w, pw_b, bn, out, batch, t_len, n_stages, k, stream);
    case 512:
      return launch<T, 512, 64>(x, dw_w, dw_b, pw_w, pw_b, bn, out, batch, t_len, n_stages, k, stream);
    case 1024:
      return launch<T, 1024, 32>(x, dw_w, dw_b, pw_w, pw_b, bn, out, batch, t_len, n_stages, k, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int titanet_megablock_f32(const void* x, const void* dw_w, const void* dw_b, const void* pw_w,
                          const void* pw_b, const void* bn, void* out, int batch, int t_len,
                          int channels, int n_stages, int k, void* stream) {
  return dispatch<float>(x, dw_w, dw_b, pw_w, pw_b, bn, out, batch, t_len, channels, n_stages,
                         k, stream);
}

int titanet_megablock_bf16(const void* x, const void* dw_w, const void* dw_b, const void* pw_w,
                           const void* pw_b, const void* bn, void* out, int batch, int t_len,
                           int channels, int n_stages, int k, void* stream) {
  return dispatch<__nv_bfloat16>(x, dw_w, dw_b, pw_w, pw_b, bn, out, batch, t_len, channels,
                                 n_stages, k, stream);
}

const char* titanet_megablock_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
