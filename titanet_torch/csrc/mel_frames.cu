// Frames log-mel kernel: materialized frames [N, n_fft] -> [N, n_mels].
//
// Replaces titanet_tpu/ops/pallas/melspec.py::_mel_frames_pallas (kernel
// body _mel_kernel). Plain torch cuts the frames (ops/frontend.py::
// frame_signal), as the JAX package does outside its kernel; this kernel
// does the windowed real DFT (the window is folded into the basis),
// |.|^2, the mel filterbank, 10*log10, and the L2 norm over the mels, and
// writes only the [N, n_mels] result. The frame mask stays outside.
//
// Bound on the H100: at N = 128 x 301 frames the two products are
// ~17.4 GFLOP against 79 MB of frames read and 12 MB written. In f32 the
// operations bound it (FP32 cores); with bf16-rounded operands the
// tensor-core rate would make the frames' bytes the bound. The frames
// tensor is what this kernel costs over the fused one (logmel.cu), which
// reads 3.2x fewer bytes for the same function.
//
// Design: one block per tile of 64 frames. The block loads the tile's
// rows into shared memory, keeping only the taps the window leaves
// non-zero ([k_lo, k_hi) of n_fft), rounded to the operand type T on the
// way (frames stay f32 in device memory in both modes). The DFT, the mel
// product, dB and the L2 norm are the device functions the fused kernel
// uses (logmel_common.cuh), with the row length as the frame stride. The
// last tile guards its rows; nothing is padded to a lane width.
// T = float: f32 operands and accumulation (no TF32). T = bf16: operands
// of both products rounded to bf16, f32 accumulation.
#include "logmel_common.cuh"

namespace {

size_t smem_bytes(int taps, int n_fft, int n_mels) {
  const size_t tile = (size_t)kTileFrames * taps;
  const size_t db = (size_t)kTileFrames * n_mels;
  const size_t power = (size_t)kTileFrames * (n_fft / 2 + 1);
  return ((tile > db ? tile : db) + power) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) mel_frames_kernel(
    const float* __restrict__ frames,  // [N, n_fft]
    const T* __restrict__ basis,       // [2, n_fft, n_bins]: window*cos | window*sin
    const T* __restrict__ fb,          // [n_bins, n_mels]
    float* __restrict__ out,           // [N, n_mels]
    int n_rows, int n_fft, int k_lo, int k_hi, int n_mels) {
  extern __shared__ float smem[];
  const int n_bins = n_fft / 2 + 1;
  const int taps = k_hi - k_lo;
  const int tile_len = kTileFrames * taps;
  const int db_len = kTileFrames * n_mels;  // the dB tile reuses the frames' room
  float* tile = smem;  // [kTileFrames][taps]
  float* power = smem + (tile_len > db_len ? tile_len : db_len);  // [kTileFrames][n_bins]

  const int n0 = blockIdx.x * kTileFrames;
  const int rows = n_rows - n0 < kTileFrames ? n_rows - n0 : kTileFrames;
  for (int i = threadIdx.x; i < tile_len; i += kThreads) {
    const int f = i / taps;
    const int k = i - f * taps;
    tile[i] = f < rows ? round_as<T>(frames[(long long)(n0 + f) * n_fft + k_lo + k]) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int fw = warp * kFramesPerWarp;
  const float* x = tile + fw * taps;
  float* pw = power + fw * n_bins;
  const T* cos_b = basis + (long long)k_lo * n_bins;
  const T* sin_b = cos_b + (long long)n_fft * n_bins;
  int j0 = 0;
  for (; j0 + 32 * kBinsPerLane <= n_bins; j0 += 32 * kBinsPerLane)
    dft_pass<T, kBinsPerLane>(x, taps, cos_b, sin_b, n_bins, j0 + lane, 0, taps, pw);
  for (; j0 + 32 <= n_bins; j0 += 32)
    dft_pass<T, 1>(x, taps, cos_b, sin_b, n_bins, j0 + lane, 0, taps, pw);
  for (; j0 < n_bins; ++j0)  // fewer than 32 bins left (the Nyquist bin)
    dft_bin_warp<T>(x, taps, cos_b, sin_b, n_bins, j0, 0, taps, pw, lane);
  __syncthreads();

  mel_db_l2_store<T>(power, tile, fb, n_bins, n_mels, out + (long long)n0 * n_mels, rows, rows);
}

template <typename T>
int launch(const void* frames, int n_rows, const void* basis, const void* fb, void* out,
           int n_fft, int k_lo, int k_hi, int n_mels, void* stream) {
  if (n_rows < 1 || k_lo < 0 || k_hi > n_fft || k_hi <= k_lo) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(k_hi - k_lo, n_fft, n_mels);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mel_frames_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_rows + kTileFrames - 1) / kTileFrames;
  mel_frames_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)frames, (const T*)basis, (const T*)fb, (float*)out, n_rows, n_fft,
      k_lo, k_hi, n_mels);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int titanet_mel_frames_f32(const void* frames, int n_rows, const void* basis, const void* fb,
                           void* out, int n_fft, int k_lo, int k_hi, int n_mels,
                           void* stream) {
  return launch<float>(frames, n_rows, basis, fb, out, n_fft, k_lo, k_hi, n_mels, stream);
}

int titanet_mel_frames_bf16(const void* frames, int n_rows, const void* basis, const void* fb,
                            void* out, int n_fft, int k_lo, int k_hi, int n_mels,
                            void* stream) {
  return launch<__nv_bfloat16>(frames, n_rows, basis, fb, out, n_fft, k_lo, k_hi, n_mels,
                               stream);
}

const char* titanet_mel_frames_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
