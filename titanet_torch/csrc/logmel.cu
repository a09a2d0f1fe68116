// Fused log-mel kernel: reflect-padded waveform rows -> [B, F, n_mels].
//
// Replaces titanet_tpu/ops/pallas/melspec.py::log_mel_spectrogram_pallas_fused
// (kernel body _fused_kernel, basis from _phase_basis). Plain torch builds
// the reflect-padded buffer (ops/frontend.py::_framing_buffer), as the JAX
// package does outside its kernel; this kernel does everything after it:
// framing, windowed real DFT, |.|^2, mel filterbank, 10*log10, L2 over mels
// and the frame mask, and writes only the [B, F, n_mels] result.
//
// Bound on the H100: operations. At B=128 x 3 s (F=301) the DFT is
// 2*F*B*win*2*n_bins ~ 16 GFLOP (the window's zero taps are skipped) and
// the mel product 2*F*B*n_bins*n_mels ~ 1.6 GFLOP, against ~25-37 MB of
// traffic: far above the card's operations-per-byte line in both modes.
//
// Design: one block per (utterance, tile of 64 frames). The block loads the
// tile's sample span, (64-1)*hop + n_fft samples, into shared memory once;
// frames are cut from it by offset (no frames tensor, no TPU phase
// decomposition, any hop). Each warp owns 8 frames and each lane 4 DFT
// bins at a time (64 accumulators), so a tap costs 8 shared-memory
// broadcasts and 8 L1 loads of the basis for 64 FMAs; the bins left over
// (the Nyquist bin) are split over the lanes by taps and summed with
// shuffles. The window's zero taps are skipped. The power spectrum of the tile stays
// in shared memory for the mel product; dB and the L2 norm run there too.
// f32 mode: f32 operands, f32 accumulation (no TF32). bf16 mode: bf16
// samples and basis, f32 accumulation, power rounded to bf16 before the bf16
// filterbank product, as the TPU kernel's MXU passes do.
#include "logmel_common.cuh"

namespace {

size_t smem_bytes(int hop, int n_fft, int n_mels) {
  const size_t span = (size_t)(kTileFrames - 1) * hop + n_fft;
  const size_t db = (size_t)kTileFrames * n_mels;
  const size_t power = (size_t)kTileFrames * (n_fft / 2 + 1);
  return ((span > db ? span : db) + power) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) logmel_kernel(
    const T* __restrict__ buf, long long buf_stride, int buf_len,
    const int* __restrict__ lengths,  // [B] or null
    const T* __restrict__ basis,      // [2, n_fft, n_bins]: window*cos | window*sin
    const T* __restrict__ fb,         // [n_bins, n_mels]
    float* __restrict__ out,          // [B, n_frames, n_mels]
    int n_frames, int hop, int n_fft, int k_lo, int k_hi, int n_mels) {
  extern __shared__ float smem[];
  const int n_bins = n_fft / 2 + 1;
  const int span = (kTileFrames - 1) * hop + n_fft;
  const int db_len = kTileFrames * n_mels;  // the dB tile reuses the samples' room
  float* samples = smem;  // [span]; holds the dB tile after the DFT
  float* power = smem + (span > db_len ? span : db_len);  // [kTileFrames][n_bins]

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kTileFrames;
  const T* row = buf + (long long)b * buf_stride;
  const int s0 = f0 * hop;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const int s = s0 + i;
    samples[i] = s < buf_len ? to_f(row[s]) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int fw = warp * kFramesPerWarp;
  const float* x = samples + fw * hop;
  float* pw = power + fw * n_bins;
  const T* cos_b = basis;
  const T* sin_b = basis + (long long)n_fft * n_bins;
  int j0 = 0;
  for (; j0 + 32 * kBinsPerLane <= n_bins; j0 += 32 * kBinsPerLane)
    dft_pass<T, kBinsPerLane>(x, hop, cos_b, sin_b, n_bins, j0 + lane, k_lo, k_hi, pw);
  for (; j0 + 32 <= n_bins; j0 += 32)
    dft_pass<T, 1>(x, hop, cos_b, sin_b, n_bins, j0 + lane, k_lo, k_hi, pw);
  for (; j0 < n_bins; ++j0)  // fewer than 32 bins left (the Nyquist bin)
    dft_bin_warp<T>(x, hop, cos_b, sin_b, n_bins, j0, k_lo, k_hi, pw, lane);
  __syncthreads();

  const int valid = lengths ? 1 + lengths[b] / hop : n_frames;
  const int rows = n_frames - f0 < kTileFrames ? n_frames - f0 : kTileFrames;
  mel_db_l2_store<T>(power, samples, fb, n_bins, n_mels,
                     out + ((long long)b * n_frames + f0) * n_mels, rows, valid - f0);
}

template <typename T>
int launch(const void* buf, long long buf_stride, int buf_len, int batch,
           const void* lengths, const void* basis, const void* fb, void* out,
           int n_frames, int hop, int n_fft, int k_lo, int k_hi, int n_mels,
           void* stream) {
  const size_t smem = smem_bytes(hop, n_fft, n_mels);
  if (smem > (size_t)kMaxSmem || batch > 65535 || batch < 1 || n_frames < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_frames + kTileFrames - 1) / kTileFrames, batch);
  logmel_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)buf, buf_stride, buf_len, (const int*)lengths, (const T*)basis,
      (const T*)fb, (float*)out, n_frames, hop, n_fft, k_lo, k_hi, n_mels);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int titanet_logmel_f32(const void* buf, long long buf_stride, int buf_len, int batch,
                       const void* lengths, const void* basis, const void* fb,
                       void* out, int n_frames, int hop, int n_fft, int k_lo,
                       int k_hi, int n_mels, void* stream) {
  return launch<float>(buf, buf_stride, buf_len, batch, lengths, basis, fb, out,
                       n_frames, hop, n_fft, k_lo, k_hi, n_mels, stream);
}

int titanet_logmel_bf16(const void* buf, long long buf_stride, int buf_len, int batch,
                        const void* lengths, const void* basis, const void* fb,
                        void* out, int n_frames, int hop, int n_fft, int k_lo,
                        int k_hi, int n_mels, void* stream) {
  return launch<__nv_bfloat16>(buf, buf_stride, buf_len, batch, lengths, basis, fb,
                               out, n_frames, hop, n_fft, k_lo, k_hi, n_mels, stream);
}

long long titanet_logmel_smem_bytes(int hop, int n_fft, int n_mels) {
  return (long long)smem_bytes(hop, n_fft, n_mels);
}

const char* titanet_logmel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
