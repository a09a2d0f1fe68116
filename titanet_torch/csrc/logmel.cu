// Fused log-mel kernels: reflect-padded waveform rows -> [B, F, n_mels].
//
// Replace titanet_tpu/ops/pallas/melspec.py::log_mel_spectrogram_pallas_fused
// (kernel body _fused_kernel, basis from _phase_basis). Plain torch builds
// the reflect-padded buffer (ops/frontend.py::_framing_buffer), as the JAX
// package does outside its kernel; these kernels do everything after it:
// framing, windowed real DFT, |.|^2, mel filterbank, 10*log10, L2 over mels
// and the frame mask, and write only the [B, F, n_mels] result. No frames
// tensor exists. Three designs:
//
// logmel_dmma_kernel (f32 at the geometries ops/kernels/melspec.py::
// fused_dmma_supports takes, TitaNet's among them): the DFT on the f64
// tensor cores, logmel_common.cuh::dmma_logmel_tile (the frames kernel's
// f32 route runs the same function). One block per (utterance, tile of 64
// frames): it stages the tile's sample span, (64 - 1) * hop + taps floats
// from the first tap the window keeps, once, with 4 floats after every hop
// when the hop is a multiple of 8 (so an A fragment's words fall in 32
// banks), and cuts each A fragment at offset f * hop + k: no frames tile.
// 43 KB of samples and a 64 KB basis ring at TitaNet's frontend: two
// blocks of 8 warps an SM, the registers capped at 128 a thread (ptxas
// spills a few bytes).
//
// logmel_kernel (f32 and bf16 where the tensor-core kernels do not take
// the geometry): FP32 cores. Bound on the H100: operations. At B=128 x 3 s
// (F=301) the DFT is 2*F*B*win*2*n_bins ~ 16 GFLOP (the window's zero taps
// are skipped) and the mel product 2*F*B*n_bins*n_mels ~ 1.6 GFLOP, against
// ~25-37 MB of traffic: far above the card's operations-per-byte line.
// One block per (utterance, tile of 64 frames). The block loads the
// tile's sample span, (64-1)*hop + n_fft samples, into shared memory once;
// frames are cut from it by offset (no TPU phase decomposition, any hop).
// Each warp owns 8 frames and each lane 4 DFT bins at a time (64
// accumulators), so a tap costs 8 shared-memory broadcasts and 8 L1 loads
// of the basis for 64 FMAs; the bins left over (the Nyquist bin) are split
// over the lanes by taps and summed with shuffles. The power spectrum of
// the tile stays in shared memory for the mel product; dB and the L2 norm
// run there too. f32 mode: f32 operands, f32 accumulation (no TF32). bf16
// mode: bf16 samples and basis, f32 accumulation, re^2 and im^2 rounded to
// bf16 apart before the bf16 filterbank product, as _fused_kernel does.
//
// logmel_tc_kernel (bf16, the serving route): the bf16 tensor cores
// (csrc/mma_bf16.cuh: wgmma for the DFT, mma.sync for the mel product), on
// the pipeline of mel_frames.cu's mel_frames_tc_kernel. Its bound is the
// same ~17.4 GFLOP at 989 TFLOP/s (~0.018 ms), against a 12.4 MB bf16
// buffer read. What it does:
// - Rows over the whole batch: a block takes 128 rows of the flattened
//   B*F frames (row n is frame n % F of utterance n / F, so a tile may
//   straddle two utterances): 301 blocks at B=128 x 3 s, not 5 x 128.
// - The frames tile is cut straight from the bf16 buffer (already bf16: no
//   rounding) into wgmma's K-major 128-byte-swizzled layout with 16-byte
//   cp.async copies when stride, hop and the first tap are multiples of 8
//   elements (2-byte loads otherwise); taps past the window are zero-filled.
//   It arrives 32 taps at a time with the first panel's basis slabs, so the
//   first products start after one slab, and stays resident for the rest
//   of the DFT. Overlapping frames read their shared samples again (~2.5x
//   at hop 160): L2 serves those reads (L1-cached copies were no faster).
// - The DFT: the frames kernel's basis panels (ops/kernels/melspec.py::
//   tc_basis, 128 bins a panel, each 8-bin group as 8 cos then 8 sin
//   columns, the Nyquist bin's cos in bin 0's zero sin column) stream
//   through a cp.async ring of 32-tap slabs; each warpgroup computes a
//   64 x 256 wgmma.m64n256k16 tile a panel, its first product starting the
//   sums through wgmma's scale-d predicate. Loops nested by panel and slab,
//   and no branch on the warp index, keep ptxas from serializing the
//   products (its notes C7518 / C7517; bench_logmel_tc.py times the cost).
// - The power rounded twice, as _fused_kernel rounds spec * spec to bf16
//   before its FB2 product: in the accumulator layout each 16-column group
//   already holds the cos and the sin columns of 8 bins, so re^2 and im^2
//   are rounded to bf16 apart into one 16 x 16 mma.sync A fragment; the B
//   operand is the doubled filterbank (ops/kernels/melspec.py::
//   fused_tc_filterbank: each group's 8 fb rows twice, FB2's layout group by
//   group; under bin 0's sin slot the Nyquist bin's row; bin 0's own im is
//   exactly 0). The panel's 256 rows are staged in shared memory while the
//   panel's DFT runs. The Nyquist bin's sin residue (~1e-16 t) is left out.
// - Epilogue in registers: 10*log10(max(mel, 1e-10)), the L2 norm over the
//   mels by shuffles, 16-byte stores; rows at or after 1 + lengths[b] / hop
//   are written as zeros, rows past B*F never stored.
#include "logmel_common.cuh"
#include "mma_bf16.cuh"

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


// ------------------------------------------------- bf16 tensor-core design

using bf16 = __nv_bfloat16;
constexpr int kTcRows = 128;     // frame rows a block: two warpgroups of 64
constexpr int kTcThreads = 256;  // 8 warps
constexpr int kSlab = 32;        // taps a basis slab
constexpr int kPanel = 256;      // basis columns a panel: 16 groups x (8 cos + 8 sin)
constexpr int kSlabElems = kSlab * kPanel;  // 16 KB, wgmma's MN-major layout (4 k groups)
constexpr int kFbRows = 256;     // doubled filterbank rows a panel: 16 groups x (8 + 8)

// bytes: frames tile (64-tap panels of 128 rows), basis ring, one panel's
// filterbank rows (ops/kernels/melspec.py::fused_tc_smem_bytes)
size_t tc_smem_bytes(int tpp, int n_mels, int stages) {
  return ((size_t)kTcRows * ((tpp + 63) / 64 * 64) + (size_t)stages * kSlabElems +
          (size_t)kFbRows * (n_mels + tc::kPad)) *
         sizeof(bf16);
}

// buf: [B, >= (n_frames - 1) * hop + k0 + taps] bf16, row stride buf_stride.
// basis: [n_panels][tpp][256] (melspec.py::tc_basis, taps from k0).
// fb: [n_panels * 256][n_mels] (melspec.py::fused_tc_filterbank): row
// 256 p + 16 g + 8 s + j is the fb row of bin 128 p + 8 g + j (s = 0: under
// its cos column, s = 1: under its sin column), except row 8 (bin 0's sin
// slot), the Nyquist bin's.
template <int NTM, int STAGES>  // NTM = n_mels / 8
__global__ void __launch_bounds__(kTcThreads, 1) logmel_tc_kernel(
    const bf16* __restrict__ buf, long long buf_stride, const int* __restrict__ lengths,
    const bf16* __restrict__ basis, const bf16* __restrict__ fb, float* __restrict__ out,
    int n_rows, int n_frames, int hop, int k0, int taps, int tpp, int n_groups) {
  constexpr int n_mels = NTM * 8;
  constexpr int mld = n_mels + tc::kPad;
  constexpr int AHEAD = STAGES - 2;  // slabs in flight; one product group reads a third stage
  extern __shared__ __align__(1024) unsigned char smem_raw[];  // wgmma tiles: 1 KB aligned
  bf16* fr_s = reinterpret_cast<bf16*>(smem_raw);              // [tpp / 64][128][64], swizzled
  bf16* ring = fr_s + kTcRows * ((tpp + 63) / 64 * 64);
  bf16* fb_s = ring + STAGES * kSlabElems;  // [kFbRows][mld]: the current panel's rows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wgm = warp >> 2;
  const int n0 = blockIdx.x * kTcRows;
  const int rows = min(kTcRows, n_rows - n0);
  const int n_panels = (n_groups + 15) / 16;
  const int spp = tpp / kSlab;       // slabs a panel
  const int total = n_panels * spp;  // slabs in all
  // blocks start their walk at different panels, so the SMs do not all read
  // the same basis slab from L2 at the same moment
  const int p0 = blockIdx.x % n_panels;
  auto panel_of = [&](int i) { return p0 + i < n_panels ? p0 + i : p0 + i - n_panels; };

  auto load_slab = [&](int g, int st) {  // slab g of the walk into ring stage st
    const int i = g / spp, ks = g - i * spp;
    const bf16* src = basis + ((long long)panel_of(i) * tpp + ks * kSlab) * kPanel;
    bf16* dst = ring + st * kSlabElems;
#pragma unroll
    for (int u = 0; u < kSlabElems / 8 / kTcThreads; ++u) {
      const int c = u * kTcThreads + tid;
      const int r = c / (kPanel / 8), col = (c % (kPanel / 8)) * 8;
      tc::cp_async16(dst + tc::sw128_b_offset(r, col, kSlab / 8), src + r * kPanel + col);
    }
  };
  auto load_fb = [&](int panel) {  // the panel's doubled filterbank rows
    const bf16* src = fb + (long long)panel * kFbRows * n_mels;
    for (int c = tid; c < kFbRows * (n_mels / 8); c += kTcThreads) {
      const int r = c / (n_mels / 8), col = (c % (n_mels / 8)) * 8;
      tc::cp_async16(fb_s + r * mld + col, src + r * n_mels + col);
    }
  };

  // frames tile, 32 taps at a time with the first panel's slabs (tap slab
  // ks lands with basis slab ks): thread t copies 8-tap chunk t % 4 of rows
  // t / 4 and t / 4 + 64; row n of the flattened B * F frames starts at
  // buf[n / F][(n % F) * hop + k0]
  const bool vec = ((buf_stride | hop | k0) & 7) == 0 &&
                   (reinterpret_cast<uintptr_t>(buf) & 15) == 0;
  const bf16* row_src[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = (tid >> 2) + 64 * u, n = n0 + r, b = n / n_frames;
    row_src[u] = r < rows ? buf + b * buf_stride + (long long)(n - b * n_frames) * hop + k0 : nullptr;
  }
  auto load_frames = [&](int ks) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = (tid >> 2) + 64 * u, k = ks * kSlab + (tid & 3) * 8;
      const bf16* src = row_src[u];
      bf16* dst = fr_s + tc::sw128_a_offset<kTcRows>(r, k);
      const int n_valid = src ? max(0, min(8, taps - k)) : 0;  // taps past the window: 0
      if (vec) {
        tc::cp_async16_zfill(dst, n_valid ? src + k : buf, 2 * n_valid);
      } else {
        alignas(16) bf16 e[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) e[i] = i < n_valid ? src[k + i] : __float2bfloat16(0.f);
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(e);
      }
    }
  };
  load_fb(panel_of(0));
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {  // the filterbank goes with slab 0
    if (s < spp) load_frames(s);
    if (s < total) load_slab(s, s);
    tc::cp_async_commit();
  }

  // DFT: warpgroup wgm, rows 64 wgm .., all 256 columns of the panel
  // (acc[4j + e]: element e of the 16 x 8 tile at columns 8j, rows
  // 16 warp ..); the mel sums of the same 16 rows a warp in macc
  float acc[128];
  float macc[NTM][4];
#pragma unroll
  for (int j = 0; j < NTM; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) macc[j][e] = 0.f;
  // The loops over panels and slabs are nested and no branch depends on the
  // warp index, so ptxas keeps the products asynchronous: with one loop over
  // all slabs and the mel product under `if (last slab)`, or with a branch
  // on the warpgroup's rows, it serializes every wgmma (notes C7517, C7518).
  for (int i_panel = 0, g = 0; i_panel < n_panels; ++i_panel) {
    for (int ks = 0; ks < spp; ++ks, ++g) {
      tc::cp_async_wait<AHEAD - 1>();
      tc::fence_proxy_async();  // this thread's copies and stores -> wgmma's reads
      __syncthreads();
      // every warp has multiplied the last panel's filterbank rows (step g - 1);
      // this panel's land with slab g + AHEAD, before its last step (the
      // launcher takes spp >= AHEAD + 1 where there are two panels or more)
      if (ks == 0 && i_panel > 0) load_fb(panel_of(i_panel));
      // the stage refilled here was read by the product group two slabs back,
      // which every warpgroup has waited for
      if (g + AHEAD < spp) load_frames(g + AHEAD);
      if (g + AHEAD < total) load_slab(g + AHEAD, (g + AHEAD) % STAGES);
      tc::cp_async_commit();
      // every warp runs the products, the rows past the end on zeros
      const bf16* slab = ring + (g % STAGES) * kSlabElems;
      tc::wgmma_fence();
#pragma unroll
      for (int k2 = 0; k2 < kSlab / 16; ++k2) {
        const int kk = ks * kSlab + k2 * 16;
        tc::wgmma_m64n256k16(  // the panel's first product starts the sums
            acc, tc::wgmma_desc_a(fr_s + (kk >> 6) * (kTcRows * 64) + wgm * 4096 + (kk & 63)),
            tc::wgmma_desc_b(slab + k2 * 2 * 512, kSlab / 8), ks | k2);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<1>();
    }

    // The panel's power, re^2 and im^2 rounded to bf16 apart, straight from
    // the accumulators into mma.sync A fragments: group grp's cos tile
    // (columns 16 grp ..) gives a[0], a[1] (k columns 0-7), its sin tile
    // a[2], a[3] (k columns 8-15), against the group's 16 doubled rows.
    tc::wgmma_wait<0>();
    const int groups = min(16, n_groups - panel_of(i_panel) * 16);
#pragma unroll
    for (int grp = 0; grp < 16; ++grp) {
      if (grp >= groups) continue;
      uint32_t a[4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int t = 4 * (2 * grp + s);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(__fmul_rn(acc[t], acc[t]),
                                                        __fmul_rn(acc[t + 1], acc[t + 1]));
        const __nv_bfloat162 hi = __floats2bfloat162_rn(__fmul_rn(acc[t + 2], acc[t + 2]),
                                                        __fmul_rn(acc[t + 3], acc[t + 3]));
        a[2 * s] = *reinterpret_cast<const uint32_t*>(&lo);
        a[2 * s + 1] = *reinterpret_cast<const uint32_t*>(&hi);
      }
      const bf16* b = fb_s + 16 * grp * mld;
#pragma unroll
      for (int j = 0; j < NTM / 2; ++j) {
        uint32_t bf[4];
        tc::load_b<true>(bf, b + 16 * j, mld, lane);
        tc::mma_16816(macc[2 * j], a, bf[0], bf[1]);
        tc::mma_16816(macc[2 * j + 1], a, bf[2], bf[3]);
      }
    }
  }
  tc::cp_async_wait<0>();

  // dB, L2 over the mels (the 4 lanes of a row), the frame mask, 16-byte stores
  const int r0 = warp * 16 + tc::frag_row(lane);
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
  // lanes q, q^1 of a row quad swap halves: an even q stores 4 columns of
  // row r0, an odd q 4 columns of row r0 + 8
  const bool even = (lane & 1) == 0;
  const int row = r0 + (even ? 0 : 8);
  const int n = n0 + row;
  const bool store = row < rows;
  bool masked = false;
  if (store && lengths) {
    const int b = n / n_frames;
    masked = n - b * n_frames >= 1 + lengths[b] / hop;
  }
#pragma unroll
  for (int j = 0; j < NTM; ++j) {
    const float a0 = macc[j][0] / ss[0], a1 = macc[j][1] / ss[0];
    const float b0 = macc[j][2] / ss[1], b1 = macc[j][3] / ss[1];
    const float rx = __shfl_xor_sync(0xffffffffu, even ? b0 : a0, 1);
    const float ry = __shfl_xor_sync(0xffffffffu, even ? b1 : a1, 1);
    const int col = j * 8 + tc::frag_col(lane) - (even ? 0 : 2);
    if (store)
      *reinterpret_cast<float4*>(out + (long long)n * n_mels + col) =
          masked ? make_float4(0.f, 0.f, 0.f, 0.f)
                 : (even ? make_float4(a0, a1, rx, ry) : make_float4(rx, ry, b0, b1));
  }
}

template <int NTM, int STAGES>
int launch_tc(const bf16* buf, long long buf_stride, const int* lengths, const bf16* basis,
              const bf16* fb, float* out, int n_rows, int n_frames, int hop, int k0, int taps,
              int tpp, int n_groups, cudaStream_t st) {
  const size_t smem = tc_smem_bytes(tpp, NTM * 8, STAGES);
  cudaError_t err = cudaFuncSetAttribute(logmel_tc_kernel<NTM, STAGES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_rows + kTcRows - 1) / kTcRows;
  logmel_tc_kernel<NTM, STAGES><<<grid, kTcThreads, smem, st>>>(
      buf, buf_stride, lengths, basis, fb, out, n_rows, n_frames, hop, k0, taps, tpp, n_groups);
  return (int)cudaGetLastError();
}

// the deepest basis ring that fits shared memory and, with two panels or
// more, leaves a panel's filterbank rows AHEAD + 1 slabs to land
// (ops/kernels/melspec.py::fused_tc_stages)
int tc_stages(int tpp, int n_groups, int n_mels) {
  const int n_panels = (n_groups + 15) / 16;
  for (int s = 4; s >= 3; --s)
    if (tc_smem_bytes(tpp, n_mels, s) <= (size_t)kMaxSmem && (n_panels == 1 || tpp / kSlab >= s - 1))
      return s;
  return 0;
}

// ----------------------------------------------- f64 tensor-core design

// buf: [B, >= buf_len] f32, row stride buf_stride; basis, fb, fb_table: the
// packs of dmma_logmel_tile (taps from k0)
template <int NTM>
__global__ void __launch_bounds__(kDmThreads, 2) logmel_dmma_kernel(
    const float* __restrict__ buf, long long buf_stride, int buf_len,
    const int* __restrict__ lengths, const double* __restrict__ basis,
    const float* __restrict__ fb, const int* __restrict__ fb_table, int n_walk,
    float* __restrict__ out, int n_frames, int hop, int k0, int steps, int n_panels) {
  extern __shared__ __align__(16) double dm_smem[];
  double* ring = dm_smem;                                            // [kDmStages][kDmStage]
  float* x = reinterpret_cast<float*>(ring + kDmStages * kDmStage);  // the sample span
  int* table_s = reinterpret_cast<int*>(x + dmma_span_floats(hop, steps));
  const bool pad = hop % 8 == 0;
  const int b = blockIdx.y, f0 = blockIdx.x * kDmRows;
  const long long s0 = (long long)f0 * hop + k0;  // the span's first sample in the row
  const int span = (kDmRows - 1) * hop + 8 * steps;
  const float* src = buf + b * buf_stride + s0;
  for (int i = threadIdx.x; i < 2 * n_walk; i += kDmThreads) table_s[i] = fb_table[i];
  const int rows = min(kDmRows, n_frames - f0);
  const int valid = (lengths ? 1 + lengths[b] / hop : n_frames) - f0;
  dmma_logmel_tile<NTM, false>(
      x, pad ? hop + kDmPad : hop, pad ? hop : (1 << 30), ring, table_s, n_walk, basis, fb, steps,
      n_panels,
      [&] {  // while the basis prologue is in flight: the span, kDmPad floats
             // after every hop (none when the hop is not a multiple of 8),
             // zero past the row
        for (int i = threadIdx.x; i < span; i += kDmThreads)
          x[pad ? i + kDmPad * (i / hop) : i] = s0 + i < buf_len ? __ldg(src + i) : 0.f;
      },
      [](int) {}, out + ((long long)b * n_frames + f0) * (NTM * 8), rows, valid);
}

template <int NTM>
int launch_dmma(const float* buf, long long buf_stride, int buf_len, int batch, const int* lengths,
                const double* basis, const float* fb, const int* fb_table, int n_walk, float* out,
                int n_frames, int hop, int k0, int steps, int n_panels, size_t smem,
                cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(logmel_dmma_kernel<NTM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_frames + kDmRows - 1) / kDmRows, batch);
  logmel_dmma_kernel<NTM><<<grid, kDmThreads, smem, st>>>(
      buf, buf_stride, buf_len, lengths, basis, fb, fb_table, n_walk, out, n_frames, hop, k0, steps,
      n_panels);
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

// bf16 on the tensor cores: basis and fb in the layouts of logmel_tc_kernel,
// taps [k0, k0 + taps) of each frame, n_mels 80 (TitaNet's)
int titanet_logmel_bf16_tc(const void* buf, long long buf_stride, int batch, const void* lengths,
                           const void* basis, const void* fb, void* out, int n_frames, int hop,
                           int k0, int taps, int n_bins, int n_mels, void* stream) {
  const int tpp = (taps + kSlab - 1) / kSlab * kSlab;
  const int n_groups = (n_bins - 1 + 7) / 8;
  if (batch < 1 || n_frames < 1 || (long long)batch * n_frames > 0x7fffffffLL || hop < 1 ||
      k0 < 0 || taps < 1 || tpp > 512 || n_bins < 2 || n_mels != 80)
    return (int)cudaErrorInvalidValue;
  const int stages = tc_stages(tpp, n_groups, n_mels);
  if (stages == 0) return (int)cudaErrorInvalidValue;
  auto run_tc = stages == 4 ? launch_tc<10, 4> : launch_tc<10, 3>;
  return run_tc((const bf16*)buf, buf_stride, (const int*)lengths, (const bf16*)basis,
                (const bf16*)fb, (float*)out, batch * n_frames, n_frames, hop, k0, taps, tpp,
                n_groups, (cudaStream_t)stream);
}

// f32 with the DFT on the f64 tensor cores: basis, fb and fb_table ([2,
// n_walk] int32) from ops/kernels/melspec.py::dmma_basis and
// dmma_filterbank, taps [k0, k0 + taps) of each frame, n_mels 80
// (TitaNet's); a block's shared memory must fit (melspec.py::
// fused_dmma_supports)
int titanet_logmel_f32_dmma(const void* buf, long long buf_stride, int buf_len, int batch,
                            const void* lengths, const void* basis, const void* fb,
                            const void* fb_table, int n_walk, void* out, int n_frames, int hop,
                            int k0, int taps, int n_bins, int n_mels, void* stream) {
  const int steps = ((taps + 7) / 8 + kDmSteps - 1) / kDmSteps * kDmSteps;
  const int n_panels = ((n_bins - 1 + 7) / 8 + 7) / 8;
  if (batch < 1 || batch > 65535 || n_frames < 1 || hop < 1 || k0 < 0 || taps < 1 || n_bins < 2 ||
      n_mels != 80 || n_walk != n_panels * 8 + 1)
    return (int)cudaErrorInvalidValue;
  const int a_floats = dmma_span_floats(hop, steps);
  const size_t smem = dmma_smem_bytes(a_floats, n_walk);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  return launch_dmma<10>((const float*)buf, buf_stride, buf_len, batch, (const int*)lengths,
                         (const double*)basis, (const float*)fb, (const int*)fb_table, n_walk,
                         (float*)out, n_frames, hop, k0, steps, n_panels, smem,
                         (cudaStream_t)stream);
}

long long titanet_logmel_smem_bytes(int hop, int n_fft, int n_mels) {
  return (long long)smem_bytes(hop, n_fft, n_mels);
}

const char* titanet_logmel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
