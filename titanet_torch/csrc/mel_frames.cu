// Frames log-mel kernel: materialized frames [N, n_fft] -> [N, n_mels].
//
// Replaces titanet_tpu/ops/pallas/melspec.py::_mel_frames_pallas (kernel
// body _mel_kernel). Plain torch cuts the frames (ops/frontend.py::
// frame_signal), as the JAX package does outside its kernel; this kernel
// does the windowed real DFT (the window is folded into the basis),
// |.|^2, the mel filterbank, 10*log10, and the L2 norm over the mels, and
// writes only the [N, n_mels] result. The frame mask stays outside.
//
// Three designs:
//
// "highest" (f32 operands, f32 accumulation) at the geometries
// ops/kernels/melspec.py::frames_dmma_supports takes, TitaNet's among
// them: mel_frames_dmma_kernel, the DFT on the f64 tensor cores, the
// device function it shares with the fused kernel's f32 route
// (logmel_common.cuh::dmma_logmel_tile: the same frames give the same bits
// on both routes). At N = 128 x 301 frames the two products are ~17.4
// GFLOP, 0.26 ms on the FP32 cores at their peak; the DFT's 15.8 GFLOP take
// 0.236 ms on the f64 tensor cores at theirs. A block takes 64 frames and
// streams their taps [k0, k0 + taps) beside the basis, 16 taps of the 64
// rows a ring stage (16-byte cp.async), read again from L2 for each panel,
// so that two blocks fit an SM (84 KB of shared memory each at TitaNet's
// frontend; a resident 64-row f32 tile would take 105 KB).
//
// "highest" at any other geometry: mel_frames_kernel, the FP32-core device
// functions it shares with the fused kernel (logmel_common.cuh).
//
// "default" (bf16 operands, f32 accumulation): mel_frames_tc_kernel, on the
// bf16 tensor cores (csrc/mma_bf16.cuh: wgmma for the DFT, mma.sync for the
// mel product). Its bound on the H100 is bytes: 61.6 MB of frames taps read
// (f32) and 12.3 MB written at N = 38,528, ~0.022 ms, against ~17 GFLOP
// with the padding (~0.017 ms at 989 TFLOP/s). A block has one SM to
// itself (the frames tile takes half its shared memory), so with 8 warps
// the fixed cost of each pipeline step (waits, a barrier, address
// arithmetic) weighs as much as the products: the design makes the steps
// few and large. What it does:
// - One block per 128 frames (two warpgroups of 64 rows). The block reads
//   the frames' taps [k_lo, k_hi) (k_lo rounded down to 16 by the wrapper,
//   so a window skip only drops 16-tap product steps whose basis rows are
//   zero: the same bits as the full-width call) once with 16-byte loads
//   (eight in flight a thread), rounds them to bf16 into shared memory in
//   wgmma's K-major 128-byte-swizzled layout (rows and taps past the end
//   zero-filled), and keeps them there for the whole DFT.
// - The basis is rearranged once per (tensor, device) by the wrapper
//   (ops/kernels/melspec.py::tc_basis): panels of 128 bins, each 8-bin
//   group as 8 cos columns then its 8 sin columns, taps padded to a
//   multiple of 32 with zero rows. Bin 0's sin column is zero, so it
//   carries the Nyquist bin's cos column: 257 bins fill 2 panels, not 3.
//   Slabs of 32 taps x 256 columns (16 KB) stream through a cp.async ring
//   in wgmma's MN-major layout (4 stages, 3 at n_fft = 512 without the
//   window skip); the basis (0.4 MB) stays in L2 for every block, and
//   each block starts its walk at panel blockIdx % 2.
// - The DFT product: each warpgroup a 64 x 256 wgmma.m64n256k16 tile of f32
//   accumulators (26 steps of 32 taps for the TitaNet frontend), one
//   product group in flight while the next slab is awaited; a thread holds
//   re and im of the same bins.
// - Power, rounded once: re^2 + im^2 in f32 (no contraction), then one
//   rounding to bf16, as _mel_kernel's DEFAULT-precision dot rounds its f32
//   power (the fused kernel rounds re^2 and im^2 apart: not this one). The
//   power goes from the accumulators straight into mma.sync A fragments
//   (two 16 x 8 accumulator tiles are one 16 x 16 A tile), against the
//   filterbank, resident in shared memory; the mel sums stay in f32
//   registers across the panels. No power tile, no barrier for the mel.
// - Epilogue in registers: 10*log10(max(mel, 1e-10)), the L2 norm over the
//   n_mels by shuffles among the 4 lanes of a row, 16-byte stores after a
//   pair exchange; rows past N are never stored.
#include "logmel_common.cuh"
#include "mma_bf16.cuh"

namespace {

size_t smem_bytes(int taps, int n_fft, int n_mels) {
  const size_t tile = (size_t)kTileFrames * taps;
  const size_t db = (size_t)kTileFrames * n_mels;
  const size_t power = (size_t)kTileFrames * (n_fft / 2 + 1);
  return ((tile > db ? tile : db) + power) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads, 1) mel_frames_kernel(
    const float* __restrict__ frames,  // [N, n_fft]
    const float* __restrict__ basis,   // [2, n_fft, n_bins]: window*cos | window*sin
    const float* __restrict__ fb,      // [n_bins, n_mels]
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
    tile[i] = f < rows ? frames[(long long)(n0 + f) * n_fft + k_lo + k] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int fw = warp * kFramesPerWarp;
  const float* x = tile + fw * taps;
  float* pw = power + fw * n_bins;
  const float* cos_b = basis + (long long)k_lo * n_bins;
  const float* sin_b = cos_b + (long long)n_fft * n_bins;
  int j0 = 0;
  for (; j0 + 32 * kBinsPerLane <= n_bins; j0 += 32 * kBinsPerLane)
    dft_pass<float, kBinsPerLane>(x, taps, cos_b, sin_b, n_bins, j0 + lane, 0, taps, pw);
  for (; j0 + 32 <= n_bins; j0 += 32)
    dft_pass<float, 1>(x, taps, cos_b, sin_b, n_bins, j0 + lane, 0, taps, pw);
  for (; j0 < n_bins; ++j0)  // fewer than 32 bins left (the Nyquist bin)
    dft_bin_warp<float>(x, taps, cos_b, sin_b, n_bins, j0, 0, taps, pw, lane);
  __syncthreads();

  mel_db_l2_store<float>(power, tile, fb, n_bins, n_mels, out + (long long)n0 * n_mels, rows, rows);
}

// ------------------------------------------------- bf16 tensor-core design

using bf16 = __nv_bfloat16;
constexpr int kTcRows = 128;     // frames a block: two warpgroups of 64 rows
constexpr int kTcThreads = 256;  // 8 warps
constexpr int kSlab = 32;        // taps a basis slab
constexpr int kPanel = 256;      // basis columns a panel: 16 groups x (8 cos + 8 sin)
constexpr int kSlabElems = kSlab * kPanel;  // 16 KB, wgmma's MN-major layout (4 k groups)

// bytes: frames tile (64-tap panels of 128 rows), basis ring, filterbank
size_t tc_smem_bytes(int tpp, int kb, int n_mels, int stages) {
  return ((size_t)kTcRows * ((tpp + 63) / 64 * 64) + (size_t)stages * kSlabElems +
          (size_t)kb * (n_mels + tc::kPad)) *
         sizeof(bf16);
}

// basis: [n_panels][tpp][256]: panel p, tap t (frames column k_lo + t),
// column 16g + 8s + j: bin 128p + 8g + j of bins 0 .. n_bins - 2, cos (s = 0)
// or sin (s = 1); the sin column of bin 0 (zero) holds the cos column of
// the Nyquist bin n_bins - 1, whose sin column is the rounding residue of
// sin(pi t) (~1e-16 t) and is left out; zero past the taps and the bins.
// fb: [kb][n_mels], kb = n_panels * 128 + 16: rows of bins 0 .. n_bins - 2,
// then at n_panels * 128 the Nyquist bin's row; zero elsewhere.
template <int NTM, int STAGES>  // NTM = n_mels / 8
__global__ void __launch_bounds__(kTcThreads, 1) mel_frames_tc_kernel(
    const float* __restrict__ frames, const bf16* __restrict__ basis,
    const bf16* __restrict__ fb, float* __restrict__ out, int n_rows, int n_fft, int k_lo,
    int taps, int tpp, int n_groups) {
  constexpr int n_mels = NTM * 8;
  constexpr int mld = n_mels + tc::kPad;
  constexpr int AHEAD = STAGES - 2;  // slabs in flight; one product group reads a third stage
  extern __shared__ __align__(1024) unsigned char smem_raw[];  // wgmma tiles: 1 KB aligned
  bf16* fr_s = reinterpret_cast<bf16*>(smem_raw);              // [tpp / 64][128][64], swizzled
  bf16* ring = fr_s + kTcRows * ((tpp + 63) / 64 * 64);
  bf16* fb_s = ring + STAGES * kSlabElems;  // [kb][mld]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wgm = warp >> 2;
  const int n0 = blockIdx.x * kTcRows;
  const int rows = min(kTcRows, n_rows - n0);
  const int n_panels = (n_groups + 15) / 16;
  const int kb = n_panels * 128 + 16;
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
  for (int c = tid; c < kb * (n_mels / 8); c += kTcThreads) {
    const int r = c / (n_mels / 8), col = (c % (n_mels / 8)) * 8;
    tc::cp_async16(fb_s + r * mld + col, fb + (long long)r * n_mels + col);
  }
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < total) load_slab(s, s);
    tc::cp_async_commit();
  }

  // frames tile: warp w takes rows w, w + 8, ..., a lane 4 taps at a time;
  // two rows x four 16-byte loads in flight a thread
  {
    const bool vec = ((k_lo | n_fft) & 3) == 0;
    for (int r0 = warp; r0 < kTcRows; r0 += 16) {
      float4 v[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = r0 + 8 * h, k = (u * 32 + lane) * 4;
          v[h][u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r < rows && k < tpp) {
            const float* src = frames + (long long)(n0 + r) * n_fft + k_lo + k;
            if (vec && k + 4 <= taps) {
              v[h][u] = __ldg(reinterpret_cast<const float4*>(src));
            } else {
              if (k < taps) v[h][u].x = src[0];
              if (k + 1 < taps) v[h][u].y = src[1];
              if (k + 2 < taps) v[h][u].z = src[2];
              if (k + 3 < taps) v[h][u].w = src[3];
            }
          }
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = r0 + 8 * h, k = (u * 32 + lane) * 4;
          if (k < tpp) {
            __nv_bfloat162 b2[2] = {__floats2bfloat162_rn(v[h][u].x, v[h][u].y),
                                    __floats2bfloat162_rn(v[h][u].z, v[h][u].w)};
            *reinterpret_cast<uint2*>(fr_s + tc::sw128_a_offset<kTcRows>(r, k)) =
                *reinterpret_cast<const uint2*>(b2);
          }
        }
    }
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
  const bool wg_rows = rows > wgm * 64;  // uniform in the warpgroup
  const bool q0 = (lane & 3) == 0;       // this lane holds column 0 of its tiles
  for (int g = 0; g < total; ++g) {
    tc::cp_async_wait<AHEAD - 1>();
    tc::fence_proxy_async();  // this thread's copies and stores -> wgmma's reads
    __syncthreads();
    // the stage refilled here was read by the product group two slabs back,
    // which every warpgroup has waited for
    if (g + AHEAD < total) load_slab(g + AHEAD, (g + AHEAD) % STAGES);
    tc::cp_async_commit();
    if (!wg_rows) continue;
    const int i_panel = g / spp, ks = g - i_panel * spp;
    if (ks == 0)
#pragma unroll
      for (int q = 0; q < 128; ++q) acc[q] = 0.f;
    const bf16* slab = ring + (g % STAGES) * kSlabElems;
    tc::wgmma_fence();
#pragma unroll
    for (int k2 = 0; k2 < kSlab / 16; ++k2) {
      const int kk = ks * kSlab + k2 * 16;
      tc::wgmma_m64k16<kPanel>(
          acc, tc::wgmma_desc_a(fr_s + (kk >> 6) * (kTcRows * 64) + wgm * 4096 + (kk & 63)),
          tc::wgmma_desc_b(slab + k2 * 2 * 512, kSlab / 8));
    }
    tc::wgmma_commit();
    tc::wgmma_wait<1>();
    if (ks != spp - 1) continue;

    // The panel's power, rounded once to bf16, straight from the
    // accumulators into mma.sync A fragments: the power tiles of groups 2c
    // and 2c + 1 (16 x 8 each, the accumulator layout) are the A operand of
    // bins 16c .. 16c + 15 (a[0], a[1]: columns 2t, 2t + 1 of rows r, r + 8;
    // a[2], a[3]: 8 columns on). In panel 0, bin 0's sin slot holds the
    // Nyquist bin's cos: its power goes to a fragment of its own.
    tc::wgmma_wait<0>();
    const int panel = panel_of(i_panel);
    const int groups = min(16, n_groups - panel * 16);
    float nyq[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (2 * c >= groups) continue;
      uint32_t a[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int grp = 2 * c + half;
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float re = acc[4 * (2 * grp) + e];
          float im = acc[4 * (2 * grp + 1) + e];
          if (grp == 0 && panel == 0 && q0 && (e & 1) == 0) {
            nyq[e >> 1] = __fmul_rn(im, im);
            im = 0.f;
          }
          p[e] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
        }
        const __nv_bfloat162 lo = __floats2bfloat162_rn(p[0], p[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p[2], p[3]);
        a[2 * half] = *reinterpret_cast<const uint32_t*>(&lo);
        a[2 * half + 1] = *reinterpret_cast<const uint32_t*>(&hi);
      }
      const bf16* b = fb_s + (panel * 128 + 16 * c) * mld;
#pragma unroll
      for (int j = 0; j < NTM / 2; ++j) {
        uint32_t bf[4];
        tc::load_b<true>(bf, b + 16 * j, mld, lane);
        tc::mma_16816(macc[2 * j], a, bf[0], bf[1]);
        tc::mma_16816(macc[2 * j + 1], a, bf[2], bf[3]);
      }
    }
    if (panel == 0) {  // the Nyquist bin against its filterbank row (k = 0 of 16)
      const __nv_bfloat162 lo = __floats2bfloat162_rn(nyq[0], 0.f);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(nyq[1], 0.f);
      const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(&lo),
                             *reinterpret_cast<const uint32_t*>(&hi), 0u, 0u};
      const bf16* b = fb_s + n_panels * 128 * mld;
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

  // dB, L2 over the mels (the 4 lanes of a row), 16-byte stores
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
  const bool store = n0 + row < n_rows;
#pragma unroll
  for (int j = 0; j < NTM; ++j) {
    const float a0 = macc[j][0] / ss[0], a1 = macc[j][1] / ss[0];
    const float b0 = macc[j][2] / ss[1], b1 = macc[j][3] / ss[1];
    const float rx = __shfl_xor_sync(0xffffffffu, even ? b0 : a0, 1);
    const float ry = __shfl_xor_sync(0xffffffffu, even ? b1 : a1, 1);
    const int col = j * 8 + tc::frag_col(lane) - (even ? 0 : 2);
    if (store)
      *reinterpret_cast<float4*>(out + (long long)(n0 + row) * n_mels + col) =
          even ? make_float4(a0, a1, rx, ry) : make_float4(rx, ry, b0, b1);
  }
}

template <int NTM, int STAGES>
int launch_tc(const float* frames, int n_rows, const bf16* basis, const bf16* fb, float* out,
              int n_fft, int k_lo, int taps, int tpp, int n_groups, cudaStream_t st) {
  const size_t smem = tc_smem_bytes(tpp, (n_groups + 15) / 16 * 128 + 16, NTM * 8, STAGES);
  cudaError_t err = cudaFuncSetAttribute(mel_frames_tc_kernel<NTM, STAGES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_rows + kTcRows - 1) / kTcRows;
  mel_frames_tc_kernel<NTM, STAGES><<<grid, kTcThreads, smem, st>>>(
      frames, basis, fb, out, n_rows, n_fft, k_lo, taps, tpp, n_groups);
  return (int)cudaGetLastError();
}

// the deepest basis ring that fits shared memory (ops/kernels/melspec.py::tc_stages)
template <int NTM>
int launch_tc_fit(const float* frames, int n_rows, const bf16* basis, const bf16* fb, float* out,
                  int n_fft, int k_lo, int taps, int tpp, int n_groups, cudaStream_t st) {
  const int kb = (n_groups + 15) / 16 * 128 + 16;
  auto fits = [&](int s) { return tc_smem_bytes(tpp, kb, NTM * 8, s) <= (size_t)kMaxSmem; };
  if (fits(4))
    return launch_tc<NTM, 4>(frames, n_rows, basis, fb, out, n_fft, k_lo, taps, tpp, n_groups, st);
  if (fits(3))
    return launch_tc<NTM, 3>(frames, n_rows, basis, fb, out, n_fft, k_lo, taps, tpp, n_groups, st);
  return (int)cudaErrorInvalidValue;
}

// ----------------------------------------------- f64 tensor-core design

// frames: [n_rows, n_fft] f32; basis, fb, fb_table: the packs of
// dmma_logmel_tile (taps from k0)
template <int NTM>
__global__ void __launch_bounds__(kDmThreads, 2) mel_frames_dmma_kernel(
    const float* __restrict__ frames, int n_rows, int n_fft, int k0, int taps,
    const double* __restrict__ basis, const float* __restrict__ fb, const int* __restrict__ fb_table,
    int n_walk, float* __restrict__ out, int steps, int n_panels) {
  extern __shared__ __align__(16) double dm_smem[];
  double* ring = dm_smem;                                            // [kDmStages][kDmStage]
  float* x = reinterpret_cast<float*>(ring + kDmStages * kDmStage);  // [kDmStages][kDmRows][stride]
  constexpr int stride = 8 * kDmSteps + kDmPad;
  int* table_s = reinterpret_cast<int*>(x + kDmStreamFloats);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kDmRows, rows = min(kDmRows, n_rows - n0);
  const int spp = steps / kDmSteps;
  for (int i = tid; i < 2 * n_walk; i += kDmThreads) table_s[i] = fb_table[i];
  // walk stage i: the rows' taps 8 kDmSteps (i % spp) .., 4 at a time
  // (chunk c: row c / (2 kDmSteps)), into slot i % kDmStages; zero past the
  // taps and the rows
  constexpr int kChunks = 2 * kDmSteps;  // 4-tap chunks of a row a stage
  const bool vec = ((n_fft | k0) & 3) == 0 && (reinterpret_cast<uintptr_t>(frames) & 15) == 0;
  dmma_logmel_tile<NTM, true>(
      x, stride, 1 << 30, ring, table_s, n_walk, basis, fb, steps, n_panels, [] {},
      [&](int i) {
        float* slot = x + (i % kDmStages) * (kDmRows * stride);
        const int kb = 8 * kDmSteps * (i % spp);
        for (int c = tid; c < kDmRows * kChunks; c += kDmThreads) {
          const int r = c / kChunks, kc = 4 * (c % kChunks), k = kb + kc;
          const float* src = frames + (long long)(n0 + r) * n_fft + k0 + k;  // read for rows < rows only
          float* dst = slot + r * stride + kc;
          const int n_valid = r < rows ? max(0, min(4, taps - k)) : 0;
          if (vec) {
            tc::cp_async16_zfill(dst, n_valid ? src : frames, 4 * n_valid);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) dst[e] = e < n_valid ? src[e] : 0.f;
          }
        }
      },
      out + (long long)n0 * (NTM * 8), rows, rows);
}

template <int NTM>
int launch_dmma(const float* frames, int n_rows, int n_fft, int k0, int taps, const double* basis,
                const float* fb, const int* fb_table, int n_walk, float* out, int steps,
                int n_panels, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(mel_frames_dmma_kernel<NTM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_rows + kDmRows - 1) / kDmRows;
  mel_frames_dmma_kernel<NTM><<<grid, kDmThreads, smem, st>>>(
      frames, n_rows, n_fft, k0, taps, basis, fb, fb_table, n_walk, out, steps, n_panels);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int titanet_mel_frames_f32(const void* frames, int n_rows, const void* basis, const void* fb,
                           void* out, int n_fft, int k_lo, int k_hi, int n_mels,
                           void* stream) {
  if (n_rows < 1 || k_lo < 0 || k_hi > n_fft || k_hi <= k_lo) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(k_hi - k_lo, n_fft, n_mels);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mel_frames_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_rows + kTileFrames - 1) / kTileFrames;
  mel_frames_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)frames, (const float*)basis, (const float*)fb, (float*)out, n_rows, n_fft,
      k_lo, k_hi, n_mels);
  return (int)cudaGetLastError();
}

// "highest" with the DFT on the f64 tensor cores: basis, fb and fb_table
// ([2, n_walk] int32) from ops/kernels/melspec.py::dmma_basis and
// dmma_filterbank, taps [k0, k0 + taps) of each frame, n_mels 80
// (TitaNet's); a block's shared memory must fit (melspec.py::
// frames_dmma_supports)
int titanet_mel_frames_dmma(const void* frames, int n_rows, const void* basis, const void* fb,
                            const void* fb_table, int n_walk, void* out, int n_fft, int k0,
                            int taps, int n_bins, int n_mels, void* stream) {
  const int steps = ((taps + 7) / 8 + kDmSteps - 1) / kDmSteps * kDmSteps;
  const int n_panels = ((n_bins - 1 + 7) / 8 + 7) / 8;
  if (n_rows < 1 || k0 < 0 || taps < 1 || k0 + taps > n_fft || n_bins < 2 || n_mels != 80 ||
      n_walk != n_panels * 8 + 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = dmma_smem_bytes(kDmStreamFloats, n_walk);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  return launch_dmma<10>((const float*)frames, n_rows, n_fft, k0, taps, (const double*)basis,
                         (const float*)fb, (const int*)fb_table, n_walk, (float*)out, steps,
                         n_panels, smem, (cudaStream_t)stream);
}

// basis and fb in the layout of mel_frames_tc_kernel; taps from k_lo on,
// n_mels 80 (TitaNet's)
int titanet_mel_frames_bf16(const void* frames, int n_rows, const void* basis, const void* fb,
                            void* out, int n_fft, int k_lo, int taps, int n_bins, int n_mels,
                            void* stream) {
  const int tpp = (taps + kSlab - 1) / kSlab * kSlab;
  if (n_rows < 1 || k_lo < 0 || taps < 1 || k_lo + taps > n_fft || tpp > 512 || n_bins < 2 ||
      n_mels != 80)
    return (int)cudaErrorInvalidValue;
  return launch_tc_fit<10>((const float*)frames, n_rows, (const bf16*)basis, (const bf16*)fb,
                           (float*)out, n_fft, k_lo, taps, tpp, (n_bins - 1 + 7) / 8,
                           (cudaStream_t)stream);
}

const char* titanet_mel_frames_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
