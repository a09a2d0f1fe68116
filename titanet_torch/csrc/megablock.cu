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
// f32, rounded to the activation type before the product; the product
// with f32 accumulation; bias, affine and relu in f32, rounded to that type
// as the next stage's input. Only the kernel's INPUT is zero outside [0, T): the
// stages are evaluated on the halo rows too and not re-zeroed there, so
// the first and last (S-1)*pad output rows differ from a chain of
// zero-padded convolutions, exactly as in the kernel this replaces.
//
// Bound on the H100: operations. One call at B=128, T=301, C=256, k=3, S=3
// is 2*B*T*S*(C*C + C*k) = 15.3 GFLOP against 2 x 19.7 MB (bf16) of
// activations and 0.4 MB of weights: 0.0155 ms at the bf16 tensor-core
// rate, 0.229 ms in f32 on the FP32 cores. The f32 route's split products
// (below) do three times the product's operations on the TF32 tensor cores:
// 45.4 GFLOP at 495 TFLOP/s plus 0.3 GFLOP of depthwise and epilogue at
// 67 TFLOP/s, 0.096 ms.
//
// What the card forces. The TPU kernel keeps all S*C*C pointwise weights
// resident in its fast memory; they do not fit a block's shared memory here
// (384 KB in bf16 at C=256), so the roles are swapped in both designs below:
// the ACTIVATION tile of one utterance stays resident in shared memory
// through all S stages, zero where a row is outside [0, T), and the weights
// stream from L2 in slabs. tb = RM - 2*pad*(S-1) output rows a tile, so that
// the largest stage output is RM rows; the halo rows (S*pad a side) are
// computed again by the neighbouring tile.
//
// bf16 at C = 128, 256 and 512: the tensor-core design (megablock_tc_kernel
// further down, with the wgmma product at C = 256 and 512 and the mma.sync
// product at C = 128). What bounds it: a block's products are RM x C x C,
// and every block streams all S*C*C weights from L2, so RM sets the
// operations per weight byte; between the products the CUDA-core passes
// (depthwise, epilogue) and the barriers of the weight pipeline leave the
// tensor cores waiting. What the design does:
//   - the tile is bf16 in two buffers: the depthwise pass writes the
//     product's A operand, the epilogue writes the next stage's input, so no
//     warp waits for the others between its K loop and its epilogue and the
//     output columns can be chunked with the accumulators in registers;
//   - the depthwise pass uses every thread (a channel pair over 8 rows each,
//     the taps of k = 3, 7, 11 unrolled over rows held in registers);
//   - the weight slabs come through a ring of cp.async stages that runs
//     across column chunks and stages, so copies are in flight during the
//     arithmetic, the epilogue and the depthwise pass;
//   - at C = 256 and 512 the products are wgmma.m64nNk16: four (C = 256, 128
//     rows) or two (C = 512, 64 rows) warpgroups, each a 64 x 128 or 64 x 256
//     part, both operands read from 128-byte-swizzled shared memory through
//     descriptors, one group of products in flight while the next slab is
//     awaited and its copies started. Against mma.sync this cuts the shared-
//     memory reads a product 2.4x and the instruction slots of the K loop;
//   - C = 128 (too narrow for two column parts of 128) runs
//     mma.sync.m16n8k16 from ldmatrix fragments, the next step's fragments
//     loaded before this step's products start (mma_bf16.cuh).
//
// f32 at C = 128, 256 and 512, the parity surface: the same kernel
// (megablock_tc_kernel, its element type float) with the products on the
// tensor cores as split TF32 ("3xTF32"). On the FP32 cores a product is
// bound by 2*B*T*S*C*C operations at 67 TFLOP/s (0.229 ms at TitaNet-S's
// serving shape). What the design does:
//   - each operand is split in registers into hi = rna.tf32(x) and
//     lo = rna.tf32(x - hi), and a k8 step adds a_lo*b_hi, a_hi*b_lo
//     and a_hi*b_hi (mma.sync.m16n8k8.tf32, f32 accumulation): each term
//     keeps about 21 bits, the error of an f32 product, not TF32's 10 (the
//     card's counterpart of how the TPU computes an f32 product, in several
//     bf16 passes). The three passes run over all of a warp's tiles in turn,
//     so consecutive mma.sync are independent;
//   - A (the depthwise output) and the weight slabs are f32 in padded
//     shared memory (A rows C + 4 floats, slab rows NC + 8), so the 32
//     words of a fragment fall into 32 banks; the weights keep the (in,
//     out) layout the bf16 route reads;
//   - the ring of cp.async slabs, the depthwise pass on every thread (taps
//     in order, fmaf, as the plain version sums them) and the two
//     activation buffers are the bf16 route's, with f32 elements;
//   - the bound it obeys: 3 x 2*B*T*S*C*C operations at 495 TFLOP/s (TF32)
//     plus the depthwise and epilogue passes at 67 TFLOP/s.
// Two f32 buffers of RM rows hold fewer rows a tile than bf16's: RM = 64
// at C = 128, 80 at 256; at C = 512 one buffer in place holds 64 (the
// depthwise output written over the stage's input in waves, the product's
// over the depthwise output once every warp has read it).
//
// C = 1024 (TitaNet-L), bf16 and f32: the cluster design
// (megablock_cluster_kernel; ClCfg in f32, ClWgCfg in bf16). Its bound at
// B=128, T=301, k = 11, S = 3 is operations: 242.4 GFLOP of products, 0.248
// ms at the bf16 tensor-core rate; in f32 three times that at the TF32 rate
// plus 3.2 GFLOP of depthwise and epilogue on the FP32 cores, 1.517 ms.
// What bounds a block that holds all C
// channels: a row is 2 KB in bf16 and 4 KB in f32, so two buffers fit 32
// rows, a tile at k = 11, S = 3 is 12 output rows of 32, 2.67x of the
// arithmetic is done again on halo rows, and each of the 3328 blocks of a
// B=128, T=301 call streams all S*C*C weights from L2 (21 GB in bf16, 42 GB
// in f32). What the design does:
//   - a cluster of N blocks (8 in f32, 4 in bf16) shares one time tile of
//     RM = 128 rows, 108 output rows at k = 11 (1.19x halo work); block q
//     holds channels [q*C/N, (q+1)*C/N) of the activation buffers, so a
//     block's shared memory holds 128 rows (f32: two buffers, ClCfg; bf16:
//     one, in place, ClWgCfg);
//   - the depthwise pass is channel by channel, so it stays local;
//   - the product is split by output columns: block q computes
//     out[:, cols_q] = A[:, 0:C] @ W[:, cols_q]. A's K chunks (KC columns)
//     come from their owners' depthwise buffers through distributed shared
//     memory: each thread loads its part of the next chunk into registers
//     while the warps multiply this one, then stores it into a local ring
//     of chunk slots, so ldmatrix, the split loads and wgmma read only the
//     block's own shared memory. A block walks the chunks in a fixed order
//     from its own first chunk on (the blocks read from distinct owners at
//     once; two calls give the same bits);
//   - W[:, cols_q] streams through the block's own ring of cp.async slabs
//     (KC rows), as in the designs above: a cluster reads each weight once
//     a tile, 2.4 GB (bf16) or 4.8 GB (f32) from L2 a call;
//   - two cluster barriers a stage: after the depthwise pass (the peers may
//     read dw) and after the products (no peer reads dw any more; in f32
//     the stage's output is then whole before the next depthwise pass reads
//     it, in bf16 the epilogue may then write over the one buffer);
//   - the products: f32 3xTF32 on mma.sync.m16n8k8, split in registers, as
//     above; bf16 wgmma.m64n256k16 from a chunk of 64 columns (one 128-byte
//     swizzled panel) and 64-row weight slabs, for which the one buffer in
//     place makes room (two buffers fit only 32-column chunks, and mma.sync
//     on them took 1.70 ms against wgmma's 1.20).
// A cluster launch that does not fit (shared memory, or no cluster of N
// blocks on the card's SMs) is refused by cudaLaunchKernelEx and its error
// returned; no other kernel runs instead.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kMaxSmem = 232448;
// The element type of the activations and the pointwise weights: elements
// of a 16-byte copy, two neighbours read as f32 and written rounded to it.
template <class T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};
template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

// ------------------------------ tensor-core design: bf16, and f32 as 3xTF32
//
// Activations live in shared memory in the element type Cfg::T (bf16, or
// f32 for the split-TF32 product). Two buffers: `in` holds a stage's input
// (RM + 2*pad rows, padded for 16-byte row offsets), `dw` the
// depthwise output (at most RM rows), which is the product's A operand; the
// epilogue writes the stage's output back into `in`. The product reads one
// buffer and writes the other, so no warp waits for the others between its K
// loop and its epilogue, and the output columns can be computed in chunks of
// NC with the f32 accumulators in registers. pw_w[s] streams from L2 in
// slabs of KS rows x NC columns through a ring of NST shared-memory stages
// filled by cp.async; the ring runs across column chunks and stages, so the
// next stage's first slabs land during the epilogue and the depthwise pass.
//
// One kernel, megablock_tc_kernel<Cfg>, holds the ring, the barriers, the
// depthwise pass and the epilogue. Cfg names the element type and the tile
// and brings the product: the layouts of `dw` and of a weight slab
// (dw_offset, slab_offset), how many slabs are in flight beyond the one
// being multiplied (AHEAD), and Cfg::Product, a thread's accumulators with
//   zero()                      before a column chunk;
//   publish()                   before the slab's barrier;
//   multiply(dw, slab, ks, rows)  acc += dw[:, ks*KS ..] @ slab;
//   finish()                    after the chunk's last slab;
//   row(i), col(j), value(i, j) the accumulator pair at (row(i), col(j) + {0, 1})
//                               of the RM x NC chunk, i < ROWS, j < COLS.

// mma.sync.m16n8k16 from ldmatrix fragments: WM x WN warps, each a WTM x WTN
// part of the chunk. `dw` and the slabs have padded rows (mma_bf16.cuh).
template <int C_, int RM_, int NC_, int WM_, int WN_, int KS_, int NST_, int MINB_>
struct TcCfg {
  using T = __nv_bfloat16;
  static constexpr bool IN_PLACE = false;
  static constexpr int C = C_, RM = RM_, NC = NC_, WM = WM_, WN = WN_, KS = KS_, NST = NST_;
  static constexpr int CH = C;  // channels a block holds
  static constexpr int MINB = MINB_;
  static constexpr int NTHR = WM * WN * 32;
  static constexpr int WTM = RM / WM, WTN = NC / WN;  // a warp's tile of the product
  static constexpr int MT = WTM / 16, NT = WTN / 8;
  static constexpr int LDA = C + tc::kPad;   // activation row stride
  static constexpr int LDW = NC + tc::kPad;  // weight slab row stride
  static constexpr int SLAB = KS * LDW;      // elements of a ring stage
  static constexpr int DW_ELEMS = RM * LDA;
  static constexpr int AHEAD = NST - 1;  // a slab is consumed when its call returns
  static_assert(WTM % 16 == 0 && WTN % 16 == 0 && C % NC == 0 && C % KS == 0 && KS % 16 == 0 &&
                    NST >= 2, "tile geometry");
  static __device__ __forceinline__ int dw_offset(int r, int c) { return r * LDA + c; }
  static __device__ __forceinline__ int slab_offset(int r, int c) { return r * LDW + c; }

  struct Product {
    static constexpr int ROWS = 2 * MT, COLS = NT;
    float acc[MT][NT][4];
    const int lane, wm, wn;
    __device__ __forceinline__ Product(int warp, int lane_)
        : lane(lane_), wm(warp / WN), wn(warp % WN) {}
    __device__ __forceinline__ void zero() { tc::zero_acc(acc); }
    static __device__ __forceinline__ void publish() {}
    __device__ __forceinline__ void multiply(const __nv_bfloat16* dw, const __nv_bfloat16* slab,
                                             int ks, int rows) {
      tc::warp_mma<MT, NT, KS, false, true>(acc, dw + wm * WTM * LDA + ks * KS, LDA,
                                            slab + wn * WTN, LDW, lane, rows - wm * WTM);
    }
    static __device__ __forceinline__ void finish() {}
    // rows >= `rows` (skipped m tiles hold zeros) are in the range too: no
    // row that is stored reads them
    __device__ __forceinline__ int row(int i) const {
      return wm * WTM + (i >> 1) * 16 + (i & 1) * 8 + tc::frag_row(lane);
    }
    __device__ __forceinline__ int col(int j) const {
      return wn * WTN + j * 8 + tc::frag_col(lane);
    }
    __device__ __forceinline__ float2 value(int i, int j) const {
      return make_float2(acc[i >> 1][j][(i & 1) * 2], acc[i >> 1][j][(i & 1) * 2 + 1]);
    }
  };
};

// wgmma.m64nNk16: WGM x 2 warpgroups over RM = 64 * WGM rows, each a 64 x NC/2
// part of the chunk, both operands read from shared memory through
// descriptors. `dw` is in wgmma's K-major 128-byte-swizzled layout, the
// weight slabs in its MN-major one (mma_bf16.cuh). One group of products
// stays in flight while the next slab is awaited, so a slab is consumed one
// call later than it is multiplied.
template <int C_, int WGM_, int NC_, int KS_, int NST_, int MINB_>
struct WgCfg {
  using T = __nv_bfloat16;
  static constexpr bool IN_PLACE = false;
  static constexpr int C = C_, WGM = WGM_, RM = 64 * WGM, NC = NC_, KS = KS_, NST = NST_;
  static constexpr int CH = C;  // channels a block holds
  static constexpr int MINB = MINB_;
  static constexpr int NTHR = 256 * WGM;  // WGM x 2 warpgroups
  static constexpr int NW = NC / 2;       // columns of a warpgroup
  static constexpr int LDA = C + tc::kPad;
  static constexpr int SLAB = KS * NC;  // elements of a ring stage
  static constexpr int KG = KS / 8;     // 8-row groups of a slab
  static constexpr int DW_ELEMS = RM * C;  // C/64 panels of [RM][64]
  static constexpr int AHEAD = NST - 2;
  static_assert((NW == 128 || NW == 256) && C % NC == 0 && C % KS == 0 && KS % 16 == 0 &&
                    C % 64 == 0 && NST >= 3, "tile geometry");
  static __device__ __forceinline__ int dw_offset(int r, int c) {
    return tc::sw128_a_offset<RM>(r, c);
  }
  static __device__ __forceinline__ int slab_offset(int r, int c) {
    return tc::sw128_b_offset(r, c, KG);
  }

  struct Product {
    static constexpr int ROWS = 2, COLS = NW / 8;
    float acc[NW / 2];
    const int lane, wg, wgm, w4;  // warpgroup: column half, 64-row part; its warp (16 rows)
    __device__ __forceinline__ Product(int warp, int lane_)
        : lane(lane_), wg((warp >> 2) & 1), wgm(warp >> 3), w4(warp & 3) {}
    __device__ __forceinline__ void zero() {
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    }
    // this thread's dw rows and weight copies, for wgmma's reads
    static __device__ __forceinline__ void publish() { tc::fence_proxy_async(); }
    __device__ __forceinline__ void multiply(const __nv_bfloat16* dw, const __nv_bfloat16* slab,
                                             int ks, int rows) {
      const __nv_bfloat16* part = slab + wg * (NW / 64) * KG * 512;
      tc::wgmma_fence();
#pragma unroll
      for (int k2 = 0; k2 < KS / 16; ++k2) {
        const int kk = ks * KS + k2 * 16;
        tc::wgmma_m64k16<NW>(
            acc, tc::wgmma_desc_a(dw + (kk >> 6) * (RM * 64) + wgm * 4096 + (kk & 63)),
            tc::wgmma_desc_b(part + k2 * 2 * 512, KG));
      }
      tc::wgmma_commit();
      tc::wgmma_wait<1>();  // the slab before is read; this one multiplies on
    }
    static __device__ __forceinline__ void finish() { tc::wgmma_wait<0>(); }
    __device__ __forceinline__ int row(int i) const {
      return wgm * 64 + w4 * 16 + i * 8 + tc::frag_row(lane);
    }
    __device__ __forceinline__ int col(int j) const {
      return wg * NW + j * 8 + tc::frag_col(lane);
    }
    __device__ __forceinline__ float2 value(int i, int j) const {
      return make_float2(acc[j * 4 + i * 2], acc[j * 4 + i * 2 + 1]);
    }
  };
};

// f32: mma.sync.m16n8k8 on TF32 operands split as hi + lo ("3xTF32").
// Fragment layout (lane = threadIdx.x % 32, g = lane / 4, t = lane % 4):
// A (16 x 8, "row") a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// B (8 x 8, "col") b0 (k = t, n = g), b1 (k = t + 4, n = g); the accumulator
// as m16n8k16's (tc::frag_row, tc::frag_col).

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: what cvt.rna.tf32.f32 gives for every finite x, on the integer pipe
// (add half of the dropped 13 bits' unit to the magnitude, clear them). The
// conversion instruction is slower: the same kernel with it took 0.4876 ms
// against 0.4366 at TitaNet-S's serving shape (ops/kernels/megablock_sweep.py;
// NVIDIA H100 80GB HBM3, 700 W).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
// x = hi + lo + (x - hi - lo), hi and lo TF32; x - hi is exact in f32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
// d += a (16 x 8 tf32, row) * b (8 x 8 tf32, col), f32 accumulation
__device__ __forceinline__ void mma_1688_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's acc[MT][NT] (16 x 8 tiles) += A (MT*16 x DEPTH, [m][k], row
// stride lda) * B (DEPTH x NT*8, [k][n], row stride ldb), f32 in shared
// memory, DEPTH a multiple of 8. Each k8 step loads the fragments as words,
// splits them, and adds a_lo*b_hi, then a_hi*b_lo, then a_hi*b_hi over all
// tiles (each pass's products independent of each other). m tiles whose first
// row is >= m_rows are skipped (warp-uniform).
template <int MT, int NT, int DEPTH>
__device__ __forceinline__ void warp_mma_3xtf32(float (&acc)[MT][NT][4], const float* a, int lda,
                                                const float* b, int ldb, int lane, int m_rows) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < DEPTH; kk += 8) {
    uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i * 16 < m_rows) {
        const float* p = a + (i * 16 + g) * lda + kk + t;
        split_tf32(p[0], ah[i][0], al[i][0]);
        split_tf32(p[8 * lda], ah[i][1], al[i][1]);
        split_tf32(p[4], ah[i][2], al[i][2]);
        split_tf32(p[8 * lda + 4], ah[i][3], al[i][3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* q = b + (kk + t) * ldb + j * 8 + g;
      split_tf32(q[0], bh[j][0], bl[j][0]);
      split_tf32(q[4 * ldb], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (i * 16 < m_rows)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_1688_tf32(acc[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (i * 16 < m_rows)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_1688_tf32(acc[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (i * 16 < m_rows)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_1688_tf32(acc[i][j], ah[i], bh[j][0], bh[j][1]);
  }
}

// The f32 tile: WM x WN warps, each a WTM x WTN part of the RM x NC chunk.
// `dw` rows are C + 4 floats (an A fragment's word (g, t) in bank 4g + t),
// slab rows NC + 8 (a B fragment's word (t, g) in bank 8t + g). IN_PLACE:
// one activation buffer; the depthwise pass writes A over the stage's input
// and the product's epilogue writes over A after every warp has read it, so
// all C output columns are one chunk (NC = C) held in registers.
template <int C_, int RM_, int NC_, int WM_, int WN_, int KS_, int NST_, int MINB_,
          bool IN_PLACE_ = false>
struct Tf32Cfg {
  using T = float;
  static constexpr bool IN_PLACE = IN_PLACE_;
  static constexpr int C = C_, RM = RM_, NC = NC_, WM = WM_, WN = WN_, KS = KS_, NST = NST_;
  static constexpr int CH = C;  // channels a block holds
  static constexpr int MINB = MINB_;
  static constexpr int NTHR = WM * WN * 32;
  static constexpr int WTM = RM / WM, WTN = NC / WN;  // a warp's tile of the product
  static constexpr int MT = WTM / 16, NT = WTN / 8;
  static constexpr int LDA = C + 4;   // activation row stride (floats)
  static constexpr int LDW = NC + 8;  // weight slab row stride
  static constexpr int SLAB = KS * LDW;
  static constexpr int DW_ELEMS = IN_PLACE ? 0 : RM * LDA;
  static constexpr int AHEAD = NST - 1;  // a slab is consumed when its call returns
  static_assert(WTM % 16 == 0 && WTN % 8 == 0 && C % NC == 0 && C % KS == 0 && KS % 8 == 0 &&
                    RM % 8 == 0 && NST >= 2 && (!IN_PLACE || NC == C), "tile geometry");
  static __device__ __forceinline__ int dw_offset(int r, int c) { return r * LDA + c; }
  static __device__ __forceinline__ int slab_offset(int r, int c) { return r * LDW + c; }

  struct Product {
    static constexpr int ROWS = 2 * MT, COLS = NT;
    float acc[MT][NT][4];
    const int lane, wm, wn;
    __device__ __forceinline__ Product(int warp, int lane_)
        : lane(lane_), wm(warp / WN), wn(warp % WN) {}
    __device__ __forceinline__ void zero() { tc::zero_acc(acc); }
    static __device__ __forceinline__ void publish() {}
    __device__ __forceinline__ void multiply(const float* dw, const float* slab, int ks, int rows) {
      warp_mma_3xtf32<MT, NT, KS>(acc, dw + wm * WTM * LDA + ks * KS, LDA, slab + wn * WTN, LDW,
                                  lane, rows - wm * WTM);
    }
    static __device__ __forceinline__ void finish() {}
    // as TcCfg::Product: rows >= `rows` hold values no stored row reads
    __device__ __forceinline__ int row(int i) const {
      return wm * WTM + (i >> 1) * 16 + (i & 1) * 8 + tc::frag_row(lane);
    }
    __device__ __forceinline__ int col(int j) const {
      return wn * WTN + j * 8 + tc::frag_col(lane);
    }
    __device__ __forceinline__ float2 value(int i, int j) const {
      return make_float2(acc[i >> 1][j][(i & 1) * 2], acc[i >> 1][j][(i & 1) * 2 + 1]);
    }
  };
};

// the address of `p` (this block's shared memory) in block `rank` of the
// cluster, and a 16-byte load from such an address (distributed shared
// memory)
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(tc::smem_addr(p)), "r"(rank));
  return out;
}
__device__ __forceinline__ uint4 ld_cluster16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// The cluster design (C = 1024): a cluster of N blocks on one time tile of
// RM rows, block q holding channels [q*CH, (q+1)*CH), CH = C/N, of both
// activation buffers (`in`, RM + 2*pad rows, and `dw`, RM rows; rows CH + 4
// floats or CH + 8 bf16). The product of a stage, out[:, cols_q] =
// dw[:, 0:C] @ pw_w[s][:, cols_q], runs over C/KC chunks of K: chunk j of
// block q is K columns [kk, kk + KC), kk = ((j + q*CH/KC) mod C/KC) * KC,
// copied from its owner's dw into a local slot of RM x (KC + pad) and
// multiplied with a weight slab of KC x CH (rows CH + 8) from the ring. WM
// x WN warps, each a WTM x WTN part of the RM x CH output; f32 multiplies
// with 3xTF32 mma.sync.m16n8k8, bf16 with mma.sync.m16n8k16 from ldmatrix
// fragments (the bf16 route runs ClWgCfg below; megablock_sweep times this
// form against it). The padding puts a fragment's words or ldmatrix rows in
// distinct banks, as in TcCfg and Tf32Cfg.
template <class T_, int C_, int N_, int RM_, int WM_, int WN_, int KC_, int NST_>
struct ClCfg {
  using T = T_;
  static constexpr bool IN_PLACE = false;
  static constexpr bool F32 = sizeof(T_) == 4;
  static constexpr int C = C_, N = N_, CH = C_ / N_, RM = RM_, WM = WM_, WN = WN_, KC = KC_,
                       NST = NST_;
  static constexpr int NTHR = WM * WN * 32;
  static constexpr int WTM = RM / WM, WTN = CH / WN;  // a warp's tile of the product
  static constexpr int MT = WTM / 16, NT = WTN / 8;
  static constexpr int PAD = F32 ? 4 : tc::kPad;
  static constexpr int LDA = CH + PAD;  // in and dw rows
  static constexpr int LDK = KC + PAD;  // chunk slot rows
  static constexpr int LDW = CH + 8;    // weight slab rows
  static constexpr int SLAB = KC * LDW, CHUNK = RM * LDK;
  static constexpr int SLOTS = 2;      // chunk slots: a chunk is multiplied before its call returns
  static constexpr int NK = C / KC;    // chunks of a stage's K loop
  static constexpr int CPB = CH / KC;  // chunks a block owns
  static constexpr int AHEAD = NST - 1;
  static constexpr int VEC = 16 / (int)sizeof(T_);            // elements of a 16-byte copy
  static constexpr int COPIES = RM * (KC / VEC) / NTHR;  // 16-byte copies a thread a chunk
  static_assert(C % N == 0 && CH % KC == 0 && KC % 16 == 0 && WTM % 16 == 0 && WTN % 16 == 0 &&
                    RM % 16 == 0 && NST >= 2 && N >= 2 && N <= 8 && COPIES >= 1 &&
                    (RM * (KC / VEC)) % NTHR == 0,
                "tile geometry");
  static __device__ __forceinline__ int dw_offset(int r, int c) { return r * LDA + c; }
  static __device__ __forceinline__ int chunk_offset(int r, int c) { return r * LDK + c; }
  static __device__ __forceinline__ int slab_offset(int r, int c) { return r * LDW + c; }

  struct Product {
    static constexpr int ROWS = 2 * MT, COLS = NT;
    float acc[MT][NT][4];
    const int lane, wm, wn;
    __device__ __forceinline__ Product(int warp, int lane_)
        : lane(lane_), wm(warp / WN), wn(warp % WN) {}
    __device__ __forceinline__ void zero() { tc::zero_acc(acc); }
    static __device__ __forceinline__ void publish() {}
    static __device__ __forceinline__ void finish() {}
    // acc += chunk (RM x KC, rows LDK) @ slab (KC x CH, rows LDW), both in
    // this block's shared memory
    __device__ __forceinline__ void multiply(const T* chunk, const T* slab, int rows) {
      if constexpr (F32)
        warp_mma_3xtf32<MT, NT, KC>(acc, chunk + wm * WTM * LDK, LDK, slab + wn * WTN, LDW, lane,
                                    rows - wm * WTM);
      else
        tc::warp_mma<MT, NT, KC, false, true>(acc, chunk + wm * WTM * LDK, LDK, slab + wn * WTN,
                                              LDW, lane, rows - wm * WTM);
    }
    // as TcCfg::Product: rows >= `rows` hold values no stored row reads
    __device__ __forceinline__ int row(int i) const {
      return wm * WTM + (i >> 1) * 16 + (i & 1) * 8 + tc::frag_row(lane);
    }
    __device__ __forceinline__ int col(int j) const {
      return wn * WTN + j * 8 + tc::frag_col(lane);
    }
    __device__ __forceinline__ float2 value(int i, int j) const {
      return make_float2(acc[i >> 1][j][(i & 1) * 2], acc[i >> 1][j][(i & 1) * 2 + 1]);
    }
  };
};

// The cluster design with wgmma (bf16): as ClCfg, but the block holds one
// activation buffer, in place (the depthwise pass writes over the stage's
// input in waves; the products' accumulators wait in registers until every
// peer has read the buffer, then the epilogue writes over it), so that a
// chunk of KC = 64 columns (one 128-byte swizzled panel, wgmma's K-major
// layout) and 64-row weight slabs (its MN-major layout) fit. Two 64-row
// warpgroups a column part, WGN column parts of NW = CH/WGN columns,
// wgmma.m64nNWk16 from both operands in shared memory; one group of
// products stays in flight while the next chunk is awaited, so a chunk slot
// and a ring stage are consumed one step later than they are multiplied
// (three chunk slots, AHEAD = NST - 2).
template <int C_, int N_, int WGN_, int NST_>
struct ClWgCfg {
  using T = __nv_bfloat16;
  static constexpr bool IN_PLACE = true;
  static constexpr bool F32 = false;
  static constexpr int C = C_, N = N_, CH = C_ / N_, RM = 128, WGN = WGN_, KC = 64, NST = NST_;
  static constexpr int NTHR = 256 * WGN;  // two warpgroups (128 rows) a column part
  static constexpr int NW = CH / WGN;     // columns of a warpgroup
  static constexpr int LDA = CH + tc::kPad;
  static constexpr int KG = KC / 8;  // 8-row groups of a slab
  static constexpr int SLAB = KC * CH, CHUNK = RM * KC;
  static constexpr int SLOTS = 3;
  static constexpr int NK = C / KC, CPB = CH / KC;
  static constexpr int AHEAD = NST - 2;
  static constexpr int VEC = 8;
  static constexpr int COPIES = RM * (KC / VEC) / NTHR;
  static_assert((NW == 128 || NW == 256) && C % N == 0 && CH % KC == 0 && NST >= 3 && N >= 2 &&
                    N <= 8 && COPIES >= 1 && (RM * (KC / VEC)) % NTHR == 0,
                "tile geometry");
  static __device__ __forceinline__ int dw_offset(int r, int c) { return r * LDA + c; }
  static __device__ __forceinline__ int chunk_offset(int r, int c) {
    return tc::sw128_a_offset<RM>(r, c);
  }
  static __device__ __forceinline__ int slab_offset(int r, int c) {
    return tc::sw128_b_offset(r, c, KG);
  }

  struct Product {
    static constexpr int ROWS = 2, COLS = NW / 8;
    float acc[NW / 2];
    const int lane, wg, wgm, w4;  // column part, 64-row part, the warp's 16 rows
    __device__ __forceinline__ Product(int warp, int lane_)
        : lane(lane_), wg((warp >> 2) % WGN), wgm((warp >> 2) / WGN), w4(warp & 3) {}
    __device__ __forceinline__ void zero() {
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    }
    // this thread's chunk and slab writes, for wgmma's reads
    static __device__ __forceinline__ void publish() { tc::fence_proxy_async(); }
    __device__ __forceinline__ void multiply(const T* chunk, const T* slab, int) {
      const T* part = slab + wg * (NW / 64) * KG * 512;
      tc::wgmma_fence();
#pragma unroll
      for (int k2 = 0; k2 < KC / 16; ++k2)
        tc::wgmma_m64k16<NW>(acc, tc::wgmma_desc_a(chunk + wgm * 4096 + k2 * 16),
                             tc::wgmma_desc_b(part + k2 * 2 * 512, KG));
      tc::wgmma_commit();
      tc::wgmma_wait<1>();  // the chunk before is read; this one multiplies on
    }
    static __device__ __forceinline__ void finish() { tc::wgmma_wait<0>(); }
    __device__ __forceinline__ int row(int i) const {
      return wgm * 64 + w4 * 16 + i * 8 + tc::frag_row(lane);
    }
    __device__ __forceinline__ int col(int j) const {
      return wg * NW + j * 8 + tc::frag_col(lane);
    }
    __device__ __forceinline__ float2 value(int i, int j) const {
      return make_float2(acc[j * 4 + i * 2], acc[j * 4 + i * 2 + 1]);
    }
  };
};

template <class Cfg>
size_t tc_smem_bytes(int pad) {
  return ((size_t)Cfg::DW_ELEMS + (size_t)Cfg::NST * Cfg::SLAB +
          (size_t)(Cfg::RM + 2 * pad) * Cfg::LDA) * sizeof(typename Cfg::T) +
         3 * Cfg::C * sizeof(float);
}

// One unit of the depthwise pass (below): channels (c, c + 1) of the
// block's Cfg::CH over output rows r0..r0+7 -> acc, before the bias; `w`
// rows are C floats apart.
template <class Cfg, int K>
__device__ __forceinline__ void depthwise_unit(const typename Cfg::T* in,
                                               const float* __restrict__ w,  // [k, C] of the stage
                                               int c, int r0, int k, float2 (&acc)[8]) {
  constexpr int C = Cfg::C, LDA = Cfg::LDA;
  using E = Elem<typename Cfg::T>;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = make_float2(0.f, 0.f);
  if (K > 0) {
    float2 v[8 + (K > 0 ? K : 1) - 1];
#pragma unroll
    for (int i = 0; i < 8 + K - 1; ++i) v[i] = E::load2(in + (r0 + i) * LDA + c);
#pragma unroll
    for (int j = 0; j < K; ++j) {  // taps in order, as the plain version sums them
      const float2 wj = *reinterpret_cast<const float2*>(w + j * C + c);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i].x = fmaf(v[i + j].x, wj.x, acc[i].x);
        acc[i].y = fmaf(v[i + j].y, wj.y, acc[i].y);
      }
    }
  } else {
    float2 wj = *reinterpret_cast<const float2*>(w + c);
    for (int j = 0; j < k; ++j) {
      const float2 wn = *reinterpret_cast<const float2*>(w + (j + 1 < k ? j + 1 : j) * C + c);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 v = E::load2(in + (r0 + i + j) * LDA + c);
        acc[i].x = fmaf(v.x, wj.x, acc[i].x);
        acc[i].y = fmaf(v.y, wj.y, acc[i].y);
      }
      wj = wn;
    }
  }
}

// Depthwise stage in -> dw for `rows` output rows: a thread owns a channel
// pair over 8 rows (a unit); output row r reads input rows r..r+k-1. The
// last group may run past `rows` (by less than 8, inside both buffers: RM is
// a multiple of 8): those rows are computed from stale rows and never read
// by a row that is stored. K > 0: k == K, the 8 + K - 1 input rows are read
// once into registers; K == 0: any k, every tap re-read.
//
// Cfg::IN_PLACE (dw == in): the units run in waves of one a thread, each
// wave read, then a barrier, then written. A unit writes only rows that it,
// the other units of its wave and the units of earlier waves read (a later
// wave's rows start lower down), so no row is overwritten before its last
// read.
template <class Cfg, int K>
__device__ __forceinline__ void depthwise_pass(const typename Cfg::T* in, typename Cfg::T* dw,
                                               const float* __restrict__ w,  // [k, C] of the stage
                                               const float* __restrict__ bias, int rows, int k,
                                               int tid) {
  constexpr int CH = Cfg::CH;
  using E = Elem<typename Cfg::T>;
  const int units = (CH / 2) * ((rows + 7) / 8);
  if (!Cfg::IN_PLACE) {
    for (int unit = tid; unit < units; unit += Cfg::NTHR) {
      const int c = (unit % (CH / 2)) * 2, r0 = (unit / (CH / 2)) * 8;
      const float2 b = *reinterpret_cast<const float2*>(bias + c);
      float2 acc[8];
      depthwise_unit<Cfg, K>(in, w, c, r0, k, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        E::store2(dw + Cfg::dw_offset(r0 + i, c), acc[i].x + b.x, acc[i].y + b.y);
    }
    return;
  }
  for (int base = 0; base < units; base += Cfg::NTHR) {
    const int unit = base + tid;
    const int c = (unit % (CH / 2)) * 2, r0 = (unit / (CH / 2)) * 8;
    float2 acc[8];
    if (unit < units) depthwise_unit<Cfg, K>(in, w, c, r0, k, acc);
    __syncthreads();  // the wave's reads are done
    if (unit < units) {
      const float2 b = *reinterpret_cast<const float2*>(bias + c);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        E::store2(dw + Cfg::dw_offset(r0 + i, c), acc[i].x + b.x, acc[i].y + b.y);
    }
  }
}

// the taps of TitaNet S, M and L unrolled; any other odd k in a loop
template <class Cfg>
__device__ __forceinline__ void depthwise_stage(const typename Cfg::T* in, typename Cfg::T* dw,
                                                const float* w, const float* bias, int rows,
                                                int k, int tid) {
  switch (k) {
    case 3: depthwise_pass<Cfg, 3>(in, dw, w, bias, rows, k, tid); break;
    case 7: depthwise_pass<Cfg, 7>(in, dw, w, bias, rows, k, tid); break;
    case 11: depthwise_pass<Cfg, 11>(in, dw, w, bias, rows, k, tid); break;
    default: depthwise_pass<Cfg, 0>(in, dw, w, bias, rows, k, tid);
  }
}

// rows [t_first, t_first + rows) of one utterance -> in (padded rows), zero
// where the time is outside [0, t_len); one cp.async group
template <class Cfg>
__device__ __forceinline__ void load_input_tile(typename Cfg::T* in, const typename Cfg::T* xb,
                                                int t_first, int rows, int t_len, int tid) {
  constexpr int VEC = Elem<typename Cfg::T>::kVec;
  constexpr int CV = Cfg::C / VEC;  // 16-byte chunks of a row
  for (int i = tid; i < rows * CV; i += Cfg::NTHR) {
    const int r = i / CV, v = i % CV;
    const int t = t_first + r;
    typename Cfg::T* dst = in + r * Cfg::LDA + v * VEC;
    if (t >= 0 && t < t_len)
      tc::cp_async16(dst, xb + (long long)t * Cfg::C + v * VEC);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  tc::cp_async_commit();
}

// the first tb rows of in -> rows [t0, t0 + tb) of one utterance, where they
// are inside [0, t_len)
template <class Cfg>
__device__ __forceinline__ void store_output_tile(typename Cfg::T* ob, const typename Cfg::T* in,
                                                  int t0, int tb, int t_len, int tid) {
  constexpr int VEC = Elem<typename Cfg::T>::kVec;
  constexpr int CV = Cfg::C / VEC;
  for (int i = tid; i < tb * CV; i += Cfg::NTHR) {
    const int r = i / CV, v = i % CV;
    if (t0 + r < t_len)
      *reinterpret_cast<uint4*>(ob + (long long)(t0 + r) * Cfg::C + v * VEC) =
          *reinterpret_cast<const uint4*>(in + r * Cfg::LDA + v * VEC);
  }
}

template <class Cfg>
__global__ void __launch_bounds__(Cfg::NTHR, Cfg::MINB) megablock_tc_kernel(
    const typename Cfg::T* __restrict__ x,     // [B, T, C]
    const float* __restrict__ dw_w,            // [S, k, C]
    const float* __restrict__ dw_b,            // [S, C]
    const typename Cfg::T* __restrict__ pw_w,  // [S, C, C] (in, out)
    const float* __restrict__ pw_b,            // [S, C]
    const float* __restrict__ bn,              // [S, 2, C] folded (scale, shift)
    typename Cfg::T* __restrict__ out,         // [B, T, C]
    int t_len, int n_stages, int k, int tb) {
  using T = typename Cfg::T;
  using E = Elem<T>;
  constexpr int C = Cfg::C, NC = Cfg::NC, KS = Cfg::KS, NST = Cfg::NST, AHEAD = Cfg::AHEAD;
  constexpr int NTHR = Cfg::NTHR, LDA = Cfg::LDA, VEC = E::kVec;
  constexpr int SLABS = C / KS;  // slabs of one column chunk
  constexpr int PER_STAGE = (C / NC) * SLABS;
  using Product = typename Cfg::Product;
  extern __shared__ __align__(1024) unsigned char smem_raw[];  // wgmma tiles: 1 KB aligned
  T* ring = reinterpret_cast<T*>(smem_raw) + Cfg::DW_ELEMS;       // [NST] slabs, Cfg::slab_offset
  float* par = reinterpret_cast<float*>(ring + NST * Cfg::SLAB);  // [3][C]: pw_b, scale, shift
  T* in = reinterpret_cast<T*>(par + 3 * C);                      // [RM + 2*pad][LDA]
  T* dw = Cfg::IN_PLACE ? in : reinterpret_cast<T*>(smem_raw);    // Cfg::dw_offset

  const int pad = (k - 1) / 2;
  const int halo = n_stages * pad;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tb;
  const T* xb = x + (long long)b * t_len * C;
  const int n_slabs = n_stages * PER_STAGE;
  Product prod(tid >> 5, tid & 31);

  auto prefetch = [&](int q) {  // slab q of the whole chain -> ring[q % NST]
    if (q < n_slabs) {
      const int s = q / PER_STAGE, rem = q % PER_STAGE;
      const T* src = pw_w + ((long long)s * C + (rem % SLABS) * KS) * C + (rem / SLABS) * NC;
      T* dst = ring + (q % NST) * Cfg::SLAB;
      for (int i = tid; i < KS * (NC / VEC); i += NTHR) {
        const int r = i / (NC / VEC), v = i % (NC / VEC);
        tc::cp_async16(dst + Cfg::slab_offset(r, v * VEC), src + (long long)r * C + v * VEC);
      }
    }
    tc::cp_async_commit();
  };

  int rows = tb + 2 * halo;  // == RM + 2*pad; row r is time t0 - halo + r
  load_input_tile<Cfg>(in, xb, t0 - halo, rows, t_len, tid);
  for (int q = 0; q < AHEAD; ++q) prefetch(q);
  tc::cp_async_wait<AHEAD>();  // the input tile has landed
  __syncthreads();

  int q = 0;
  for (int s = 0; s < n_stages; ++s) {
    rows -= 2 * pad;  // this stage's output rows; row r is time t0 - halo + (s+1)*pad + r
    // this stage's epilogue vectors (read after the K loop's barriers)
    for (int i = tid; i < 3 * C; i += NTHR)
      par[i] = i < C ? pw_b[s * C + i] : bn[(s * 2) * C + i - C];
    depthwise_stage<Cfg>(in, dw, dw_w + (long long)s * k * C, dw_b + s * C, rows, k, tid);

    // pointwise dw @ pw_w[s] -> in, NC output columns at a time
    for (int n0 = 0; n0 < C; n0 += NC) {
      prod.zero();
      for (int ks = 0; ks < SLABS; ++ks, ++q) {
        tc::cp_async_wait<AHEAD - 1>();  // slab q has landed (this thread's copies)
        Product::publish();
        __syncthreads();  // everyone's; dw is written; the ring stage of slab q + AHEAD is consumed
        prefetch(q + AHEAD);
        prod.multiply(dw, ring + (q % NST) * Cfg::SLAB, ks, rows);
      }
      Product::finish();
      if (Cfg::IN_PLACE) __syncthreads();  // every warp has read A: write over it
#pragma unroll
      for (int j = 0; j < Product::COLS; ++j) {
        const int c = n0 + prod.col(j);
        const float2 pb = *reinterpret_cast<const float2*>(par + c);
        const float2 scale = *reinterpret_cast<const float2*>(par + C + c);
        const float2 shift = *reinterpret_cast<const float2*>(par + 2 * C + c);
#pragma unroll
        for (int i = 0; i < Product::ROWS; ++i) {
          const float2 v = prod.value(i, j);
          const float v0 = (v.x + pb.x) * scale.x + shift.x;
          const float v1 = (v.y + pb.y) * scale.y + shift.y;
          E::store2(in + prod.row(i) * LDA + c, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        }
      }
    }
    __syncthreads();  // the stage's output is complete before anyone reads it
  }

  // rows == tb: row r is time t0 + r
  store_output_tile<Cfg>(out + (long long)b * t_len * C, in, t0, tb, t_len, tid);
}

template <class Cfg>
int launch_tc(const void* x, const void* dw_w, const void* dw_b, const void* pw_w,
              const void* pw_b, const void* bn, void* out, int batch, int t_len, int n_stages,
              int k, void* stream) {
  const int pad = (k - 1) / 2;
  const int tb = Cfg::RM - 2 * pad * (n_stages - 1);
  const size_t smem = tc_smem_bytes<Cfg>(pad);
  if (tb < 1 || smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(megablock_tc_kernel<Cfg>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t_len + tb - 1) / tb, batch);
  using T = typename Cfg::T;
  megablock_tc_kernel<Cfg><<<grid, Cfg::NTHR, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)dw_w, (const float*)dw_b, (const T*)pw_w, (const float*)pw_b,
      (const float*)bn, (T*)out, t_len, n_stages, k, tb);
  return (int)cudaGetLastError();
}

// Shared memory of one block of the cluster design: the weight ring, the
// chunk slots, a stage's pw_b, scale and shift for the block's channels, and
// the activation buffers (dw last, at the same offset in every block).
template <class Cfg>
size_t cl_smem_bytes(int pad) {
  const size_t rows = Cfg::RM + 2 * pad + (Cfg::IN_PLACE ? 0 : Cfg::RM);
  return ((size_t)Cfg::NST * Cfg::SLAB + (size_t)Cfg::SLOTS * Cfg::CHUNK + rows * Cfg::LDA) *
             sizeof(typename Cfg::T) +
         3 * Cfg::CH * sizeof(float);
}

template <class Cfg>
__global__ void __launch_bounds__(Cfg::NTHR, 1) megablock_cluster_kernel(
    const typename Cfg::T* __restrict__ x,     // [B, T, C]
    const float* __restrict__ dw_w,            // [S, k, C]
    const float* __restrict__ dw_b,            // [S, C]
    const typename Cfg::T* __restrict__ pw_w,  // [S, C, C] (in, out)
    const float* __restrict__ pw_b,            // [S, C]
    const float* __restrict__ bn,              // [S, 2, C] folded (scale, shift)
    typename Cfg::T* __restrict__ out,         // [B, T, C]
    int t_len, int n_stages, int k, int tb) {
  using T = typename Cfg::T;
  using E = Elem<T>;
  constexpr int C = Cfg::C, N = Cfg::N, CH = Cfg::CH, KC = Cfg::KC, NST = Cfg::NST;
  constexpr int NK = Cfg::NK, AHEAD = Cfg::AHEAD, NTHR = Cfg::NTHR, LDA = Cfg::LDA;
  constexpr int SLOTS = Cfg::SLOTS, VEC = Cfg::VEC, COPIES = Cfg::COPIES;
  constexpr int CV = CH / VEC;  // 16-byte pieces of a row of the block's channels
  constexpr int KV = KC / VEC;  // of a row of a chunk
  using Product = typename Cfg::Product;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  if (cluster.num_blocks() != (unsigned)N) return;  // another cluster shape: the launcher never sends one

  extern __shared__ __align__(1024) unsigned char smem_raw[];  // as megablock_tc_kernel's
  const int pad = (k - 1) / 2;
  T* ring = reinterpret_cast<T*>(smem_raw);                        // [NST] slabs of [KC][LDW]
  T* chunks = ring + NST * Cfg::SLAB;                              // [SLOTS] chunk slots
  float* par = reinterpret_cast<float*>(chunks + SLOTS * Cfg::CHUNK);  // [3][CH]: pw_b, scale, shift
  T* in = reinterpret_cast<T*>(par + 3 * CH);                      // [RM + 2*pad][LDA]
  T* dw = Cfg::IN_PLACE ? in : in + (Cfg::RM + 2 * pad) * LDA;     // [RM][LDA]

  const int halo = n_stages * pad;
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int c0 = rank * CH;  // the block's channels: [c0, c0 + CH)
  const int b = blockIdx.y;
  const int t0 = (blockIdx.x / N) * tb;
  const int n_slabs = n_stages * NK;
  Product prod(tid >> 5, tid & 31);

  auto prefetch = [&](int g) {  // slab g of the chain -> ring[g % NST]
    if (g < n_slabs) {
      const int kk = ((g % NK + rank * Cfg::CPB) % NK) * KC;
      const T* src = pw_w + ((long long)(g / NK) * C + kk) * C + c0;
      T* dst = ring + (g % NST) * Cfg::SLAB;
      for (int i = tid; i < KC * CV; i += NTHR) {
        const int r = i / CV, v = i % CV;
        tc::cp_async16(dst + Cfg::slab_offset(r, v * VEC), src + (long long)r * C + v * VEC);
      }
    }
    tc::cp_async_commit();
  };

  int rows = tb + 2 * halo;  // == RM + 2*pad; row r is time t0 - halo + r
  {
    const T* xb = x + (long long)b * t_len * C + c0;
    for (int i = tid; i < rows * CV; i += NTHR) {
      const int r = i / CV, v = i % CV;
      const int t = t0 - halo + r;
      T* dst = in + r * LDA + v * VEC;
      if (t >= 0 && t < t_len)
        tc::cp_async16(dst, xb + (long long)t * C + v * VEC);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    tc::cp_async_commit();
  }
  for (int g = 0; g < AHEAD; ++g) prefetch(g);
  tc::cp_async_wait<AHEAD>();  // the input tile has landed
  __syncthreads();

  uint4 held[COPIES];  // this thread's part of the next chunk
  int g = 0;
  for (int s = 0; s < n_stages; ++s) {
    rows -= 2 * pad;  // this stage's output rows; row r is time t0 - halo + (s+1)*pad + r
    const int rows16 = min(Cfg::RM, (rows + 15) & ~15);  // the rows of the m tiles multiplied
    for (int i = tid; i < 3 * CH; i += NTHR)
      par[i] = i < CH ? pw_b[s * C + c0 + i] : bn[(s * 2 + i / CH - 1) * C + c0 + i % CH];
    depthwise_stage<Cfg>(in, dw, dw_w + (long long)s * k * C + c0, dw_b + s * C + c0, rows, k, tid);
    cluster.sync();  // every block's dw is written: its peers may read it

    // chunk j: its owner's dw columns -> registers (fetch) -> slot j % SLOTS
    // (put). The loads are volatile asm, so they stay ahead of the products'
    // (volatile) instructions and run under them.
    auto fetch = [&](int j) {
      const int kk = ((j + rank * Cfg::CPB) % NK) * KC;
      const uint32_t src = cluster_addr(dw + kk % CH, kk / CH);
#pragma unroll
      for (int p = 0; p < COPIES; ++p) {
        const int i = tid + p * NTHR, r = i / KV, v = i % KV;
        if (r < rows16) held[p] = ld_cluster16(src + (uint32_t)((r * LDA + v * VEC) * sizeof(T)));
      }
    };
    auto put = [&](int j) {
      T* dst = chunks + (j % SLOTS) * Cfg::CHUNK;
#pragma unroll
      for (int p = 0; p < COPIES; ++p) {
        const int i = tid + p * NTHR, r = i / KV, v = i % KV;
        if (r < rows16) *reinterpret_cast<uint4*>(dst + Cfg::chunk_offset(r, v * VEC)) = held[p];
      }
    };
    fetch(0);
    put(0);
    prod.zero();
    for (int j = 0; j < NK; ++j, ++g) {
      tc::cp_async_wait<AHEAD - 1>();  // slab g has landed (this thread's copies)
      Product::publish();
      __syncthreads();  // everyone's, and chunk j; slab g + AHEAD's stage and slot (j+1) % SLOTS are consumed
      prefetch(g + AHEAD);
      if (j + 1 < NK) fetch(j + 1);
      prod.multiply(chunks + (j % SLOTS) * Cfg::CHUNK, ring + (g % NST) * Cfg::SLAB, rows);
      if (j + 1 < NK) put(j + 1);
    }
    Product::finish();
    if (Cfg::IN_PLACE) cluster.sync();  // no peer reads this block's buffer any more: write over it
#pragma unroll
    for (int j = 0; j < Product::COLS; ++j) {
      const int c = prod.col(j);
      const float2 pb = *reinterpret_cast<const float2*>(par + c);
      const float2 scale = *reinterpret_cast<const float2*>(par + CH + c);
      const float2 shift = *reinterpret_cast<const float2*>(par + 2 * CH + c);
#pragma unroll
      for (int i = 0; i < Product::ROWS; ++i) {
        const float2 v = prod.value(i, j);
        const float v0 = (v.x + pb.x) * scale.x + shift.x;
        const float v1 = (v.y + pb.y) * scale.y + shift.y;
        E::store2(in + prod.row(i) * LDA + c, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      }
    }
    if (Cfg::IN_PLACE)
      __syncthreads();  // the stage's output is whole
    else
      cluster.sync();  // no peer reads this block's dw any more; the stage's output is whole
  }

  // rows == tb: row r is time t0 + r
  T* ob = out + (long long)b * t_len * C + c0;
  for (int i = tid; i < tb * CV; i += NTHR) {
    const int r = i / CV, v = i % CV;
    if (t0 + r < t_len)
      *reinterpret_cast<uint4*>(ob + (long long)(t0 + r) * C + v * VEC) =
          *reinterpret_cast<const uint4*>(in + r * LDA + v * VEC);
  }
}

// The launch configuration of a cluster of `cluster_blocks` (the design's:
// Cfg::N) with `extra_smem` bytes over the design's shared memory; `attr`
// holds the cluster's shape. Returns 0 or the error of the shape check.
template <class Cfg>
int cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int batch, int t_len,
                   int n_stages, int k, int cluster_blocks, int extra_smem, int& tb) {
  const int pad = (k - 1) / 2;
  tb = Cfg::RM - 2 * pad * (n_stages - 1);
  const size_t smem = cl_smem_bytes<Cfg>(pad);
  if (tb < 1 || smem > (size_t)kMaxSmem || cluster_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(megablock_cluster_kernel<Cfg>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster_blocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(((t_len + tb - 1) / tb) * cluster_blocks, batch, 1);
  cfg.blockDim = dim3(Cfg::NTHR, 1, 1);
  cfg.dynamicSmemBytes = smem + extra_smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return 0;
}

template <class Cfg>
int launch_cluster(const void* x, const void* dw_w, const void* dw_b, const void* pw_w,
                   const void* pw_b, const void* bn, void* out, int batch, int t_len, int n_stages,
                   int k, void* stream, int cluster_blocks = Cfg::N, int extra_smem = 0) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int tb = 0;
  const int code =
      cluster_config<Cfg>(cfg, attr, batch, t_len, n_stages, k, cluster_blocks, extra_smem, tb);
  if (code != 0) return code;
  cfg.stream = (cudaStream_t)stream;
  using T = typename Cfg::T;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, megablock_cluster_kernel<Cfg>, (const T*)x, (const float*)dw_w, (const float*)dw_b,
      (const T*)pw_w, (const float*)pw_b, (const float*)bn, (T*)out, t_len, n_stages, k, tb);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error behind for the next one
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// Clusters of the design that the card holds at once (B=1 and T=1 tiles a
// cluster: the count does not depend on the grid), or minus the error.
template <class Cfg>
int max_active_clusters(int k, int n_stages) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int tb = 0, n = 0;
  const int code = cluster_config<Cfg>(cfg, attr, 1, 1, n_stages, k, Cfg::N, 0, tb);
  if (code != 0) return -code;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, megablock_cluster_kernel<Cfg>, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return n;
}

// ops/kernels/megablock.py::TC_TILES names the same numbers. C = 256 and 512
// (TitaNet S and M) run the wgmma product; C = 128 is too narrow for its two
// column halves: it runs the mma.sync product.
//                  C,  RM,  NC, WM, WN, KS, NST, blocks an SM
using Tc128 = TcCfg<128, 64, 128, 2, 2, 32, 3, 2>;
//                  C, RM/64, NC, KS, NST, blocks an SM
using Wg256 = WgCfg<256, 2, 256, 32, 4, 1>;
using Wg512 = WgCfg<512, 1, 512, 16, 4, 1>;
// f32, 3xTF32 (ops/kernels/megablock.py::F32_TILES), a ring of two slabs:
// at C = 128 and 256 two f32 buffers of RM rows (80 fit at C = 256: tiles
// of 76 rows, 4 cover T = 301); at C = 512 two buffers fit only 32 rows, so
// one buffer runs in place with 64 (tiles of 52 at k = 7), which halves the
// weight bytes streamed from L2 a row. Of the tiles timed at (C, k) = (256,
// 3) and (512, 7) (32 to 128 rows, two buffers or one, 4, 8 or 16 warps,
// 16 or 32 slab rows, 2 or 3 stages, 128 to 512 columns a pass;
// ops/kernels/megablock_sweep.py), these were the fastest (NVIDIA H100 80GB
// HBM3, 700 W).
//                    C,  RM,  NC, WM, WN, KS, NST, blocks an SM
using Tf128 = Tf32Cfg<128, 64, 128, 2, 4, 32, 3, 1>;
using Tf256 = Tf32Cfg<256, 80, 256, 1, 8, 16, 2, 1>;
using Tf512 = Tf32Cfg<512, 64, 512, 1, 8, 16, 2, 1, true>;
// C = 1024 (TitaNet L), the cluster design (ops/kernels/megablock.py::
// CLUSTER_TILES): 128 rows a tile, one block an SM, a block 213.7 KB (f32)
// / 223.4 KB (bf16) of shared memory at k = 11. Of the variants timed at
// (1024, 11) (ops/kernels/megablock_sweep.py: clusters of 4 or 8, 4 to 16
// warps, K chunks of 16 to 64, 2 to 4 ring stages; bf16 on mma.sync with
// two buffers or on wgmma in place), these were the fastest: f32 6.80 ms,
// bf16 1.20 ms against 1.70 on mma.sync (NVIDIA H100 80GB HBM3, 700 W).
//                                 T,    C, N,  RM, WM, WN, KC, NST
using Cl1024F32 = ClCfg<float, 1024, 8, 128, 4, 2, 32, 2>;
//                         C, N, WGN, NST
using Cl1024Bf16 = ClWgCfg<1024, 4, 1, 3>;

bool bad_shape(int batch, int t_len, int n_stages, int k) {
  return batch < 1 || batch > 65535 || t_len < 1 || n_stages < 1 || k < 1 || k % 2 == 0;
}

}  // namespace

// the arguments every launch passes on
#define CHAIN_ARGS x, dw_w, dw_b, pw_w, pw_b, bn, out, batch, t_len, n_stages, k, stream

extern "C" {

int titanet_megablock_f32(const void* x, const void* dw_w, const void* dw_b, const void* pw_w,
                          const void* pw_b, const void* bn, void* out, int batch, int t_len,
                          int channels, int n_stages, int k, void* stream) {
  if (bad_shape(batch, t_len, n_stages, k)) return (int)cudaErrorInvalidValue;
  switch (channels) {  // ops/kernels/megablock.py::F32_TILES
    case 128: return launch_tc<Tf128>(CHAIN_ARGS);
    case 256: return launch_tc<Tf256>(CHAIN_ARGS);
    case 512: return launch_tc<Tf512>(CHAIN_ARGS);
    case 1024: return launch_cluster<Cl1024F32>(CHAIN_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

int titanet_megablock_bf16(const void* x, const void* dw_w, const void* dw_b, const void* pw_w,
                           const void* pw_b, const void* bn, void* out, int batch, int t_len,
                           int channels, int n_stages, int k, void* stream) {
  if (bad_shape(batch, t_len, n_stages, k)) return (int)cudaErrorInvalidValue;
  switch (channels) {
    case 128: return launch_tc<Tc128>(CHAIN_ARGS);
    case 256: return launch_tc<Wg256>(CHAIN_ARGS);
    case 512: return launch_tc<Wg512>(CHAIN_ARGS);
    case 1024: return launch_cluster<Cl1024Bf16>(CHAIN_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

// C = 1024 with a cluster of `cluster_blocks` blocks and `extra_smem` bytes
// of shared memory over the design's: what a refused cluster launch
// returns (the routes above launch the design's own).
int titanet_megablock_cluster(int f32, const void* x, const void* dw_w, const void* dw_b,
                              const void* pw_w, const void* pw_b, const void* bn, void* out,
                              int batch, int t_len, int n_stages, int k, void* stream,
                              int cluster_blocks, int extra_smem) {
  if (bad_shape(batch, t_len, n_stages, k)) return (int)cudaErrorInvalidValue;
  return f32 ? launch_cluster<Cl1024F32>(CHAIN_ARGS, cluster_blocks, extra_smem)
             : launch_cluster<Cl1024Bf16>(CHAIN_ARGS, cluster_blocks, extra_smem);
}

// cudaOccupancyMaxActiveClusters of the C = 1024 design at k and S, or
// minus the error
int titanet_megablock_max_active_clusters(int f32, int k, int n_stages) {
  if (k < 1 || k % 2 == 0 || n_stages < 1) return -(int)cudaErrorInvalidValue;
  return f32 ? max_active_clusters<Cl1024F32>(k, n_stages)
             : max_active_clusters<Cl1024Bf16>(k, n_stages);
}

const char* titanet_megablock_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

#undef CHAIN_ARGS
