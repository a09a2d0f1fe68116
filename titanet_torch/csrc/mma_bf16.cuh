// bf16 tensor-core building blocks shared by the kernels of this directory:
// cp.async copies, ldmatrix loads, the m16n8k16 mma.sync and a warp-level
// tile product on top of them; further down, wgmma (warpgroup products from
// shared-memory descriptors) with its swizzled layouts.
//
// mma.sync part.
// Shared-memory convention. Every operand tile is a row-major bf16 array
// whose rows are padded by kPad = 8 elements (16 bytes): with a row width
// that is a multiple of 64 elements the stride is 16 bytes mod 128, so the
// eight 16-byte rows that one ldmatrix phase reads fall into eight distinct
// bank groups (no conflict) without an XOR swizzle.
//
// Fragment layout of mma.sync.m16n8k16 (lane = threadIdx.x % 32):
//   accumulator d[0..3] of a 16 x 8 tile: d[0], d[1] at row lane / 4,
//   columns (lane % 4) * 2 + {0, 1}; d[2], d[3] eight rows below
//   (frag_row, frag_col).
//   A (16 x 16, "row") and B (16 x 8, "col") come from ldmatrix.x4 with the
//   per-lane addresses computed in load_a / load_b below; an operand stored
//   the other way round (A as [k][m], B as [k][n]) uses ldmatrix.trans.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

constexpr int kPad = 8;  // bf16 elements of padding a shared-memory row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy global -> shared; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}
// the same copy, reading `src_bytes` (0 or 16) bytes and zero-filling the rest
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), f32 accumulation
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// accumulator coordinates: d[0], d[1] at (frag_row, frag_col + {0, 1}),
// d[2], d[3] at (frag_row + 8, frag_col + {0, 1})
__device__ __forceinline__ int frag_row(int lane) { return lane >> 2; }
__device__ __forceinline__ int frag_col(int lane) { return (lane & 3) * 2; }

// A fragment of the 16 x 16 tile at `tile` (its element (m, k) = (0, 0)).
// kTrans = false: stored [m][k], k contiguous, row stride ld.
// kTrans = true:  stored [k][m], m contiguous, row stride ld.
template <bool kTrans>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld,
                                       int lane) {
  if (!kTrans) {
    ldmatrix_x4(a, tile + (lane & 15) * ld + (lane >> 4) * 8);
  } else {
    // matrices: (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
    ldmatrix_x4_trans(a, tile + ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8);
  }
}

// B fragments of two neighbouring 16 (k) x 8 (n) tiles at `tile` (element
// (k, n) = (0, 0)): b[0], b[1] for columns 0-7, b[2], b[3] for columns 8-15.
// kTrans = false: stored [n][k], k contiguous ("col", what mma wants).
// kTrans = true:  stored [k][n], n contiguous (a row-major [K, N] weight).
template <bool kTrans>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const __nv_bfloat16* tile, int ld,
                                       int lane) {
  if (!kTrans) {
    // matrices: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
    ldmatrix_x4(b, tile + ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8);
  } else {
    // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
    ldmatrix_x4_trans(b, tile + (lane & 15) * ld + (lane >> 4) * 8);
  }
}

// One warp's acc[MT][NT] (16 x 8 tiles; NT even) += A (MT*16 x DEPTH) *
// B (DEPTH x NT*8) from shared memory, DEPTH a multiple of 16. `a` and `b`
// point at the warp's element (0, 0) of each operand; m tiles whose first
// row is >= m_rows are skipped (warp-uniform). The fragments of step k+1
// are loaded before the products of step k start, so the ldmatrix
// latency hides behind the tensor cores.
template <int MT, int NT, int DEPTH, bool kTransA, bool kTransB>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* b, int ldb, int lane,
                                         int m_rows = MT * 16) {
  static_assert(NT % 2 == 0 && DEPTH % 16 == 0, "B fragments come in pairs of n tiles");
  constexpr int STEPS = DEPTH / 16;
  uint32_t af[2][MT][4], bf[2][NT / 2][4];
  auto load = [&](int step, int buf) {
    const int kk = step * 16;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i * 16 < m_rows)
        load_a<kTransA>(af[buf][i], kTransA ? a + kk * lda + i * 16 : a + i * 16 * lda + kk, lda,
                        lane);
    }
#pragma unroll
    for (int j = 0; j < NT / 2; ++j)
      load_b<kTransB>(bf[buf][j], kTransB ? b + kk * ldb + j * 16 : b + j * 16 * ldb + kk, ldb,
                      lane);
  };
  load(0, 0);
#pragma unroll
  for (int step = 0; step < STEPS; ++step) {
    if (step + 1 < STEPS) load(step + 1, (step + 1) & 1);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i * 16 < m_rows) {
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          mma_16816(acc[i][2 * j], af[step & 1][i], bf[step & 1][j][0], bf[step & 1][j][1]);
          mma_16816(acc[i][2 * j + 1], af[step & 1][i], bf[step & 1][j][2], bf[step & 1][j][3]);
        }
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
}

// ------------------------------------------------------------------ wgmma
//
// Warpgroup products (4 warps, 64 rows): the operands come from shared
// memory through 64-bit descriptors, in the 128-byte swizzled layouts below
// (A may instead come from registers, in mma.sync's A-fragment layout);
// the f32 accumulator fragment of warp w covers rows 16w .. 16w+15 and is
// laid out like NT = N/8 mma.sync tiles side by side (d[4j + q] is element q
// of the 16 x 8 tile at columns 8j ..).
//
// A or B, "K-major" (a row-major [64][K] activation tile; a B stored [n][k]
// the same way): panels of 64 columns;
// a panel is [ROWS][128 bytes], and the 16-byte chunk c of row r sits at
// chunk c ^ (r % 8). Panels are ROWS * 128 bytes apart; a 16-column step
// inside a panel is 32 bytes further (the hardware applies the XOR to the
// address), a 64-row step 8 KB.
// B or A, "MN-major" (a row-major [K][N] weight slab; an A stored [k][m]
// the same way): atoms of 8 k-rows x 64
// columns = 1 KB, row kr of an atom holds chunk c at chunk c ^ kr. The atom
// of (k / 8 = kg, n / 64 = nb) is atom nb * KG + kg, so consecutive k groups
// are SBO = 1 KB apart and consecutive 64-column blocks LBO = KG KB apart.
// Every tile base is 1024-byte aligned.

template <int ROWS>  // rows of a panel
__device__ __forceinline__ int sw128_a_offset(int r, int c) {  // elements; panel-major
  return (c >> 6) * (ROWS * 64) + r * 64 + ((((c & 63) >> 3) ^ (r & 7)) << 3) + (c & 7);
}
__device__ __forceinline__ int sw128_b_offset(int k, int n, int kg_per_slab) {  // elements
  return ((n >> 6) * kg_per_slab + (k >> 3)) * 512 + (k & 7) * 64 +
         ((((n & 63) >> 3) ^ (k & 7)) << 3) + (n & 7);
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}
// descriptor of the A tile at `p` (panel base + 2 * (k % 64) bytes)
__device__ __forceinline__ uint64_t wgmma_desc_a(const void* p) { return wgmma_desc(p, 16, 1024); }
// descriptor of the B tile whose first atom is at `p`
__device__ __forceinline__ uint64_t wgmma_desc_b(const void* p, int kg_per_slab) {
  return wgmma_desc(p, kg_per_slab * 1024, 1024);
}

// generic-proxy writes (st.shared, cp.async) -> visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins the compiler's accesses of an accumulator (or register-A operand) to
// this point, between the asynchronous product's issue and its wait: without
// it, reads of a finished accumulator can be scheduled above the wait, and
// ptxas then serializes the products (C7514)
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16, K-major tile) * B (16 x 128, stored [k][n])
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 1, 1, 1, 0, 1;\n"  // scale-d, scale-a, scale-b, A K-major, B MN-major
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b));
}

// d (64 x 256, f32) += A (64 x 16, K-major tile) * B (16 x 256, stored [k][n])
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, 1, 1, 1, 0, 1;\n"  // scale-d, scale-a, scale-b, A K-major, B MN-major
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
      "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
      "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
      "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
      "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
      "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
      "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b));
}

// d (64 x 256, f32) = A (64 x 16, K-major tile) * B (16 x 256, stored [k][n])
// + (accumulate ? d : 0): the scale-d predicate starts a sum without a
// zeroing pass over the accumulators (a pass that ptxas would have to order
// against the asynchronous products)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"  // scale-d, scale-a, scale-b, A K-major, B MN-major
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
      "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
      "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
      "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
      "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
      "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
      "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 128, f32) = A (64 x 16 bf16, registers) * B (16 x 128, stored [k][n])
// + (accumulate ? d : 0). A is each warp's 16 x 16 slice of the warpgroup's
// 64 rows (warp w: rows 16w ..) in the mma.sync A-fragment layout (an
// ldmatrix.x4 of a row-major tile, as load_a<false>). The registers of a
// are read asynchronously: they stay untouched until the product's group is
// waited for.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"  // scale-d, scale-a, scale-b, B MN-major
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, f32) = A (64 x 16, stored [k][m]: MN-major, the layout of an
// MN-major B) * B (16 x 64, stored [n][k]: K-major, the layout of a K-major
// A) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_m64n64k16_tn(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"  // scale-d, scale-a, scale-b, A MN-major, B K-major
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b);
template <>
__device__ __forceinline__ void wgmma_m64k16<128>(float (&d)[64], uint64_t da, uint64_t db) {
  wgmma_m64n128k16(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_m64k16<256>(float (&d)[128], uint64_t da, uint64_t db) {
  wgmma_m64n256k16(d, da, db);
}

}  // namespace tc
