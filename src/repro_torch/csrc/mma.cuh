// Tensor-core building blocks of the port's bf16 kernels on Hopper (sm_90a):
// cp.async tile loads into a 128-byte-swizzled shared layout, wgmma for the
// products whose operands both lie K-major in shared memory, and mma.sync
// m16n8k16 with ldmatrix for those that take an operand from registers or
// transposed.
//
// Shared layout of one operand tile: 64 rows x 128 bf16 columns (16 KB),
// stored as two column blocks of 64 rows x 64 columns (8 KB, 128 B a row).
// In a block, 16-byte chunk j of row r sits at chunk j ^ (r % 8): the
// 128-byte swizzle that wgmma's descriptor names (layout type 1), so the
// blocks must start 1024-byte aligned; ldmatrix reads eight rows of one
// logical chunk from eight different banks. Head dims below 128 are
// zero-filled up to it.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr int kTileRows = 64;                  // rows of an operand tile (wgmma M)
constexpr int kTileCols = 128;                 // bf16 columns (head dims padded)
constexpr int kBlockBytes = kTileRows * 128;   // one 64-column block
constexpr int kTileBytes = 2 * kBlockBytes;    // 16 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (row, col) of a tile; col a multiple of 8.
__device__ __forceinline__ uint32_t tile_off(int row, int col) {
  return (col >> 6) * kBlockBytes + row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4);
}

// ---- cp.async ---------------------------------------------------------------
// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [0, 64) x cols [0, 128) of a tile from `src` (row stride ld
// elements): rows >= rows_valid and cols >= cols_valid are zero-filled.
// `any` is a valid address handed to the zero-filling copies. The caller
// commits the group.
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          int ld, int rows_valid, int cols_valid,
                                          const void* any, int tid, int threads) {
  for (int i = tid; i < kTileRows * (kTileCols / 8); i += threads) {
    const int r = i >> 4, col = (i & 15) * 8;
    const bool ok = r < rows_valid && col < cols_valid;
    cp_async16(dst + tile_off(r, col),
               ok ? static_cast<const void*>(src + static_cast<size_t>(r) * ld + col) : any,
               ok ? 16 : 0);
  }
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(x) : "memory");
}
__device__ __forceinline__ uint32_t ld_shared_b32(uint32_t addr) {
  uint32_t x;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(x) : "r"(addr) : "memory");
  return x;
}
__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 x;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w) : "r"(addr) : "memory");
  return x;
}

// The two bf16 of a packed pair as floats (lo first).
__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// Makes this thread's completed generic-proxy writes to shared memory (plain
// stores, cp.async) visible to wgmma's reads (the async proxy); a barrier
// after it extends that to the other threads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma ------------------------------------------------------------------
// Descriptor of a K-major operand in one 128-byte-swizzled block: start
// address >> 4, leading offset 1 (unused by swizzled K-major layouts),
// stride 1024 B between groups of 8 rows, layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous product.
__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x) :: "memory");
}

// D (64 x 64, fp32) (+)= A (64 x 16) . B (64 x 16)^T, both K-major bf16 in
// shared memory. Thread t of the warpgroup holds D[16 w + g + 8 i][8 j + 2 q + e]
// in d[4 j + 2 i + e] (w = t / 32, g = t % 32 / 4, q = t % 4).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Issue S = A . B^T over the 128 columns of two tiles (8 k-steps of 16) as
// wgmma m64n64k16, without committing: the caller commits and waits. With
// `accumulate` S += A . B^T (a head dim past 128, in column tiles).
__device__ __forceinline__ void issue_abt(float (&s)[32], uint32_t a, uint32_t b,
                                          bool accumulate = false) {
#pragma unroll
  for (int kk = 0; kk < kTileCols / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kBlockBytes + (kk & 3) * 32;
    wgmma_m64n64k16(s, sw128_desc(a + off), sw128_desc(b + off), kk > 0 || accumulate);
  }
}

// ---- mma.sync ---------------------------------------------------------------
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d (16 x 8, fp32) += a (16 x 16, bf16 row) . b (16 x 8, bf16 col).
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values as a bf16 pair (lo in the low half), rounded to nearest.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of k-step kk (columns 16 kk .. 16 kk + 15) of mma.sync from a
// 64-column accumulator in the wgmma layout above (warp w's rows 16 w ..).
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&s)[32], int kk) {
  a[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

// In place over a 64-column accumulator in the wgmma layout: each of this
// thread's two rows (i = 0, 1) becomes its softmax over the columns below
// lim[i], taken in base 2 of s * sl2, with 0 at the other columns and the
// sum floored at 1e-30 (a row with no valid column is all zeros). The 64
// columns of a row lie in one quad, so two shuffles reduce them.
__device__ __forceinline__ void row_softmax64(float (&s)[32], const int (&lim)[2],
                                              float sl2, int qd) {
  float mx[2] = {-1e30f, -1e30f}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * qd + (e & 1);
      s[4 * j + e] = col < lim[e >> 1] ? s[4 * j + e] * sl2 : -1e30f;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * qd + (e & 1);
      const float p = col < lim[e >> 1] ? exp2f(s[4 * j + e] - mx[e >> 1]) : 0.f;
      s[4 * j + e] = p;
      sum[e >> 1] += p;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    sum[i] = 1.f / fmaxf(sum[i], 1e-30f);
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] *= sum[(e >> 1) & 1];
}

// acc (16 x 128 per warp, 16 n-blocks of 8) += A (16 x 16) . B, B = rows
// [k0, k0 + 16) x all 128 columns of a row-major tile at b (K along rows),
// read transposed by ldmatrix.
__device__ __forceinline__ void mma_a_btile(float (&acc)[16][4], const uint32_t (&a)[4],
                                            uint32_t b, int k0, int lane) {
  const int i = lane >> 3;
  const int row = k0 + (i & 1) * 8 + (lane & 7);
#pragma unroll
  for (int np = 0; np < 8; ++np) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, b + tile_off(row, 16 * np + (i >> 1) * 8));
    mma_16816(acc[2 * np], a, r[0], r[1]);
    mma_16816(acc[2 * np + 1], a, r[2], r[3]);
  }
}

// A fragment of k-step k0 .. k0 + 15 of A = T^T, T a row-major tile at t
// (rows = A's k, columns = A's rows): A's rows m0 .. m0 + 15 of warp's
// product, read transposed by ldmatrix.
__device__ __forceinline__ void a_frag_trans(uint32_t (&a)[4], uint32_t t, int k0,
                                             int m0, int lane) {
  const int i = lane >> 3;
  ldmatrix_x4_trans(a, t + tile_off(k0 + (i >> 1) * 8 + (lane & 7), m0 + (i & 1) * 8));
}

}  // namespace repro
