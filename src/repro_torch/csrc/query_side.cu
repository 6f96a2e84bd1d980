// F-side query pass: out = softmax(scale * Q K~^T) M + delta * V.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ss_attention.py:365
// query_side (body _query_side_kernel :339, probabilities
// _query_side_probs :311).
//
// What it computes, per batch-head b and query row i:
//   s_ic = scale * q[b,i] . k_l[b,c] over the c landmark columns, with the
//   segment-causal F-mask when seg > 0: column c is valid iff
//   c <= (pos_offset + i) / seg; p = exp(s - max) zeroed where masked,
//   normalized by max(sum, 1e-30);
//   out[b,i] = p . M[b] + delta[b] * v[b,i], accumulated in fp32 and
//   written in q's type.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): it must read Q and
// V and write the output once. At the training shape (b = 56 batch-heads,
// n = 4096, c = 64, seg = 64, d = dv = 128, bf16) that is 176 MB, 178 MB
// with K~ and M (53.1 us), against 3.8 GFLOP of unmasked pairs (4 us); at
// the serving shape (b = 28, n = 352) 8.4 MB (2.5 us): bytes-bound
// everywhere.
//
// Two kernels, chosen by the storage type (a dispatch, not a fallback):
//
// * bf16: tensor cores over query tiles. The softmax axis is the small
//   resident c axis, so each query row is one independent row softmax and Q
//   and V are read once. A CTA (one warpgroup, 128 threads) owns one
//   batch-head and a run of 64-row query tiles (the wrapper's query-tile
//   plan sizes the runs for about TARGET_CTAS CTAs: 10 runs of 7 tiles per
//   head at the training shape, 6 runs of one tile at the serving shape).
//   K~ and M (c x d, c x dv, c <= 64: the landmark axis is padded to 64
//   rows with zeros and the padded columns masked) are loaded once per CTA
//   into 128-byte-swizzled tiles (csrc/mma.cuh); the Q and V tiles stream
//   through a two-stage cp.async ring, zero-filled past n. Per tile:
//   S = Q K~^T by wgmma m64n64k16 from shared memory; the F-mask and the
//   row softmax in registers in base 2 (a row's 64 columns lie in one quad
//   of the accumulator layout: two shuffles); P rounded to bf16 and P M by
//   mma.sync m16n8k16 with M read transposed by ldmatrix; + delta * v from
//   the V tile in fp32; the bf16 result is staged in the Q slot (dead once
//   S is formed) and written in 16-byte stores, rows below n only.
//   Budget: 99,328 B of shared memory a CTA (1 KB alignment slack, K~, M,
//   two stages of Q and V at 16 KB each), so two CTAs fit an SM; S (32) and
//   the P M accumulator (64) take most of its 128 registers a thread
//   (ptxas, no spills). A sweep of 3-64 runs per head at the training shape
//   found 10 to 32 equal within 3% (PERF.md).
// * fp32: exact fp32 FMA loops. A CTA owns kRows = 16 query rows of one
//   batch-head (grid b x n / 16). It loads K~ (c x d) into shared memory,
//   each of its 4 warps computes the probabilities of 4 rows with lanes over
//   landmark columns (K~ rows padded to d + 1 floats: conflict-free), then
//   the same buffer is refilled with M (c x dv) and lanes sweep value
//   columns for P.M + delta * v.
//
// Wide heads (absorbed MLA's prefill: d = 576, dv = 512): a second fp32
// kernel, query_side_wide_kernel, runs the narrow one's passes with its
// tiles in dynamic shared memory at a row stride of 576 (189 KB, one CTA
// an SM). The tensor-core kernel is a template over the
// column tiles of d (1 for d <= 128, 5 up to 640): K~ stays resident in 5
// tiles, each query tile's Q arrives in 128-column tiles through the
// cp.async ring with S accumulating over them by wgmma, and dv splits
// across a grid axis of 128-column tiles (M's and V's columns of this CTA;
// each recomputes S). 165 KB of shared memory, one CTA an SM.
//
// Past 64 landmark columns (c > 64; the reference's query_side keeps any c
// resident): every variant hands over, inside this file and by c, to its
// column-tiled counterpart in query_side_ct.cuh (the c <= 64 launches stay
// the kernels above). A row's softmax then spans several 64-column tiles,
// so it is flash attention over the landmark axis with K~ as the keys and
// M as the values: a running max and sum per query row, the fp32 P M
// accumulator rescaled when the max moves, column tiles wholly past a query
// block's F-mask reach skipped, padded columns masked, the sum floored at
// 1e-30 at the end. bf16: steps over (query tile, landmark tile, column tile
// of d); Q and K~ column tiles through a two-stage ring, M and V tiles
// through two-slot rings of their own: 129 KB of shared memory, one CTA an
// SM (the 64-column kernel's 97 KB fit two); Q is read again for each
// landmark tile, from L2. fp32 (any d up to 576): the FMA kernel's two
// passes per landmark tile at a row stride of 128 or 576. At c = 128 the
// bound is still the bytes of Q, V and out (kernels/cost.py); the time is
// in PERF.md.
#include "common.cuh"
#include "mma.cuh"
#include "query_side_ct.cuh"

namespace {

using repro::kNegInf;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kMaxC = 64;                     // landmark columns (2 per lane)
constexpr int kMaxD = 128;                    // max head dim of the narrow kernels
constexpr int kWideMaxD = 576;                // max d (the wide-head variants)
constexpr int kWideMaxDv = 512;               // max dv
// The wide fp32 kernel's dynamic shared memory for head dims up to kD (its
// compile-time row stride; dv <= kD): Q rows, K~ (rows padded to kD + 1
// floats) then M in the same buffer, P.
constexpr int fma_smem_bytes(int kD) {
  return (kRows * kD + kMaxC * (kD + 1) + kRows * kMaxC) * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
query_side_kernel(const T* __restrict__ q, const T* __restrict__ kl,
                  const T* __restrict__ mm, const T* __restrict__ v,
                  const float* __restrict__ delta, T* __restrict__ out,
                  int n, int c, int d, int dv, float scale, int seg,
                  int pos_offset) {
  __shared__ float q_s[kRows][kMaxD];
  __shared__ float buf[kMaxC][kMaxD + 1];  // K~ first, then M
  __shared__ float p_s[kRows][kMaxC];

  const int bi = blockIdx.x;
  const int i0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* qb = q + static_cast<size_t>(bi) * n * d;
  const T* klb = kl + static_cast<size_t>(bi) * c * d;
  const T* mb = mm + static_cast<size_t>(bi) * c * dv;
  const T* vb = v + static_cast<size_t>(bi) * n * dv;
  T* ob = out + static_cast<size_t>(bi) * n * dv;

  for (int x = tid; x < kRows * d; x += kThreads) {
    const int r = x / d, col = x - r * d;
    q_s[r][col] = i0 + r < n
        ? repro::to_float(qb[static_cast<size_t>(i0 + r) * d + col]) : 0.f;
  }
  for (int x = tid; x < c * d; x += kThreads) {
    const int cc = x / d, col = x - cc * d;
    buf[cc][col] = repro::to_float(klb[x]);
  }
  __syncthreads();

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int i = i0 + r;
    float s[2];
    bool ok[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int cc = lane + 32 * t;
      ok[t] = cc < c && (seg == 0 || cc <= (pos_offset + i) / seg);
      s[t] = kNegInf;
      if (ok[t]) {
        float dot = 0.f;
        for (int kk = 0; kk < d; ++kk) dot = fmaf(q_s[r][kk], buf[cc][kk], dot);
        s[t] = dot * scale;
      }
    }
    const float mx = repro::warp_max(fmaxf(s[0], s[1]));
    const float p0 = ok[0] ? expf(s[0] - mx) : 0.f;
    const float p1 = ok[1] ? expf(s[1] - mx) : 0.f;
    const float den = fmaxf(repro::warp_sum(p0 + p1), 1e-30f);
    if (lane < c) p_s[r][lane] = p0 / den;
    if (lane + 32 < c) p_s[r][lane + 32] = p1 / den;
  }
  __syncthreads();  // every row's P is in p_s; K~ no longer needed
  for (int x = tid; x < c * dv; x += kThreads) {
    const int cc = x / dv, col = x - cc * dv;
    buf[cc][col] = repro::to_float(mb[x]);
  }
  __syncthreads();

  const float dlt = delta[bi];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int i = i0 + r;
    if (i >= n) continue;
#pragma unroll
    for (int j = 0; j < kMaxD / 32; ++j) {
      const int col = lane + 32 * j;
      if (col >= dv) continue;
      float o = 0.f;
      for (int cc = 0; cc < c; ++cc) o = fmaf(p_s[r][cc], buf[cc][col], o);
      o = o + dlt * repro::to_float(vb[static_cast<size_t>(i) * dv + col]);
      ob[static_cast<size_t>(i) * dv + col] = repro::from_float<T>(o);
    }
  }
}

// The fp32 kernel for wide heads (d up to kWideMaxD, dv up to kWideMaxDv):
// the narrow kernel's passes with its tiles in dynamic shared memory at a
// row stride of kD = kWideMaxD.
__global__ void __launch_bounds__(kThreads)
query_side_wide_kernel(const float* __restrict__ q, const float* __restrict__ kl,
                       const float* __restrict__ mm, const float* __restrict__ v,
                       const float* __restrict__ delta, float* __restrict__ out,
                       int n, int c, int d, int dv, float scale, int seg,
                       int pos_offset) {
  constexpr int kD = kWideMaxD;
  extern __shared__ float fma_smem[];
  auto q_s = reinterpret_cast<float (*)[kD]>(fma_smem);                   // [kRows][kD]
  auto buf = reinterpret_cast<float (*)[kD + 1]>(fma_smem + kRows * kD);  // K~, then M
  auto p_s = reinterpret_cast<float (*)[kMaxC]>(fma_smem + kRows * kD + kMaxC * (kD + 1));

  const int bi = blockIdx.x;
  const int i0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* qb = q + static_cast<size_t>(bi) * n * d;
  const float* klb = kl + static_cast<size_t>(bi) * c * d;
  const float* mb = mm + static_cast<size_t>(bi) * c * dv;
  const float* vb = v + static_cast<size_t>(bi) * n * dv;
  float* ob = out + static_cast<size_t>(bi) * n * dv;

  for (int x = tid; x < kRows * d; x += kThreads) {
    const int r = x / d, col = x - r * d;
    q_s[r][col] = i0 + r < n
        ? repro::to_float(qb[static_cast<size_t>(i0 + r) * d + col]) : 0.f;
  }
  for (int x = tid; x < c * d; x += kThreads) {
    const int cc = x / d, col = x - cc * d;
    buf[cc][col] = repro::to_float(klb[x]);
  }
  __syncthreads();

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int i = i0 + r;
    float s[2];
    bool ok[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int cc = lane + 32 * t;
      ok[t] = cc < c && (seg == 0 || cc <= (pos_offset + i) / seg);
      s[t] = kNegInf;
      if (ok[t]) {
        float dot = 0.f;
        for (int kk = 0; kk < d; ++kk) dot = fmaf(q_s[r][kk], buf[cc][kk], dot);
        s[t] = dot * scale;
      }
    }
    const float mx = repro::warp_max(fmaxf(s[0], s[1]));
    const float p0 = ok[0] ? expf(s[0] - mx) : 0.f;
    const float p1 = ok[1] ? expf(s[1] - mx) : 0.f;
    const float den = fmaxf(repro::warp_sum(p0 + p1), 1e-30f);
    if (lane < c) p_s[r][lane] = p0 / den;
    if (lane + 32 < c) p_s[r][lane + 32] = p1 / den;
  }
  __syncthreads();  // every row's P is in p_s; K~ no longer needed
  for (int x = tid; x < c * dv; x += kThreads) {
    const int cc = x / dv, col = x - cc * dv;
    buf[cc][col] = repro::to_float(mb[x]);
  }
  __syncthreads();

  const float dlt = delta[bi];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int i = i0 + r;
    if (i >= n) continue;
    for (int col = lane; col < dv; col += 32) {
      float o = 0.f;
      for (int cc = 0; cc < c; ++cc) o = fmaf(p_s[r][cc], buf[cc][col], o);
      o = o + dlt * repro::to_float(vb[static_cast<size_t>(i) * dv + col]);
      ob[static_cast<size_t>(i) * dv + col] = o;
    }
  }
}

// ---- bf16: tensor cores over query tiles ------------------------------------
namespace tc {

constexpr int kThreads = 128;              // one warpgroup
constexpr int kStepRows = 64;              // query rows per tile (= QUERY_TILE)
static_assert(kStepRows == repro::kTileRows, "a query tile is one wgmma M");
constexpr int kStages = 2;
constexpr int kCols = repro::kTileCols;    // columns of a tile: d's column tiles, dv's tiles
constexpr int kWideCT = 5;                 // d's column tiles past 128 (up to 640)
static_assert(kWideCT * kCols >= kWideMaxD, "K~ fits its resident column tiles");
// 1024 B of alignment slack, K~ (kCT column tiles) and M (this CTA's value
// columns), then the ring: per stage one Q column tile and one V tile.
constexpr int smem_bytes(int ct) { return 1024 + repro::kTileBytes * (ct + 1 + 2 * kStages); }

using bf16 = __nv_bfloat16;

// kCT: column tiles of d (1: d <= 128; kWideCT: wider). Steps walk the
// (query tile, column tile) pairs in order: a step brings one Q column tile
// (and, at column tile 0, the query tile's V tile of this CTA's value
// columns) and adds its part of S; the last column tile's step runs the
// softmax, P M and the write. With kCT = 1 a step is a query tile.
template <int kCT>
__global__ void __launch_bounds__(kThreads)
query_side_tc(const bf16* __restrict__ q, const bf16* __restrict__ kl,
              const bf16* __restrict__ mm, const bf16* __restrict__ v,
              const float* __restrict__ delta, bf16* __restrict__ out, int n,
              int c, int d, int dv, float scale, int seg, int pos_offset,
              int run_rows) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t kl_s = (repro::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t m_s = kl_s + kCT * repro::kTileBytes;
  // grid.y = b x value tiles: this CTA's value columns [dv0, dv0 + dvw)
  const int dvt = (dv + kCols - 1) / kCols;
  const int run = blockIdx.x, bi = blockIdx.y / dvt, vt = blockIdx.y - bi * dvt;
  const int dv0 = vt * kCols, dvw = min(kCols, dv - dv0);
  const int row_begin = run * run_rows;
  const int row_end = min(n, row_begin + run_rows);
  const int tiles = (row_end - row_begin + kStepRows - 1) / kStepRows;
  const int steps = tiles * kCT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, qd = lane & 3;

  const bf16* qb = q + static_cast<size_t>(bi) * n * d;
  const bf16* vb = v + static_cast<size_t>(bi) * n * dv + dv0;
  bf16* ob = out + static_cast<size_t>(bi) * n * dv + dv0;
  auto q_s = [&](int st) { return kl_s + repro::kTileBytes * (kCT + 1 + 2 * st); };
  auto v_s = [&](int st) { return q_s(st) + repro::kTileBytes; };
  auto load_step = [&](int sp) {
    const int it = sp / kCT, ct = sp - it * kCT;
    const int i0 = row_begin + it * kStepRows;
    repro::load_tile(q_s(sp % kStages), qb + static_cast<size_t>(i0) * d + ct * kCols, d,
                     row_end - i0, d - ct * kCols, q, tid, kThreads);
    if (ct == 0)
      repro::load_tile(v_s(it % kStages), vb + static_cast<size_t>(i0) * dv, dv,
                       row_end - i0, dvw, v, tid, kThreads);
  };
#pragma unroll
  for (int ct = 0; ct < kCT; ++ct)
    repro::load_tile(kl_s + ct * repro::kTileBytes,
                     kl + static_cast<size_t>(bi) * c * d + ct * kCols, d, c, d - ct * kCols,
                     kl, tid, kThreads);
  repro::load_tile(m_s, mm + static_cast<size_t>(bi) * c * dv + dv0, dv, c, dvw, mm, tid,
                   kThreads);
  load_step(0);
  repro::cp_async_commit();

  const float sl2 = scale * repro::kLog2e;
  const float dlt = delta[bi];
  const int ksteps = (c + 15) / 16;  // k-steps of P M that hold a landmark column
  float s[32];

  for (int sp = 0; sp < steps; ++sp) {
    const int it = sp / kCT, ct = sp - it * kCT;
    const int st = sp % kStages;
    const int i0 = row_begin + it * kStepRows;
    if (sp + 1 < steps) load_step(sp + 1);  // its stage was released at sp - 1
    repro::cp_async_commit();
    repro::cp_async_wait<1>();  // step sp (and K~, M) landed
    repro::fence_proxy_async();
    __syncthreads();

    if (ct == 0) {
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) repro::fence_operand(s[e]);
    repro::wgmma_fence();
    repro::issue_abt(s, q_s(st), kl_s + ct * repro::kTileBytes, ct > 0);
    repro::wgmma_commit();
    repro::wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 32; ++e) repro::fence_operand(s[e]);
    if (ct < kCT - 1) {
      __syncthreads();  // the stage is released for step sp + kStages
      continue;
    }

    // F-mask: row i sees columns below min(c, (pos_offset + i) / seg + 1);
    // rows at or past n none.
    int lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = i0 + 16 * warp + gr + 8 * i;
      lim[i] = row >= row_end ? 0 : seg > 0 ? min(c, (pos_offset + row) / seg + 1) : c;
    }
    repro::row_softmax64(s, lim, sl2, qd);

    // acc = P M: P in bf16 from registers, M transposed from shared memory
    float acc[16][4];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < ksteps) {
        uint32_t a[4];
        repro::a_frag(a, s, kk);
        repro::mma_a_btile(acc, a, m_s, 16 * kk, lane);
      }
    }

    // out = acc + delta * v, staged as bf16 in the Q slot (every warp's
    // wgmma has read it), then written in 16-byte stores.
    __syncthreads();
    const uint32_t o_s = q_s(st), vt_s = v_s(it % kStages);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 16 * warp + gr + 8 * i;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * qd;
        const uint32_t off = repro::tile_off(row, col) + (col & 7) * 2;
        const float2 vv = repro::unpack_bf16(repro::ld_shared_b32(vt_s + off));
        repro::st_shared_b32(o_s + off, repro::pack_bf16(acc[j][2 * i] + dlt * vv.x,
                                                         acc[j][2 * i + 1] + dlt * vv.y));
      }
    }
    __syncthreads();
    for (int x = tid; x < kStepRows * (repro::kTileCols / 8); x += kThreads) {
      const int r = x >> 4, col = (x & 15) * 8;
      if (i0 + r < row_end && col < dvw) {
        *reinterpret_cast<uint4*>(ob + static_cast<size_t>(i0 + r) * dv + col) =
            repro::ld_shared_v4(o_s + repro::tile_off(r, col));
      }
    }
    __syncthreads();  // the stage is released for step sp + kStages
  }
}

template <int kCT>
int launch_tiles(const void* q, const void* kl, const void* mm, const void* v,
                 const float* delta, void* out, int b, int n, int c, int d, int dv,
                 float scale, int seg, int pos_offset, int run_rows, cudaStream_t st) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        query_side_tc<kCT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(kCT));
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const dim3 grid((n + run_rows - 1) / run_rows, b * ((dv + kCols - 1) / kCols));
  query_side_tc<kCT><<<grid, kThreads, smem_bytes(kCT), st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kl),
      static_cast<const bf16*>(mm), static_cast<const bf16*>(v), delta,
      static_cast<bf16*>(out), n, c, d, dv, scale, seg, pos_offset, run_rows);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* kl, const void* mm, const void* v,
           const float* delta, void* out, int b, int n, int c, int d, int dv,
           float scale, int seg, int pos_offset, int run_rows, cudaStream_t st) {
  if (d > kWideMaxD || dv > kWideMaxDv || d % 8 || dv % 8 || run_rows <= 0
      || run_rows % kStepRows) {
    return cudaErrorInvalidValue;
  }
  if (c > repro::kTileRows) {   // past 64 landmark columns: the column-tiled kernel
    return d <= kCols
        ? repro::qs_ct::tc::launch_ct_tiles<1, false>(q, kl, mm, v, delta, out, nullptr, b,
                                                      n, c, d, dv, scale, seg, pos_offset,
                                                      run_rows, st)
        : repro::qs_ct::tc::launch_ct_tiles<kWideCT, false>(q, kl, mm, v, delta, out,
                                                            nullptr, b, n, c, d, dv, scale,
                                                            seg, pos_offset, run_rows, st);
  }
  return d <= kCols
      ? launch_tiles<1>(q, kl, mm, v, delta, out, b, n, c, d, dv, scale, seg, pos_offset,
                        run_rows, st)
      : launch_tiles<kWideCT>(q, kl, mm, v, delta, out, b, n, c, d, dv, scale, seg,
                              pos_offset, run_rows, st);
}

}  // namespace tc

}  // namespace

// Plain C entry point for ctypes. delta is fp32 (b,); q, k_l, M, v and out
// share the storage type: bf16 runs the tensor-core kernel (head dims
// multiples of 8) on runs of run_rows query rows (a multiple of 64,
// from the wrapper's query-tile plan), fp32 the FMA kernel (run_rows
// unused); c > 64 runs each one's column-tiled variant (query_side_ct.cuh).
// Returns cudaGetLastError() after the launch.
extern "C" int query_side_launch(
    const void* q, const void* kl, const void* mm, const void* v,
    const void* delta, void* out, int b, int n, int c, int d, int dv,
    float scale, int seg, int pos_offset, int run_rows, int dtype, void* stream) {
  if (d > kWideMaxD || dv > kWideMaxDv || b <= 0 || n <= 0 || c <= 0 || d <= 0 || dv <= 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == repro::kBF16) {
    return tc::launch(q, kl, mm, v, dl, out, b, n, c, d, dv, scale, seg, pos_offset,
                      run_rows, st);
  }
  if (dtype != repro::kF32) return cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(kl);
  const float* mf = static_cast<const float*>(mm);
  const float* vf = static_cast<const float*>(v);
  if (c > kMaxC) {   // past 64 landmark columns: the column-tiled kernel
    return d <= kMaxD && dv <= kMaxD
        ? repro::qs_ct::launch_ct_fp32<kMaxD, false>(qf, kf, mf, vf, dl,
                                                     static_cast<float*>(out), nullptr, b,
                                                     n, c, d, dv, scale, seg, pos_offset, st)
        : repro::qs_ct::launch_ct_fp32<kWideMaxD, false>(qf, kf, mf, vf, dl,
                                                         static_cast<float*>(out), nullptr,
                                                         b, n, c, d, dv, scale, seg,
                                                         pos_offset, st);
  }
  const dim3 grid(b, (n + kRows - 1) / kRows);
  if (d <= kMaxD && dv <= kMaxD) {
    query_side_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(kl),
        static_cast<const float*>(mm), static_cast<const float*>(v), dl,
        static_cast<float*>(out), n, c, d, dv, scale, seg, pos_offset);
    return static_cast<int>(cudaGetLastError());
  }
  static bool sized = false;   // past 48 KB of shared memory
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        query_side_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        fma_smem_bytes(kWideMaxD));
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  query_side_wide_kernel<<<grid, kThreads, fma_smem_bytes(kWideMaxD), st>>>(
      static_cast<const float*>(q), static_cast<const float*>(kl),
      static_cast<const float*>(mm), static_cast<const float*>(v), dl,
      static_cast<float*>(out), n, c, d, dv, scale, seg, pos_offset);
  return static_cast<int>(cudaGetLastError());
}
