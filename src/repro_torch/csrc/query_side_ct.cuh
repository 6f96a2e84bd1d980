// K2's kernels past 64 landmark columns (c > 64), shared by csrc/query_side.cu
// (K2 itself) and csrc/query_side_bwd.cu (K4's first pass, kStats = true,
// which writes each query row's softmax stats and D = rowsum(P o dP) = g .
// (P M) instead of out). Both walk the landmark axis in tiles of 64 columns
// as flash attention with K~ as the keys and M as the values: a running max
// and sum per query row, the fp32 P M accumulator rescaled when the max
// moves, a column tile wholly past the F-mask reach of a query block's last
// row skipped, the padded columns of the last tile masked, and the sum
// floored at 1e-30 at the end, as the reference's _query_side_probs
// (src/repro/kernels/ss_attention.py:311). Q and V (or g) are read once from
// device memory; K~ and M are read again for every query block, from L2.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace repro {
namespace qs_ct {

// ---- fp32: FMA loops ----------------------------------------------------------
constexpr int kThreads = 128;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = (kThreads / 32) * kRowsPerWarp;  // query rows per CTA
constexpr int kMaxC = 64;                              // landmark columns a tile (2 per lane)
// Dynamic shared memory at row stride kD: Q rows, K~ then M (rows padded to
// kD + 1 floats), P.
constexpr int fma_smem_bytes(int kD) {
  return (kRows * kD + kMaxC * (kD + 1) + kRows * kMaxC) * 4;
}

// fp32 past kMaxC landmark columns (c > 64): the FMA kernel's two passes
// per 64-column tile, flash attention with K~ as the keys and M as the
// values. Each warp keeps its rows' running max and sum in registers
// (every lane holds the same copy) and rescales its fp32 P.M accumulators
// when the max moves; a column tile wholly past the CTA's last row's F-mask
// reach is skipped. kD is the row stride of the tiles (kMaxD or
// kWideMaxD). kStats is K4's first pass (csrc/query_side_bwd.cu): `v`
// holds the cotangent g, and each row's fp32 (m, l, D) is written to
// stats (m at [0, b n), l at [b n, 2 b n), D = g . (P M) / l at [2 b n,
// 3 b n); m in natural units) instead of out.
template <int kD, bool kStats>
__global__ void __launch_bounds__(kThreads)
query_side_ct_kernel(const float* __restrict__ q, const float* __restrict__ kl,
                     const float* __restrict__ mm, const float* __restrict__ v,
                     const float* __restrict__ delta, float* __restrict__ out,
                     float* __restrict__ stats, int n, int c, int d, int dv, float scale,
                     int seg, int pos_offset) {
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

  for (int x = tid; x < kRows * d; x += kThreads) {
    const int r = x / d, col = x - r * d;
    q_s[r][col] = i0 + r < n ? qb[static_cast<size_t>(i0 + r) * d + col] : 0.f;
  }
  const int last = min(n, i0 + kRows) - 1;
  const int reach = seg > 0 ? min(c, (pos_offset + last) / seg + 1) : c;
  const int tiles = (reach + kMaxC - 1) / kMaxC;

  float mrun[kRowsPerWarp], lrun[kRowsPerWarp], corr[kRowsPerWarp];
  float o[kRowsPerWarp][kD / 32];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    mrun[rr] = repro::kNegInf;
    lrun[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < kD / 32; ++j) o[rr][j] = 0.f;
  }

  for (int lt = 0; lt < tiles; ++lt) {
    const int c0 = lt * kMaxC, ct = min(kMaxC, c - c0);
    __syncthreads();  // the previous tile's M is consumed (first: q_s written)
    for (int x = tid; x < ct * d; x += kThreads) {
      const int cc = x / d, col = x - cc * d;
      buf[cc][col] = klb[static_cast<size_t>(c0 + cc) * d + col];
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
        ok[t] = cc < ct && (seg == 0 || c0 + cc <= (pos_offset + i) / seg);
        s[t] = repro::kNegInf;
        if (ok[t]) {
          float dot = 0.f;
          for (int kk = 0; kk < d; ++kk) dot = fmaf(q_s[r][kk], buf[cc][kk], dot);
          s[t] = dot * scale;
        }
      }
      const float m_new = fmaxf(mrun[rr], repro::warp_max(fmaxf(s[0], s[1])));
      corr[rr] = expf(mrun[rr] - m_new);
      mrun[rr] = m_new;
      const float p0 = ok[0] ? expf(s[0] - m_new) : 0.f;
      const float p1 = ok[1] ? expf(s[1] - m_new) : 0.f;
      lrun[rr] = lrun[rr] * corr[rr] + repro::warp_sum(p0 + p1);
      p_s[r][lane] = p0;
      p_s[r][lane + 32] = p1;
    }
    __syncthreads();  // every row's P is in p_s; K~ no longer needed
    for (int x = tid; x < ct * dv; x += kThreads) {
      const int cc = x / dv, col = x - cc * dv;
      buf[cc][col] = mb[static_cast<size_t>(c0 + cc) * dv + col];
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
#pragma unroll
      for (int j = 0; j < kD / 32; ++j) {
        const int col = lane + 32 * j;
        if (col >= dv) continue;
        float a = o[rr][j] * corr[rr];
        for (int cc = 0; cc < ct; ++cc) a = fmaf(p_s[r][cc], buf[cc][col], a);
        o[rr][j] = a;
      }
    }
  }

  const float dlt = kStats ? 0.f : delta[bi];
  const size_t bn = static_cast<size_t>(gridDim.x) * n;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int i = i0 + r;
    if (i >= n) continue;
    const float inv = 1.f / fmaxf(lrun[rr], 1e-30f);
    float dsum = 0.f;
#pragma unroll
    for (int j = 0; j < kD / 32; ++j) {
      const int col = lane + 32 * j;
      if (col >= dv) continue;
      const size_t at = static_cast<size_t>(i) * dv + col;
      if constexpr (kStats) {
        dsum = fmaf(o[rr][j] * inv, vb[at], dsum);
      } else {
        out[static_cast<size_t>(bi) * n * dv + at] = o[rr][j] * inv + dlt * vb[at];
      }
    }
    if constexpr (kStats) {
      dsum = repro::warp_sum(dsum);
      if (lane == 0) {
        const size_t row = static_cast<size_t>(bi) * n + i;
        stats[row] = mrun[rr];
        stats[bn + row] = lrun[rr];
        stats[2 * bn + row] = dsum;
      }
    }
  }
}

template <int kD, bool kStats>
inline int launch_ct_fp32(const float* q, const float* kl, const float* mm, const float* v,
                   const float* delta, float* out, float* stats, int b, int n, int c, int d,
                   int dv, float scale, int seg, int pos_offset, cudaStream_t st) {
  static bool sized = false;   // past 48 KB of shared memory at the wide stride
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        query_side_ct_kernel<kD, kStats>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        fma_smem_bytes(kD));
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const dim3 grid(b, (n + kRows - 1) / kRows);
  query_side_ct_kernel<kD, kStats><<<grid, kThreads, fma_smem_bytes(kD), st>>>(
      q, kl, mm, v, delta, out, stats, n, c, d, dv, scale, seg, pos_offset);
  return static_cast<int>(cudaGetLastError());
}


// ---- bf16: tensor cores -------------------------------------------------------
namespace tc {

constexpr int kThreads = 128;              // one warpgroup
constexpr int kStepRows = repro::kTileRows;  // query rows per tile (= QUERY_TILE)
constexpr int kStages = 2;
constexpr int kCols = repro::kTileCols;    // columns of a tile

using bf16 = __nv_bfloat16;

// Past 64 landmark columns (c > kTileRows): flash attention over the
// landmark axis, K~ as the keys and M as the values. Steps walk the
// (query tile, landmark tile, column tile of d) triples in order, skipping
// the landmark tiles wholly past a query tile's F-mask reach (the reach of
// its last row). A step brings one Q column tile and the matching K~ column
// tile into a two-stage ring; a landmark tile's first step also brings its
// M tile (this CTA's value columns; own two-slot ring), and a query tile's
// first step its V tile (own two-slot ring). The last column tile's step
// updates each row's running max and sum in registers (base 2), rescales
// the fp32 P M accumulator when the max moves and adds P M by mma.sync;
// the query tile's last step divides by max(sum, 1e-30), adds delta V and
// writes as the 64-column kernel does. Padded columns of the last landmark
// tile are masked, its padded M rows zero-filled. kStats is K4's first pass
// (csrc/query_side_bwd.cu; d, dv <= 128): the V operand is the cotangent g,
// and the epilogue writes each row's fp32 (m in base 2, l, D = g . (P M) / l)
// to stats (m at [0, b n), l at [b n, 2 b n), D at [2 b n, 3 b n)) instead of
// out. 128 KB of shared memory and a 1 KB slack: one CTA an SM.
constexpr int ct_smem_bytes() { return 1024 + repro::kTileBytes * (2 * kStages + 2 + 2); }

template <int kCT, bool kStats>
__global__ void __launch_bounds__(kThreads)
query_side_tc_ct(const bf16* __restrict__ q, const bf16* __restrict__ kl,
                 const bf16* __restrict__ mm, const bf16* __restrict__ v,
                 const float* __restrict__ delta, bf16* __restrict__ out,
                 float* __restrict__ stats, int n, int c, int d, int dv, float scale,
                 int seg, int pos_offset, int run_rows) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (repro::smem_u32(smem_raw) + 1023u) & ~1023u;
  // ring stage st: Q column tile, K~ column tile; then M slots 0, 1; V slots 0, 1
  auto q_s = [&](int st) { return base + repro::kTileBytes * (2 * st); };
  auto k_s = [&](int st) { return q_s(st) + repro::kTileBytes; };
  auto m_s = [&](int sl) { return base + repro::kTileBytes * (2 * kStages + sl); };
  auto v_s = [&](int sl) { return base + repro::kTileBytes * (2 * kStages + 2 + sl); };
  const int dvt = (dv + kCols - 1) / kCols;
  const int run = blockIdx.x, bi = blockIdx.y / dvt, vt = blockIdx.y - bi * dvt;
  const int dv0 = vt * kCols, dvw = min(kCols, dv - dv0);
  const int row_begin = run * run_rows;
  const int row_end = min(n, row_begin + run_rows);
  const int tiles = (row_end - row_begin + kStepRows - 1) / kStepRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, qd = lane & 3;

  const bf16* qb = q + static_cast<size_t>(bi) * n * d;
  const bf16* klb = kl + static_cast<size_t>(bi) * c * d;
  const bf16* mb = mm + static_cast<size_t>(bi) * c * dv + dv0;
  const bf16* vb = v + static_cast<size_t>(bi) * n * dv + dv0;
  // landmark tiles query tile it reaches (its last row's F-mask reach)
  auto lt_count = [&](int it) {
    const int last = min(row_end, row_begin + (it + 1) * kStepRows) - 1;
    const int reach = seg > 0 ? min(c, (pos_offset + last) / seg + 1) : c;
    return (reach + repro::kTileRows - 1) / repro::kTileRows;
  };
  // step (it, lt, ct) is the sp-th step and (it, lt) the pr-th landmark step
  auto load_step = [&](int it, int lt, int ct, int sp, int pr) {
    const int i0 = row_begin + it * kStepRows, c0 = lt * repro::kTileRows;
    repro::load_tile(q_s(sp % kStages), qb + static_cast<size_t>(i0) * d + ct * kCols, d,
                     row_end - i0, d - ct * kCols, q, tid, kThreads);
    repro::load_tile(k_s(sp % kStages), klb + static_cast<size_t>(c0) * d + ct * kCols, d,
                     c - c0, d - ct * kCols, kl, tid, kThreads);
    if (ct == 0) {
      repro::load_tile(m_s(pr % 2), mb + static_cast<size_t>(c0) * dv, dv, c - c0, dvw, mm,
                       tid, kThreads);
      if (lt == 0)
        repro::load_tile(v_s(it % 2), vb + static_cast<size_t>(i0) * dv, dv, row_end - i0,
                         dvw, v, tid, kThreads);
    }
  };
  if (tiles <= 0) return;
  load_step(0, 0, 0, 0, 0);
  repro::cp_async_commit();

  const float sl2 = scale * repro::kLog2e;
  const float dlt = kStats ? 0.f : delta[bi];
  float s[32];
  float acc[16][4];
  float mx[2], lsum[2];
  int it = 0, lt = 0, ct = 0, sp = 0, pr = 0, lts = lt_count(0);

  while (it < tiles) {
    // the step after this one
    int nit = it, nlt = lt, nct = ct + 1, nlts = lts;
    if (nct == kCT) {
      nct = 0;
      if (++nlt == lts) {
        nlt = 0;
        if (++nit < tiles) nlts = lt_count(nit);
      }
    }
    const int npr = pr + (ct == kCT - 1 ? 1 : 0);
    if (nit < tiles) load_step(nit, nlt, nct, sp + 1, npr);  // its stage was released at sp - 1
    repro::cp_async_commit();
    repro::cp_async_wait<1>();  // step sp landed
    repro::fence_proxy_async();
    __syncthreads();

    const int i0 = row_begin + it * kStepRows, c0 = lt * repro::kTileRows;
    if (lt == 0 && ct == 0) {
      mx[0] = mx[1] = repro::kNegInf;
      lsum[0] = lsum[1] = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    if (ct == 0) {
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) repro::fence_operand(s[e]);
    repro::wgmma_fence();
    repro::issue_abt(s, q_s(sp % kStages), k_s(sp % kStages), ct > 0);
    repro::wgmma_commit();
    repro::wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 32; ++e) repro::fence_operand(s[e]);

    if (ct == kCT - 1) {
      // F-mask: row i sees global columns below min(c, (pos_offset + i) / seg + 1),
      // rows at or past n none; lim is that bound within this landmark tile.
      int lim[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = i0 + 16 * warp + gr + 8 * i;
        lim[i] = (row >= row_end ? 0 : seg > 0 ? min(c, (pos_offset + row) / seg + 1) : c) - c0;
      }
      float tmax[2] = {repro::kNegInf, repro::kNegInf};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * qd + (e & 1);
          s[4 * j + e] = col < lim[e >> 1] ? s[4 * j + e] * sl2 : repro::kNegInf;
          tmax[e >> 1] = fmaxf(tmax[e >> 1], s[4 * j + e]);
        }
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
        const float m_new = fmaxf(mx[i], tmax[i]);
        corr[i] = exp2f(mx[i] - m_new);
        mx[i] = m_new;
        lsum[i] *= corr[i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * qd + (e & 1);
          const float p = col < lim[e >> 1] ? exp2f(s[4 * j + e] - mx[e >> 1]) : 0.f;
          s[4 * j + e] = p;
          lsum[e >> 1] += p;
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }
      // acc += P M: P in bf16 from registers, M transposed from shared memory
      const int ksteps = min(4, (c - c0 + 15) / 16);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < ksteps) {
          uint32_t a[4];
          repro::a_frag(a, s, kk);
          repro::mma_a_btile(acc, a, m_s(pr % 2), 16 * kk, lane);
        }
      }

      if (lt == lts - 1) {
        float inv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 1);
          lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 2);
          inv[i] = 1.f / fmaxf(lsum[i], 1e-30f);
        }
        const uint32_t vt_s = v_s(it % 2);
        if constexpr (kStats) {
          // D = g . (P M) / l over this row's value columns, then the quad
          float dsum[2] = {0.f, 0.f};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = 16 * warp + gr + 8 * i;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int col = 8 * j + 2 * qd;
              const uint32_t off = repro::tile_off(row, col) + (col & 7) * 2;
              const float2 gv = repro::unpack_bf16(repro::ld_shared_b32(vt_s + off));
              dsum[i] = fmaf(acc[j][2 * i], gv.x, fmaf(acc[j][2 * i + 1], gv.y, dsum[i]));
            }
            dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], 1);
            dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], 2);
            const int grow = i0 + row;
            if (qd == 0 && grow < row_end) {
              const size_t bn = static_cast<size_t>(gridDim.y) * n;
              const size_t at = static_cast<size_t>(bi) * n + grow;
              stats[at] = mx[i];
              stats[bn + at] = lsum[i];
              stats[2 * bn + at] = dsum[i] * inv[i];
            }
          }
        } else {
          // out = acc / l + delta * v, staged as bf16 in this step's Q slot
          // (every warp's wgmma has read it), then written in 16-byte stores.
          __syncthreads();
          const uint32_t o_s = q_s(sp % kStages);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = 16 * warp + gr + 8 * i;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int col = 8 * j + 2 * qd;
              const uint32_t off = repro::tile_off(row, col) + (col & 7) * 2;
              const float2 vv = repro::unpack_bf16(repro::ld_shared_b32(vt_s + off));
              repro::st_shared_b32(o_s + off,
                                   repro::pack_bf16(acc[j][2 * i] * inv[i] + dlt * vv.x,
                                                    acc[j][2 * i + 1] * inv[i] + dlt * vv.y));
            }
          }
          __syncthreads();
          bf16* ob = out + static_cast<size_t>(bi) * n * dv + dv0;
          for (int x = tid; x < kStepRows * (repro::kTileCols / 8); x += kThreads) {
            const int r = x >> 4, col = (x & 15) * 8;
            if (i0 + r < row_end && col < dvw) {
              *reinterpret_cast<uint4*>(ob + static_cast<size_t>(i0 + r) * dv + col) =
                  repro::ld_shared_v4(o_s + repro::tile_off(r, col));
            }
          }
        }
      }
    }
    __syncthreads();  // the stage and slots are released for later steps
    it = nit;
    lt = nlt;
    ct = nct;
    lts = nlts;
    pr = npr;
    ++sp;
  }
}

template <int kCT, bool kStats>
inline int launch_ct_tiles(const void* q, const void* kl, const void* mm, const void* v,
                    const float* delta, void* out, float* stats, int b, int n, int c, int d,
                    int dv, float scale, int seg, int pos_offset, int run_rows,
                    cudaStream_t st) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        query_side_tc_ct<kCT, kStats>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ct_smem_bytes());
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const dim3 grid((n + run_rows - 1) / run_rows, b * ((dv + kCols - 1) / kCols));
  query_side_tc_ct<kCT, kStats><<<grid, kThreads, ct_smem_bytes(), st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kl),
      static_cast<const bf16*>(mm), static_cast<const bf16*>(v), delta,
      static_cast<bf16*>(out), stats, n, c, d, dv, scale, seg, pos_offset, run_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace qs_ct
}  // namespace repro
