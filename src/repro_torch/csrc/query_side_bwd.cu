// F-side backward: dQ, dK~, dM, dV, ddelta of
//   out = softmax(scale * Q K~^T) M + delta * V.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ss_attention_bwd.py:267
// query_side_bwd (body _query_side_bwd_kernel :206, probabilities
// _query_side_probs of ss_attention.py:311).
//
// What it computes, per batch-head b and query row i, with P the row
// softmax of K2 (segment-causal F-mask when seg > 0: column cc is valid iff
// cc <= (pos_offset + i) / seg) and g the cotangent of out:
//   dP_ic = g[i] . M[cc],  ds_ic = P_ic (dP_ic - sum_cc P_ic dP_ic) scale
//   dQ[i] = sum_cc ds_ic K~[cc],  dV[i] = delta g[i],
//   dK~ = sum_i ds_i^T Q[i],  dM = sum_i P_i^T g[i],  ddelta = sum_i g[i] . V[i].
// P is recomputed from Q and K~ (no stats). Sums are fp32; dQ and dV are
// written in their inputs' type, dK~ and dM in theirs, ddelta in fp32.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): at the training
// shape (b = 56, n = 4096, c = 64, d = dv = 128, seg = 64, bf16) it must read
// Q, V and g and write dQ and dV once (5 * 56 * 4096 * 128 * 2 B = 294 MB,
// 88 us); the products over the 7.5 M unmasked (row, column) pairs are
// 2 * 7.5e6 * 5 * 128 = 9.5 GFLOP (10 us at the bf16 rate): bytes-bound.
//
// The Pallas kernel sums dK~, dM and ddelta in VMEM scratch across its
// sequential grid; a CUDA grid has no order. So every kernel here owns one
// batch-head and a run of query rows (the wrapper's query-tile plan: one
// wave, 2 runs of 2048 rows per head at the training shape), writes fp32
// partials of dK~, dM and ddelta per run to a workspace (b, runs, ...) that
// the wrapper allocates (7.3 MB at the training shape), and
// qs_bwd_reduce, grid b x c,
// sums them over the runs in a fixed order and casts. No atomics: the
// gradients are bitwise deterministic. Two main kernels, chosen by the
// storage type (a dispatch, not a fallback):
//
// * bf16 (qs_bwd_tc): tensor cores. A CTA is two warpgroups (256 threads);
//   a step is 128 query rows, 64 per warpgroup (wgmma's M). K~ and M (c <= 64
//   rows, zero-padded to 64 and the padded columns masked) are loaded once
//   into 128-byte-swizzled tiles; Q, g and V stream through a two-stage
//   cp.async ring, zero-filled past n. Per step, each warpgroup issues
//   S = Q K~^T and dP = g M^T for its 64 rows by wgmma m64n64k16 and, while
//   they run, the CTA writes dV = delta g (16-byte stores) and adds g . v to
//   ddelta, both from the stage. P (row softmax in registers, base 2),
//   rowsum(P o dP) and dS = P o (dP - rowsum) scale are formed in registers,
//   rounded to bf16 and staged in the V slot (dead once ddelta is formed);
//   dQ = dS K~ by mma.sync m16n8k16 from registers, K~ read transposed by
//   ldmatrix, written from registers. Then warpgroup 0 adds dK~ += dS^T Q
//   and warpgroup 1 dM += P^T g over the step's 128 rows (mma.sync, A read
//   transposed from the staged tiles; a warp whose 16 landmark rows no row
//   of the step may attend skips), each accumulator 64 x 128 fp32 carried
//   in registers across the run: 64 a thread, beside S and dP (32 each) and
//   dQ (64): 219 registers a thread (ptxas, no spills), 56 K of the SM's 64
//   K. Shared memory: 230,400 B a CTA (1 KB alignment slack, K~ and M at 16
//   KB, two stages of Q, g and V at 32 KB each), one CTA an SM.
// * fp32 (qs_bwd_main): exact fp32 FMA loops, 256 threads. The CTA holds K~
//   and M (c x d, c x dv, fp32, rows padded to d + 1 floats) in dynamic
//   shared memory and walks its rows 16 at a time: each of the 8 warps
//   computes P and ds of 2 rows with lanes over the c columns, then thread
//   t writes dQ / dV of column t for 8 rows and adds the 16 rows into
//   column t of dK~ and dM for 32 of the c landmark rows, kept in
//   registers.
//
// Past 64 landmark columns (c > 64, chosen by c inside this file; c <= 64
// runs the kernels above unchanged). dS of a column needs its row's whole
// softmax and D = rowsum(P o dP), which needs every column, so a column
// tile cannot finish alone. D = sum_c P_ic (g_i . M_c) = g_i . (P M)_i,
// which a K2-style forward over the column tiles gives. Three launches:
//  1. K2's column-tiled kernel (query_side_ct.cuh) in stats mode on g:
//     each query row's fp32 (m, l, D) into a (3, b, n) workspace;
//  2. the main kernel (bf16 or fp32) with the landmark tile on a third grid
//     axis: a CTA owns (query run, batch-head, 64-column tile), rebuilds P
//     from (m, l) and dS from D, keeps today's accumulators of dK~ and dM
//     for its 64 landmark rows, writes its rows of the runs' partials (the
//     same workspace, summed by qs_bwd_reduce), and dQ as an fp32 partial
//     per column tile (b, tiles, n, d); a bf16 CTA starts at the first step
//     of its run that reaches its tile. dV and ddelta come from tile 0;
//  3. qs_bwd_dq_reduce sums each row's dQ partials over the tiles it
//     reaches, in tile order, and casts.
// No atomics: two launches give bitwise-equal gradients. The bf16 main
// kernel keeps its shared memory (230,400 B, one CTA an SM); ptxas reports
// its registers for both instances (PERF.md). The stats pass is the bf16
// column-tiled K2 kernel (129 KB). Extra traffic against the c <= 64
// kernel: the stats pass reads Q and g again, and dQ's partials are
// written and read once in fp32.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"
#include "query_side_ct.cuh"

namespace {

using repro::kNegInf;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per step
constexpr int kMaxC = 64;                     // landmark columns (2 per lane)
constexpr int kMaxD = 128;                    // max head dim (d and dv)
constexpr int kHalfC = kMaxC * kMaxD / kThreads;  // landmark rows per thread
static_assert(kThreads == 2 * kMaxD, "thread t: column t % 128, half t / 128");

struct Smem {
  float kl[kMaxC][kMaxD + 1];
  float mm[kMaxC][kMaxD + 1];
  float q[kRows][kMaxD];
  float g[kRows][kMaxD];
  float p[kRows][kMaxC];
  float ds[kRows][kMaxC];
  float red[kWarps];
};

// kTiled (c > kMaxC): the CTA takes landmark tile lt = blockIdx.z (rows
// [64 lt, 64 lt + 64) of K~ and M) and rebuilds P from the first pass's fp32
// stats (m, l, D of each query row: stats[0 .. b n), [b n ..), [2 b n ..));
// its dQ goes to the fp32 partial ws_dq (b, tiles, n, d), summed in tile
// order by qs_bwd_dq_reduce; dV and ddelta come from tile 0 only.
template <typename T, bool kTiled>
__global__ void __launch_bounds__(kThreads)
qs_bwd_main(const T* __restrict__ q, const T* __restrict__ kl,
            const T* __restrict__ mm, const T* __restrict__ v,
            const float* __restrict__ delta, const T* __restrict__ g,
            T* __restrict__ dq, T* __restrict__ dvo,
            float* __restrict__ ws_k, float* __restrict__ ws_m,
            float* __restrict__ ws_d, const float* __restrict__ stats,
            float* __restrict__ ws_dq, int n, int c, int d, int dv,
            float scale, int seg, int pos_offset, int run_rows) {
  extern __shared__ float smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int bi = blockIdx.x;
  const int run = blockIdx.y;
  const int runs = gridDim.y;
  const int lt = blockIdx.z, c0 = lt * kMaxC;
  const int ct = kTiled ? min(kMaxC, c - c0) : c;  // landmark rows of this CTA
  const size_t bn = static_cast<size_t>(gridDim.x) * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = tid & (kMaxD - 1);
  const int half = tid / kMaxD;
  const T* qb = q + static_cast<size_t>(bi) * n * d;
  const T* vb = v + static_cast<size_t>(bi) * n * dv;
  const T* gb = g + static_cast<size_t>(bi) * n * dv;
  T* dqb = dq + static_cast<size_t>(bi) * n * d;
  T* dvb = dvo + static_cast<size_t>(bi) * n * dv;

  for (int x = tid; x < ct * d; x += kThreads) {
    sm.kl[x / d][x % d] = repro::to_float(kl[(static_cast<size_t>(bi) * c + c0) * d + x]);
  }
  for (int x = tid; x < ct * dv; x += kThreads) {
    sm.mm[x / dv][x % dv] = repro::to_float(mm[(static_cast<size_t>(bi) * c + c0) * dv + x]);
  }
  const float dlt = delta[bi];
  const int i_begin = run * run_rows;
  const int i_end = min(n, i_begin + run_rows);

  float acc_k[kHalfC], acc_m[kHalfC];
#pragma unroll
  for (int t = 0; t < kHalfC; ++t) acc_k[t] = acc_m[t] = 0.f;
  float dd = 0.f;

  for (int i0 = i_begin; i0 < i_end; i0 += kRows) {
    __syncthreads();  // previous rows consumed (first pass: K~ and M written)
    for (int x = tid; x < kRows * d; x += kThreads) {
      const int r = x / d, cc = x - r * d;
      sm.q[r][cc] = i0 + r < i_end
          ? repro::to_float(qb[static_cast<size_t>(i0 + r) * d + cc]) : 0.f;
    }
    for (int x = tid; x < kRows * dv; x += kThreads) {
      const int r = x / dv, cc = x - r * dv;
      float gv = 0.f;
      if (i0 + r < i_end) {
        const size_t at = static_cast<size_t>(i0 + r) * dv + cc;
        gv = repro::to_float(gb[at]);
        if (lt == 0) dd = fmaf(gv, repro::to_float(vb[at]), dd);
      }
      sm.g[r][cc] = gv;
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int i = i0 + r;
      float s[2], dp[2];
      bool ok[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int cc = lane + 32 * t;
        ok[t] = i < i_end && cc < ct && (seg == 0 || c0 + cc <= (pos_offset + i) / seg);
        s[t] = kNegInf;
        dp[t] = 0.f;
        if (ok[t]) {
          float dot = 0.f, dpp = 0.f;
          for (int kk = 0; kk < d; ++kk) dot = fmaf(sm.q[r][kk], sm.kl[cc][kk], dot);
          for (int kk = 0; kk < dv; ++kk) dpp = fmaf(sm.g[r][kk], sm.mm[cc][kk], dpp);
          s[t] = dot * scale;
          dp[t] = dpp;
        }
      }
      float p0, p1, drow;
      if constexpr (kTiled) {
        // the row's softmax over all c columns, from the first pass
        const size_t at = static_cast<size_t>(bi) * n + min(i, n - 1);
        const float mi = stats[at], inv = 1.f / fmaxf(stats[bn + at], 1e-30f);
        p0 = ok[0] ? expf(s[0] - mi) * inv : 0.f;
        p1 = ok[1] ? expf(s[1] - mi) * inv : 0.f;
        drow = stats[2 * bn + at];
      } else {
        const float mx = repro::warp_max(fmaxf(s[0], s[1]));
        p0 = ok[0] ? expf(s[0] - mx) : 0.f;
        p1 = ok[1] ? expf(s[1] - mx) : 0.f;
        const float den = fmaxf(repro::warp_sum(p0 + p1), 1e-30f);
        p0 /= den;
        p1 /= den;
        drow = repro::warp_sum(p0 * dp[0] + p1 * dp[1]);
      }
      sm.p[r][lane] = p0;
      sm.p[r][lane + 32] = p1;
      sm.ds[r][lane] = p0 * (dp[0] - drow) * scale;
      sm.ds[r][lane + 32] = p1 * (dp[1] - drow) * scale;
    }
    __syncthreads();

    // dQ and dV of this step's rows: thread t writes column t % 128 of 8 rows.
#pragma unroll
    for (int rr = 0; rr < kRows / 2; ++rr) {
      const int r = half * (kRows / 2) + rr;
      const int i = i0 + r;
      if (i >= i_end) break;
      if (col < d) {
        float a = 0.f;
        for (int cc = 0; cc < ct; ++cc) a = fmaf(sm.ds[r][cc], sm.kl[cc][col], a);
        if constexpr (kTiled) {
          ws_dq[((static_cast<size_t>(bi) * gridDim.z + lt) * n + i) * d + col] = a;
        } else {
          dqb[static_cast<size_t>(i) * d + col] = repro::from_float<T>(a);
        }
      }
      if (col < dv && lt == 0) {
        dvb[static_cast<size_t>(i) * dv + col] = repro::from_float<T>(dlt * sm.g[r][col]);
      }
    }
    // Partials of dK~ and dM: landmark rows half * 32 + t, column t % 128.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float qv = col < d ? sm.q[r][col] : 0.f;
      const float gv = col < dv ? sm.g[r][col] : 0.f;
#pragma unroll
      for (int t = 0; t < kHalfC; ++t) {
        const int cc = half * kHalfC + t;
        acc_k[t] = fmaf(sm.ds[r][cc], qv, acc_k[t]);
        acc_m[t] = fmaf(sm.p[r][cc], gv, acc_m[t]);
      }
    }
  }

  const size_t part = static_cast<size_t>(bi) * runs + run;
#pragma unroll
  for (int t = 0; t < kHalfC; ++t) {
    const int cc = half * kHalfC + t;
    if (cc >= ct) break;
    if (col < d) ws_k[(part * c + c0 + cc) * d + col] = acc_k[t];
    if (col < dv) ws_m[(part * c + c0 + cc) * dv + col] = acc_m[t];
  }
  dd = repro::warp_sum(dd);
  if (lane == 0) sm.red[warp] = dd;
  __syncthreads();
  if (tid == 0 && lt == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += sm.red[w];
    ws_d[part] = s;
  }
}

// One CTA per (batch-head, landmark row): thread t < 128 sums column t of
// dK~, thread 128 + t column t of dM, over the runs in order; the CTA of
// landmark row 0 also sums ddelta.
template <typename T>
__global__ void __launch_bounds__(2 * kMaxD)
qs_bwd_reduce(const float* __restrict__ ws_k, const float* __restrict__ ws_m,
              const float* __restrict__ ws_d, T* __restrict__ dkl,
              T* __restrict__ dm, float* __restrict__ dd, int runs, int c,
              int d, int dv) {
  const int bi = blockIdx.x / c, row = blockIdx.x - bi * c;
  const int t = threadIdx.x;
  const size_t base = static_cast<size_t>(bi) * runs;
  const size_t rc = static_cast<size_t>(bi) * c + row;
  if (t < kMaxD) {
    if (t < d) {
      float s = 0.f;
      for (int r = 0; r < runs; ++r) s += ws_k[((base + r) * c + row) * d + t];
      dkl[rc * d + t] = repro::from_float<T>(s);
    }
  } else if (t - kMaxD < dv) {
    float s = 0.f;
    for (int r = 0; r < runs; ++r) s += ws_m[((base + r) * c + row) * dv + t - kMaxD];
    dm[rc * dv + t - kMaxD] = repro::from_float<T>(s);
  }
  if (row == 0 && t == 0) {
    float s = 0.f;
    for (int r = 0; r < runs; ++r) s += ws_d[base + r];
    dd[bi] = s;
  }
}

// Past 64 landmark columns: dQ of each query row as the sum, in tile order,
// of the fp32 partials ws_dq (b, tiles, n, d) of the landmark tiles the row
// reaches (its F-mask bound; every tile without seg). One CTA per kRows
// rows of one batch-head, a thread per column.
template <typename T>
__global__ void __launch_bounds__(kMaxD)
qs_bwd_dq_reduce(const float* __restrict__ ws_dq, T* __restrict__ dq, int n, int c,
                 int d, int seg, int pos_offset, int tiles) {
  const int bi = blockIdx.y, col = threadIdx.x;
  if (col >= d) return;
  for (int r = 0; r < kRows; ++r) {
    const int i = blockIdx.x * kRows + r;
    if (i >= n) break;
    const int lim = seg > 0 ? min(c, (pos_offset + i) / seg + 1) : c;
    const int nt = min(tiles, (lim + kMaxC - 1) / kMaxC);
    float a = 0.f;
    for (int t = 0; t < nt; ++t) {
      a += ws_dq[((static_cast<size_t>(bi) * tiles + t) * n + i) * d + col];
    }
    dq[(static_cast<size_t>(bi) * n + i) * d + col] = repro::from_float<T>(a);
  }
}

// ---- bf16: tensor cores over 128-row steps ----------------------------------
namespace tc {

constexpr int kThreads = 256;                     // two warpgroups
constexpr int kStepRows = 2 * repro::kTileRows;   // query rows per step (= QS_BWD_STEP_ROWS)
constexpr int kStages = 2;
constexpr int kStageBytes = 6 * repro::kTileBytes;  // Q, g, V: two 64-row tiles each
// 1024 B of alignment slack, K~ and M, then the Q/g/V ring.
constexpr int kSmemBytes = 1024 + 2 * repro::kTileBytes + kStages * kStageBytes;
constexpr int kStatsCtas = 264;  // CTAs of the first pass past 64 columns

using bf16 = __nv_bfloat16;

// 8 bf16 (16 bytes) times x as 8 bf16.
__device__ __forceinline__ uint4 scale8(uint4 a, float x) {
  uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = repro::unpack_bf16(w[k]);
    w[k] = repro::pack_bf16(f.x * x, f.y * x);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The dot product of two runs of 8 bf16, in fp32.
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 fa = repro::unpack_bf16(wa[k]), fb = repro::unpack_bf16(wb[k]);
    s = fmaf(fa.x, fb.x, fmaf(fa.y, fb.y, s));
  }
  return s;
}

// kTiled (c > 64): the CTA takes landmark tile lt = blockIdx.z (rows
// [64 lt, 64 lt + 64) of K~ and M), rebuilds P from the first pass's fp32
// stats (m in base 2, l, D of each query row: stats[0 .. b n), [b n ..),
// [2 b n ..)) instead of the row softmax, starts at the first step of its
// run that reaches the tile, writes dQ as an fp32 partial to ws_dq (b,
// tiles, n, d), summed in tile order by qs_bwd_dq_reduce, and leaves dV and
// ddelta to tile 0.
template <bool kTiled>
__global__ void __launch_bounds__(kThreads, 1)
qs_bwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ kl,
          const bf16* __restrict__ mm, const bf16* __restrict__ v,
          const float* __restrict__ delta, const bf16* __restrict__ g,
          bf16* __restrict__ dq, bf16* __restrict__ dvo, float* __restrict__ ws_k,
          float* __restrict__ ws_m, float* __restrict__ ws_d,
          const float* __restrict__ stats, float* __restrict__ ws_dq, int n, int c,
          int d, int dv, float scale, int seg, int pos_offset, int run_rows) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float red[kThreads / 32];
  const uint32_t kl_s = (repro::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t m_s = kl_s + repro::kTileBytes;
  const int run = blockIdx.x, runs = gridDim.x, bi = blockIdx.y;
  const int lt = blockIdx.z, c0 = lt * repro::kTileRows;
  const int ct = kTiled ? min(repro::kTileRows, c - c0) : c;  // landmark rows of this CTA
  const size_t bn = static_cast<size_t>(gridDim.y) * n;
  const int row_end = min(n, run * run_rows + run_rows);
  // the first row that reaches the tile: pos_offset + i >= c0 * seg
  const int first = kTiled && seg > 0 ? c0 * seg - pos_offset : 0;
  const int row_begin = run * run_rows
      + max(0, min(first - run * run_rows, row_end - run * run_rows)) / kStepRows * kStepRows;
  const int steps = (row_end - row_begin + kStepRows - 1) / kStepRows;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gr = lane >> 2, qd = lane & 3;

  const size_t qoff = static_cast<size_t>(bi) * n * d, voff = static_cast<size_t>(bi) * n * dv;
  // stage st: Q tiles 0, 1, then g tiles 0, 1, then V tiles 0, 1 (h = rows 64 h ..)
  auto q_s = [&](int st, int h) {
    return kl_s + 2 * repro::kTileBytes + st * kStageBytes + h * repro::kTileBytes;
  };
  auto g_s = [&](int st, int h) { return q_s(st, h) + 2 * repro::kTileBytes; };
  auto v_s = [&](int st, int h) { return q_s(st, h) + 4 * repro::kTileBytes; };
  auto load_step = [&](int it) {
    const int st = it % kStages;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i0 = row_begin + it * kStepRows + h * repro::kTileRows;
      repro::load_tile(q_s(st, h), q + qoff + static_cast<size_t>(i0) * d, d,
                       row_end - i0, d, q, tid, kThreads);
      repro::load_tile(g_s(st, h), g + voff + static_cast<size_t>(i0) * dv, dv,
                       row_end - i0, dv, g, tid, kThreads);
      repro::load_tile(v_s(st, h), v + voff + static_cast<size_t>(i0) * dv, dv,
                       row_end - i0, dv, v, tid, kThreads);
    }
  };
  repro::load_tile(kl_s, kl + (static_cast<size_t>(bi) * c + c0) * d, d, ct, d, kl, tid,
                   kThreads);
  repro::load_tile(m_s, mm + (static_cast<size_t>(bi) * c + c0) * dv, dv, ct, dv, mm, tid,
                   kThreads);
  if (steps > 0) load_step(0);
  repro::cp_async_commit();

  const float sl2 = scale * repro::kLog2e;
  const float dlt = delta[bi];
  const int ksteps = (ct + 15) / 16;  // k-steps of dS K~ that hold a landmark column
  // this warpgroup's persistent product: dK~ (warpgroup 0) or dM (1), landmark
  // rows 16 warp + gr (+ 8), columns 8 j + 2 qd (+ 1)
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float ddl = 0.f;

  for (int it = 0; it < steps; ++it) {
    const int st = it % kStages;
    const int i0 = row_begin + it * kStepRows;
    if (it + 1 < steps) load_step(it + 1);  // its stage was released at it - 1
    repro::cp_async_commit();
    repro::cp_async_wait<1>();  // step it (and K~, M) landed
    repro::fence_proxy_async();
    __syncthreads();

    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[e] = 0.f;
      dp[e] = 0.f;
      repro::fence_operand(s[e]);
      repro::fence_operand(dp[e]);
    }
    repro::wgmma_fence();
    repro::issue_abt(s, q_s(st, wg), kl_s);
    repro::issue_abt(dp, g_s(st, wg), m_s);
    repro::wgmma_commit();

    // While the products run: dV = delta g and ddelta += g . v, 16 bytes a
    // thread, rows below n only (tile 0 only, past 64 columns).
    for (int x = tid; lt == 0 && x < kStepRows * (repro::kTileCols / 8); x += kThreads) {
      const int r = x >> 4, col = (x & 15) * 8;
      if (i0 + r < row_end && col < dv) {
        const uint32_t off = repro::tile_off(r & 63, col);
        const uint4 gv = repro::ld_shared_v4(g_s(st, r >> 6) + off);
        ddl += dot8(gv, repro::ld_shared_v4(v_s(st, r >> 6) + off));
        *reinterpret_cast<uint4*>(dvo + voff + static_cast<size_t>(i0 + r) * dv + col) =
            scale8(gv, dlt);
      }
    }

    repro::wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      repro::fence_operand(s[e]);
      repro::fence_operand(dp[e]);
    }
    // P (F-mask: row i sees columns below min(c, (pos_offset + i) / seg + 1),
    // rows at or past n none), then dS = P o (dP - rowsum(P o dP)) scale.
    const int r_lo = 64 * wg + 16 * warp + gr;  // the thread's rows in the step
    int lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = i0 + r_lo + 8 * i;
      lim[i] = (row >= row_end ? 0 : seg > 0 ? min(c, (pos_offset + row) / seg + 1) : c) - c0;
    }
    float rs[2] = {0.f, 0.f};
    if constexpr (kTiled) {
      // P from the row's stats over all c columns; rowsum(P o dP) is D
      float m2[2], inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const size_t at = static_cast<size_t>(bi) * n + min(i0 + r_lo + 8 * i, n - 1);
        m2[i] = stats[at];
        inv[i] = 1.f / fmaxf(stats[bn + at], 1e-30f);
        rs[i] = stats[2 * bn + at];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * qd + (e & 1), i = e >> 1;
          s[4 * j + e] = col < lim[i] ? exp2f(s[4 * j + e] * sl2 - m2[i]) * inv[i] : 0.f;
        }
      }
    } else {
      repro::row_softmax64(s, lim, sl2, qd);
#pragma unroll
      for (int e = 0; e < 32; ++e) rs[(e >> 1) & 1] += s[e] * dp[e];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      }
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) dp[e] = s[e] * (dp[e] - rs[(e >> 1) & 1]) * scale;

    __syncthreads();  // every thread has read V: its slot takes P and dS
    const uint32_t p_s = v_s(st, 0), ds_s = v_s(st, 1);  // (128 rows, 64 columns) each
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = 8 * j + 2 * qd;
        const uint32_t off = repro::tile_off(r_lo + 8 * i, col) + (col & 7) * 2;
        repro::st_shared_b32(p_s + off, repro::pack_bf16(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
        repro::st_shared_b32(ds_s + off, repro::pack_bf16(dp[4 * j + 2 * i], dp[4 * j + 2 * i + 1]));
      }
    }

    // dQ = dS K~ for this warpgroup's rows: dS from registers, K~ transposed
    {
      float dqa[16][4];
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < ksteps) {
          uint32_t a[4];
          repro::a_frag(a, dp, kk);
          repro::mma_a_btile(dqa, a, kl_s, 16 * kk, lane);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = i0 + r_lo + 8 * i;
        if (row >= row_end) continue;
        if constexpr (kTiled) {
          float* o = ws_dq + ((static_cast<size_t>(bi) * gridDim.z + lt) * n + row) * d;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = 8 * j + 2 * qd;
            if (col < d) {
              *reinterpret_cast<float2*>(o + col) = make_float2(dqa[j][2 * i], dqa[j][2 * i + 1]);
            }
          }
        } else {
          bf16* o = dq + qoff + static_cast<size_t>(row) * d;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = 8 * j + 2 * qd;
            if (col < d) {
              *reinterpret_cast<__nv_bfloat162*>(o + col) =
                  __floats2bfloat162_rn(dqa[j][2 * i], dqa[j][2 * i + 1]);
            }
          }
        }
      }
    }
    __syncthreads();  // P and dS staged

    // Warpgroup 0: dK~ += dS^T Q; warpgroup 1: dM += P^T g, over the step's
    // rows. A warp whose landmark rows no row of the step may attend (their P
    // and dS are zeros) skips; so does a 64-row half past n.
    const int last = min(row_end, i0 + kStepRows) - 1;
    const int reach = (seg > 0 ? min(c, (pos_offset + last) / seg + 1) : c) - c0;
    if (16 * warp < reach) {
      const uint32_t at = wg == 0 ? ds_s : p_s;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (i0 + h * repro::kTileRows >= row_end) break;
        const uint32_t bt = wg == 0 ? q_s(st, h) : g_s(st, h);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t a[4];
          repro::a_frag_trans(a, at, h * repro::kTileRows + 16 * kk, 16 * warp, lane);
          repro::mma_a_btile(acc, a, bt, 16 * kk, lane);
        }
      }
    }
    __syncthreads();  // the stage is released for step it + kStages
  }

  // fp32 partials of this run: dK~ (warpgroup 0) or dM (1), then ddelta
  const size_t part = static_cast<size_t>(bi) * runs + run;
  const int cols = wg == 0 ? d : dv;
  float* w = (wg == 0 ? ws_k : ws_m) + (part * c + c0) * cols;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = 16 * warp + gr + 8 * i;
    if (row >= ct) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * qd;
      if (col < cols) {
        *reinterpret_cast<float2*>(w + static_cast<size_t>(row) * cols + col) =
            make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
      }
    }
  }
  ddl = repro::warp_sum(ddl);
  if (lane == 0) red[tid >> 5] = ddl;
  __syncthreads();
  if (tid == 0 && lt == 0) {
    float s = 0.f;
    for (int k = 0; k < kThreads / 32; ++k) s += red[k];
    ws_d[part] = s;
  }
}

template <bool kTiled>
int launch_main(const void* q, const void* kl, const void* mm, const void* v,
                const float* delta, const void* g, void* dq, void* dv_out, float* ws_k,
                float* ws_m, float* ws_d, const float* stats, float* ws_dq, int runs,
                int tiles, int n, int b, int c, int d, int dv, float scale, int seg,
                int pos_offset, int run_rows, cudaStream_t st) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        qs_bwd_tc<kTiled>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  qs_bwd_tc<kTiled><<<dim3(runs, b, tiles), kThreads, kSmemBytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kl),
      static_cast<const bf16*>(mm), static_cast<const bf16*>(v), delta,
      static_cast<const bf16*>(g), static_cast<bf16*>(dq), static_cast<bf16*>(dv_out),
      ws_k, ws_m, ws_d, stats, ws_dq, n, c, d, dv, scale, seg, pos_offset, run_rows);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* kl, const void* mm, const void* v,
           const float* delta, const void* g, void* dq, void* dv_out, float* ws_k,
           float* ws_m, float* ws_d, float* stats, float* ws_dq, int runs, int n, int b,
           int c, int d, int dv, float scale, int seg, int pos_offset, int run_rows,
           cudaStream_t st) {
  if (d % 8 || dv % 8 || run_rows % kStepRows) return cudaErrorInvalidValue;
  if (c <= repro::kTileRows) {
    return launch_main<false>(q, kl, mm, v, delta, g, dq, dv_out, ws_k, ws_m, ws_d, nullptr,
                              nullptr, runs, 1, n, b, c, d, dv, scale, seg, pos_offset,
                              run_rows, st);
  }
  // past 64 landmark columns: the rows' stats first (K2's column-tiled kernel
  // on g), then a landmark tile a grid slice, then dQ's partials summed
  if (stats == nullptr || ws_dq == nullptr) return cudaErrorInvalidValue;
  // the first pass's query runs: about kStatsCtas CTAs (one an SM at its
  // 129 KB of shared memory: two waves)
  const int qsteps = (n + repro::kTileRows - 1) / repro::kTileRows;
  const int want = max(1, min(qsteps, (kStatsCtas + b - 1) / b));
  int err = repro::qs_ct::tc::launch_ct_tiles<1, true>(
      q, kl, mm, g, nullptr, nullptr, stats, b, n, c, d, dv, scale, seg, pos_offset,
      repro::kTileRows * ((qsteps + want - 1) / want), st);
  if (err != cudaSuccess) return err;
  const int tiles = (c + repro::kTileRows - 1) / repro::kTileRows;
  err = launch_main<true>(q, kl, mm, v, delta, g, dq, dv_out, ws_k, ws_m, ws_d, stats,
                          ws_dq, runs, tiles, n, b, c, d, dv, scale, seg, pos_offset,
                          run_rows, st);
  if (err != cudaSuccess) return err;
  qs_bwd_dq_reduce<bf16><<<dim3((n + kRows - 1) / kRows, b), kMaxD, 0, st>>>(
      ws_dq, static_cast<bf16*>(dq), n, c, d, seg, pos_offset, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <typename T, bool kTiled>
int launch_fma(const void* q, const void* kl, const void* mm, const void* v,
               const float* delta, const void* g, void* dq, void* dv_out, float* ws_k,
               float* ws_m, float* ws_d, const float* stats, float* ws_dq, int b, int runs,
               int tiles, int n, int c, int d, int dv, float scale, int seg,
               int pos_offset, int run_rows, cudaStream_t st) {
  const int smem = static_cast<int>(sizeof(Smem));
  const cudaError_t err = cudaFuncSetAttribute(
      qs_bwd_main<T, kTiled>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  qs_bwd_main<T, kTiled><<<dim3(b, runs, tiles), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kl),
      static_cast<const T*>(mm), static_cast<const T*>(v), delta,
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dv_out),
      ws_k, ws_m, ws_d, stats, ws_dq, n, c, d, dv, scale, seg, pos_offset, run_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* q, const void* kl, const void* mm, const void* v,
                 const float* delta, const void* g, void* dq, void* dkl,
                 void* dm, void* dv_out, float* dd, float* ws_k, float* ws_m,
                 float* ws_d, float* stats, float* ws_dq, int b, int n, int c, int d,
                 int dv, float scale, int seg, int pos_offset, int run_rows,
                 cudaStream_t st) {
  const int runs = (n + run_rows - 1) / run_rows;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const int rc = tc::launch(q, kl, mm, v, delta, g, dq, dv_out, ws_k, ws_m, ws_d, stats,
                              ws_dq, runs, n, b, c, d, dv, scale, seg, pos_offset, run_rows,
                              st);
    if (rc != 0) return rc;
  } else if (c <= kMaxC) {
    const int rc = launch_fma<T, false>(q, kl, mm, v, delta, g, dq, dv_out, ws_k, ws_m,
                                        ws_d, nullptr, nullptr, b, runs, 1, n, c, d, dv,
                                        scale, seg, pos_offset, run_rows, st);
    if (rc != 0) return rc;
  } else {
    // past 64 landmark columns: the rows' stats (K2's column-tiled FMA
    // kernel on g), a landmark tile a grid slice, then dQ's partials summed
    if (stats == nullptr || ws_dq == nullptr) return cudaErrorInvalidValue;
    int rc = repro::qs_ct::launch_ct_fp32<kMaxD, true>(
        static_cast<const float*>(q), static_cast<const float*>(kl),
        static_cast<const float*>(mm), static_cast<const float*>(g), nullptr, nullptr,
        stats, b, n, c, d, dv, scale, seg, pos_offset, st);
    if (rc != 0) return rc;
    const int tiles = (c + kMaxC - 1) / kMaxC;
    rc = launch_fma<T, true>(q, kl, mm, v, delta, g, dq, dv_out, ws_k, ws_m, ws_d, stats,
                             ws_dq, b, runs, tiles, n, c, d, dv, scale, seg, pos_offset,
                             run_rows, st);
    if (rc != 0) return rc;
    qs_bwd_dq_reduce<T><<<dim3((n + kRows - 1) / kRows, b), kMaxD, 0, st>>>(
        ws_dq, static_cast<T*>(dq), n, c, d, seg, pos_offset, tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  qs_bwd_reduce<T><<<b * c, 2 * kMaxD, 0, st>>>(ws_k, ws_m, ws_d, static_cast<T*>(dkl),
                                                static_cast<T*>(dm), dd, runs, c, d, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. q, k_l, M, v, g and the dQ, dK~, dM, dV
// outputs share the storage type; delta and ddelta are fp32 (b,). Each CTA
// owns a run of run_rows query rows of one batch-head (from the wrapper's
// query-tile plan; a multiple of 128 for bf16): runs = ceil(n / run_rows).
// ws_k (b, runs, c, d), ws_m (b, runs, c, dv) and ws_d (b, runs) are the
// fp32 workspace of the runs' partials. bf16 runs the tensor-core kernel
// (head dims multiples of 8), fp32 the FMA kernel. Past 64 landmark
// columns stats (3, b, n) and ws_dq (b, ceil(c / 64), n, d) are the fp32
// workspaces of the rows' softmax stats and dQ's per-tile partials (null
// for c <= 64). Returns cudaGetLastError() after the launches (0 =
// launched).
extern "C" int query_side_bwd_launch(
    const void* q, const void* kl, const void* mm, const void* v,
    const void* delta, const void* g, void* dq, void* dkl, void* dm,
    void* dv_out, void* dd, void* ws_k, void* ws_m, void* ws_d, void* stats,
    void* ws_dq, int b, int n, int c, int d, int dv, float scale, int seg,
    int pos_offset, int run_rows, int dtype, void* stream) {
  if (d > kMaxD || dv > kMaxD || b <= 0 || n <= 0 || c <= 0 || run_rows <= 0) {
    return cudaErrorInvalidValue;
  }
  float* sf = static_cast<float*>(stats);
  float* wq = static_cast<float*>(ws_dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dl = static_cast<const float*>(delta);
  float* ddf = static_cast<float*>(dd);
  float* wk = static_cast<float*>(ws_k);
  float* wm = static_cast<float*>(ws_m);
  float* wd = static_cast<float*>(ws_d);
  if (dtype == repro::kF32) {
    return launch_typed<float>(q, kl, mm, v, dl, g, dq, dkl, dm, dv_out, ddf, wk, wm, wd, sf, wq, b, n, c, d, dv, scale, seg, pos_offset, run_rows, st);
  }
  if (dtype == repro::kBF16) {
    return launch_typed<__nv_bfloat16>(q, kl, mm, v, dl, g, dq, dkl, dm, dv_out, ddf, wk, wm, wd, sf, wq, b, n, c, d, dv, scale, seg, pos_offset, run_rows, st);
  }
  return cudaErrorInvalidValue;
}
