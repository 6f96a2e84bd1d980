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
// Design. The softmax axis c is resident, so each query row is independent
// and dQ / dV stream out. The Pallas kernel sums dK~, dM and ddelta in VMEM
// scratch across its sequential grid; a CUDA grid has no order, so:
//  * qs_bwd_main, grid (b, ceil(n / 256)), 256 threads: a CTA owns 256 query
//    rows and holds K~ and M (c x d, c x dv, fp32, rows padded to d + 1
//    floats) in dynamic shared memory. It walks its rows 16 at a time: each
//    of the 8 warps computes P and ds of 2 rows with lanes over the c
//    columns, then thread t writes dQ / dV of column t for 8 rows and adds
//    the 16 rows into column t of dK~ and dM for 32 of the c landmark rows,
//    kept in registers. Each CTA writes its fp32 partials of dK~, dM and
//    ddelta to a workspace (b, blocks, ...) that the wrapper allocates.
//  * qs_bwd_reduce, grid (b): sums the partials over the blocks in a fixed
//    order and casts. No atomics, so the grads are bitwise deterministic.
// Products are fp32 FMA loops; tensor cores and TMA are later work.
#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per step
constexpr int kBlockRows = 256;               // query rows per CTA (= K4_BLOCK_ROWS)
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
qs_bwd_main(const T* __restrict__ q, const T* __restrict__ kl,
            const T* __restrict__ mm, const T* __restrict__ v,
            const float* __restrict__ delta, const T* __restrict__ g,
            T* __restrict__ dq, T* __restrict__ dvo,
            float* __restrict__ ws_k, float* __restrict__ ws_m,
            float* __restrict__ ws_d, int n, int c, int d, int dv,
            float scale, int seg, int pos_offset) {
  extern __shared__ float smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int bi = blockIdx.x;
  const int blk = blockIdx.y;
  const int blocks = gridDim.y;
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

  for (int x = tid; x < c * d; x += kThreads) {
    sm.kl[x / d][x % d] = repro::to_float(kl[static_cast<size_t>(bi) * c * d + x]);
  }
  for (int x = tid; x < c * dv; x += kThreads) {
    sm.mm[x / dv][x % dv] = repro::to_float(mm[static_cast<size_t>(bi) * c * dv + x]);
  }
  const float dlt = delta[bi];
  const int i_begin = blk * kBlockRows;
  const int i_end = min(n, i_begin + kBlockRows);

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
        dd = fmaf(gv, repro::to_float(vb[at]), dd);
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
        ok[t] = i < i_end && cc < c && (seg == 0 || cc <= (pos_offset + i) / seg);
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
      const float mx = repro::warp_max(fmaxf(s[0], s[1]));
      float p0 = ok[0] ? expf(s[0] - mx) : 0.f;
      float p1 = ok[1] ? expf(s[1] - mx) : 0.f;
      const float den = fmaxf(repro::warp_sum(p0 + p1), 1e-30f);
      p0 /= den;
      p1 /= den;
      const float drow = repro::warp_sum(p0 * dp[0] + p1 * dp[1]);
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
        for (int cc = 0; cc < c; ++cc) a = fmaf(sm.ds[r][cc], sm.kl[cc][col], a);
        dqb[static_cast<size_t>(i) * d + col] = repro::from_float<T>(a);
      }
      if (col < dv) {
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

  const size_t part = static_cast<size_t>(bi) * blocks + blk;
#pragma unroll
  for (int t = 0; t < kHalfC; ++t) {
    const int cc = half * kHalfC + t;
    if (cc >= c) break;
    if (col < d) ws_k[(part * c + cc) * d + col] = acc_k[t];
    if (col < dv) ws_m[(part * c + cc) * dv + col] = acc_m[t];
  }
  dd = repro::warp_sum(dd);
  if (lane == 0) sm.red[warp] = dd;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += sm.red[w];
    ws_d[part] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
qs_bwd_reduce(const float* __restrict__ ws_k, const float* __restrict__ ws_m,
              const float* __restrict__ ws_d, T* __restrict__ dkl,
              T* __restrict__ dm, float* __restrict__ dd, int blocks, int c,
              int d, int dv) {
  const int bi = blockIdx.x;
  const size_t base = static_cast<size_t>(bi) * blocks;
  for (int x = threadIdx.x; x < c * d; x += kThreads) {
    float s = 0.f;
    for (int blk = 0; blk < blocks; ++blk) s += ws_k[(base + blk) * c * d + x];
    dkl[static_cast<size_t>(bi) * c * d + x] = repro::from_float<T>(s);
  }
  for (int x = threadIdx.x; x < c * dv; x += kThreads) {
    float s = 0.f;
    for (int blk = 0; blk < blocks; ++blk) s += ws_m[(base + blk) * c * dv + x];
    dm[static_cast<size_t>(bi) * c * dv + x] = repro::from_float<T>(s);
  }
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int blk = 0; blk < blocks; ++blk) s += ws_d[base + blk];
    dd[bi] = s;
  }
}

template <typename T>
int launch_typed(const void* q, const void* kl, const void* mm, const void* v,
                 const float* delta, const void* g, void* dq, void* dkl,
                 void* dm, void* dv_out, float* dd, float* ws_k, float* ws_m,
                 float* ws_d, int b, int n, int c, int d, int dv, float scale,
                 int seg, int pos_offset, cudaStream_t st) {
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      qs_bwd_main<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kBlockRows - 1) / kBlockRows;
  qs_bwd_main<T><<<dim3(b, blocks), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kl),
      static_cast<const T*>(mm), static_cast<const T*>(v), delta,
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dv_out),
      ws_k, ws_m, ws_d, n, c, d, dv, scale, seg, pos_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  qs_bwd_reduce<T><<<b, kThreads, 0, st>>>(ws_k, ws_m, ws_d,
                                           static_cast<T*>(dkl),
                                           static_cast<T*>(dm), dd, blocks, c,
                                           d, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. q, k_l, M, v, g and the dQ, dK~, dM, dV
// outputs share the storage type; delta and ddelta are fp32 (b,). ws_k
// (b, blocks, c, d), ws_m (b, blocks, c, dv) and ws_d (b, blocks) are fp32
// scratch with blocks = ceil(n / kBlockRows) (the wrapper's
// K4_BLOCK_ROWS, held equal by a test). Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int query_side_bwd_launch(
    const void* q, const void* kl, const void* mm, const void* v,
    const void* delta, const void* g, void* dq, void* dkl, void* dm,
    void* dv_out, void* dd, void* ws_k, void* ws_m, void* ws_d, int b, int n,
    int c, int d, int dv, float scale, int seg, int pos_offset, int dtype,
    void* stream) {
  if (d > kMaxD || dv > kMaxD || c > kMaxC || b <= 0 || n <= 0 || c <= 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dl = static_cast<const float*>(delta);
  float* ddf = static_cast<float*>(dd);
  float* wk = static_cast<float*>(ws_k);
  float* wm = static_cast<float*>(ws_m);
  float* wd = static_cast<float*>(ws_d);
  if (dtype == repro::kF32) {
    return launch_typed<float>(q, kl, mm, v, dl, g, dq, dkl, dm, dv_out, ddf, wk, wm, wd, b, n, c, d, dv, scale, seg, pos_offset, st);
  }
  if (dtype == repro::kBF16) {
    return launch_typed<__nv_bfloat16>(q, kl, mm, v, dl, g, dq, dkl, dm, dv_out, ddf, wk, wm, wd, b, n, c, d, dv, scale, seg, pos_offset, st);
  }
  return cudaErrorInvalidValue;
}
