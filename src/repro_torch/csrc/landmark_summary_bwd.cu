// B-side backward: dQ~, dK, dV of BV = softmax(scale * Q~ K^T) V.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ss_attention_bwd.py:117
// landmark_summary_bwd (body _landmark_summary_bwd_kernel :49, mask
// _b_side_mask of ss_attention.py:62).
//
// What it computes, per batch-head b, landmark row r and key j (valid iff
// j < kv_valid, kv_valid already clamped to n by the wrapper, and, when
// seg > 0, j < (r + 1) * seg):
//   p_rj  = exp(scale * q_l[r] . k[j] - m_r) / max(l_r, 1e-30), 0 if masked
//   ds_rj = p_rj * (g[r] . v[j] - D_r) * scale
//   dV[j] = sum_r p_rj g[r],  dK[j] = sum_r ds_rj q_l[r],
//   dQ~[r] = sum_j ds_rj k[j],
// from the forward's fp32 stats (m, l) and D_r = g[r] . BV[r] (computed by
// the wrapper), so P is rebuilt exactly, without a second reduction pass.
// A row with no valid key has l = 0 and keeps p = 0. Sums are fp32; dQ~
// is written in q_l's type, dK and dV in k's / v's.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): at the training
// shape (b = 56 batch-heads, c = 64, n = 4096, d = dv = 128, seg = 64, bf16)
// it must read K and V and write dK and dV once (4 * 56 * 4096 * 128 * 2 B
// = 235 MB, 70 us); the 5 products over the 7.5 M attended (row, key) pairs
// are 2 * 7.5e6 * 5 * 128 = 9.5 GFLOP (10 us at the bf16 rate), so it is
// bytes-bound.
//
// Design. The Pallas kernel walks key blocks in order and carries dQ~ in
// VMEM scratch across them. A CUDA grid has no order, so the work is split
// over two kernels launched back to back on one stream, neither with
// atomics, so the grads are bitwise deterministic:
//  * keys pass (ls_bwd_keys_pass), grid (b, ceil(n / 32)): a CTA owns 32
//    keys and keeps their K/V rows in shared memory (padded to d + 1
//    floats, conflict-free). It
//    walks the landmark rows 8 at a time, from the first row that may
//    attend its first key (segment-causal: row t0 / seg) to c; each warp
//    rebuilds p and ds of 2 rows with a lane per key, then thread t adds
//    the 8 rows into column t of dK and dV for all 32 keys, kept in
//    registers. Every key in [0, n) is written, so keys that no row may
//    attend, or at or past kv_valid, get exact zeros.
//  * rows pass (ls_bwd_rows_pass), grid (b, ceil(c / 8)): K1's shape. A
//    CTA owns 8 landmark rows, streams the keys they may attend in 32-key
//    tiles, rebuilds ds and accumulates dQ~ in registers.
// Products are fp32 FMA loops; tensor cores and TMA are later work.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;  // landmark rows per step
constexpr int kTileN = 32;                    // keys per shared tile
constexpr int kMaxD = 128;                    // max head dim (d and dv)
static_assert(kThreads == kMaxD, "keys pass: one thread per column");

// Rebuild p and ds of landmark row `row` against key `key` from the shared
// rows qr (d), gr (dv) and the shared key/value rows kj (d), vj (dv).
__device__ __forceinline__ void rebuild(const float* qr, const float* gr,
                                        const float* kj, const float* vj,
                                        int d, int dv, float scale, float m,
                                        float l, float dcoef, float* p,
                                        float* ds) {
  float dot = 0.f, dp = 0.f;
  for (int kk = 0; kk < d; ++kk) dot = fmaf(qr[kk], kj[kk], dot);
  for (int kk = 0; kk < dv; ++kk) dp = fmaf(gr[kk], vj[kk], dp);
  *p = expf(dot * scale - m) / fmaxf(l, 1e-30f);
  *ds = *p * (dp - dcoef) * scale;
}

template <typename TQ, typename T>
__global__ void __launch_bounds__(kThreads)
ls_bwd_keys_pass(const TQ* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ g,
                 const float* __restrict__ m, const float* __restrict__ l,
                 const float* __restrict__ dcoef, T* __restrict__ dk,
                 T* __restrict__ dvo, int c, int n, int d, int dv, float scale,
                 int kv_valid, int seg) {
  __shared__ float k_s[kTileN][kMaxD + 1];
  __shared__ float v_s[kTileN][kMaxD + 1];
  __shared__ float q_s[kRows][kMaxD];
  __shared__ float g_s[kRows][kMaxD];
  __shared__ float p_s[kRows][kTileN];
  __shared__ float ds_s[kRows][kTileN];

  const int bi = blockIdx.x;
  const int t0 = blockIdx.y * kTileN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t bc = static_cast<size_t>(bi) * c;
  const TQ* qb = q + bc * d;
  const T* gb = g + bc * dv;
  const T* kb = k + static_cast<size_t>(bi) * n * d;
  const T* vb = v + static_cast<size_t>(bi) * n * dv;

  const int n_end = min(n, kv_valid);
  for (int i = tid; i < kTileN * d; i += kThreads) {
    const int j = i / d, col = i - j * d;
    k_s[j][col] = t0 + j < n_end
        ? repro::to_float(kb[static_cast<size_t>(t0 + j) * d + col]) : 0.f;
  }
  for (int i = tid; i < kTileN * dv; i += kThreads) {
    const int j = i / dv, col = i - j * dv;
    v_s[j][col] = t0 + j < n_end
        ? repro::to_float(vb[static_cast<size_t>(t0 + j) * dv + col]) : 0.f;
  }
  // Rows [r_begin, r_end) are the only ones that may attend a key of this
  // tile: none when the tile starts at or past the valid end; under the
  // segment-causal mask, row r attends key t0 only if t0 < (r + 1) * seg.
  const int r_end = t0 < n_end ? c : 0;
  const int r_begin = seg > 0 ? (min(t0 / seg, c) / kRows) * kRows : 0;

  const int col = tid;
  float acc_k[kTileN], acc_v[kTileN];
#pragma unroll
  for (int j = 0; j < kTileN; ++j) acc_k[j] = acc_v[j] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kRows) {
    __syncthreads();  // previous rows consumed (first pass: K/V tile written)
    for (int i = tid; i < kRows * d; i += kThreads) {
      const int r = i / d, cc = i - r * d;
      q_s[r][cc] = r0 + r < c
          ? repro::to_float(qb[static_cast<size_t>(r0 + r) * d + cc]) : 0.f;
    }
    for (int i = tid; i < kRows * dv; i += kThreads) {
      const int r = i / dv, cc = i - r * dv;
      g_s[r][cc] = r0 + r < c
          ? repro::to_float(gb[static_cast<size_t>(r0 + r) * dv + cc]) : 0.f;
    }
    __syncthreads();
    const int key = t0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int row = r0 + r;
      bool valid = row < c && key < n_end;
      if (seg > 0) valid = valid && key < (row + 1) * seg;
      float p = 0.f, ds = 0.f;
      if (valid) {
        rebuild(q_s[r], g_s[r], k_s[lane], v_s[lane], d, dv, scale, m[bc + row],
                l[bc + row], dcoef[bc + row], &p, &ds);
      }
      p_s[r][lane] = p;
      ds_s[r][lane] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float qv = col < d ? q_s[r][col] : 0.f;
      const float gv = col < dv ? g_s[r][col] : 0.f;
#pragma unroll
      for (int j = 0; j < kTileN; ++j) {
        acc_k[j] = fmaf(ds_s[r][j], qv, acc_k[j]);
        acc_v[j] = fmaf(p_s[r][j], gv, acc_v[j]);
      }
    }
  }

  T* dkb = dk + static_cast<size_t>(bi) * n * d;
  T* dvb = dvo + static_cast<size_t>(bi) * n * dv;
#pragma unroll
  for (int j = 0; j < kTileN; ++j) {
    const int key = t0 + j;
    if (key >= n) break;
    if (col < d) dkb[static_cast<size_t>(key) * d + col] = repro::from_float<T>(acc_k[j]);
    if (col < dv) dvb[static_cast<size_t>(key) * dv + col] = repro::from_float<T>(acc_v[j]);
  }
}

template <typename TQ, typename T>
__global__ void __launch_bounds__(kThreads)
ls_bwd_rows_pass(const TQ* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ g,
                 const float* __restrict__ m, const float* __restrict__ l,
                 const float* __restrict__ dcoef, TQ* __restrict__ dq, int c,
                 int n, int d, int dv, float scale, int kv_valid, int seg) {
  __shared__ float q_s[kRows][kMaxD];
  __shared__ float g_s[kRows][kMaxD];
  __shared__ float k_s[kTileN][kMaxD + 1];
  __shared__ float v_s[kTileN][kMaxD + 1];
  __shared__ float ds_s[kRows][kTileN];

  const int bi = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t bc = static_cast<size_t>(bi) * c;
  const TQ* qb = q + bc * d;
  const T* gb = g + bc * dv;
  const T* kb = k + static_cast<size_t>(bi) * n * d;
  const T* vb = v + static_cast<size_t>(bi) * n * dv;

  for (int i = tid; i < kRows * d; i += kThreads) {
    const int r = i / d, cc = i - r * d;
    q_s[r][cc] = row0 + r < c
        ? repro::to_float(qb[static_cast<size_t>(row0 + r) * d + cc]) : 0.f;
  }
  for (int i = tid; i < kRows * dv; i += kThreads) {
    const int r = i / dv, cc = i - r * dv;
    g_s[r][cc] = row0 + r < c
        ? repro::to_float(gb[static_cast<size_t>(row0 + r) * dv + cc]) : 0.f;
  }
  // Keys [0, n_end) are the only ones any row of this CTA may attend.
  int n_end = min(n, kv_valid);
  if (seg > 0) n_end = min(n_end, min(row0 + kRows, c) * seg);

  float m_r[kRowsPerWarp], l_r[kRowsPerWarp], d_r[kRowsPerWarp];
  float acc[kRowsPerWarp][kMaxD / 32];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + warp * kRowsPerWarp + rr;
    m_r[rr] = row < c ? m[bc + row] : 0.f;
    l_r[rr] = row < c ? l[bc + row] : 0.f;
    d_r[rr] = row < c ? dcoef[bc + row] : 0.f;
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) acc[rr][i] = 0.f;
  }

  for (int t0 = 0; t0 < n_end; t0 += kTileN) {
    __syncthreads();  // previous tile consumed (first pass: rows written)
    for (int i = tid; i < kTileN * d; i += kThreads) {
      const int j = i / d, cc = i - j * d;
      k_s[j][cc] = t0 + j < n_end
          ? repro::to_float(kb[static_cast<size_t>(t0 + j) * d + cc]) : 0.f;
    }
    for (int i = tid; i < kTileN * dv; i += kThreads) {
      const int j = i / dv, cc = i - j * dv;
      v_s[j][cc] = t0 + j < n_end
          ? repro::to_float(vb[static_cast<size_t>(t0 + j) * dv + cc]) : 0.f;
    }
    __syncthreads();

    const int key = t0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int row = row0 + r;
      bool valid = row < c && key < n_end;
      if (seg > 0) valid = valid && key < (row + 1) * seg;
      float p = 0.f, ds = 0.f;
      if (valid) {
        rebuild(q_s[r], g_s[r], k_s[lane], v_s[lane], d, dv, scale, m_r[rr],
                l_r[rr], d_r[rr], &p, &ds);
      }
      ds_s[r][lane] = ds;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kMaxD / 32; ++i) {
        const int cc = lane + 32 * i;
        float a = acc[rr][i];
        if (cc < d) {
          for (int j = 0; j < kTileN; ++j) a = fmaf(ds_s[r][j], k_s[j][cc], a);
        }
        acc[rr][i] = a;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + warp * kRowsPerWarp + rr;
    if (row >= c) continue;
    TQ* o = dq + (bc + row) * d;
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      const int cc = lane + 32 * i;
      if (cc < d) o[cc] = repro::from_float<TQ>(acc[rr][i]);
    }
  }
}

template <typename TQ, typename T>
int launch_typed(const void* q, const void* k, const void* v, const void* g,
                 const float* m, const float* l, const float* dcoef, void* dq,
                 void* dk, void* dv_out, int b, int c, int n, int d, int dv,
                 float scale, int kv_valid, int seg, cudaStream_t st) {
  const TQ* qt = static_cast<const TQ*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  ls_bwd_keys_pass<TQ, T><<<dim3(b, (n + kTileN - 1) / kTileN), kThreads, 0, st>>>(
      qt, kt, vt, gt, m, l, dcoef, static_cast<T*>(dk), static_cast<T*>(dv_out),
      c, n, d, dv, scale, kv_valid, seg);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ls_bwd_rows_pass<TQ, T><<<dim3(b, (c + kRows - 1) / kRows), kThreads, 0, st>>>(
      qt, kt, vt, gt, m, l, dcoef, static_cast<TQ*>(dq), c, n, d, dv, scale,
      kv_valid, seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. q_dtype is q_l's (and dq's) storage type,
// kv_dtype that of k, v, g, dk and dv: fp32/fp32, bf16/bf16 and fp32
// queries against bf16 keys, as K1 builds. m, l and dcoef are fp32 (b, c).
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int landmark_summary_bwd_launch(
    const void* q, const void* k, const void* v, const void* g,
    const void* m, const void* l, const void* dcoef, void* dq, void* dk,
    void* dv_out, int b, int c, int n, int d, int dv, float scale,
    int kv_valid, int seg, int q_dtype, int kv_dtype, void* stream) {
  if (d > kMaxD || dv > kMaxD || b <= 0 || c <= 0 || n <= 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  const float* df = static_cast<const float*>(dcoef);
  using bf16 = __nv_bfloat16;
  const bool qf = q_dtype == repro::kF32, qb = q_dtype == repro::kBF16;
  const bool kf = kv_dtype == repro::kF32, kb = kv_dtype == repro::kBF16;
  if (qf && kf) return launch_typed<float, float>(q, k, v, g, mf, lf, df, dq, dk, dv_out, b, c, n, d, dv, scale, kv_valid, seg, st);
  if (qf && kb) return launch_typed<float, bf16>(q, k, v, g, mf, lf, df, dq, dk, dv_out, b, c, n, d, dv, scale, kv_valid, seg, st);
  if (qb && kb) return launch_typed<bf16, bf16>(q, k, v, g, mf, lf, df, dq, dk, dv_out, b, c, n, d, dv, scale, kv_valid, seg, st);
  return cudaErrorInvalidValue;
}
