// B-side landmark summary: BV = softmax(scale * Q~ K^T) V by online softmax.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ss_attention.py:195
// landmark_summary (body _landmark_summary_kernel :140, step
// _landmark_summary_step :94, mask _b_side_mask :62).
//
// What it computes, per batch-head b and landmark row r:
//   s_rj = scale * q_l[b,r] . k[b,j]   for keys j in [0, n)
//   key j is valid iff j < kv_valid (kv_valid already clamped to n by the
//   wrapper) and, when seg > 0 (segment-causal), j < (r + 1) * seg;
//   m_r = max of the valid s_rj (-1e30 if none), l_r = sum exp(s_rj - m_r),
//   out[b,r] = (sum exp(s_rj - m_r) v[b,j]) / max(l_r, 1e-30), in v's type,
//   and optionally m_r, l_r in fp32 (the stats prefill hands to decode).
//   Masked keys contribute exactly 0: a row with no valid key returns
//   (m=-1e30, l=0, out=0), never exp(0) = 1.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): at the serving
// shapes (b = 28 heads, c = 64, n <= 512 valid keys, d = dv = 128, bf16) the
// function must read K and V once (28 * 512 * 128 * 2 B * 2 = 7.3 MB) and
// does 2 * 2 * b * c * n * d = 0.47 GFLOP, so it is bytes-bound at ~2.3 us.
//
// Design. The TPU kernel carries (m, l, acc) in VMEM scratch across a
// sequential grid axis over key blocks. Here the key stream is a loop inside
// one CTA, which owns kRows = 8 landmark rows of one batch-head: the c axis
// is tiled over gridDim.y (rows are independent streams), so b * c / 8 = 224
// CTAs fill the 132 SMs where one CTA per batch-head would leave most idle;
// the K/V re-reads of the 8 row tiles of one head mostly hit L2. Each of the
// 4 warps owns 2 rows and keeps their fp32 (m, l, acc) in registers; a lane
// owns one key of the 32-key shared tile for the scores (K tile rows padded
// to d + 1 floats so the 32 lanes hit 32 banks) and 4 value columns for the
// P.V update. Products are fp32 FMA loops: simple and exact to the
// reference's fp32 accumulation; tensor-core mma, TMA pipelining and the
// kv-head (not query-head) K/V read are later work. The loop stops at the
// last key any row of the CTA may attend, so bucket padding costs nothing.
#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;  // landmark rows per CTA
constexpr int kTileN = 32;                    // keys per shared tile
constexpr int kMaxD = 128;                    // max head dim (d and dv)

template <typename TQ, typename T>
__global__ void __launch_bounds__(kThreads)
landmark_summary_kernel(const TQ* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        int c, int n, int d, int dv, float scale,
                        int kv_valid, int seg) {
  __shared__ float q_s[kRows][kMaxD];
  __shared__ float k_s[kTileN][kMaxD + 1];
  __shared__ float v_s[kTileN][kMaxD];
  __shared__ float p_s[kRows][kTileN];

  const int bi = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const TQ* qb = q + static_cast<size_t>(bi) * c * d;
  const T* kb = k + static_cast<size_t>(bi) * n * d;
  const T* vb = v + static_cast<size_t>(bi) * n * dv;

  for (int i = tid; i < kRows * d; i += kThreads) {
    const int r = i / d, col = i - r * d;
    q_s[r][col] = row0 + r < c
        ? repro::to_float(qb[static_cast<size_t>(row0 + r) * d + col]) : 0.f;
  }
  // Keys [0, n_end) are the only ones any row of this CTA may attend.
  int n_end = min(n, kv_valid);
  if (seg > 0) n_end = min(n_end, min(row0 + kRows, c) * seg);

  float m_r[kRowsPerWarp], l_r[kRowsPerWarp], acc[kRowsPerWarp][kMaxD / 32];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m_r[rr] = kNegInf;
    l_r[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) acc[rr][i] = 0.f;
  }

  for (int t0 = 0; t0 < n_end; t0 += kTileN) {
    __syncthreads();  // previous tile consumed (first pass: q_s written)
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
    __syncthreads();

    const int key = t0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int row = row0 + r;
      bool valid = key < n_end && row < c;
      if (seg > 0) valid = valid && key < (row + 1) * seg;
      float s = kNegInf;
      if (valid) {
        float dot = 0.f;
        for (int kk = 0; kk < d; ++kk) dot = fmaf(q_s[r][kk], k_s[lane][kk], dot);
        s = dot * scale;
      }
      const float m_new = fmaxf(m_r[rr], repro::warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float corr = expf(m_r[rr] - m_new);
      l_r[rr] = l_r[rr] * corr + repro::warp_sum(p);
      m_r[rr] = m_new;
      p_s[r][lane] = p;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kMaxD / 32; ++i) {
        const int col = lane + 32 * i;
        float a = acc[rr][i] * corr;
        if (col < dv) {
          for (int j = 0; j < kTileN; ++j) a = fmaf(p_s[r][j], v_s[j][col], a);
        }
        acc[rr][i] = a;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + warp * kRowsPerWarp + rr;
    if (row >= c) continue;
    const float den = fmaxf(l_r[rr], 1e-30f);
    T* o = out + (static_cast<size_t>(bi) * c + row) * dv;
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      const int col = lane + 32 * i;
      if (col < dv) o[col] = repro::from_float<T>(acc[rr][i] / den);
    }
    if (m_out != nullptr && lane == 0) {
      m_out[static_cast<size_t>(bi) * c + row] = m_r[rr];
      l_out[static_cast<size_t>(bi) * c + row] = l_r[rr];
    }
  }
}

template <typename TQ, typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 float* m_out, float* l_out, int b, int c, int n, int d,
                 int dv, float scale, int kv_valid, int seg,
                 cudaStream_t st) {
  const dim3 grid(b, (c + kRows - 1) / kRows);
  landmark_summary_kernel<TQ, T><<<grid, kThreads, 0, st>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), m_out, l_out, c, n, d,
      dv, scale, kv_valid, seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. q_dtype is the landmark queries' storage
// type, kv_dtype that of k, v and the output: fp32/fp32, bf16/bf16, and
// fp32 queries against bf16 keys (the prefill handoff streams fp32 landmark
// means against bf16 keys, as the reference does). m_out and l_out may both
// be null (no stats). Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int landmark_summary_launch(
    const void* q, const void* k, const void* v, void* out, void* m_out,
    void* l_out, int b, int c, int n, int d, int dv, float scale,
    int kv_valid, int seg, int q_dtype, int kv_dtype, void* stream) {
  if (d > kMaxD || dv > kMaxD || b <= 0 || c <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  using bf16 = __nv_bfloat16;
  const bool qf = q_dtype == repro::kF32, qb = q_dtype == repro::kBF16;
  const bool kf = kv_dtype == repro::kF32, kb = kv_dtype == repro::kBF16;
  if (qf && kf) return launch_typed<float, float>(q, k, v, out, mo, lo, b, c, n, d, dv, scale, kv_valid, seg, st);
  if (qf && kb) return launch_typed<float, bf16>(q, k, v, out, mo, lo, b, c, n, d, dv, scale, kv_valid, seg, st);
  if (qb && kb) return launch_typed<bf16, bf16>(q, k, v, out, mo, lo, b, c, n, d, dv, scale, kv_valid, seg, st);
  return cudaErrorInvalidValue;
}
