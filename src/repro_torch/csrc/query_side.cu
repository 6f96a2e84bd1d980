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
// Bound on the H100 (3.35 TB/s): at the serving shapes (b = 28, n <= 512,
// c = 64, d = dv = 128, bf16) it must read Q and V and write the output once
// (3 * 28 * 512 * 128 * 2 B = 11 MB, ~3.3 us); its 2 * 2 * b * n * c * d =
// 0.47 GFLOP are far below the tensor-core rate, so it is bytes-bound.
//
// Design. The softmax axis is the small resident c axis, so each query row
// is one independent row softmax: no online recurrence is needed and Q/V
// are read exactly once. A CTA owns kRows = 16 query rows of one batch-head
// (gridDim.y tiles n, b * n / 16 = 896 CTAs at the serving shape). It loads
// K~ (c x d) into shared memory, each of its 4 warps computes the
// probabilities of 4 rows with lanes over landmark columns (K~ rows padded
// to d + 1 floats: conflict-free), then the same buffer is refilled with M
// (c x dv) and lanes sweep value columns for P.M + delta * v. The K~ and M
// re-reads per CTA come from L2. fp32 FMA loops; tensor cores are later
// work.
#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kMaxC = 64;                     // landmark columns (2 per lane)
constexpr int kMaxD = 128;                    // max head dim (d and dv)

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

}  // namespace

// Plain C entry point for ctypes. delta is fp32 (b,); q, k_l, M, v and out
// share the storage type. Returns cudaGetLastError() after the launch.
extern "C" int query_side_launch(
    const void* q, const void* kl, const void* mm, const void* v,
    const void* delta, void* out, int b, int n, int c, int d, int dv,
    float scale, int seg, int pos_offset, int dtype, void* stream) {
  if (d > kMaxD || dv > kMaxD || c > kMaxC || b <= 0 || n <= 0 || c <= 0) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(b, (n + kRows - 1) / kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == repro::kF32) {
    query_side_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(kl),
        static_cast<const float*>(mm), static_cast<const float*>(v), dl,
        static_cast<float*>(out), n, c, d, dv, scale, seg, pos_offset);
  } else if (dtype == repro::kBF16) {
    query_side_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kl),
        static_cast<const __nv_bfloat16*>(mm), static_cast<const __nv_bfloat16*>(v),
        dl, static_cast<__nv_bfloat16*>(out), n, c, d, dv, scale, seg, pos_offset);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
