// Gather-free paged decode rows: fp32 online-softmax partials (m, l, acc)
// of r query rows per kv head over keys 0..kv_valid-1, read straight from
// the shared K/V block pools through each lane's block table.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_decode.py:162
// paged_row_stats_lanes (body _paged_row_stats_kernel :83; the single-lane
// paged_row_stats :267 and its custom_vmap rule _lane_fn :229 have no
// counterpart: lanes are the grid's first axis).
//
// What it computes, per lane, kv head h and row:
//   key t (t < kv_valid[lane]) lives in pool block table[lane, t / bs] at
//   offset t % bs; s_t = scale * q[lane,h,row] . K[h, blk, t % bs];
//   m = max s_t, l = sum exp(s_t - m), acc = sum exp(s_t - m) V[h, blk, .].
//   A row with no valid key (kv_valid = 0, padded lanes) returns exactly
//   (m = -1e30, l = 0, acc = 0), the anchor flash_merge absorbs; slots past
//   the last valid key (ragged last block, ZERO_BLOCK tail) are never read.
//
// Bound on the H100 (3.35 TB/s): the work is the valid keys' K and V rows:
// at the serving shape (4 lanes, 4 kv heads, r = 7, d = dv = 128, fp32
// pools, <= 512 keys) at most 4 * 4 * 512 * 128 * 4 B * 2 = 8.4 MB (~2.5 us)
// and 2 * 2 * r * keys * d flops per lane-head, so it is bytes-bound.
//
// Design. The TPU kernel walks (lane, head, slot) with the slot axis
// sequential and scalar-prefetched table entries. Here one CTA owns one
// (lane, kv head) and loads its own table entries; its 8 warps split the
// lane's valid slots round-robin, each keeping a private fp32 partial
// (m, l, acc) for the r <= 8 rows in registers (lanes hold d / 32 feature
// columns; a score is a warp reduction), and the CTA merges the 8 partials
// through shared memory at the end with the same max-rescale algebra as
// flash_merge. The loop stops at the lane's last valid key, so its cost
// follows the data, not the table width. The grid is only lanes * hkv CTAs
// (16 at the serving shape): a split over slots across CTAs plus a merge
// pass (flash-decoding) is the next step for long horizons.
#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxR = 8;                 // query rows per kv head
constexpr int kMaxD = 128;               // max head dim (d and dv)
constexpr int kCols = kMaxD / 32;        // feature columns per lane

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_row_stats_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                       const T* __restrict__ vpool, const int* __restrict__ table,
                       const int* __restrict__ kv_valid, float* __restrict__ m_out,
                       float* __restrict__ l_out, float* __restrict__ acc_out,
                       int hkv, int r, int d, int dv, int nb, int bs,
                       int n_slots, float scale) {
  __shared__ float m_s[kWarps][kMaxR];
  __shared__ float l_s[kWarps][kMaxR];
  __shared__ float acc_s[kWarps][kMaxR][kMaxD];

  const int ln = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int valid = min(max(kv_valid[ln], 0), n_slots * bs);
  const T* qb = q + (static_cast<size_t>(ln) * hkv + h) * r * d;

  float qr[kMaxR][kCols], m[kMaxR], l[kMaxR], acc[kMaxR][kCols];
#pragma unroll
  for (int row = 0; row < kMaxR; ++row) {
    m[row] = kNegInf;
    l[row] = 0.f;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int col = lane + 32 * i;
      qr[row][i] = row < r && col < d
          ? repro::to_float(qb[static_cast<size_t>(row) * d + col]) : 0.f;
      acc[row][i] = 0.f;
    }
  }

  const int n_blk = (valid + bs - 1) / bs;
  const int* tb = table + static_cast<size_t>(ln) * n_slots;
  for (int slot = warp; slot < n_blk; slot += kWarps) {
    const size_t base = (static_cast<size_t>(h) * nb + tb[slot]) * bs;
    const int kend = min(bs, valid - slot * bs);
    for (int j = 0; j < kend; ++j) {
      const T* kr = kpool + (base + j) * d;
      const T* vr = vpool + (base + j) * dv;
      float kx[kCols], vx[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int col = lane + 32 * i;
        kx[i] = col < d ? repro::to_float(kr[col]) : 0.f;
        vx[i] = col < dv ? repro::to_float(vr[col]) : 0.f;
      }
#pragma unroll
      for (int row = 0; row < kMaxR; ++row) {
        if (row < r) {  // uniform across the warp
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < kCols; ++i) part = fmaf(qr[row][i], kx[i], part);
          const float s = repro::warp_sum(part) * scale;
          const float m_new = fmaxf(m[row], s);
          const float corr = expf(m[row] - m_new);
          const float p = expf(s - m_new);
          l[row] = l[row] * corr + p;
#pragma unroll
          for (int i = 0; i < kCols; ++i) acc[row][i] = fmaf(p, vx[i], acc[row][i] * corr);
          m[row] = m_new;
        }
      }
    }
  }

#pragma unroll
  for (int row = 0; row < kMaxR; ++row) {
    if (row < r) {
      if (lane == 0) {
        m_s[warp][row] = m[row];
        l_s[warp][row] = l[row];
      }
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int col = lane + 32 * i;
        if (col < dv) acc_s[warp][row][col] = acc[row][i];
      }
    }
  }
  __syncthreads();

  // Merge the warps' partials (flash_merge algebra). All-empty rows keep
  // the -1e30 anchor: exp(0) * 0 sums to l = 0, acc = 0.
  for (int x = tid; x < r * dv; x += kThreads) {
    const int row = x / dv, col = x - row * dv;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][row]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(m_s[w][row] - mx);
      lsum += l_s[w][row] * e;
      a += acc_s[w][row][col] * e;
    }
    const size_t o = (static_cast<size_t>(ln) * hkv + h) * r + row;
    acc_out[o * dv + col] = a;
    if (col == 0) {
      m_out[o] = mx;
      l_out[o] = lsum;
    }
  }
}

}  // namespace

// Plain C entry point for ctypes: one launch for all lanes. q and the pools
// share the storage type; table and kv_valid are int32; outputs fp32.
// Returns cudaGetLastError() after the launch.
extern "C" int paged_row_stats_launch(
    const void* q, const void* kpool, const void* vpool, const void* table,
    const void* kv_valid, void* m_out, void* l_out, void* acc_out, int lanes,
    int hkv, int r, int d, int dv, int nb, int bs, int n_slots, float scale,
    int dtype, void* stream) {
  if (d > kMaxD || dv > kMaxD || r > kMaxR || r <= 0 || lanes <= 0 || hkv <= 0) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(lanes, hkv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* kvv = static_cast<const int*>(kv_valid);
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  float* ao = static_cast<float*>(acc_out);
  if (dtype == repro::kF32) {
    paged_row_stats_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(kpool),
        static_cast<const float*>(vpool), tb, kvv, mo, lo, ao, hkv, r, d, dv,
        nb, bs, n_slots, scale);
  } else if (dtype == repro::kBF16) {
    paged_row_stats_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kpool),
        static_cast<const __nv_bfloat16*>(vpool), tb, kvv, mo, lo, ao, hkv, r,
        d, dv, nb, bs, n_slots, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
