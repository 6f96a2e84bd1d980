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
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): the function must
// read K and V once and does 4 d flops per attended (row, key) pair. At the
// training shape (b = 56 batch-heads, c = 64, n = 4096, seg = 64, d = dv =
// 128, bf16) that is 117 MB (35 us) against 3.8 GFLOP (4 us); at the serving
// shapes (b = 28, n <= 512) 7.3 MB (2.2 us): bytes-bound everywhere.
//
// Two kernels, chosen by the storage types (a dispatch, not a fallback):
//
// * bf16 q, k, v: tensor cores on a split-key grid. The TPU kernel walks the
//   keys of one row block in order, carrying (m, l, acc) in VMEM; on 132 SMs
//   that serial walk is the whole time (4096 keys for the last rows under the
//   causal mask). Here a CTA (one warpgroup, 128 threads) holds all 64 rows
//   of a row tile -- Q~ resident in shared memory, exactly wgmma's M -- and
//   one chunk of the keys, so the grid (key chunks, row tiles, b) is several
//   hundred CTAs at both shapes (the wrapper's chunk plan sizes the chunks).
//   Per 64-key tile: K and V arrive by cp.async into a two-stage ring (16 B
//   a thread, 128-byte swizzle, zero-filled past the chunk); S = Q~ K^T by
//   wgmma m64n64k16 from shared memory; the online softmax in registers in
//   base 2 (scale * log2 e folded in); P rounded to bf16 and acc += P V by
//   mma.sync m16n8k16 with V read transposed by ldmatrix. A warp whose 16
//   rows cannot reach the tile's first key skips its softmax and P V. A head
//   with one chunk writes out (and m, l) directly; otherwise each chunk
//   writes fp32 partials (m, l, acc) for the rows that reach it to the
//   wrapper's workspace, and landmark_summary_merge combines them in chunk
//   order with flash_merge's rule: deterministic, no atomics.
// * fp32 q with fp32 or bf16 k, v (the fp32 model, and the serving seed
//   launch's fp32 landmark means against bf16 keys): exact fp32 FMA loops.
//   A CTA owns kRows = 8 landmark rows of one batch-head (grid b x c / 8);
//   each of the 4 warps owns 2 rows and keeps their fp32 (m, l, acc) in
//   registers; a lane owns one key of the 32-key shared tile for the scores
//   (K rows padded to d + 1 floats, conflict-free) and 4 value columns for
//   the P V update. The loop stops at the last key any row may attend.
#include "common.cuh"
#include "mma.cuh"

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


// ---- bf16: tensor cores on a split-key grid ----------------------------------
namespace tc {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = repro::kTileRows;   // landmark rows per CTA
constexpr int kKeys = repro::kTileRows;   // keys per tile
constexpr int kStages = 2;
// 1024 B of alignment slack, Q~, then the K/V ring.
constexpr int kSmemBytes = 1024 + repro::kTileBytes * (1 + 2 * kStages);
constexpr float kLn2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

__global__ void __launch_bounds__(kThreads)
landmark_summary_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ ws_m, float* __restrict__ ws_l,
                    float* __restrict__ ws_acc, int c, int n, int d, int dv,
                    float scale, int n_end, int seg, int chunk_keys, int chunks) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (repro::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int chunk = blockIdx.x, row0 = blockIdx.y * kRows, bi = blockIdx.z;
  const int key0 = chunk * chunk_keys;
  const int key_end = min(key0 + chunk_keys, n_end);
  // No row of this tile reaches the chunk (segment-causal): nothing to do.
  if (key0 >= repro::b_side_reach(min(c, row0 + kRows) - 1, n_end, seg)) return;
  const int tiles = (key_end - key0 + kKeys - 1) / kKeys;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;

  const bf16* kb = k + static_cast<size_t>(bi) * n * d;
  const bf16* vb = v + static_cast<size_t>(bi) * n * dv;
  auto k_s = [&](int st) { return q_s + repro::kTileBytes * (1 + 2 * st); };
  auto v_s = [&](int st) { return k_s(st) + repro::kTileBytes; };
  auto load_kv = [&](int it) {
    const int t0 = key0 + it * kKeys;
    repro::load_tile(k_s(it % kStages), kb + static_cast<size_t>(t0) * d, d,
                     key_end - t0, d, k, tid, kThreads);
    repro::load_tile(v_s(it % kStages), vb + static_cast<size_t>(t0) * dv, dv,
                     key_end - t0, dv, v, tid, kThreads);
  };
  repro::load_tile(q_s, q + (static_cast<size_t>(bi) * c + row0) * d, d, c - row0,
                   d, q, tid, kThreads);
  load_kv(0);
  repro::cp_async_commit();

  // This thread's rows: row0 + 16 warp + g (acc[.][0..1]) and + 8 ([2..3]).
  const int r_lo = row0 + 16 * warp + g;
  // Keys the warp's last existing row may attend; the warp idles past them.
  const int warp_reach = row0 + 16 * warp < c
      ? repro::b_side_reach(min(c, row0 + 16 * warp + 16) - 1, n_end, seg) : 0;
  const float sl2 = scale * repro::kLog2e;
  float mx[2] = {repro::kNegInf, repro::kNegInf}, lsum[2] = {0.f, 0.f};
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int t0 = key0 + it * kKeys;
    if (it + 1 < tiles) load_kv(it + 1);  // its stage was released at it - 1
    repro::cp_async_commit();
    repro::cp_async_wait<1>();  // tile it (and Q~) landed
    repro::fence_proxy_async();
    __syncthreads();

    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[e] = 0.f;
      repro::fence_operand(s[e]);
    }
    repro::wgmma_fence();
    repro::issue_abt(s, q_s, k_s(it % kStages));
    repro::wgmma_commit();
    repro::wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 32; ++e) repro::fence_operand(s[e]);

    if (t0 < warp_reach) {
      // mask, scale to base 2, row max over this thread's 16 keys then the quad
      float tmax[2] = {repro::kNegInf, repro::kNegInf};
      uint32_t valid = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t0 + 8 * j + 2 * qd + (e & 1);
          const int row = r_lo + 8 * (e >> 1);
          const bool ok =
              key < key_end && row < c && key < repro::b_side_reach(row, n_end, seg);
          valid |= static_cast<uint32_t>(ok) << (4 * j + e);
          s[4 * j + e] = ok ? s[4 * j + e] * sl2 : repro::kNegInf;
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
          const float p = (valid >> (4 * j + e)) & 1u ? exp2f(s[4 * j + e] - mx[e >> 1]) : 0.f;
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
      // acc += P V: P in bf16 from registers, V transposed from shared memory
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        repro::a_frag(a, s, kk);
        repro::mma_a_btile(acc, a, v_s(it % kStages), 16 * kk, lane);
      }
    }
    __syncthreads();  // the stage is released for tile it + kStages
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 1);
    lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 2);
    const int row = r_lo + 8 * i;
    if (row >= c) continue;
    const float m_nat = mx[i] == repro::kNegInf ? repro::kNegInf : mx[i] * kLn2;
    const size_t rc = static_cast<size_t>(bi) * c + row;
    if (chunks == 1) {
      const float inv = 1.f / fmaxf(lsum[i], 1e-30f);
      bf16* o = out + rc * dv;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * qd;
        if (col < dv) {
          *reinterpret_cast<__nv_bfloat162*>(o + col) =
              __floats2bfloat162_rn(acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
        }
      }
      if (m_out != nullptr && qd == 0) {
        m_out[rc] = m_nat;
        l_out[rc] = lsum[i];
      }
    } else if (key0 < repro::b_side_reach(row, n_end, seg)) {
      const size_t w = (static_cast<size_t>(bi) * chunks + chunk) * c + row;
      float* o = ws_acc + w * dv;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * qd;
        if (col < dv) *reinterpret_cast<float2*>(o + col) = make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
      }
      if (qd == 0) {
        ws_m[w] = m_nat;
        ws_l[w] = lsum[i];
      }
    }
  }
}

// One CTA per (batch-head, row), a thread per value column: merges the
// partials of the chunks the row reaches, in chunk order, with flash_merge's
// rule (a chunk with m = -1e30, l = 0 is absorbed; a row that reaches none
// gets m = -1e30, l = 0, out = 0).
__global__ void __launch_bounds__(128)
landmark_summary_merge(const float* __restrict__ ws_m, const float* __restrict__ ws_l,
                       const float* __restrict__ ws_acc, bf16* __restrict__ out,
                       float* __restrict__ m_out, float* __restrict__ l_out, int c,
                       int dv, int n_end, int seg, int chunk_keys, int chunks) {
  const int bi = blockIdx.x / c, row = blockIdx.x - bi * c;
  const int col = threadIdx.x;
  const int nch =
      min(chunks, (repro::b_side_reach(row, n_end, seg) + chunk_keys - 1) / chunk_keys);
  const size_t w0 = static_cast<size_t>(bi) * chunks * c + row;
  float m = repro::kNegInf;
  for (int ch = 0; ch < nch; ++ch) m = fmaxf(m, ws_m[w0 + static_cast<size_t>(ch) * c]);
  float l = 0.f, a = 0.f;
  for (int ch = 0; ch < nch; ++ch) {
    const size_t w = w0 + static_cast<size_t>(ch) * c;
    const float corr = expf(ws_m[w] - m);
    l += ws_l[w] * corr;
    if (col < dv) a += ws_acc[w * dv + col] * corr;
  }
  const size_t rc = static_cast<size_t>(bi) * c + row;
  if (col < dv) out[rc * dv + col] = __float2bfloat16(a / fmaxf(l, 1e-30f));
  if (m_out != nullptr && col == 0) {
    m_out[rc] = m;
    l_out[rc] = l;
  }
}

int launch(const void* q, const void* k, const void* v, void* out, float* m_out,
           float* l_out, float* ws, int b, int c, int n, int d, int dv, float scale,
           int kv_valid, int seg, int chunk_keys, cudaStream_t st) {
  if (d > repro::kTileCols || dv > repro::kTileCols || d % 8 || dv % 8 || chunk_keys <= 0
      || chunk_keys % kKeys) {
    return cudaErrorInvalidValue;
  }
  int n_end = min(n, kv_valid);
  if (seg > 0) n_end = min(n_end, c * seg);
  const int chunks = n_end > 0 ? (n_end + chunk_keys - 1) / chunk_keys : 0;
  // workspace: m and l (b, chunks, c), then acc (b, chunks, c, dv)
  const size_t rows = static_cast<size_t>(b) * chunks * c;
  float* ws_m = ws;
  float* ws_l = ws == nullptr ? nullptr : ws + rows;
  float* ws_acc = ws == nullptr ? nullptr : ws + 2 * rows;
  if (chunks > 1 && ws == nullptr) return cudaErrorInvalidValue;
  if (chunks >= 1) {
    static bool sized = false;
    if (!sized) {
      const cudaError_t err = cudaFuncSetAttribute(
          landmark_summary_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      sized = true;
    }
    const dim3 grid(chunks, (c + kRows - 1) / kRows, b);
    landmark_summary_tc<<<grid, kThreads, kSmemBytes, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), m_out, l_out, ws_m, ws_l,
        ws_acc, c, n, d, dv, scale, n_end, seg, chunk_keys, chunks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (chunks != 1) {
    landmark_summary_merge<<<b * c, 128, 0, st>>>(ws_m, ws_l, ws_acc,
                                                  static_cast<bf16*>(out), m_out, l_out, c,
                                                  dv, n_end, seg, chunk_keys, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// Plain C entry point for ctypes. q_dtype is the landmark queries' storage
// type, kv_dtype that of k, v and the output: bf16/bf16 runs the tensor-core
// kernel on chunks of chunk_keys keys (a multiple of 64, from the wrapper's
// chunk plan) with ws the fp32 workspace of the chunks' partials (null when
// the plan has one chunk); fp32/fp32 and fp32 queries against bf16 keys
// (the prefill handoff streams fp32 landmark means against bf16 keys, as the
// reference does) run the fp32 kernel, which takes no workspace. m_out and
// l_out may both be null (no stats). Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int landmark_summary_launch(
    const void* q, const void* k, const void* v, void* out, void* m_out,
    void* l_out, void* ws, int b, int c, int n, int d, int dv, float scale,
    int kv_valid, int seg, int chunk_keys, int q_dtype, int kv_dtype, void* stream) {
  if (d > kMaxD || dv > kMaxD || b <= 0 || c <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  using bf16 = __nv_bfloat16;
  const bool qf = q_dtype == repro::kF32, qb = q_dtype == repro::kBF16;
  const bool kf = kv_dtype == repro::kF32, kb = kv_dtype == repro::kBF16;
  if (qb && kb) return tc::launch(q, k, v, out, mo, lo, static_cast<float*>(ws), b, c, n, d, dv, scale, kv_valid, seg, chunk_keys, st);
  if (qf && kf) return launch_typed<float, float>(q, k, v, out, mo, lo, b, c, n, d, dv, scale, kv_valid, seg, st);
  if (qf && kb) return launch_typed<float, bf16>(q, k, v, out, mo, lo, b, c, n, d, dv, scale, kv_valid, seg, st);
  return cudaErrorInvalidValue;
}
