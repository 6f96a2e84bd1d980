// B-side landmark summary: BV = softmax(scale * Q~ K^T) V by online softmax.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ss_attention.py:195
// landmark_summary (body _landmark_summary_kernel :140, step
// _landmark_summary_step :94, mask _b_side_mask :62).
//
// What it computes, per batch-head b and landmark row r:
//   s_rj = scale * q_l[b,r] . k[b,j]   for keys j in [0, n)
//   key j sits at global position kv_off + j (kv_off = 0 unsharded; the
//   context-parallel attention passes its shard's offset) and is valid iff
//   kv_off + j < kv_valid (global, clamped to kv_off + n by the wrapper)
//   and, when seg > 0 (segment-causal), kv_off + j < (r + 1) * seg;
//   m_r = max of the valid s_rj (-1e30 if none), l_r = sum exp(s_rj - m_r),
//   out[b,r] = (sum exp(s_rj - m_r) v[b,j]) / max(l_r, 1e-30), in v's type,
//   and optionally m_r, l_r in fp32 (the stats prefill hands to decode).
//   Masked keys contribute exactly 0: a row with no valid key returns
//   (m=-1e30, l=0, out=0), never exp(0) = 1. On a later shard the low rows
//   reach no key at all; every kernel still writes their empty row, since
//   the outputs come from torch.empty.
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
//   order with flash_merge's rule: deterministic, no atomics. Past 64
//   landmark rows the row tiles lie on the grid; row_block (the wrapper's,
//   the dispatch plan's block_c: a multiple of 64, 64 by default) sets how
//   many of them one CTA walks in order over its chunk, the reference's
//   block_c row tiling turned into rows a CTA holds in turn.
// * fp32 q with fp32 or bf16 k, v (the fp32 model, and the serving seed
//   launch's fp32 landmark means against bf16 keys): exact fp32 FMA loops.
//   A CTA owns kRows = 8 landmark rows of one batch-head (grid b x c / 8);
//   each of the 4 warps owns 2 rows and keeps their fp32 (m, l, acc) in
//   registers; a lane owns one key of the 32-key shared tile for the scores
//   (K rows padded to d + 1 floats, conflict-free) and 4 value columns for
//   the P V update. The loop stops at the last key any row may attend.
//
// Wide heads (absorbed MLA's prefill: d = 576, the 512 kv_lora latents and
// 64 rope columns; dv = 512, the latents). The tensor-core kernel splits dv
// across a grid axis of 128-column tiles, each CTA recomputing the scores
// for its value columns (the scores are 53% of the flops at 576 / 512, so
// the split costs up to 4x those), and runs as a template over the column
// tiles of d (1 for d <= 128, 5 up to 640): Q~ stays resident in 5 tiles
// and each 64-key tile's K arrives in 128-column tiles through the cp.async
// ring, S accumulating over them by wgmma (148 KB of shared memory, one CTA
// an SM). The fp32 path has a second kernel, landmark_summary_wide_kernel:
// all dv columns a CTA (each score computed once), K and V tiles copied in
// their storage type by cp.async into alternating buffers (90 KB at bf16
// k, v; 159 KB at fp32), 16-byte shared reads for the scores. At the
// seed's shape it takes 0.090 ms of device time against 0.86 for a first
// version that split dv over the grid (PERF.md).
// At MLA's prefill shape (16 heads broadcast from one latent stream, 64
// rows, 333 of 352 keys) the bound is the bytes of the broadcast keys and
// values, 4 us; the bf16 kernel takes 35 us of device time (PERF.md): the 4x
// score recompute and one CTA an SM leave it latency-bound.
#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::kNegInf;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;  // landmark rows per CTA
constexpr int kTileN = 32;                    // keys per shared tile
constexpr int kMaxD = 128;                    // max head dim of the narrow kernels
constexpr int kWideMaxD = 576;                // max d (the wide-head variants)
constexpr int kWideMaxDv = 512;               // max dv

template <typename TQ, typename T>
__global__ void __launch_bounds__(kThreads)
landmark_summary_kernel(const TQ* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        int c, int n, int d, int dv, float scale,
                        int kv_valid, int seg, int kv_off) {
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
  const int n_end = repro::b_side_end(n, min(row0 + kRows, c), kv_valid, seg, kv_off);

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
      if (seg > 0) valid = valid && key < (row + 1) * seg - kv_off;
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

// The fp32 kernel for wide heads (d up to kWideMaxD, dv up to kWideMaxDv).
// A CTA owns kRows landmark rows of one batch-head and all dv value
// columns, so each score is computed once. K and V tiles of kTileN keys
// arrive in their storage type by cp.async (16 bytes a copy, zero-filled
// past n_end) into one K and one V buffer that alternate: K(t + 1) lands
// while P V(t) runs and V(t + 1) while the scores of t + 1 run. A lane owns
// one key of the tile for the scores and reads its row 16 bytes at a time
// (K rows padded by 16 bytes: eight lanes of a phase hit distinct banks)
// against Q~ broadcast from fp32 shared rows, one FMA chain; for P V it
// owns the value column pairs 2 lane + 64 i, i < kWideMaxDv / 64, their
// fp32 acc in registers. A warp owns one row (8 warps a CTA: at MLA's 16
// heads x 64 rows the grid is 128 CTAs, one an SM, and two rows a warp
// left each scheduler one warp to hide latency with).
constexpr int kWideWarps = 8;                         // a warp a landmark row
constexpr int kWideThreads = kWideWarps * 32;
constexpr int kWideRowsPerWarp = kRows / kWideWarps;
static_assert(kWideRowsPerWarp * kWideWarps == kRows, "rows split evenly over the warps");

template <typename T>
struct Wide {
  static constexpr int kVec = 16 / sizeof(T);           // elements of a 16-byte copy
  static constexpr int kKStride = kWideMaxD + kVec;     // K row in shared memory
  static constexpr int kPairs = kWideMaxDv / 64;        // value column pairs a lane
  // Q~ rows (fp32), P, a K tile, a V tile
  static constexpr int kQBytes = kRows * kWideMaxD * 4;
  static constexpr int kPBytes = kRows * kTileN * 4;
  static constexpr int kKBytes = kTileN * kKStride * static_cast<int>(sizeof(T));
  static constexpr int kSmem = kQBytes + kPBytes + kKBytes + kTileN * kWideMaxDv * static_cast<int>(sizeof(T));
};

// 16 bytes of shared memory as kVec floats.
__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = repro::unpack_bf16(w[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return repro::unpack_bf16(*reinterpret_cast<const uint32_t*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Rows [t0, t0 + kTileN) of a (n, width) operand into a shared tile of row
// stride ld elements, rows past n_end zero-filled. The caller commits.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, int width, int t0,
                                          int n_end, int tid) {
  constexpr int kVec = Wide<T>::kVec;
  const int per_row = width / kVec;
  for (int i = tid; i < kTileN * per_row; i += kWideThreads) {
    const int j = i / per_row, col = (i - j * per_row) * kVec;
    const bool ok = t0 + j < n_end;
    repro::cp_async16(repro::smem_u32(dst + j * ld + col),
                      ok ? static_cast<const void*>(src + static_cast<size_t>(t0 + j) * width + col)
                         : static_cast<const void*>(src),
                      ok ? 16 : 0);
  }
}

template <typename TQ, typename T>
__global__ void __launch_bounds__(kWideThreads)
landmark_summary_wide_kernel(const TQ* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ out,
                             float* __restrict__ m_out, float* __restrict__ l_out,
                             int c, int n, int d, int dv, float scale,
                             int kv_valid, int seg, int kv_off) {
  using W = Wide<T>;
  constexpr int kVec = W::kVec;
  extern __shared__ __align__(16) uint8_t wide_smem[];
  float* q_s = reinterpret_cast<float*>(wide_smem);                       // [kRows][kWideMaxD]
  float* p_s = reinterpret_cast<float*>(wide_smem + W::kQBytes);          // [kRows][kTileN]
  T* k_s = reinterpret_cast<T*>(wide_smem + W::kQBytes + W::kPBytes);     // [kTileN][kKStride]
  T* v_s = reinterpret_cast<T*>(wide_smem + W::kQBytes + W::kPBytes + W::kKBytes);  // [kTileN][kWideMaxDv]

  const int bi = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const TQ* qb = q + static_cast<size_t>(bi) * c * d;
  const T* kb = k + static_cast<size_t>(bi) * n * d;
  const T* vb = v + static_cast<size_t>(bi) * n * dv;
  // Keys [0, n_end) are the only ones any row of this CTA may attend.
  const int n_end = repro::b_side_end(n, min(row0 + kRows, c), kv_valid, seg, kv_off);

  load_rows(k_s, W::kKStride, kb, d, 0, n_end, tid);
  repro::cp_async_commit();
  load_rows(v_s, kWideMaxDv, vb, dv, 0, n_end, tid);
  repro::cp_async_commit();
  for (int i = tid; i < kRows * d; i += kWideThreads) {
    const int r = i / d, col = i - r * d;
    q_s[r * kWideMaxD + col] = row0 + r < c
        ? repro::to_float(qb[static_cast<size_t>(row0 + r) * d + col]) : 0.f;
  }

  float m_r[kWideRowsPerWarp], l_r[kWideRowsPerWarp], acc[kWideRowsPerWarp][W::kPairs][2];
#pragma unroll
  for (int rr = 0; rr < kWideRowsPerWarp; ++rr) {
    m_r[rr] = kNegInf;
    l_r[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < W::kPairs; ++i) acc[rr][i][0] = acc[rr][i][1] = 0.f;
  }
  const int r0 = warp * kWideRowsPerWarp;

  for (int t0 = 0; t0 < n_end; t0 += kTileN) {
    const bool more = t0 + kTileN < n_end;
    repro::cp_async_wait<1>();  // K(t) landed; V(t) may be in flight
    __syncthreads();            // ... for every thread (first pass: q_s written)

    // one FMA chain a score, in column order: the order of the plain
    // version's fp32 product, so the fp32 model's routes agree to rounding
    // that its random-weight core does not amplify
    float dot[kWideRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kWideRowsPerWarp; ++rr) dot[rr] = 0.f;
    const T* krow = k_s + lane * W::kKStride;
#pragma unroll 2
    for (int kk = 0; kk < d; kk += kVec) {
      float kf[kVec];
      load_vec(krow + kk, kf);
#pragma unroll
      for (int rr = 0; rr < kWideRowsPerWarp; ++rr) {
#pragma unroll
        for (int h = 0; h < kVec; h += 4) {
          float qf[4];
          load_vec(q_s + (r0 + rr) * kWideMaxD + kk + h, qf);
#pragma unroll
          for (int e = 0; e < 4; ++e) dot[rr] = fmaf(qf[e], kf[h + e], dot[rr]);
        }
      }
    }
    const int key = t0 + lane;
    float corr[kWideRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kWideRowsPerWarp; ++rr) {
      const int row = row0 + r0 + rr;
      bool valid = key < n_end && row < c;
      if (seg > 0) valid = valid && key < (row + 1) * seg - kv_off;
      const float s = valid ? dot[rr] * scale : kNegInf;
      const float m_new = fmaxf(m_r[rr], repro::warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      corr[rr] = expf(m_r[rr] - m_new);
      l_r[rr] = l_r[rr] * corr[rr] + repro::warp_sum(p);
      m_r[rr] = m_new;
      p_s[(r0 + rr) * kTileN + lane] = p;
    }
    __syncthreads();  // every warp is done with k_s
    if (more) load_rows(k_s, W::kKStride, kb, d, t0 + kTileN, n_end, tid);
    repro::cp_async_commit();
    repro::cp_async_wait<1>();  // V(t) landed; K(t + 1) may be in flight
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kWideRowsPerWarp; ++rr)
#pragma unroll
      for (int i = 0; i < W::kPairs; ++i) {
        acc[rr][i][0] *= corr[rr];
        acc[rr][i][1] *= corr[rr];
      }
    const int j_end = min(kTileN, n_end - t0);
#pragma unroll 4
    for (int j = 0; j < j_end; ++j) {
      float p[kWideRowsPerWarp];
#pragma unroll
      for (int rr = 0; rr < kWideRowsPerWarp; ++rr) p[rr] = p_s[(r0 + rr) * kTileN + j];
      const T* vrow = v_s + j * kWideMaxDv + 2 * lane;
#pragma unroll
      for (int i = 0; i < W::kPairs; ++i) {
        if (2 * lane + 64 * i < dv) {
          const float2 x = load_pair(vrow + 64 * i);
#pragma unroll
          for (int rr = 0; rr < kWideRowsPerWarp; ++rr) {
            acc[rr][i][0] = fmaf(p[rr], x.x, acc[rr][i][0]);
            acc[rr][i][1] = fmaf(p[rr], x.y, acc[rr][i][1]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with v_s
    if (more) load_rows(v_s, kWideMaxDv, vb, dv, t0 + kTileN, n_end, tid);
    repro::cp_async_commit();
  }
  repro::cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < kWideRowsPerWarp; ++rr) {
    const int row = row0 + r0 + rr;
    if (row >= c) continue;
    const float inv = 1.f / fmaxf(l_r[rr], 1e-30f);
    T* o = out + (static_cast<size_t>(bi) * c + row) * dv;
#pragma unroll
    for (int i = 0; i < W::kPairs; ++i) {
      const int col = 2 * lane + 64 * i;
      if (col < dv) store_pair(o + col, acc[rr][i][0] * inv, acc[rr][i][1] * inv);
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
                 int dv, float scale, int kv_valid, int seg, int kv_off,
                 cudaStream_t st) {
  if (d <= kMaxD && dv <= kMaxD) {
    const dim3 grid(b, (c + kRows - 1) / kRows);
    landmark_summary_kernel<TQ, T><<<grid, kThreads, 0, st>>>(
        static_cast<const TQ*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), m_out, l_out, c, n, d,
        dv, scale, kv_valid, seg, kv_off);
    return static_cast<int>(cudaGetLastError());
  }
  // the wide kernel copies 16-byte chunks of k and v rows
  if (d % 8 || dv % 8 || reinterpret_cast<uintptr_t>(k) % 16
      || reinterpret_cast<uintptr_t>(v) % 16) {
    return cudaErrorInvalidValue;
  }
  static bool sized = false;   // past 48 KB of shared memory
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        landmark_summary_wide_kernel<TQ, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Wide<T>::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const dim3 grid(b, (c + kRows - 1) / kRows);
  landmark_summary_wide_kernel<TQ, T><<<grid, kWideThreads, Wide<T>::kSmem, st>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), m_out, l_out, c, n, d,
      dv, scale, kv_valid, seg, kv_off);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: tensor cores on a split-key grid ----------------------------------
namespace tc {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = repro::kTileRows;   // landmark rows per CTA
constexpr int kKeys = repro::kTileRows;   // keys per tile
constexpr int kStages = 2;
constexpr int kCols = repro::kTileCols;   // columns of a tile: d's column tiles, dv's tiles
constexpr int kWideCT = 5;                // d's column tiles past 128 (up to 640)
static_assert(kWideCT * kCols >= kWideMaxD, "Q~ fits its resident column tiles");
// 1024 B of alignment slack, Q~ (kCT column tiles), then the ring: per stage
// one K column tile and one V tile.
constexpr int smem_bytes(int ct) { return 1024 + repro::kTileBytes * (ct + 2 * kStages); }
constexpr float kLn2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

// kCT: column tiles of d (1: d <= 128; kWideCT: wider). Steps walk the
// (key tile, column tile) pairs in order: a step brings one K column tile
// (and, at column tile 0, the key tile's V tile of this CTA's value
// columns) and adds its part of S; the last column tile's step runs the
// softmax and P V. With kCT = 1 a step is a key tile, as it always was.
// This walks one row tile (rows row0 .. row0 + 63) over the CTA's chunk.
template <int kCT>
__device__ __forceinline__ void landmark_summary_tile(
    uint32_t q_s, const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ m_out,
    float* __restrict__ l_out, float* __restrict__ ws_m, float* __restrict__ ws_l,
    float* __restrict__ ws_acc, int c, int n, int d, int dv, float scale, int n_end,
    int seg, int kv_off, int chunk_keys, int chunks, int row0) {
  // grid.z = b x value tiles: this CTA's value columns [dv0, dv0 + dvw)
  const int dvt = (dv + kCols - 1) / kCols;
  const int chunk = blockIdx.x;
  const int bi = blockIdx.z / dvt, vt = blockIdx.z - bi * dvt;
  const int dv0 = vt * kCols, dvw = min(kCols, dv - dv0);
  const int key0 = chunk * chunk_keys;
  const int key_end = min(key0 + chunk_keys, n_end);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // No row of this tile reaches the chunk (segment-causal): nothing to do,
  // unless the plan has one chunk, which writes the output directly. Then
  // the chunk is the first, so no row of the tile reaches any key (a low
  // row tile on a later shard): each gets the empty row the merge gives.
  if (key0 >= repro::b_side_reach(min(c, row0 + kRows) - 1, n_end, seg, kv_off)) {
    if (chunks == 1) {
      const int rows = min(kRows, c - row0);
      for (int i = tid; i < rows * dvw; i += kThreads) {
        const int r = i / dvw, col = i - r * dvw;
        out[(static_cast<size_t>(bi) * c + row0 + r) * dv + dv0 + col] = __float2bfloat16(0.f);
      }
      if (m_out != nullptr && vt == 0) {
        for (int r = tid; r < rows; r += kThreads) {
          m_out[static_cast<size_t>(bi) * c + row0 + r] = repro::kNegInf;
          l_out[static_cast<size_t>(bi) * c + row0 + r] = 0.f;
        }
      }
    }
    return;
  }
  const int tiles = (key_end - key0 + kKeys - 1) / kKeys;
  const int steps = tiles * kCT;
  const int g = lane >> 2, qd = lane & 3;

  const bf16* kb = k + static_cast<size_t>(bi) * n * d;
  const bf16* vb = v + static_cast<size_t>(bi) * n * dv + dv0;
  auto k_s = [&](int st) { return q_s + repro::kTileBytes * (kCT + 2 * st); };
  auto v_s = [&](int st) { return k_s(st) + repro::kTileBytes; };
  auto load_step = [&](int sp) {
    const int it = sp / kCT, ct = sp - it * kCT;
    const int t0 = key0 + it * kKeys;
    repro::load_tile(k_s(sp % kStages), kb + static_cast<size_t>(t0) * d + ct * kCols, d,
                     key_end - t0, d - ct * kCols, k, tid, kThreads);
    if (ct == 0)
      repro::load_tile(v_s(it % kStages), vb + static_cast<size_t>(t0) * dv, dv,
                       key_end - t0, dvw, v, tid, kThreads);
  };
#pragma unroll
  for (int ct = 0; ct < kCT; ++ct)
    repro::load_tile(q_s + ct * repro::kTileBytes,
                     q + (static_cast<size_t>(bi) * c + row0) * d + ct * kCols, d, c - row0,
                     d - ct * kCols, q, tid, kThreads);
  load_step(0);
  repro::cp_async_commit();

  // This thread's rows: row0 + 16 warp + g (acc[.][0..1]) and + 8 ([2..3]).
  const int r_lo = row0 + 16 * warp + g;
  // Keys the warp's last existing row may attend; the warp idles past them.
  const int warp_reach = row0 + 16 * warp < c
      ? repro::b_side_reach(min(c, row0 + 16 * warp + 16) - 1, n_end, seg, kv_off) : 0;
  const float sl2 = scale * repro::kLog2e;
  float mx[2] = {repro::kNegInf, repro::kNegInf}, lsum[2] = {0.f, 0.f};
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float s[32];

  for (int sp = 0; sp < steps; ++sp) {
    const int it = sp / kCT, ct = sp - it * kCT;
    const int t0 = key0 + it * kKeys;
    if (sp + 1 < steps) load_step(sp + 1);  // its stage was released at sp - 1
    repro::cp_async_commit();
    repro::cp_async_wait<1>();  // step sp (and Q~) landed
    repro::fence_proxy_async();
    __syncthreads();

    if (ct == 0) {
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) repro::fence_operand(s[e]);
    repro::wgmma_fence();
    repro::issue_abt(s, q_s + ct * repro::kTileBytes, k_s(sp % kStages), ct > 0);
    repro::wgmma_commit();
    repro::wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 32; ++e) repro::fence_operand(s[e]);

    if (ct == kCT - 1 && t0 < warp_reach) {
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
              key < key_end && row < c && key < repro::b_side_reach(row, n_end, seg, kv_off);
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
    __syncthreads();  // the stages are released for step sp + kStages
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
      bf16* o = out + rc * dv + dv0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * qd;
        if (col < dvw) {
          *reinterpret_cast<__nv_bfloat162*>(o + col) =
              __floats2bfloat162_rn(acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
        }
      }
      if (m_out != nullptr && qd == 0 && vt == 0) {
        m_out[rc] = m_nat;
        l_out[rc] = lsum[i];
      }
    } else if (key0 < repro::b_side_reach(row, n_end, seg, kv_off)) {
      const size_t w = (static_cast<size_t>(bi) * chunks + chunk) * c + row;
      float* o = ws_acc + w * dv + dv0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * qd;
        if (col < dvw) *reinterpret_cast<float2*>(o + col) = make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
      }
      if (qd == 0 && vt == 0) {
        ws_m[w] = m_nat;
        ws_l[w] = lsum[i];
      }
    }
  }
}

// Grid (key chunks, row groups, b x value tiles): a CTA walks the
// row_block / 64 row tiles of its group in order over its chunk of keys.
template <int kCT>
__global__ void __launch_bounds__(kThreads)
landmark_summary_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ ws_m, float* __restrict__ ws_l,
                    float* __restrict__ ws_acc, int c, int n, int d, int dv,
                    float scale, int n_end, int seg, int kv_off, int chunk_keys,
                    int chunks, int row_block) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (repro::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int row_end = min(c, static_cast<int>(blockIdx.y + 1) * row_block);
  for (int row0 = blockIdx.y * row_block; row0 < row_end; row0 += kRows) {
    landmark_summary_tile<kCT>(q_s, q, k, v, out, m_out, l_out, ws_m, ws_l, ws_acc, c, n,
                               d, dv, scale, n_end, seg, kv_off, chunk_keys, chunks, row0);
    repro::cp_async_wait<0>();
    __syncthreads();  // shared memory is free for the next row tile
  }
}

// One CTA per (batch-head, row), threads over the value columns: merges the
// partials of the chunks the row reaches, in chunk order, with flash_merge's
// rule (a chunk with m = -1e30, l = 0 is absorbed; a row that reaches none,
// every row when the plan has no chunk, gets m = -1e30, l = 0, out = 0).
__global__ void __launch_bounds__(128)
landmark_summary_merge(const float* __restrict__ ws_m, const float* __restrict__ ws_l,
                       const float* __restrict__ ws_acc, bf16* __restrict__ out,
                       float* __restrict__ m_out, float* __restrict__ l_out, int c,
                       int dv, int n_end, int seg, int kv_off, int chunk_keys,
                       int chunks) {
  const int bi = blockIdx.x / c, row = blockIdx.x - bi * c;
  const int reach = max(0, repro::b_side_reach(row, n_end, seg, kv_off));
  const int nch = min(chunks, (reach + chunk_keys - 1) / chunk_keys);
  const size_t w0 = static_cast<size_t>(bi) * chunks * c + row;
  float m = repro::kNegInf;
  for (int ch = 0; ch < nch; ++ch) m = fmaxf(m, ws_m[w0 + static_cast<size_t>(ch) * c]);
  float l = 0.f;
  for (int ch = 0; ch < nch; ++ch) {
    const size_t w = w0 + static_cast<size_t>(ch) * c;
    l += ws_l[w] * expf(ws_m[w] - m);
  }
  const size_t rc = static_cast<size_t>(bi) * c + row;
  for (int col = threadIdx.x; col < dv; col += 128) {
    float a = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      const size_t w = w0 + static_cast<size_t>(ch) * c;
      a += ws_acc[w * dv + col] * expf(ws_m[w] - m);
    }
    out[rc * dv + col] = __float2bfloat16(a / fmaxf(l, 1e-30f));
  }
  if (m_out != nullptr && threadIdx.x == 0) {
    m_out[rc] = m;
    l_out[rc] = l;
  }
}

template <int kCT>
int launch_tiles(const void* q, const void* k, const void* v, void* out, float* m_out,
                 float* l_out, float* ws_m, float* ws_l, float* ws_acc, int b, int c, int n,
                 int d, int dv, float scale, int n_end, int seg, int kv_off, int chunk_keys,
                 int chunks, int row_block, cudaStream_t st) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        landmark_summary_tc<kCT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes(kCT));
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const dim3 grid(chunks, (c + row_block - 1) / row_block, b * ((dv + kCols - 1) / kCols));
  landmark_summary_tc<kCT><<<grid, kThreads, smem_bytes(kCT), st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), m_out, l_out, ws_m, ws_l, ws_acc, c, n, d, dv, scale, n_end,
      seg, kv_off, chunk_keys, chunks, row_block);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, void* out, float* m_out,
           float* l_out, float* ws, int b, int c, int n, int d, int dv, float scale,
           int kv_valid, int seg, int kv_off, int chunk_keys, int row_block,
           cudaStream_t st) {
  if (d > kWideMaxD || dv > kWideMaxDv || d % 8 || dv % 8 || chunk_keys <= 0
      || chunk_keys % kKeys || row_block <= 0 || row_block % kRows) {
    return cudaErrorInvalidValue;
  }
  const int n_end = repro::b_side_end(n, c, kv_valid, seg, kv_off);
  const int chunks = n_end > 0 ? (n_end + chunk_keys - 1) / chunk_keys : 0;
  // workspace: m and l (b, chunks, c), then acc (b, chunks, c, dv)
  const size_t rows = static_cast<size_t>(b) * chunks * c;
  float* ws_m = ws;
  float* ws_l = ws == nullptr ? nullptr : ws + rows;
  float* ws_acc = ws == nullptr ? nullptr : ws + 2 * rows;
  if (chunks > 1 && ws == nullptr) return cudaErrorInvalidValue;
  if (chunks >= 1) {
    const int err = d <= kCols
        ? launch_tiles<1>(q, k, v, out, m_out, l_out, ws_m, ws_l, ws_acc, b, c, n, d, dv,
                          scale, n_end, seg, kv_off, chunk_keys, chunks, row_block, st)
        : launch_tiles<kWideCT>(q, k, v, out, m_out, l_out, ws_m, ws_l, ws_acc, b, c, n, d,
                                dv, scale, n_end, seg, kv_off, chunk_keys, chunks, row_block,
                                st);
    if (err != cudaSuccess) return err;
  }
  if (chunks != 1) {
    landmark_summary_merge<<<b * c, 128, 0, st>>>(ws_m, ws_l, ws_acc,
                                                  static_cast<bf16*>(out), m_out, l_out, c,
                                                  dv, n_end, seg, kv_off, chunk_keys, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// Plain C entry point for ctypes. q_dtype is the landmark queries' storage
// type, kv_dtype that of k, v and the output: bf16/bf16 runs the tensor-core
// kernel on chunks of chunk_keys keys (a multiple of 64, from the wrapper's
// chunk plan) and row groups of row_block rows (a multiple of 64; the fp32
// kernels ignore it) with ws the fp32 workspace of the chunks' partials (null when
// the plan has one chunk); fp32/fp32 and fp32 queries against bf16 keys
// (the prefill handoff streams fp32 landmark means against bf16 keys, as the
// reference does) run the fp32 kernel, which takes no workspace. m_out and
// l_out may both be null (no stats). kv_valid is global and kv_off the
// global position of key 0 (a shard's offset; 0 unsharded). Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int landmark_summary_launch(
    const void* q, const void* k, const void* v, void* out, void* m_out,
    void* l_out, void* ws, int b, int c, int n, int d, int dv, float scale,
    int kv_valid, int seg, int kv_off, int chunk_keys, int row_block, int q_dtype,
    int kv_dtype, void* stream) {
  if (d > kWideMaxD || dv > kWideMaxDv || d <= 0 || dv <= 0 || b <= 0 || c <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  using bf16 = __nv_bfloat16;
  const bool qf = q_dtype == repro::kF32, qb = q_dtype == repro::kBF16;
  const bool kf = kv_dtype == repro::kF32, kb = kv_dtype == repro::kBF16;
  if (qb && kb) return tc::launch(q, k, v, out, mo, lo, static_cast<float*>(ws), b, c, n, d, dv, scale, kv_valid, seg, kv_off, chunk_keys, row_block, st);
  if (qf && kf) return launch_typed<float, float>(q, k, v, out, mo, lo, b, c, n, d, dv, scale, kv_valid, seg, kv_off, st);
  if (qf && kb) return launch_typed<float, bf16>(q, k, v, out, mo, lo, b, c, n, d, dv, scale, kv_valid, seg, kv_off, st);
  return cudaErrorInvalidValue;
}
