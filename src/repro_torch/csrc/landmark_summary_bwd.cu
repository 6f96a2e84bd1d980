// B-side backward: dQ~, dK, dV of BV = softmax(scale * Q~ K^T) V.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ss_attention_bwd.py:117
// landmark_summary_bwd (body _landmark_summary_bwd_kernel :49, mask
// _b_side_mask of ss_attention.py:62).
//
// What it computes, per batch-head b, landmark row r and key j (at global
// position kv_off + j: a shard's offset under the context-parallel attention,
// else 0; valid iff kv_off + j < kv_valid, global and clamped to
// kv_off + n by the wrapper, and, when seg > 0, kv_off + j < (r + 1) * seg):
//   p_rj  = exp(scale * q_l[r] . k[j] - m_r) / max(l_r, 1e-30), 0 if masked
//   ds_rj = p_rj * (g[r] . v[j] - D_r) * scale
//   dV[j] = sum_r p_rj g[r],  dK[j] = sum_r ds_rj q_l[r],
//   dQ~[r] = sum_j ds_rj k[j],
// from the forward's fp32 stats (m, l) and D_r = g[r] . BV[r] (computed by
// the wrapper), so P is rebuilt exactly, without a second reduction pass.
// A row with no valid key has l = 0 and keeps p = 0. Sums are fp32; dQ~
// is written in q_l's type, dK and dV in k's / v's. Keys that no row may
// attend, or at or past kv_valid, get exact zeros. Under a sequence shard
// m and l are the merged global stats and dQ~ is the shard's partial.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): at the training
// shape (b = 56 batch-heads, c = 64, n = 4096, d = dv = 128, seg = 64, bf16)
// it must read K and V and write dK and dV once (4 * 56 * 4096 * 128 * 2 B
// = 235 MB, 70 us); the 5 products over the 7.5 M attended (row, key) pairs
// are 2 * 7.5e6 * 5 * 128 = 9.5 GFLOP (10 us at the bf16 rate), so it is
// bytes-bound.
//
// Two kernels, chosen by the storage types (a dispatch, not a fallback):
//
// * bf16 q_l, k, v, g: one pass on tensor cores over a split-key grid. The
//   Pallas kernel walks key blocks in order and carries dQ~ in VMEM across
//   them; a CUDA grid has no order. Here a CTA (one warpgroup) owns one
//   chunk of keys of one head (grid: key chunks over n, b; the wrapper's
//   chunk plan sizes them) and keeps Q~ and g (64 rows, zero-padded),
//   with each row's m, l and D in registers, resident. Per 64-key tile, K
//   and V arrive by cp.async into a two-stage ring (128-byte swizzle);
//   S = Q~ K^T and dP = g V^T by wgmma m64n64k16 from shared memory; P and
//   dS = P o (dP - D) scale are rebuilt in registers; dQ~ += dS K by
//   mma.sync m16n8k16 (dS from registers, K read transposed by ldmatrix),
//   carried in registers across the chunk. P and dS are staged as bf16 in
//   the V slot of the tile's stage (V is dead once dP is formed) and read
//   transposed for dV = P^T g and dK = dS^T Q~ (mma.sync, a warp per 16
//   keys, row groups that cannot reach the warp's keys skipped). Each key
//   belongs to one CTA, so dK and dV are written once, every key in [0, n)
//   by some CTA. dQ~ goes as one fp32 partial per chunk to the wrapper's
//   workspace (or straight to dq_l when the plan has one chunk), and
//   ls_bwd_dq_reduce sums the partials in chunk order. No atomics: the
//   gradients are bitwise deterministic. P and dS are rounded to bf16 for
//   the three products that take them.
// * fp32 q_l with fp32 or bf16 k, v, g: exact fp32 FMA loops in two passes
//   launched back to back, neither with atomics:
//    - keys pass (ls_bwd_keys_pass), grid (b, ceil(n / 32)): a CTA owns 32
//      keys and keeps their K/V rows in shared memory (padded to d + 1
//      floats, conflict-free). It walks the landmark rows 8 at a time, from
//      the first row that may attend its first key (segment-causal: row
//      t0 / seg) to c; each warp rebuilds p and ds of 2 rows with a lane
//      per key, then thread t adds the 8 rows into column t of dK and dV
//      for all 32 keys, kept in registers. Every key in [0, n) is written.
//    - rows pass (ls_bwd_rows_pass), grid (b, ceil(c / 8)): K1's fp32
//      shape. A CTA owns 8 landmark rows, streams the keys they may attend
//      in 32-key tiles, rebuilds ds and accumulates dQ~ in registers.
//
// Past 64 landmark rows (bf16, c > 64). dK / dV of a key sum over every
// row, dQ~ of a row over every key, and one row tile of 64 is what a CTA's
// registers hold. The row tiles go on the grid: grid (key chunks, row
// groups, b), a CTA walking the row_block / 64 row tiles of its group in
// order (row_block: the wrapper's, the dispatch plan's block_c; 64 by
// default, every row tile its own CTA). Each row tile is the c <= 64 pass
// over the keys its rows may attend, with its dQ~ partials per chunk as
// before and its dK / dV as fp32 partials per row tile, (b, tiles, n, d)
// and (b, tiles, n, dv); ls_bwd_kv_reduce sums them in row-tile order over
// the tiles that reach each key (zeros where none does) and casts. No
// atomics: bitwise deterministic. Registers and shared memory stay the c <=
// 64 kernel's (97 KB, ptxas in PERF.md); the extra cost is the partials'
// fp32 traffic: under the causal mask at c = 128 a key reached by both row
// tiles (the first half) is written and read twice in fp32.
#include "common.cuh"
#include "mma.cuh"

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
                 int kv_valid, int seg, int kv_off) {
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

  const int n_end = min(n, kv_valid - kv_off);
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
  // segment-causal mask, row r attends key t0 only if its global position
  // kv_off + t0 < (r + 1) * seg.
  const int r_end = t0 < n_end ? c : 0;
  const int r_begin = seg > 0 ? (min((kv_off + t0) / seg, c) / kRows) * kRows : 0;

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
      if (seg > 0) valid = valid && key < (row + 1) * seg - kv_off;
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
                 int n, int d, int dv, float scale, int kv_valid, int seg,
                 int kv_off) {
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
  const int n_end = repro::b_side_end(n, min(row0 + kRows, c), kv_valid, seg, kv_off);

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
      if (seg > 0) valid = valid && key < (row + 1) * seg - kv_off;
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
                 float scale, int kv_valid, int seg, int kv_off, cudaStream_t st) {
  const TQ* qt = static_cast<const TQ*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  ls_bwd_keys_pass<TQ, T><<<dim3(b, (n + kTileN - 1) / kTileN), kThreads, 0, st>>>(
      qt, kt, vt, gt, m, l, dcoef, static_cast<T*>(dk), static_cast<T*>(dv_out),
      c, n, d, dv, scale, kv_valid, seg, kv_off);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ls_bwd_rows_pass<TQ, T><<<dim3(b, (c + kRows - 1) / kRows), kThreads, 0, st>>>(
      qt, kt, vt, gt, m, l, dcoef, static_cast<TQ*>(dq), c, n, d, dv, scale,
      kv_valid, seg, kv_off);
  return static_cast<int>(cudaGetLastError());
}


// ---- bf16: one pass on tensor cores over a split-key grid -------------------
namespace tc {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = repro::kTileRows;   // landmark rows of a row tile
constexpr int kKeys = repro::kTileRows;   // keys per tile
constexpr int kStages = 2;
// 1024 B of alignment slack, Q~ and g, then the K/V ring.
constexpr int kSmemBytes = 1024 + repro::kTileBytes * (2 + 2 * kStages);

using bf16 = __nv_bfloat16;

// Zero rows [from, to) of a row-major (rows, cols) bf16 array, 16 B a store
// (cols a multiple of 8).
__device__ __forceinline__ void zero_rows(bf16* a, int cols, int from, int to, int tid) {
  if (to <= from) return;
  uint4* p = reinterpret_cast<uint4*>(a + static_cast<size_t>(from) * cols);
  const int count = (to - from) * cols / 8;
  for (int i = tid; i < count; i += kThreads) p[i] = make_uint4(0u, 0u, 0u, 0u);
}

// acc (a warp's 16 keys x 128 columns) as bf16 rows key0w + g (+ 8) of a
// (rows, cols) array, keys below key_stop and columns below cols only.
__device__ __forceinline__ void store_keys(bf16* a, const float (&acc)[16][4], int cols,
                                           int key_lo, int key_stop, int qd) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key_lo + 8 * i;
    if (key >= key_stop) continue;
    bf16* o = a + static_cast<size_t>(key) * cols;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * qd;
      if (col < cols) {
        *reinterpret_cast<__nv_bfloat162*>(o + col) =
            __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
      }
    }
  }
}

// acc (a warp's 16 keys x 128 columns) as fp32 rows key_lo + g (+ 8) of a
// (rows, cols) array, keys below key_stop and columns below cols only.
__device__ __forceinline__ void store_keys_f32(float* a, const float (&acc)[16][4], int cols,
                                               int key_lo, int key_stop, int qd) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key_lo + 8 * i;
    if (key >= key_stop) continue;
    float* o = a + static_cast<size_t>(key) * cols;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * qd;
      if (col < cols) *reinterpret_cast<float2*>(o + col) = make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

// Keys some row of row tile rt (rows 64 rt .. 64 rt + 63) may attend.
__host__ __device__ __forceinline__ int tile_end(int rt, int c, int n_end, int seg, int kv_off) {
  return seg > 0 ? min(n_end, min(c, kRows * (rt + 1)) * seg - kv_off) : n_end;
}

// One row tile (rows row0 .. row0 + 63) against the CTA's chunk of keys.
// With one row tile (c <= 64) dK and dV are written as bf16 (keys no row
// reaches: zeros); with more, as this tile's fp32 partials ws_kv (dK: (b,
// tiles, n, d), then dV: (b, tiles, n, dv)), which ls_bwd_kv_reduce sums.
__device__ __forceinline__ void ls_bwd_tile(
    uint32_t q_s, const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g, const float* __restrict__ m,
    const float* __restrict__ l, const float* __restrict__ dcoef, bf16* __restrict__ dq,
    bf16* __restrict__ dk, bf16* __restrict__ dvo, float* __restrict__ ws_dq,
    float* __restrict__ ws_kv, int b, int c, int n, int d, int dv, float scale, int n_end,
    int seg, int kv_off, int chunk_keys, int chunks, int chunk, int bi, int rt, int rtiles) {
  const uint32_t g_s = q_s + repro::kTileBytes;
  const int row0 = rt * kRows;
  const int key0 = chunk * chunk_keys;
  const int key_stop = min(key0 + chunk_keys, n);  // dK, dV rows this CTA writes
  const int key_end = min(key_stop, tile_end(rt, c, n_end, seg, kv_off));  // keys the tile's rows may attend
  const int tiles = key_end > key0 ? (key_end - key0 + kKeys - 1) / kKeys : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, qd = lane & 3;

  const bf16* kb = k + static_cast<size_t>(bi) * n * d;
  const bf16* vb = v + static_cast<size_t>(bi) * n * dv;
  bf16* dkb = dk + static_cast<size_t>(bi) * n * d;
  bf16* dvb = dvo + static_cast<size_t>(bi) * n * dv;
  float* pkb = rtiles > 1 ? ws_kv + (static_cast<size_t>(bi) * rtiles + rt) * n * d : nullptr;
  float* pvb = rtiles > 1
      ? ws_kv + static_cast<size_t>(b) * rtiles * n * d
            + (static_cast<size_t>(bi) * rtiles + rt) * n * dv
      : nullptr;
  if (rtiles == 1) {
    // keys past the computed tiles: exact zeros
    zero_rows(dkb, d, key0 + tiles * kKeys, key_stop, tid);
    zero_rows(dvb, dv, key0 + tiles * kKeys, key_stop, tid);
  }
  if (tiles == 0) return;

  auto k_s = [&](int st) { return q_s + repro::kTileBytes * (2 + 2 * st); };
  auto v_s = [&](int st) { return k_s(st) + repro::kTileBytes; };
  auto load_kv = [&](int it) {
    const int t0 = key0 + it * kKeys;
    repro::load_tile(k_s(it % kStages), kb + static_cast<size_t>(t0) * d, d,
                     key_end - t0, d, k, tid, kThreads);
    repro::load_tile(v_s(it % kStages), vb + static_cast<size_t>(t0) * dv, dv,
                     key_end - t0, dv, v, tid, kThreads);
  };
  const size_t bc = static_cast<size_t>(bi) * c;
  repro::load_tile(q_s, q + (bc + row0) * d, d, c - row0, d, q, tid, kThreads);
  repro::load_tile(g_s, g + (bc + row0) * dv, dv, c - row0, dv, g, tid, kThreads);
  load_kv(0);
  repro::cp_async_commit();

  // This thread's rows row0 + r_lo and + 8: base-2 anchor, 1 / l, D.
  const int r_lo = 16 * warp + gr;
  float m2[2], inv_l[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r_lo + 8 * i;
    m2[i] = row < c ? m[bc + row] * repro::kLog2e : 0.f;
    inv_l[i] = row < c ? 1.f / fmaxf(l[bc + row], 1e-30f) : 0.f;
    dr[i] = row < c ? dcoef[bc + row] : 0.f;
  }
  const int warp_reach = row0 + 16 * warp < c
      ? repro::b_side_reach(min(c, row0 + 16 * warp + 16) - 1, n_end, seg, kv_off) : 0;
  const float sl2 = scale * repro::kLog2e;
  float dqa[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int t0 = key0 + it * kKeys;
    const int st = it % kStages;
    if (it + 1 < tiles) load_kv(it + 1);  // its stage was released at it - 1
    repro::cp_async_commit();
    repro::cp_async_wait<1>();  // tile it (and Q~, g) landed
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
    repro::issue_abt(s, q_s, k_s(st));
    repro::issue_abt(dp, g_s, v_s(st));
    repro::wgmma_commit();
    repro::wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      repro::fence_operand(s[e]);
      repro::fence_operand(dp[e]);
    }
    // p and ds in place of s and dp
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + 8 * j + 2 * qd + (e & 1);
        const int i = e >> 1, row = row0 + r_lo + 8 * i;
        const bool ok =
            key < key_end && row < c && key < repro::b_side_reach(row, n_end, seg, kv_off);
        const float p = ok ? exp2f(s[4 * j + e] * sl2 - m2[i]) * inv_l[i] : 0.f;
        s[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - dr[i]) * scale;
      }
    }
    __syncthreads();  // every warp's wgmma has read V: its slot takes P and dS
    const uint32_t p_s = v_s(st), ds_s = p_s + repro::kBlockBytes;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r_lo + 8 * i, col = 8 * j + 2 * qd;
        const uint32_t off = repro::tile_off(row, col) + (col & 7) * 2;
        repro::st_shared_b32(p_s + off, repro::pack_bf16(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
        repro::st_shared_b32(ds_s + off, repro::pack_bf16(dp[4 * j + 2 * i], dp[4 * j + 2 * i + 1]));
      }
    }
    // dQ~ += dS K (a warp whose rows cannot reach the tile adds zeros: skipped)
    if (t0 < warp_reach) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        repro::a_frag(a, dp, kk);
        repro::mma_a_btile(dqa, a, k_s(st), 16 * kk, lane);
      }
    }
    __syncthreads();  // P and dS staged
    // dV = P^T g and dK = dS^T Q~ for keys t0 + 16 warp ..; row groups that
    // cannot reach the warp's first key (global position kv_off + key_w)
    // hold zeros of P and dS: skipped.
    const int key_w = t0 + 16 * warp;
    const int kk0 = seg > 0 ? min(max((kv_off + key_w) / seg - row0, 0), kRows) / 16 : 0;
    float acc[16][4];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      for (int kk = kk0; kk < 4; ++kk) {
        uint32_t a[4];
        repro::a_frag_trans(a, pass == 0 ? p_s : ds_s, 16 * kk, 16 * warp, lane);
        repro::mma_a_btile(acc, a, pass == 0 ? g_s : q_s, 16 * kk, lane);
      }
      if (rtiles > 1) {
        if (pass == 0) store_keys_f32(pvb, acc, dv, key_w + gr, key_stop, qd);
        else store_keys_f32(pkb, acc, d, key_w + gr, key_stop, qd);
      } else {
        if (pass == 0) store_keys(dvb, acc, dv, key_w + gr, key_stop, qd);
        else store_keys(dkb, acc, d, key_w + gr, key_stop, qd);
      }
    }
    __syncthreads();  // the stage is released for tile it + kStages
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r_lo + 8 * i;
    if (row >= c) continue;
    if (chunks == 1) {
      bf16* o = dq + (bc + row) * d;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * qd;
        if (col < d) {
          *reinterpret_cast<__nv_bfloat162*>(o + col) =
              __floats2bfloat162_rn(dqa[j][2 * i], dqa[j][2 * i + 1]);
        }
      }
    } else if (key0 < repro::b_side_reach(row, n_end, seg, kv_off)) {
      float* o = ws_dq + ((static_cast<size_t>(bi) * chunks + chunk) * c + row) * d;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * qd;
        if (col < d) *reinterpret_cast<float2*>(o + col) = make_float2(dqa[j][2 * i], dqa[j][2 * i + 1]);
      }
    }
  }
}

// Grid (key chunks, row groups, b): a CTA walks the row_block / 64 row
// tiles of its group in order over its chunk of keys.
__global__ void __launch_bounds__(kThreads)
ls_bwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ g,
          const float* __restrict__ m, const float* __restrict__ l,
          const float* __restrict__ dcoef, bf16* __restrict__ dq,
          bf16* __restrict__ dk, bf16* __restrict__ dvo, float* __restrict__ ws_dq,
          float* __restrict__ ws_kv, int c, int n, int d, int dv, float scale, int n_end,
          int seg, int kv_off, int chunk_keys, int chunks, int row_block) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (repro::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int rtiles = (c + kRows - 1) / kRows, per = row_block / kRows;
  const int rt_end = min(rtiles, (blockIdx.y + 1) * per);
  for (int rt = blockIdx.y * per; rt < rt_end; ++rt) {
    ls_bwd_tile(q_s, q, k, v, g, m, l, dcoef, dq, dk, dvo, ws_dq, ws_kv, gridDim.z, c, n,
                d, dv, scale, n_end, seg, kv_off, chunk_keys, chunks, blockIdx.x,
                blockIdx.z, rt, rtiles);
    repro::cp_async_wait<0>();
    __syncthreads();  // shared memory is free for the next row tile
  }
}

// Past 64 landmark rows: dK and dV of each key as the sum, in row-tile
// order, of the fp32 partials of the row tiles whose rows may attend it
// (zeros if none). One CTA per 8 keys of one batch-head, a thread per column.
__global__ void __launch_bounds__(128)
ls_bwd_kv_reduce(const float* __restrict__ ws_kv, bf16* __restrict__ dk,
                 bf16* __restrict__ dvo, int b, int c, int n, int d, int dv, int n_end,
                 int seg, int kv_off) {
  constexpr int kKeysPer = 8;
  const int bi = blockIdx.y, col = threadIdx.x;
  const int rtiles = (c + kRows - 1) / kRows;
  const float* pk = ws_kv + static_cast<size_t>(bi) * rtiles * n * d;
  const float* pv = ws_kv + static_cast<size_t>(b) * rtiles * n * d
                    + static_cast<size_t>(bi) * rtiles * n * dv;
  for (int x = 0; x < kKeysPer; ++x) {
    const int key = blockIdx.x * kKeysPer + x;
    if (key >= n) break;
    float ak = 0.f, av = 0.f;
    for (int rt = 0; rt < rtiles; ++rt) {
      if (key >= tile_end(rt, c, n_end, seg, kv_off)) continue;
      if (col < d) ak += pk[(static_cast<size_t>(rt) * n + key) * d + col];
      if (col < dv) av += pv[(static_cast<size_t>(rt) * n + key) * dv + col];
    }
    if (col < d) dk[(static_cast<size_t>(bi) * n + key) * d + col] = __float2bfloat16(ak);
    if (col < dv) dvo[(static_cast<size_t>(bi) * n + key) * dv + col] = __float2bfloat16(av);
  }
}

// One CTA per (batch-head, row), a thread per column: dQ~ as the sum of the
// partials of the chunks the row reaches, in chunk order (zeros if none).
__global__ void __launch_bounds__(128)
ls_bwd_dq_reduce(const float* __restrict__ ws_dq, bf16* __restrict__ dq, int c, int d,
                 int n_end, int seg, int kv_off, int chunk_keys, int chunks) {
  const int bi = blockIdx.x / c, row = blockIdx.x - bi * c;
  const int col = threadIdx.x;
  if (col >= d) return;
  const int reach = max(0, repro::b_side_reach(row, n_end, seg, kv_off));
  const int nch = min(chunks, (reach + chunk_keys - 1) / chunk_keys);
  float a = 0.f;
  for (int ch = 0; ch < nch; ++ch) {
    a += ws_dq[((static_cast<size_t>(bi) * chunks + ch) * c + row) * d + col];
  }
  dq[(static_cast<size_t>(bi) * c + row) * d + col] = __float2bfloat16(a);
}

int launch(const void* q, const void* k, const void* v, const void* g, const float* m,
           const float* l, const float* dcoef, void* dq, void* dk, void* dv_out,
           float* ws_dq, float* ws_kv, int b, int c, int n, int d, int dv, float scale,
           int kv_valid, int seg, int kv_off, int chunk_keys, int row_block, cudaStream_t st) {
  if (d > repro::kTileCols || dv > repro::kTileCols || d % 8 || dv % 8
      || chunk_keys <= 0 || chunk_keys % kKeys || row_block <= 0 || row_block % kRows) {
    return cudaErrorInvalidValue;
  }
  const int n_end = repro::b_side_end(n, c, kv_valid, seg, kv_off);
  const int chunks = n_end > 0 ? (n_end + chunk_keys - 1) / chunk_keys : 0;
  const int rtiles = (c + kRows - 1) / kRows;
  if (chunks > 1 && ws_dq == nullptr) return cudaErrorInvalidValue;
  if (rtiles > 1 && ws_kv == nullptr) return cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        ls_bwd_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  // every key of [0, n) belongs to one CTA of each row group: chunks past
  // n_end only write zeros (or nothing, past 64 rows: the reduce writes them)
  const int groups = (c + row_block - 1) / row_block;
  const dim3 grid((n + chunk_keys - 1) / chunk_keys, groups, b);
  ls_bwd_tc<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), m, l, dcoef, static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv_out), ws_dq, ws_kv, c, n, d, dv, scale,
      n_end, seg, kv_off, chunk_keys, chunks, row_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunks != 1) {
    ls_bwd_dq_reduce<<<b * c, 128, 0, st>>>(ws_dq, static_cast<bf16*>(dq), c, d, n_end,
                                            seg, kv_off, chunk_keys, chunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (rtiles > 1) {
    ls_bwd_kv_reduce<<<dim3((n + 7) / 8, b), 128, 0, st>>>(
        ws_kv, static_cast<bf16*>(dk), static_cast<bf16*>(dv_out), b, c, n, d, dv, n_end,
        seg, kv_off);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// Plain C entry point for ctypes. q_dtype is q_l's (and dq's) storage type,
// kv_dtype that of k, v, g, dk and dv: bf16/bf16 runs the tensor-core pass
// on chunks of chunk_keys keys (a multiple of 64, from the wrapper's chunk
// plan) and row groups of row_block rows (a multiple of 64) with ws_dq the
// fp32 workspace of the chunks' dQ~ partials (null when the plan has one
// chunk) and ws_kv that of the row tiles' dK / dV partials (null for c <=
// 64); fp32/fp32 and fp32 queries
// against bf16 keys, as K1 builds, run the fp32 passes (no workspace). m, l
// and dcoef are fp32 (b, c). kv_valid is global and kv_off the global
// position of key 0 (a shard's offset; 0 unsharded). Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int landmark_summary_bwd_launch(
    const void* q, const void* k, const void* v, const void* g,
    const void* m, const void* l, const void* dcoef, void* dq, void* dk,
    void* dv_out, void* ws_dq, void* ws_kv, int b, int c, int n, int d, int dv,
    float scale, int kv_valid, int seg, int kv_off, int chunk_keys, int row_block,
    int q_dtype, int kv_dtype, void* stream) {
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
  if (qb && kb) return tc::launch(q, k, v, g, mf, lf, df, dq, dk, dv_out, static_cast<float*>(ws_dq), static_cast<float*>(ws_kv), b, c, n, d, dv, scale, kv_valid, seg, kv_off, chunk_keys, row_block, st);
  if (qf && kf) return launch_typed<float, float>(q, k, v, g, mf, lf, df, dq, dk, dv_out, b, c, n, d, dv, scale, kv_valid, seg, kv_off, st);
  if (qf && kb) return launch_typed<float, bf16>(q, k, v, g, mf, lf, df, dq, dk, dv_out, b, c, n, d, dv, scale, kv_valid, seg, kv_off, st);
  return cudaErrorInvalidValue;
}
