// Gather-free paged decode rows: fp32 online-softmax partials (m, l, acc)
// of r query rows per kv head over keys 0..kv_valid-1, read straight from
// the shared K/V block pools through each lane's block table.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_decode.py:162
// paged_row_stats_lanes (body _paged_row_stats_kernel :83; the single-lane
// paged_row_stats :267 and its custom_vmap rule _lane_fn :229 have no
// counterpart: lanes are a grid axis).
//
// What it computes, per lane, kv head h and row:
//   key t (t < kv_valid[lane]) lives in pool block table[lane, t / bs] at
//   offset t % bs; s_t = scale * q[lane,h,row] . K[h, blk, t % bs];
//   m = max s_t, l = sum exp(s_t - m), acc = sum exp(s_t - m) V[h, blk, .].
//   A row with no valid key (kv_valid = 0, padded lanes) returns exactly
//   (m = -1e30, l = 0, acc = 0), the anchor flash_merge absorbs; slots past
//   the last valid key (ZERO_BLOCK tail) are never read.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s fp32 FMA): the valid keys' K
// and V rows. Per key and kv head it reads d + dv elements and does
// 2 r (d + dv) flops: at d = dv = 128 that is r / 2 flop/B in fp32 pools
// and r in bf16. The FMA ridge is about 20 flop/B, so at r = 7 (Qwen2-7B)
// the kernel is bytes-bound, and at r = 48 (granite-20b, 48 heads on one
// kv head) it is bound by operations. At the serving shape (4 lanes, 4 kv
// heads, r = 7, d = dv = 128, bs 16, fp32, <= 512 keys) the bytes take
// ~1 us; at a 16k horizon 126 MB take ~38 us.
//
// Design: a split-slot (flash-decoding) grid with bulk-copied pool blocks.
// - Grid (chunk, kv head x row group, lane). The wrapper's slot-chunk plan
//   (kernels/paged_decode.py:slot_chunk_plan) cuts the table's n_slots
//   into chunks of whole blocks, sized from n_slots alone (kv_valid lives
//   on the device, so the host never waits for it) for about 528 CTAs. A
//   CTA whose chunk holds no valid key writes the anchor and exits. A CTA
//   takes up to kMaxRows = 64 query rows of its kv head; more rows take
//   more row groups (each reads the chunk's K and V again).
// - A step is up to kStepKeys = 32 keys (one per lane): for bs <= 32,
//   floor(32 / bs) consecutive whole blocks (bs need not divide 32); for
//   bs > 32, a 32-key slice of one block (a 48-key block is a 32-key and a
//   16-key step). The slice's K rows and V rows are each contiguous, so a
//   step is one bulk copy per block and operand either way. Thread 0 reads
//   the table entry and copies the step's K rows, then its V rows, into
//   one stage of a ring in shared memory with Hopper's bulk copy
//   (cp.async.bulk ... mbarrier::complete_tx::bytes), completion on one
//   mbarrier per stage. The first kStages = 2 steps are in flight before
//   the first is consumed. Step i-1's stage is refilled after the CTA-wide
//   barrier that follows step i's scores, so one __syncthreads per step
//   suffices; this needs at least 2 stages (with one, a step would be
//   issued after the wait that needs it).
// - q's rows, pre-scaled to fp32, are staged in shared memory once. Scores
//   of a whole step, in fp32 FMA, in groups of 8 rows: 16 keys per pass, 16
//   threads per key, each thread holding its two 4-column chunks of the
//   group's 8 rows in registers (loaded from shared memory once per group
//   and step); the 8 partial sums of a thread are reduced over its 16
//   threads by a transposing butterfly (8 shuffles, not 32), after which
//   threads 2 row and 2 row + 1 hold row `row`'s score. The 16 threads of a
//   key read one contiguous row of the stage: no bank conflicts without
//   padding, which a bulk copy cannot add.
// - Warp w owns query rows w, w + 8, w + 16, ... (kRowsPerWarp of them, a
//   template parameter of 1, 2, 4 or 8), lane j key j of the step: one max,
//   one rescale of the accumulator and one exp per row and lane per step
//   (not per key), then P V with each lane holding 4 value columns of each
//   of its rows (the warp reads one contiguous V row per key, once for all
//   its rows), the weights broadcast by shuffle, 16 keys unrolled.
// - Partials: with one chunk the CTA writes (m, l, acc) directly; else
//   each chunk's fp32 partial goes to the wrapper's workspace and
//   paged_row_stats_merge combines them in chunk order with flash_merge's
//   rule (no atomics: two launches give the same bits).
// A sweep on the H100 chose 528 CTAs and 2 stages (PERF.md): at a 16k
// horizon 256 CTAs left most SMs one CTA (latency-bound), 3 stages gained
// nothing, and 4 stages of 32 KB left room for only one CTA an SM.
#include <cstdint>

#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRowsPerWarp = 8;       // the largest kRowsPerWarp instance
constexpr int kMaxRows = 64;             // query rows per CTA (a row group)
constexpr int kRowGroup = 8;             // rows per score-pass group (the butterfly's 8)
constexpr int kMaxD = 128;               // max head dim (d and dv)
constexpr int kStepKeys = 32;            // max keys per step (one per lane)
constexpr int kStages = 2;               // ring stages (mbarriers)
constexpr int kKeyThreads = 16;          // threads per key in the score pass
constexpr int kKeysPerPass = kThreads / kKeyThreads;
constexpr int kChunks = kMaxD / 4 / kKeyThreads;   // 4-column chunks per thread
// dynamic shared memory at most: the ring (kStages steps of up to kStepKeys
// K rows and kStepKeys V rows of fp32), q's rows in fp32, and the scores of
// two steps
constexpr uint32_t kMaxRing = kStages * kStepKeys * 2 * kMaxD * 4;
constexpr uint32_t kMaxDynamic =
    kMaxRing + kMaxRows * kMaxD * 4 + 2 * kMaxRows * (kStepKeys + 1) * 4;
static_assert(kMaxRows == kWarps * kMaxRowsPerWarp, "warp w owns rows w, w + 8, ...");
static_assert(kRowGroup == 8 && kMaxRows % kRowGroup == 0, "butterfly_rows sums 8 rows");
static_assert(kStages >= 2, "step i-1's stage is refilled after step i's wait");

// ---- mbarrier and bulk copy -------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// `bytes` (a multiple of 16) from 16-byte aligned global `src` to shared
// `dst`; completion counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Four consecutive elements as floats (16 B of fp32, 8 B of bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Sum x[0..7] over the 16 threads of a key group (lanes differing in bits
// 0-3). Each step hands half of the remaining rows to the partner, so after
// 8 shuffles the thread with key-thread index kt holds the full sum of row
// kt >> 1.
__device__ __forceinline__ float butterfly_rows(const float (&x)[kRowGroup], int kt) {
  const bool b3 = kt & 8, b2 = kt & 4, b1 = kt & 2;
  float y[4], z[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = b3 ? x[4 + i] : x[i], send = b3 ? x[i] : x[4 + i];
    y[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = b2 ? y[2 + i] : y[i], send = b2 ? y[i] : y[2 + i];
    z[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
  float s = (b1 ? z[1] : z[0]) + __shfl_xor_sync(0xffffffffu, b1 ? z[0] : z[1], 2);
  return s + __shfl_xor_sync(0xffffffffu, s, 1);
}

// The geometry of a step of a chunk whose valid blocks are nblk: its first
// block b0 (within the chunk), nbk blocks, key offset key0 within the first
// block and nkeys keys (the stage's K rows; all nbk blocks whole when
// bs <= kStepKeys, else one 32-key slice).
struct Step {
  int b0, nbk, key0, nkeys;
};

// How a chunk is walked, for the launcher (the ring's size) and the kernel
// (the walk): for bs <= 32, bps whole blocks a step (up to 32 keys); for
// bs > 32, spb slices of 32 keys a block. A stage holds the step's K rows,
// then its V rows from kv_cap rows on, so key j of the step is row j of
// either.
struct StepGeom {
  int bs;
  bool sliced;
  int spb, bps, kv_cap;
  __host__ __device__ explicit StepGeom(int bs_)
      : bs(bs_),
        sliced(bs_ > kStepKeys),
        spb(sliced ? (bs_ + kStepKeys - 1) / kStepKeys : 1),
        bps(sliced ? 1 : kStepKeys / bs_),
        kv_cap(sliced ? kStepKeys : bps * bs_) {}
  // steps of nblk blocks whose valid keys are `keys` (> (nblk - 1) * bs)
  __host__ __device__ int steps(int nblk, int keys) const {
    return sliced ? (nblk - 1) * spb + (keys - (nblk - 1) * bs + kStepKeys - 1) / kStepKeys
                  : (nblk + bps - 1) / bps;
  }
  __device__ __forceinline__ Step at(int i, int nblk) const {
    Step s;
    if (sliced) {
      s.b0 = i / spb;
      s.nbk = 1;
      s.key0 = (i - s.b0 * spb) * kStepKeys;
      s.nkeys = min(kStepKeys, bs - s.key0);
    } else {
      s.b0 = i * bps;
      s.nbk = min(bps, nblk - s.b0);
      s.key0 = 0;
      s.nkeys = s.nbk * bs;
    }
    return s;
  }
};

template <typename T, int kRowsPerWarp>
__global__ void __launch_bounds__(kThreads, kRowsPerWarp >= 8 ? 1 : 2)
paged_row_stats_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                       const T* __restrict__ vpool, const int* __restrict__ table,
                       const int* __restrict__ kv_valid, float* __restrict__ m_out,
                       float* __restrict__ l_out, float* __restrict__ acc_out,
                       float* __restrict__ ws, int hkv, int r, int d, int dv, int nb,
                       int bs, int n_slots, int chunk_slots, int chunks,
                       uint32_t stage_bytes, uint32_t ring_bytes, float scale) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kStages];

  const int chunk = blockIdx.x, ln = blockIdx.z;
  const int n_rg = (r + kMaxRows - 1) / kMaxRows;
  const int h = blockIdx.y / n_rg, row0 = (blockIdx.y - h * n_rg) * kMaxRows;
  const int rows = min(kMaxRows, r - row0);                  // this CTA's query rows
  const int groups = (rows + kRowGroup - 1) / kRowGroup;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = chunk * chunk_slots;
  const int* tb = table + static_cast<size_t>(ln) * n_slots + s0;
  const int blk0 = tid == 0 && s0 < n_slots ? tb[0] : 0;   // fetched beside kv_valid
  const int valid = min(max(kv_valid[ln], 0), n_slots * bs);
  const int n_blk = (valid + bs - 1) / bs;
  const int nblk = min(s0 + chunk_slots, n_blk) - s0;   // blocks of this chunk

  // Where this CTA's (m, l, acc) go: the output with one chunk, else its
  // partial in the workspace (layout: see paged_row_stats_merge).
  const size_t o = (static_cast<size_t>(ln) * hkv + h) * r + row0;   // first output row
  float* mo = m_out + o;
  float* lo = l_out + o;
  float* ao = acc_out + o * dv;
  if (chunks > 1) {
    const size_t all = static_cast<size_t>(gridDim.z) * hkv * chunks * r;
    const size_t w = ((static_cast<size_t>(ln) * hkv + h) * chunks + chunk) * r + row0;
    ao = ws + w * dv;
    mo = ws + all * dv + w;
    lo = ws + all * (dv + 1) + w;
  }
  if (nblk <= 0) {   // no valid key in this chunk: the anchor, which merges as 0
    for (int x = tid; x < rows * dv; x += kThreads) ao[x] = 0.f;
    for (int x = tid; x < rows; x += kThreads) {
      mo[x] = kNegInf;
      lo[x] = 0.f;
    }
    return;
  }

  const StepGeom geom(bs);
  const int chunk_keys = min(valid - s0 * bs, nblk * bs);   // valid keys of the chunk
  const int n_steps = geom.steps(nblk, chunk_keys);
  const uint32_t ring0 = smem_addr(ring), bar0 = smem_addr(full);
  auto issue = [&](int i) {   // step i of the chunk into stage i % kStages
    const Step sp = geom.at(i, nblk);
    const int st = i % kStages;
    const uint32_t dst = ring0 + st * stage_bytes, bar = bar0 + 8 * st;
    const int krows = geom.sliced ? sp.nkeys : bs;   // rows copied per block
    const uint32_t kb = static_cast<uint32_t>(krows) * d * sizeof(T);
    const uint32_t vb = static_cast<uint32_t>(krows) * dv * sizeof(T);
    const uint32_t v_at = static_cast<uint32_t>(geom.kv_cap) * d * sizeof(T);
    mbar_expect_tx(bar, sp.nbk * (kb + vb));
    for (int b = 0; b < sp.nbk; ++b) {
      const int slot = sp.b0 + b;
      const size_t row = (static_cast<size_t>(h) * nb + (slot == 0 ? blk0 : tb[slot])) * bs
                         + sp.key0;
      bulk_copy(dst + b * kb, kpool + row * d, kb, bar);
      bulk_copy(dst + v_at + b * vb, vpool + row * dv, vb, bar);
    }
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bar0 + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  // q's rows (groups * 8 of them, zero past `rows`), pre-scaled fp32, after
  // the ring; then the scores of two steps, [2][groups * 8][kStepKeys + 1]
  // (+1: the score writes spread over banks).
  float* q_sh = reinterpret_cast<float*>(ring + ring_bytes);
  const int s_rows = groups * kRowGroup, d4 = d / 4;
  float* s_sh = q_sh + static_cast<size_t>(s_rows) * d;
  for (int x = tid; x < s_rows * d4; x += kThreads) {
    const int row = x / d4, col = 4 * (x - row * d4);
    float4 v = row < rows ? load4(q + (o + row) * d + col) : make_float4(0.f, 0.f, 0.f, 0.f);
    v.x *= scale;
    v.y *= scale;
    v.z *= scale;
    v.w *= scale;
    *reinterpret_cast<float4*>(q_sh + row * d + col) = v;
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < min(kStages, n_steps); ++i) issue(i);
  }

  // Score-pass roles: key `kp` of each pass of 16, key-thread kt owning the
  // 4-column chunks kt and kt + 16 (columns 4 kt.. and 64 + 4 kt..).
  const int kt = tid & (kKeyThreads - 1), kp = tid / kKeyThreads;

  // The running state of rows warp + 8 j (identical in every lane) and
  // lane's 4 value columns of each row's accumulator.
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][4];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  const int vcol = 4 * lane;

  for (int i = 0; i < n_steps; ++i) {
    const int st = i % kStages;
    mbar_wait(bar0 + 8 * st, (i / kStages) & 1);
    const Step sp = geom.at(i, nblk);
    const T* ks = reinterpret_cast<const T*>(ring + st * stage_bytes);
    const T* vs = ks + static_cast<size_t>(geom.kv_cap) * d;
    // valid keys of the step: its rows up to kv_valid
    const int kend = min(sp.nkeys, chunk_keys - (sp.b0 * bs + sp.key0));
    float* sb = s_sh + (i & 1) * s_rows * (kStepKeys + 1);

    // scores of the whole step: sb[row][key] = scale q[row] . K[key]
    const int passes = (kend + kKeysPerPass - 1) / kKeysPerPass;
    for (int g = 0; g < groups; ++g) {
      float qr[kRowGroup][kChunks][4];
#pragma unroll
      for (int row = 0; row < kRowGroup; ++row)
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          const int col = 4 * (kt + kKeyThreads * j);
          const float4 x = col < d ? *reinterpret_cast<const float4*>(
                                         q_sh + (g * kRowGroup + row) * d + col)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
          qr[row][j][0] = x.x;
          qr[row][j][1] = x.y;
          qr[row][j][2] = x.z;
          qr[row][j][3] = x.w;
        }
      for (int p = 0; p < passes; ++p) {
        const int key = kp + kKeysPerPass * p;
        const T* kr = ks + static_cast<size_t>(min(key, kend - 1)) * d;
        float part[kRowGroup];
#pragma unroll
        for (int row = 0; row < kRowGroup; ++row) part[row] = 0.f;
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          const int col = 4 * (kt + kKeyThreads * j);
          if (col < d) {
            const float4 kx = load4(kr + col);
#pragma unroll
            for (int row = 0; row < kRowGroup; ++row) {
              part[row] = fmaf(qr[row][j][0], kx.x, part[row]);
              part[row] = fmaf(qr[row][j][1], kx.y, part[row]);
              part[row] = fmaf(qr[row][j][2], kx.z, part[row]);
              part[row] = fmaf(qr[row][j][3], kx.w, part[row]);
            }
          }
        }
        const float s = butterfly_rows(part, kt);
        if (!(kt & 1) && key < kend)
          sb[(g * kRowGroup + (kt >> 1)) * (kStepKeys + 1) + key] = s;
      }
    }
    __syncthreads();
    // Every thread is past step i-1: refill its stage with step i-1+kStages.
    if (tid == 0 && i >= 1 && i - 1 + kStages < n_steps) issue(i - 1 + kStages);

    if (warp < rows) {
      float pw[kRowsPerWarp];
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const int row = warp + kWarps * j;
        pw[j] = 0.f;
        if (row < rows) {   // warp-uniform
          const float s = lane < kend ? sb[row * (kStepKeys + 1) + lane] : kNegInf;
          const float m_new = fmaxf(m[j], repro::warp_max(s));
          const float corr = expf(m[j] - m_new);
          pw[j] = lane < kend ? expf(s - m_new) : 0.f;
          l[j] = l[j] * corr + repro::warp_sum(pw[j]);
          m[j] = m_new;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] *= corr;
        }
      }
      // 16 keys at a time, unrolled: their V reads are independent and
      // issue together rather than one per key; each V row is read once
      // for all of the warp's rows.
      for (int k0 = 0; k0 < kend; k0 += 16) {
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int key = k0 + jj;
          const bool live = key < kend && vcol < dv;
          const float4 vx = live ? load4(vs + static_cast<size_t>(key) * dv + vcol)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int j = 0; j < kRowsPerWarp; ++j) {
            const float pk = __shfl_sync(0xffffffffu, pw[j], key);
            if (live) {
              acc[j][0] = fmaf(pk, vx.x, acc[j][0]);
              acc[j][1] = fmaf(pk, vx.y, acc[j][1]);
              acc[j][2] = fmaf(pk, vx.z, acc[j][2]);
              acc[j][3] = fmaf(pk, vx.w, acc[j][3]);
            }
          }
        }
      }
    }
  }

  if (warp >= rows) return;
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int row = warp + kWarps * j;
    if (row >= rows) break;
    if (vcol < dv)
      *reinterpret_cast<float4*>(ao + static_cast<size_t>(row) * dv + vcol) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    if (lane == 0) {
      mo[row] = m[j];
      lo[row] = l[j];
    }
  }
}

// One CTA per (lane, kv head, row): merges the partials of every chunk in
// chunk order with flash_merge's rule (a chunk with no valid key left the
// anchor, whose weight exp(-1e30 - m) is 0; a lane with no valid key keeps
// it: m = -1e30, l = 0, acc = 0). The chunks' weights exp(m_c - m) and
// their l are staged in shared memory; each thread then sums one value
// column over the chunks in order, and thread 0 sums l. Workspace layout
// over the rows w = ((lane * hkv + h) * chunks + chunk) * r + row of all
// `rows`: acc (rows x dv, so every row starts 16-byte aligned), then m
// (rows), then l (rows).
__global__ void __launch_bounds__(128)
paged_row_stats_merge(const float* __restrict__ ws, float* __restrict__ m_out,
                      float* __restrict__ l_out, float* __restrict__ acc_out, int r,
                      int dv, int chunks) {
  extern __shared__ float e_s[];   // per chunk: its weight, then (+chunks) its l
  float* l_s = e_s + chunks;
  __shared__ float mx_s[4];
  const int lh = blockIdx.x / r, row = blockIdx.x - lh * r, tid = threadIdx.x;
  const size_t rows = static_cast<size_t>(gridDim.x) * chunks;
  const float* ws_m = ws + rows * dv;
  const float* ws_l = ws_m + rows;
  const size_t w0 = static_cast<size_t>(lh) * chunks * r + row;   // chunk c: w0 + c r
  float mx = kNegInf;
  for (int c = tid; c < chunks; c += 128) {
    const size_t w = w0 + static_cast<size_t>(c) * r;
    e_s[c] = ws_m[w];
    l_s[c] = ws_l[w];
    mx = fmaxf(mx, e_s[c]);
  }
  mx = repro::warp_max(mx);
  if ((tid & 31) == 0) mx_s[tid >> 5] = mx;
  __syncthreads();
  mx = fmaxf(fmaxf(mx_s[0], mx_s[1]), fmaxf(mx_s[2], mx_s[3]));
  for (int c = tid; c < chunks; c += 128) e_s[c] = expf(e_s[c] - mx);
  __syncthreads();
  const size_t o = static_cast<size_t>(lh) * r + row;
  for (int col = tid; col < dv; col += 128) {
    float a = 0.f;
#pragma unroll 8
    for (int c = 0; c < chunks; ++c) a += ws[(w0 + static_cast<size_t>(c) * r) * dv + col] * e_s[c];
    acc_out[o * dv + col] = a;
  }
  if (tid == 0) {
    float l = 0.f;
    for (int c = 0; c < chunks; ++c) l += l_s[c] * e_s[c];
    m_out[o] = mx;
    l_out[o] = l;
  }
}

template <typename T, int kRowsPerWarp>
int launch_rows(const dim3 grid, size_t smem, cudaStream_t st, const void* q,
                const void* kpool, const void* vpool, const int* table, const int* kv_valid,
                float* m_out, float* l_out, float* acc_out, float* ws, int hkv, int r, int d,
                int dv, int nb, int bs, int n_slots, int chunk_slots, int chunks,
                uint32_t stage_bytes, uint32_t ring_bytes, float scale) {
  static bool sized = false;   // allow the largest shared memory once (beside 16 B static)
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_row_stats_kernel<T, kRowsPerWarp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxDynamic));
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  paged_row_stats_kernel<T, kRowsPerWarp><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool), static_cast<const T*>(vpool),
      table, kv_valid, m_out, l_out, acc_out, ws, hkv, r, d, dv, nb, bs, n_slots,
      chunk_slots, chunks, stage_bytes, ring_bytes, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* q, const void* kpool, const void* vpool, const int* table,
                 const int* kv_valid, float* m_out, float* l_out, float* acc_out,
                 float* ws, int lanes, int hkv, int r, int d, int dv, int nb, int bs,
                 int n_slots, int chunk_slots, float scale, cudaStream_t st) {
  const int chunks = n_slots > 0 ? (n_slots + chunk_slots - 1) / chunk_slots : 1;
  if (chunks > 1 && ws == nullptr) return cudaErrorInvalidValue;
  const StepGeom geom(bs);
  const uint32_t stage_bytes =
      (static_cast<uint32_t>(geom.kv_cap) * (d + dv) * sizeof(T) + 127u) & ~127u;
  // a chunk of one step uses one stage of the ring
  const int chunk_steps = geom.steps(chunk_slots, chunk_slots * bs);
  const uint32_t ring_bytes = static_cast<uint32_t>(min(kStages, chunk_steps)) * stage_bytes;
  const int rows = min(r, kMaxRows), groups = (rows + kRowGroup - 1) / kRowGroup;
  const size_t smem = ring_bytes + static_cast<size_t>(groups) * kRowGroup * d * 4
                      + 2 * static_cast<size_t>(groups) * kRowGroup * (kStepKeys + 1) * 4;
  const int n_rg = (r + kMaxRows - 1) / kMaxRows;
  const dim3 grid(chunks, hkv * n_rg, lanes);
  // rows per warp: the smallest instance that holds `groups`
  auto go = [&](auto fn) {
    return fn(grid, smem, st, q, kpool, vpool, table, kv_valid, m_out, l_out, acc_out, ws,
              hkv, r, d, dv, nb, bs, n_slots, chunk_slots, chunks, stage_bytes, ring_bytes,
              scale);
  };
  const int err = groups <= 1   ? go(launch_rows<T, 1>)
                  : groups <= 2 ? go(launch_rows<T, 2>)
                  : groups <= 4 ? go(launch_rows<T, 4>)
                                : go(launch_rows<T, kMaxRowsPerWarp>);
  if (err != cudaSuccess || chunks == 1) return err;
  paged_row_stats_merge<<<lanes * hkv * r, 128, 2 * chunks * sizeof(float), st>>>(
      ws, m_out, l_out, acc_out, r, dv, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes: one launch (two with more than one chunk)
// for all lanes, any r and any bs. q and the pools share the storage type (fp32 or bf16);
// table and kv_valid are int32; outputs fp32. chunk_slots comes from the
// wrapper's slot-chunk plan; ws is its fp32 workspace of
// lanes * hkv * chunks * r * (dv + 2) floats (null with one chunk).
// q and the pools must be 16-byte aligned, a pool
// block (bs * d or bs * dv elements) whole 16-byte units, d and dv
// multiples of 4. Returns cudaGetLastError() after the launches.
extern "C" int paged_row_stats_launch(
    const void* q, const void* kpool, const void* vpool, const void* table,
    const void* kv_valid, void* m_out, void* l_out, void* acc_out, void* ws, int lanes,
    int hkv, int r, int d, int dv, int nb, int bs, int n_slots, int chunk_slots,
    float scale, int dtype, void* stream) {
  const int es = dtype == repro::kF32 ? 4 : 2;
  if (d > kMaxD || dv > kMaxD || d % 4 || dv % 4 || r <= 0 || lanes <= 0
      || hkv <= 0 || bs <= 0 || n_slots < 0 || chunk_slots <= 0
      || (bs * d * es) % 16 || (bs * dv * es) % 16
      || (reinterpret_cast<uintptr_t>(kpool) | reinterpret_cast<uintptr_t>(vpool)) % 16) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* kvv = static_cast<const int*>(kv_valid);
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  float* ao = static_cast<float*>(acc_out);
  float* w = static_cast<float*>(ws);
  if (dtype == repro::kF32) {
    return launch_typed<float>(q, kpool, vpool, tb, kvv, mo, lo, ao, w, lanes, hkv, r, d,
                               dv, nb, bs, n_slots, chunk_slots, scale, st);
  }
  if (dtype == repro::kBF16) {
    return launch_typed<__nv_bfloat16>(q, kpool, vpool, tb, kvv, mo, lo, ao, w, lanes, hkv,
                                       r, d, dv, nb, bs, n_slots, chunk_slots, scale,
                                       st);
  }
  return cudaErrorInvalidValue;
}
