// Gather-free paged decode rows: fp32 online-softmax partials (m, l, acc)
// of r query rows per kv head over keys 0..kv_valid-1, read straight from
// the shared K/V block pools through each lane's block table.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_decode.py:162
// paged_row_stats_lanes (body _paged_row_stats_kernel :83, whose `splits`
// loop :118 sums the scores over several key pools; the single-lane
// paged_row_stats :267 and its custom_vmap rule _lane_fn :229 have no
// counterpart: lanes are a grid axis). One key pool of width up to 128
// runs the narrow kernel below; two key pools (absorbed MLA: latent + rope)
// or wider heads run paged_row_stats_wide (further down), a dispatch by
// shape.
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
// bs <= the step's keys, else one slice).
struct Step {
  int b0, nbk, key0, nkeys;
};

// How a chunk is walked, for the launcher (the ring's size) and the kernel
// (the walk), in steps of up to sk keys (kStepKeys = 32 in the narrow
// kernel, kWideStepKeys = 16 in the wide one): for bs <= sk, bps whole
// blocks a step; for bs > sk, spb slices of sk keys a block. A stage holds
// the step's K rows, then its V rows from kv_cap rows on, so key j of the
// step is row j of either.
struct StepGeom {
  int bs, sk;
  bool sliced;
  int spb, bps, kv_cap;
  __host__ __device__ explicit StepGeom(int bs_, int sk_ = kStepKeys)
      : bs(bs_),
        sk(sk_),
        sliced(bs_ > sk_),
        spb(sliced ? (bs_ + sk_ - 1) / sk_ : 1),
        bps(sliced ? 1 : sk_ / bs_),
        kv_cap(sliced ? sk_ : bps * bs_) {}
  // steps of nblk blocks whose valid keys are `keys` (> (nblk - 1) * bs)
  __host__ __device__ int steps(int nblk, int keys) const {
    return sliced ? (nblk - 1) * spb + (keys - (nblk - 1) * bs + sk - 1) / sk
                  : (nblk + bps - 1) / bps;
  }
  __device__ __forceinline__ Step at(int i, int nblk) const {
    Step s;
    if (sliced) {
      s.b0 = i / spb;
      s.nbk = 1;
      s.key0 = (i - s.b0 * spb) * sk;
      s.nkeys = min(sk, bs - s.key0);
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


// ---- wide heads: up to two key pools, d <= 576, dv <= 512 ----------------------
// Absorbed MLA's decode (kernels/paged_decode.py: the 512-wide latent pool
// and the 64-wide rope pool as key pools, the latent pool as the value
// pool, hkv = 1, r = 16 query heads). One CTA per (chunk, kv head x row
// group of kWideRows = 16 rows, lane), the narrow kernel's split-slot grid
// and merge. A step is up to kWideStepKeys = 16 keys; thread 0 bulk-copies
// the step's rows of each key pool and, unless the value pool is the first
// key pool (the same storage), its V rows, into a two-stage ring. With the
// alias a bf16 latent+rope block of 16 keys is one 18 KiB stage, and each
// key's 576 elements are read once for the scores and again (its first
// 512) for P V, not 1,088. Warp w owns query rows w and w + 8: q's rows
// live pre-scaled in its registers (each lane 4-column chunks lane + 32 j
// of both rows), so a key's score is one pass over its row in shared
// memory and a warp sum, with no shared scores and no barrier between
// scores and P V; the accumulator (16 x 512 fp32) is spread over the
// warps, each lane holding 4-column chunks lane + 32 j of its two rows'
// value columns. Per key the work is 2 r (d + dv) = 34,816 flops on 1,152
// bytes (bf16, aliased): about 30 flop/B, above the fp32 FMA ridge of
// about 20, so the kernel is bound by operations.
constexpr int kWideMaxD = 576;                  // sum of the key pools' widths
constexpr int kWideMaxDv = 512;                 // value width
constexpr int kWideRows = 16;                   // query rows per CTA (a row group)
constexpr int kWideRowsPerWarp = kWideRows / kWarps;
constexpr int kWideStepKeys = 16;               // max keys per step
constexpr int kWideQChunks = (kWideMaxD / 4 + 31) / 32;   // q chunks per lane and row
constexpr int kWideVChunks = kWideMaxDv / 4 / 32;         // value chunks per lane and row
constexpr uint32_t kWideMaxDynamic =
    kStages * kWideStepKeys * (kWideMaxD + kWideMaxDv) * 4;
static_assert(kWideRowsPerWarp == 2, "warp w owns rows w and w + 8");
static_assert(kWideStepKeys <= 32, "a lane holds one key's score");

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
paged_row_stats_wide(const T* __restrict__ q, const T* __restrict__ kp0,
                     const T* __restrict__ kp1, const T* __restrict__ vpool, int v_alias,
                     const int* __restrict__ table, const int* __restrict__ kv_valid,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     float* __restrict__ acc_out, float* __restrict__ ws, int hkv, int r,
                     int w0, int w1, int dv, int nb, int bs, int n_slots, int chunk_slots,
                     int chunks, uint32_t stage_bytes, float scale) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kStages];

  const int d = w0 + w1;
  const int chunk = blockIdx.x, ln = blockIdx.z;
  const int n_rg = (r + kWideRows - 1) / kWideRows;
  const int h = blockIdx.y / n_rg, row0 = (blockIdx.y - h * n_rg) * kWideRows;
  const int rows = min(kWideRows, r - row0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = chunk * chunk_slots;
  const int* tb = table + static_cast<size_t>(ln) * n_slots + s0;
  const int valid = min(max(kv_valid[ln], 0), n_slots * bs);
  const int n_blk = (valid + bs - 1) / bs;
  const int nblk = min(s0 + chunk_slots, n_blk) - s0;

  const size_t o = (static_cast<size_t>(ln) * hkv + h) * r + row0;
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
  if (nblk <= 0) {   // no valid key in this chunk: the anchor
    for (int x = tid; x < rows * dv; x += kThreads) ao[x] = 0.f;
    for (int x = tid; x < rows; x += kThreads) {
      mo[x] = kNegInf;
      lo[x] = 0.f;
    }
    return;
  }

  const StepGeom geom(bs, kWideStepKeys);
  const int chunk_keys = min(valid - s0 * bs, nblk * bs);
  const int n_steps = geom.steps(nblk, chunk_keys);
  // stage layout (elements): K rows of pool 0, of pool 1, then V rows
  const int k1_at = geom.kv_cap * w0, v_at = geom.kv_cap * d;
  const uint32_t k1_bytes = k1_at * sizeof(T), v_bytes = v_at * sizeof(T);
  const uint32_t ring0 = smem_addr(ring), bar0 = smem_addr(full);
  auto issue = [&](int i) {
    const Step sp = geom.at(i, nblk);
    const int st = i % kStages;
    const uint32_t dst = ring0 + st * stage_bytes, bar = bar0 + 8 * st;
    const int krows = geom.sliced ? sp.nkeys : bs;
    const uint32_t b0 = static_cast<uint32_t>(krows) * w0 * sizeof(T);
    const uint32_t b1 = static_cast<uint32_t>(krows) * w1 * sizeof(T);
    const uint32_t bv = v_alias ? 0u : static_cast<uint32_t>(krows) * dv * sizeof(T);
    mbar_expect_tx(bar, sp.nbk * (b0 + b1 + bv));
    for (int b = 0; b < sp.nbk; ++b) {
      const size_t row = (static_cast<size_t>(h) * nb + tb[sp.b0 + b]) * bs + sp.key0;
      bulk_copy(dst + b * b0, kp0 + row * w0, b0, bar);
      if (b1) bulk_copy(dst + k1_bytes + b * b1, kp1 + row * w1, b1, bar);
      if (bv) bulk_copy(dst + v_bytes + b * bv, vpool + row * dv, bv, bar);
    }
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bar0 + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < min(kStages, n_steps); ++i) issue(i);
  }

  // This lane's q chunks (4 columns at 4 c, c = lane + 32 j) of rows warp and
  // warp + 8, pre-scaled, and where each chunk's key columns sit in a stage:
  // element offset of key 0 and the row stride (pool 0 or pool 1).
  const int d4 = d / 4;
  float qr[kWideRowsPerWarp][kWideQChunks][4];
  int k_off[kWideQChunks], k_ld[kWideQChunks];
#pragma unroll
  for (int j = 0; j < kWideQChunks; ++j) {
    const int col = 4 * (lane + 32 * j);
    k_off[j] = col < w0 ? col : k1_at + col - w0;
    k_ld[j] = col < w0 ? w0 : w1;
#pragma unroll
    for (int rr = 0; rr < kWideRowsPerWarp; ++rr) {
      const int row = warp + kWarps * rr;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < rows && lane + 32 * j < d4) x = load4(q + (o + row) * d + col);
      qr[rr][j][0] = x.x * scale;
      qr[rr][j][1] = x.y * scale;
      qr[rr][j][2] = x.z * scale;
      qr[rr][j][3] = x.w * scale;
    }
  }
  float m[kWideRowsPerWarp], l[kWideRowsPerWarp], acc[kWideRowsPerWarp][kWideVChunks][4];
#pragma unroll
  for (int rr = 0; rr < kWideRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < kWideVChunks; ++j) acc[rr][j][0] = acc[rr][j][1] = acc[rr][j][2] =
        acc[rr][j][3] = 0.f;
  }
  const int v_base = v_alias ? 0 : v_at, v_ld = v_alias ? w0 : dv;
  const bool live_rows = warp < rows;   // warp-uniform: row warp exists

  for (int i = 0; i < n_steps; ++i) {
    const int st = i % kStages;
    const Step sp = geom.at(i, nblk);
    const int kend = min(sp.nkeys, chunk_keys - (sp.b0 * bs + sp.key0));
    if (live_rows) {
      mbar_wait(bar0 + 8 * st, (i / kStages) & 1);
      const T* stg = reinterpret_cast<const T*>(ring + st * stage_bytes);
      // scores: lane `key` keeps key's score of each row
      float sc[kWideRowsPerWarp] = {kNegInf, kNegInf};
      for (int key = 0; key < kend; ++key) {
        float part[kWideRowsPerWarp] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kWideQChunks; ++j) {
          if (lane + 32 * j < d4) {
            const float4 kx = load4(stg + k_off[j] + key * k_ld[j]);
#pragma unroll
            for (int rr = 0; rr < kWideRowsPerWarp; ++rr) {
              part[rr] = fmaf(qr[rr][j][0], kx.x, part[rr]);
              part[rr] = fmaf(qr[rr][j][1], kx.y, part[rr]);
              part[rr] = fmaf(qr[rr][j][2], kx.z, part[rr]);
              part[rr] = fmaf(qr[rr][j][3], kx.w, part[rr]);
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < kWideRowsPerWarp; ++rr) {
          const float s = repro::warp_sum(part[rr]);
          if (lane == key) sc[rr] = s;
        }
      }
      float pw[kWideRowsPerWarp];
#pragma unroll
      for (int rr = 0; rr < kWideRowsPerWarp; ++rr) {
        const float m_new = fmaxf(m[rr], repro::warp_max(sc[rr]));
        const float corr = expf(m[rr] - m_new);
        pw[rr] = lane < kend ? expf(sc[rr] - m_new) : 0.f;
        l[rr] = l[rr] * corr + repro::warp_sum(pw[rr]);
        m[rr] = m_new;
#pragma unroll
        for (int j = 0; j < kWideVChunks; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[rr][j][e] *= corr;
      }
      // P V: each lane its 4-column chunks of every value row
      for (int key = 0; key < kend; ++key) {
        const float p0 = __shfl_sync(0xffffffffu, pw[0], key);
        const float p1 = __shfl_sync(0xffffffffu, pw[1], key);
#pragma unroll
        for (int j = 0; j < kWideVChunks; ++j) {
          const int col = 4 * (lane + 32 * j);
          if (col < dv) {
            const float4 vx = load4(stg + v_base + key * v_ld + col);
            acc[0][j][0] = fmaf(p0, vx.x, acc[0][j][0]);
            acc[0][j][1] = fmaf(p0, vx.y, acc[0][j][1]);
            acc[0][j][2] = fmaf(p0, vx.z, acc[0][j][2]);
            acc[0][j][3] = fmaf(p0, vx.w, acc[0][j][3]);
            acc[1][j][0] = fmaf(p1, vx.x, acc[1][j][0]);
            acc[1][j][1] = fmaf(p1, vx.y, acc[1][j][1]);
            acc[1][j][2] = fmaf(p1, vx.z, acc[1][j][2]);
            acc[1][j][3] = fmaf(p1, vx.w, acc[1][j][3]);
          }
        }
      }
    }
    __syncthreads();   // every warp is past stage st: refill it
    if (tid == 0 && i + kStages < n_steps) issue(i + kStages);
  }

#pragma unroll
  for (int rr = 0; rr < kWideRowsPerWarp; ++rr) {
    const int row = warp + kWarps * rr;
    if (row >= rows) break;
#pragma unroll
    for (int j = 0; j < kWideVChunks; ++j) {
      const int col = 4 * (lane + 32 * j);
      if (col < dv)
        *reinterpret_cast<float4*>(ao + static_cast<size_t>(row) * dv + col) =
            make_float4(acc[rr][j][0], acc[rr][j][1], acc[rr][j][2], acc[rr][j][3]);
    }
    if (lane == 0) {
      mo[row] = m[rr];
      lo[row] = l[rr];
    }
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

int merge_chunks(float* ws, float* m_out, float* l_out, float* acc_out, int lanes, int hkv,
                 int r, int dv, int chunks, cudaStream_t st) {
  paged_row_stats_merge<<<lanes * hkv * r, 128, 2 * chunks * sizeof(float), st>>>(
      ws, m_out, l_out, acc_out, r, dv, chunks);
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
  return merge_chunks(ws, m_out, l_out, acc_out, lanes, hkv, r, dv, chunks, st);
}

template <typename T>
int launch_wide(const void* q, const void* kp0, const void* kp1, const void* vpool,
                const int* table, const int* kv_valid, float* m_out, float* l_out,
                float* acc_out, float* ws, int lanes, int hkv, int r, int w0, int w1, int dv,
                int nb, int bs, int n_slots, int chunk_slots, float scale, cudaStream_t st) {
  const int chunks = n_slots > 0 ? (n_slots + chunk_slots - 1) / chunk_slots : 1;
  if (chunks > 1 && ws == nullptr) return cudaErrorInvalidValue;
  // the value pool is the first key pool: its rows are copied once
  const int v_alias = vpool == kp0 && dv == w0;
  const StepGeom geom(bs, kWideStepKeys);
  const uint32_t stage_bytes =
      (static_cast<uint32_t>(geom.kv_cap) * (w0 + w1 + (v_alias ? 0 : dv)) * sizeof(T)
       + 127u) & ~127u;
  const int chunk_steps = geom.steps(chunk_slots, chunk_slots * bs);
  const size_t smem = static_cast<size_t>(min(kStages, chunk_steps)) * stage_bytes;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_row_stats_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kWideMaxDynamic));
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const int n_rg = (r + kWideRows - 1) / kWideRows;
  const dim3 grid(chunks, hkv * n_rg, lanes);
  paged_row_stats_wide<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp0), static_cast<const T*>(kp1),
      static_cast<const T*>(vpool), v_alias, table, kv_valid, m_out, l_out, acc_out, ws, hkv,
      r, w0, w1, dv, nb, bs, n_slots, chunk_slots, chunks, stage_bytes, scale);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != cudaSuccess || chunks == 1) return err;
  return merge_chunks(ws, m_out, l_out, acc_out, lanes, hkv, r, dv, chunks, st);
}

}  // namespace

// Plain C entry point for ctypes: one launch (two with more than one chunk)
// for all lanes, any r and any bs. Key pool 0 (width w0) and, when kpool1 is
// not null, key pool 1 (width w1) hold the keys, q's d = w0 + w1 features
// split across them in order; vpool (width dv) holds the values and may be
// kpool0 itself. One pool with w0 and dv up to 128 runs the narrow kernel;
// two pools, or wider heads (w0 + w1 up to 576, dv up to 512), the wide one
// (a dispatch by shape). q and the pools share the storage type (fp32 or
// bf16); table and kv_valid are int32; outputs fp32. chunk_slots comes from
// the wrapper's slot-chunk plan; ws is its fp32 workspace of
// lanes * hkv * chunks * r * (dv + 2) floats (null with one chunk). q and
// the pools must be 16-byte aligned, a pool block (bs rows of each width)
// whole 16-byte units, every width a multiple of 4. Returns
// cudaGetLastError() after the launches.
extern "C" int paged_row_stats_launch(
    const void* q, const void* kpool0, const void* kpool1, const void* vpool,
    const void* table, const void* kv_valid, void* m_out, void* l_out, void* acc_out,
    void* ws, int lanes, int hkv, int r, int w0, int w1, int dv, int nb, int bs,
    int n_slots, int chunk_slots, float scale, int dtype, void* stream) {
  const int es = dtype == repro::kF32 ? 4 : 2;
  const bool wide = kpool1 != nullptr || w0 > kMaxD || dv > kMaxD;
  const int ws1 = kpool1 != nullptr ? w1 : 0;
  if ((wide ? (w0 + ws1 > kWideMaxD || dv > kWideMaxDv) : (w0 > kMaxD || dv > kMaxD))
      || w0 <= 0 || dv <= 0 || w0 % 4 || ws1 % 4 || dv % 4 || r <= 0 || lanes <= 0
      || hkv <= 0 || bs <= 0 || n_slots < 0 || chunk_slots <= 0
      || (bs * w0 * es) % 16 || (bs * ws1 * es) % 16 || (bs * dv * es) % 16
      || (kpool1 != nullptr && ws1 <= 0)
      || (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(kpool0)
          | reinterpret_cast<uintptr_t>(kpool1) | reinterpret_cast<uintptr_t>(vpool)) % 16) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* kvv = static_cast<const int*>(kv_valid);
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  float* ao = static_cast<float*>(acc_out);
  float* w = static_cast<float*>(ws);
  using bf16 = __nv_bfloat16;
  if (dtype != repro::kF32 && dtype != repro::kBF16) return cudaErrorInvalidValue;
  if (wide) {
    return dtype == repro::kF32
        ? launch_wide<float>(q, kpool0, kpool1, vpool, tb, kvv, mo, lo, ao, w, lanes, hkv, r,
                             w0, ws1, dv, nb, bs, n_slots, chunk_slots, scale, st)
        : launch_wide<bf16>(q, kpool0, kpool1, vpool, tb, kvv, mo, lo, ao, w, lanes, hkv, r,
                            w0, ws1, dv, nb, bs, n_slots, chunk_slots, scale, st);
  }
  return dtype == repro::kF32
      ? launch_typed<float>(q, kpool0, vpool, tb, kvv, mo, lo, ao, w, lanes, hkv, r, w0, dv,
                            nb, bs, n_slots, chunk_slots, scale, st)
      : launch_typed<bf16>(q, kpool0, vpool, tb, kvv, mo, lo, ao, w, lanes, hkv, r, w0, dv,
                           nb, bs, n_slots, chunk_slots, scale, st);
}
