// Shared helpers for the port's hand-written Hopper kernels: element
// conversions (every kernel accumulates in fp32 whatever its storage type),
// warp reductions, and the dtype codes the ctypes wrappers pass.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// Masked score sentinel, the reference's _NEG_INF: finite, so a row with no
// valid key keeps an anchor that flash_merge absorbs (exp(-1e30 - m) == 0).
constexpr float kNegInf = -1e30f;

constexpr float kLog2e = 1.4426950408889634f;

// B-side mask: landmark row r may attend keys [0, b_side_reach(r)) of the
// n_end keys any row may attend, the keys of a shard whose first key sits at
// global position kv_off (0 unsharded). Segment-causal when seg > 0: global
// position below (r + 1) * seg, so on a later shard the reach of a low row
// is <= 0 (it attends no key of the shard).
__device__ __forceinline__ int b_side_reach(int r, int n_end, int seg, int kv_off) {
  return seg > 0 ? min(n_end, (r + 1) * seg - kv_off) : n_end;
}

// Keys [0, n) of a shard at global offset kv_off that some landmark row may
// attend: below the global kv_valid and, segment-causal, below c * seg.
// May be <= 0 (no key of the shard is attended).
__host__ __device__ __forceinline__ int b_side_end(int n, int c, int kv_valid, int seg,
                                                   int kv_off) {
  const int end = min(n, kv_valid - kv_off);
  return seg > 0 ? min(end, c * seg - kv_off) : end;
}

// Storage-type codes shared with kernels/build.py.
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a bf16 cast does
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

}  // namespace repro
