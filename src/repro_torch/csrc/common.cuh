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
// n_end keys any row may attend (segment-causal when seg > 0).
__device__ __forceinline__ int b_side_reach(int r, int n_end, int seg) {
  return seg > 0 ? min(n_end, (r + 1) * seg) : n_end;
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
