// Helpers shared by the port's attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hvd_torch {

// The JAX package masks with -1e30, not -inf: a masked score then
// softmaxes to exactly 0 and a fully masked row stays finite.
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like astype
}

// Chunk offsets (a ring step sees queries from global position q_offset
// and keys from kv_offset) enter every kernel as one number, shift =
// q_offset - kv_offset: local key kpos is visible to local query qpos iff
// kpos <= qpos + shift (shift 0: the plain causal mask). The keys that a
// causal tile whose last row is q_last can see are [0, causal_kv_end).
__device__ __forceinline__ int causal_kv_end(int q_last, int shift, int Tk) {
  return min(Tk, max(0, q_last + shift + 1));
}

// x rounded to T and widened back: the "cast p to v's dtype" step.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

}  // namespace hvd_torch
