// The element type of the residuals the training kernels save and read:
// float, or bfloat16 rounded to nearest even (the JAX package's
// residual_dtype, pallas_lstm.py:79). Shared by bilstm_infer.cu,
// bilstm_bwd.cu, lane_fwd.cuh and lane_bwd.cuh: a residual is computed
// and carried in float32 and rounded only where it is stored, and read
// back widened to float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace resid {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

template <typename R>
__device__ __forceinline__ R narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive values to `to`, aligned to four elements: one 16-byte
// store of floats, or one 8-byte store of bfloat16s.
__device__ __forceinline__ void store4(float* to, float4 v) {
  *reinterpret_cast<float4*>(to) = v;
}
__device__ __forceinline__ void store4(bf16* to, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(to) = u;
}

// A read-only load through the non-coherent path, before it is widened:
// a float, or a bfloat16's bits in the low half of a 32-bit register
// (one 2-byte load, no instruction after it). widen_loaded() makes the
// float32 value where it is used, so that nothing waits on the load
// before then.
template <typename R>
struct Loaded {
  using type = float;
};
template <>
struct Loaded<bf16> {
  using type = unsigned;
};
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ unsigned load(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ float widen_loaded(float v) { return v; }
__device__ __forceinline__ float widen_loaded(unsigned bits) {
  return __uint_as_float(bits << 16);
}

}  // namespace resid
