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

// The operand of a product with a weight of element type W: v itself
// beside a float weight; beside a bfloat16 one v rounded to bfloat16
// (nearest even) and widened again, as pallas_lstm._cell rounds h_{t-1}
// and _cell_bwd d_pre (``x.astype(w.dtype)``). The product's sum stays
// float32.
template <typename W>
__device__ __forceinline__ float operand(float v) {
  if constexpr (std::is_same<W, float>::value) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}
template <typename W>
__device__ __forceinline__ float4 operand(float4 v) {
  if constexpr (std::is_same<W, float>::value) {
    return v;
  } else {
    return make_float4(operand<W>(v.x), operand<W>(v.y), operand<W>(v.z),
                       operand<W>(v.w));
  }
}

// For kernels that take W_hh of either type a direction (the multi-stream
// lane kernels): `is_bf16` says whether this direction's W_hh is
// bfloat16. A kernel built for float W reads float32 whatever the flag;
// one built for bfloat16 W reads element i of either type, widened.
template <typename W>
__device__ __forceinline__ float weight(const float* w, size_t i,
                                        bool is_bf16) {
  if constexpr (std::is_same<W, float>::value) {
    return w[i];
  } else {
    return is_bf16 ? widen(reinterpret_cast<const W*>(w)[i]) : w[i];
  }
}

// The product's operand in those kernels, made once a direction: v
// rounded as operand<W> rounds it beside a bfloat16 W_hh, v itself beside
// a float32 one. It picks between the two by a bit mask set here, not by
// a select on the flag in every step.
template <typename W>
struct Operand {
  unsigned mask = 0;  // all ones: take the rounded value
  __device__ __forceinline__ explicit Operand(bool is_bf16) {
    if constexpr (!std::is_same<W, float>::value) {
      mask = is_bf16 ? 0xffffffffu : 0u;
    }
  }
  __device__ __forceinline__ float operator()(float v) const {
    if constexpr (std::is_same<W, float>::value) {
      return v;
    } else {
      return __uint_as_float((__float_as_uint(operand<W>(v)) & mask) |
                             (__float_as_uint(v) & ~mask));
    }
  }
  __device__ __forceinline__ float4 operator()(float4 v) const {
    return make_float4((*this)(v.x), (*this)(v.y), (*this)(v.z),
                       (*this)(v.w));
  }
};

}  // namespace resid
