// Element types of the kernels' bf16 variants (GemNet-OC and PaiNN with
// compute_dtype: bfloat16). A bf16 input is widened to f32 where it is
// loaded, every product and sum is f32, and a value is rounded to bf16
// (round to nearest even, __float2bfloat16_rn) only where the TPU kernel it
// replaces rounds it. For float every helper is the identity.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

namespace dtype {

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// *p through the read-only cache, widened to f32
template <typename T>
__device__ __forceinline__ float ldg(const T* p) {
  return f32(__ldg(p));
}

// x rounded to T and widened back
template <typename T>
__device__ __forceinline__ float rounded(float x) {
  if constexpr (kF32<T>) {
    return x;
  } else {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
}

// x stored as T
template <typename T>
__device__ __forceinline__ T narrow(float x) {
  if constexpr (kF32<T>) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

}  // namespace dtype
