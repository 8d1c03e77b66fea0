// Shared helpers for the hand-written Hopper kernels of repro_torch.
//
// Every kernel computes in f32 and is templated over its storage type,
// float or __nv_bfloat16; conversions go through the CUDA intrinsics.
#pragma once

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// The finite "minus infinity" the Pallas kernels seed their running
// max with (kernels/flash_attention.py MASK_VALUE = -0.7 * f32 max).
constexpr float kMaskValue = -0.7f * FLT_MAX;

// Storage-type codes passed from Python (kernels/_build.py callers).
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace repro
