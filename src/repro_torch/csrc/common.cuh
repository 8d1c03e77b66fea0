// Shared helpers for the hand-written Hopper kernels of repro_torch.
//
// Every kernel computes in f32. Queries and outputs are float or
// __nv_bfloat16; a paged pool's payload is the same type, or (K4) an
// int8_t / __nv_fp8_e4m3 payload beside f32 per-(token, head) scales.
// Conversions go through the CUDA intrinsics.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace repro {

// The finite "minus infinity" the Pallas kernels seed their running
// max with (kernels/flash_attention.py MASK_VALUE = -0.7 * f32 max).
constexpr float kMaskValue = -0.7f * FLT_MAX;

// Storage-type codes passed from Python (kernels/_build.py callers):
// query/output types, and the two quantized payload types of K4.
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// True for the payload types that carry scales (K4).
template <typename P>
struct IsQuant {
  static constexpr bool value = false;
};
template <>
struct IsQuant<int8_t> {
  static constexpr bool value = true;
};
template <>
struct IsQuant<__nv_fp8_e4m3> {
  static constexpr bool value = true;
};

// One 32-bit word of payload P unpacked to f32: Word<P>::N elements,
// the lowest-addressed first.
template <typename P>
struct Word;
template <>
struct Word<float> {
  static constexpr int N = 1;
  __device__ static void unpack(unsigned w, float* out) {
    out[0] = __uint_as_float(w);
  }
};
template <>
struct Word<__nv_bfloat16> {
  static constexpr int N = 2;
  __device__ static void unpack(unsigned w, float* out) {
    // a bf16 is the high half of an f32
    out[0] = __uint_as_float(w << 16);
    out[1] = __uint_as_float(w & 0xffff0000u);
  }
};
template <>
struct Word<int8_t> {
  static constexpr int N = 4;
  __device__ static void unpack(unsigned w, float* out) {
#pragma unroll
    for (int i = 0; i < 4; ++i)   // sign-extend byte i
      out[i] = static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
  }
};
template <>
struct Word<__nv_fp8_e4m3> {
  static constexpr int N = 4;
  __device__ static void unpack(unsigned w, float* out) {
    // e4m3x2 -> f16x2 (one cvt on sm_89+; every e4m3 value is exact in
    // f16), then f16 -> f32
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>((w >> (16 * i)) & 0xffffu),
          __NV_E4M3);
      __half_raw lo, hi;
      lo.x = h.x;
      hi.x = h.y;
      out[2 * i] = __half2float(__half(lo));
      out[2 * i + 1] = __half2float(__half(hi));
    }
  }
};

// Elements of P in one 16-byte load.
template <typename P>
constexpr int kVec = 16 / static_cast<int>(sizeof(P));

// One 16-byte load of P unpacked to kVec<P> f32 values.
template <typename P>
__device__ __forceinline__ void unpack16(const uint4& u, float* out) {
  constexpr int N = Word<P>::N;
  Word<P>::unpack(u.x, out);
  Word<P>::unpack(u.y, out + N);
  Word<P>::unpack(u.z, out + 2 * N);
  Word<P>::unpack(u.w, out + 3 * N);
}

// Asynchronous copies from device memory to shared memory (sm_80+),
// used by K2's ring of key/value tiles. ``n`` of the copy's bytes are
// read and the rest zero-filled, so n = 0 reads nothing and stores
// zeros (a masked token never touches the pool).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The kv-head range [kv_lo, kv_lo + Hkv) of a paged pool of Hkp kv heads
// (K2 / K3 / K4 on the kv heads a tensor-parallel rank's query heads
// read, in a pool every rank holds whole): moves the payload pointers
// kv_lo heads of D elements of payload type ``pdtype`` on, and the
// scales (quantized payloads) kv_lo on, so that a kernel walks Hkv heads
// at the pool's row stride of Hkp heads. No byte of the pool is copied.
// False for a range outside the pool.
inline bool kv_range(const void*& k_pool, const void*& v_pool,
                     const void*& k_scale, const void*& v_scale, int pdtype,
                     int D, int kv_lo, int Hkv, int Hkp) {
  if (kv_lo < 0 || Hkv < 1 || kv_lo + Hkv > Hkp) return false;
  const long long bytes = static_cast<long long>(kv_lo) * D *
                          (pdtype == kF32 ? 4 : pdtype == kBF16 ? 2 : 1);
  k_pool = static_cast<const char*>(k_pool) + bytes;
  v_pool = static_cast<const char*>(v_pool) + bytes;
  if (k_scale != nullptr) k_scale = static_cast<const float*>(k_scale) + kv_lo;
  if (v_scale != nullptr) v_scale = static_cast<const float*>(v_scale) + kv_lo;
  return true;
}

}  // namespace repro
