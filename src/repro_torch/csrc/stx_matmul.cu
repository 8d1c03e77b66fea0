// K6: the STX tile's matmul, (M, K) @ (K, N) with an f32 accumulator.
//
// Replaces repro/kernels/stx_matmul.py::stx_matmul_pallas (body
// _mm_kernel). Same function: x (M, K) and w (K, N) of one type (f32 or
// bf16), every product summed in f32, the result cast once to out's
// type (f32 or bf16). The Pallas kernel walks an (i, j, k) grid of
// 128-blocks with the f32 accumulator in VMEM scratch and needs operands
// padded to block multiples (repro/kernels/ops.py pads them); here the
// k walk is a loop inside the CTA, the accumulator lives in registers,
// and ragged M, N and K are masked in the loads and the store, so
// nothing is padded.
//
// What bounds it on the H100: operations. (4096, 2048) @ (2048, 8192)
// is 137 GFLOP against 84 MB of operands and output in bf16: 0.139 ms
// at the tensor cores' 989 TFLOP/s. This first version runs on the CUDA
// cores instead (67 TFLOP/s f32 peak): a 128 x 128 output tile a CTA,
// 256 threads with 8 x 8 outputs each (two 4-row and two 4-column
// strips, so the 16-byte shared-memory reads of a warp hit distinct
// banks), k in steps of 16 staged through shared memory as f32 (bf16 is
// widened as it is staged). Tensor cores (wgmma with TMA-fed bf16
// tiles) are the redesign that would approach the bound.

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int BM = 128, BN = 128, BK = 16;
constexpr int THREADS = 256;     // 16 x 16, 8 x 8 outputs each
constexpr int PAD = 4;           // keeps rows 16-byte aligned

template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS)
    mm_kernel(const TI* __restrict__ x, const TI* __restrict__ w,
              TO* __restrict__ o, int M, int N, int K) {
  __shared__ __align__(16) float xs[BK][BM + PAD];   // x tile, k-major
  __shared__ __align__(16) float ws[BK][BN + PAD];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile (BM x BK): 16 consecutive threads along a row's k
#pragma unroll
    for (int e = 0; e < BM * BK / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int r = idx / BK, kk = idx % BK;
      const int gm = m0 + r, gk = k0 + kk;
      xs[kk][r] = gm < M && gk < K
                      ? to_f32(x[static_cast<long long>(gm) * K + gk])
                      : 0.f;
    }
    // w tile (BK x BN): 128 consecutive threads along a row's n
#pragma unroll
    for (int e = 0; e < BK * BN / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int kk = idx / BN, c = idx % BN;
      const int gk = k0 + kk, gn = n0 + c;
      ws[kk][c] = gk < K && gn < N
                      ? to_f32(w[static_cast<long long>(gk) * N + gn])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[kk][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (gn < N)
        o[static_cast<long long>(gm) * N + gn] = from_f32<TO>(acc[i][j]);
    }
  }
}

template <typename TI, typename TO>
cudaError_t launch(const void* x, const void* w, void* o, int M, int N,
                   int K, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm_kernel<TI, TO><<<grid, THREADS, 0, stream>>>(
      static_cast<const TI*>(x), static_cast<const TI*>(w),
      static_cast<TO*>(o), M, N, K);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t launch_in(const void* x, const void* w, void* o, int out_dtype,
                      int M, int N, int K, cudaStream_t stream) {
  return out_dtype == repro::kBF16
             ? launch<TI, __nv_bfloat16>(x, w, o, M, N, K, stream)
             : launch<TI, float>(x, w, o, M, N, K, stream);
}

}  // namespace

// C entry point (loaded with ctypes by repro_torch/kernels/
// stx_matmul.py). x (M, K) and w (K, N) contiguous of one type (dtype:
// kF32 or kBF16), o (M, N) contiguous of out_dtype (kF32 or kBF16).
// Returns the launch's cudaGetLastError() code.
extern "C" int repro_stx_matmul(const void* x, const void* w, void* o,
                                int dtype, int out_dtype, int M, int N,
                                int K, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (M + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == repro::kBF16
          ? launch_in<__nv_bfloat16>(x, w, o, out_dtype, M, N, K, s)
          : launch_in<float>(x, w, o, out_dtype, M, N, K, s);
  return static_cast<int>(err);
}
