// K6: the STX tile's matmul, (M, K) @ (K, N) with an f32 accumulator.
//
// Replaces repro/kernels/stx_matmul.py::stx_matmul_pallas (body
// _mm_kernel). Same function: x (M, K) and w (K, N) of one type (f32 or
// bf16), every product summed in f32, the result cast once to out's
// type (f32 or bf16). The Pallas kernel walks an (i, j, k) grid of
// 128-blocks with the f32 accumulator in VMEM scratch and needs operands
// padded to block multiples (repro/kernels/ops.py pads them); here the
// k walk is a loop inside the CTA, the accumulator lives in registers,
// and ragged M, N and K are handled in the kernel, so nothing is padded.
//
// What bounds it on the H100: operations. (4096, 2048) @ (2048, 8192)
// is 137 GFLOP against 117 MB of operands and output in bf16: 0.139 ms
// at the tensor cores' 989 TFLOP/s, against 0.035 ms for the bytes.
// Two bodies, chosen by the wrapper from the shape before the launch:
//   * wgmma (bf16 operands whose rows TMA can describe: K and N multiples
//     of 8, both bases 16-byte aligned). A CTA writes a 128 x 256 tile:
//     one producer warp keeps TMA loads of x (128 x 64) and w (64 x 256,
//     four 64-wide boxes) bf16 tiles in flight in a ring of 4 stages of
//     48 KB, 128-byte swizzled, with full / empty mbarriers; two consumer
//     warpgroups of 64 rows each run wgmma m64n256k16 from shared memory
//     into 128 f32 registers a thread (x K-major, w MN-major through the
//     transpose bit). 256 columns a CTA read each x tile half as often as
//     128 would, and ran faster on the card; a second wgmma group kept in
//     flight across k tiles did not.
//     TMA's zero fill covers a ragged K (and the M, N edges); the
//     epilogue casts once and stores under a mask.
//   * simt (f32 operands, and bf16 ones TMA cannot describe): the CUDA
//     cores in f32, 67 TFLOP/s at most. A 128 x 128 output tile a CTA,
//     256 threads with 8 x 8 outputs each (two 4-row and two 4-column
//     strips, so the 16-byte shared-memory reads of a warp hit distinct
//     banks), k in steps of 16 staged through shared memory as f32 (bf16
//     is widened as it is staged). f32 stays here: TF32 would break the
//     1e-5 / 1e-4 tolerance the Pallas kernel is held to.
// Left for later: a persistent grid that overlaps one tile's epilogue
// with the next one's loads (one 128 x 256 tile a CTA keeps 1 CTA an SM
// and leaves the tensor cores idle in every epilogue), setmaxnreg with a
// third consumer warpgroup, clusters that multicast a shared x or w
// tile, fp8 operands.

#include "common.cuh"
#include "hopper.cuh"

#include <type_traits>

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

// ---------------------------------------------------------------------------
// wgmma body (bf16 operands)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int CONSUMERS = 256;                 // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 32;        // + one producer warp
constexpr int X_BYTES = BM * BK * 2;           // 16 KB: 128 rows of 128 B
constexpr int W_BOX = BK * 64 * 2;             // 8 KB: one 64-wide column box
constexpr int W_BOXES = BN / 64;
constexpr int STAGE_BYTES = X_BYTES + W_BOXES * W_BOX;
constexpr size_t SMEM = STAGES * STAGE_BYTES + 1024;   // + alignment slack

template <typename TO>
__global__ void __launch_bounds__(THREADS, 1)
    mm_wgmma(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap wmap, TO* __restrict__ o,
             int M, int N, int K) {
  namespace hw = repro::hopper;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  uint8_t* smem = smem_raw + ((1024 - (hw::smem_u32(smem_raw) & 1023)) & 1023);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], CONSUMERS);
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) hw::mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        uint8_t* st = smem + s * STAGE_BYTES;
        hw::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        hw::tma_load_2d(st, &xmap, &full[s], t * BK, m0);
#pragma unroll
        for (int c = 0; c < W_BOXES; ++c)
          hw::tma_load_2d(st + X_BYTES + c * W_BOX, &wmap, &full[s],
                          n0 + 64 * c, t * BK);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < nk; ++t) {
    const int s = t % STAGES;
    hw::mbar_wait(&full[s], (t / STAGES) & 1);
    const uint8_t* st = smem + s * STAGE_BYTES;
    hw::fence_regs(acc);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t a = hw::sw128_desc(st + wg * 64 * 128 + kk * 32, 16, 1024);
      const uint64_t b =
          hw::sw128_desc(st + X_BYTES + kk * 16 * 128, W_BOX, 1024);
      hw::Wgmma<BN>::ss<1>(acc, a, b, 1);
    }
    hw::wgmma_commit();
    hw::wgmma_wait();
    hw::fence_regs(acc);
    hw::mbar_arrive(&empty[s]);
  }

  const int r0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gm = r0 + 8 * i;
    if (gm >= M) continue;
    TO* row = o + static_cast<long long>(gm) * N;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const int gn = n0 + 8 * n + 2 * (lane % 4);   // N % 8 == 0: both or none
      if (gn >= N) continue;
      const float v0 = acc[4 * n + 2 * i], v1 = acc[4 * n + 2 * i + 1];
      if constexpr (std::is_same<TO, float>::value) {
        *reinterpret_cast<float2*>(row + gn) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(row + gn) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <typename TO>
cudaError_t launch(const void* x, const void* w, void* o, int M, int N, int K,
                   cudaStream_t stream) {
  namespace hw = repro::hopper;
  CUtensorMap xmap, wmap;
  const uint64_t xdims[2] = {static_cast<uint64_t>(K),
                             static_cast<uint64_t>(M)};
  const uint64_t xstride[1] = {static_cast<uint64_t>(K) * 2};
  const uint32_t xbox[2] = {64, BM};
  const uint64_t wdims[2] = {static_cast<uint64_t>(N),
                             static_cast<uint64_t>(K)};
  const uint64_t wstride[1] = {static_cast<uint64_t>(N) * 2};
  const uint32_t wbox[2] = {64, BK};
  if (!hw::make_bf16_map(&xmap, x, 2, xdims, xstride, xbox) ||
      !hw::make_bf16_map(&wmap, w, 2, wdims, wstride, wbox))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mm_wgmma<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm_wgmma<TO><<<grid, THREADS, SMEM, stream>>>(xmap, wmap,
                                                 static_cast<TO*>(o), M, N, K);
  return cudaGetLastError();
}

}  // namespace tc

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
// body: 0 runs the SIMT body, 1 the wgmma body (bf16 operands with K and
// N multiples of 8 and 16-byte aligned bases; anything else is refused
// with cudaErrorInvalidValue, never rerouted). Returns the launch's
// cudaGetLastError() code.
extern "C" int repro_stx_matmul(const void* x, const void* w, void* o,
                                int dtype, int out_dtype, int M, int N,
                                int K, int body, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (M + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype != repro::kBF16 || K % 8 != 0 || N % 8 != 0 ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(w) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        out_dtype == repro::kBF16
            ? tc::launch<__nv_bfloat16>(x, w, o, M, N, K, s)
            : tc::launch<float>(x, w, o, M, N, K, s));
  }
  if (body != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      dtype == repro::kBF16
          ? launch_in<__nv_bfloat16>(x, w, o, out_dtype, M, N, K, s)
          : launch_in<float>(x, w, o, out_dtype, M, N, K, s);
  return static_cast<int>(err);
}
