// K5: the diagonal linear recurrence of the RG-LRU (recurrentgemma).
//
// Replaces repro/kernels/rglru_scan.py::rglru_scan_pallas (body
// _scan_kernel). Same function: a, x (B, T, D), an optional h0 (B, D),
// h_t = a_t * h_{t-1} + x_t with the carry h in f32 and h_t stored in
// x's type at every step. The product and the sum are rounded one at a
// time (__fmul_rn, __fadd_rn: no fused multiply-add), the Pallas body's
// order and the plain version's, so in f32 the kernel's output equals
// kernels/ref.py::linear_scan bit for bit.
//
// What bounds it on the H100: each element is read twice (a, x) and
// written once for 2 flops, so in principle memory: 3 * B * T * D * 4 B
// / 3.35 TB/s, 0.0376 ms at serving's (8, 512, 2560) in f32. This first
// version is held by latency instead. The recurrence is sequential in
// T, so the only parallelism is over (b, d): 20,480 channels at that
// shape, a tenth of the card's 270,336 resident threads, each walking
// 512 dependent steps. What the design does about it:
//   * one thread per (b, d) channel, consecutive d on consecutive lanes,
//     so every time step of a warp is one coalesced 128-byte (f32) load
//     of a, one of x and one store of h;
//   * the T loop runs in chunks of U steps, and the loads of the next
//     chunk are issued before the current chunk's multiply-adds and
//     stores, so 2U loads a thread are in flight behind the dependent
//     chain;
//   * ragged T (the last chunk) and ragged D (the last CTA) are masked
//     here, so the wrapper pads nothing.
// A chunked two-pass scan (per-chunk decay products, then a carry
// fix-up), which parallelises over T as well, is the redesign that
// would reach the byte bound.

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int THREADS = 64;      // channels per CTA
constexpr int U = 16;            // time steps per chunk

template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ a,
                                           const T* __restrict__ x,
                                           int t0, int Tn, long long D,
                                           float* av, float* xv) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool in = t0 + u < Tn;
    av[u] = in ? to_f32(a[(t0 + u) * D]) : 0.f;
    xv[u] = in ? to_f32(x[(t0 + u) * D]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                const float* __restrict__ h0, T* __restrict__ o, int Tn,
                int D) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  if (d >= D) return;
  const long long b = blockIdx.y;
  const long long base = b * Tn * D + d;
  a += base;
  x += base;
  o += base;
  float h = h0 != nullptr ? h0[b * D + d] : 0.f;
  float av[U], xv[U];
  load_chunk(a, x, 0, Tn, D, av, xv);
  for (int t0 = 0; t0 < Tn; t0 += U) {
    float an[U], xn[U];
    load_chunk(a, x, t0 + U, Tn, D, an, xn);   // in flight meanwhile
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < Tn) {
        h = __fadd_rn(__fmul_rn(av[u], h), xv[u]);
        o[static_cast<long long>(t0 + u) * D] = from_f32<T>(h);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      av[u] = an[u];
      xv[u] = xn[u];
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* x, const void* h0, void* o,
                   int B, int Tn, int D, cudaStream_t stream) {
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  scan_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x),
      static_cast<const float*>(h0), static_cast<T*>(o), Tn, D);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes by repro_torch/kernels/
// rglru_scan.py). a, x and o contiguous (B, T, D) of one type (dtype:
// kF32 or kBF16); h0 a contiguous (B, D) f32 carry or null (zeros).
// Returns the launch's cudaGetLastError() code.
extern "C" int repro_rglru_scan(const void* a, const void* x, const void* h0,
                                void* o, int dtype, int B, int Tn, int D,
                                void* stream) {
  if (B < 1 || B > 65535 || Tn < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == repro::kBF16
                        ? launch<__nv_bfloat16>(a, x, h0, o, B, Tn, D, s)
                        : launch<float>(a, x, h0, o, B, Tn, D, s);
  return static_cast<int>(err);
}
