// K8: the VRP tile's compensated dot (K8a) and sum (K8b).
//
// Replaces repro/kernels/vrp_dot.py::vrp_dot_pallas (body _dot_kernel)
// and ::vrp_sum_pallas (body _sum_kernel). Same function: flat f32
// inputs of n elements; element i belongs to lane i mod 1024 of an
// (8, 128) lane tile, and each lane walks its elements in block order
// (i = j * 1024 + lane, j = 0 .. ceil(n / 1024) - 1), keeping a
// Neumaier pair (s, c): two_sum(s, v) -> (s, err), c += err, and for
// the dot v = p of Dekker's two_prod(x, y) -> (p, e) with c += e after
// (Veltkamp splitter 2^12 + 1). The output is the lanes' (8, 128, 2)
// pairs, which kernels/ops.py finalizes with a compensated tree.
//
// The partition and the order are the contract: with every operation
// rounded on its own (__fadd_rn, __fsub_rn, __fmul_rn; nvcc would
// otherwise contract c - (c - a) with c = 4097 * a, or a * b - p, into
// a fused multiply-add and break the error-free transforms) the lanes
// equal the plain version (kernels/ref.py::vrp_dot_lanes) and the Pallas
// kernel bit for bit. The ragged tail reads as zeros inside the kernel:
// two_prod(0, 0) and two_sum(s, 0) leave (s, c) unchanged, so no padded
// copy is made.
//
// What bounds it on the H100: 8 bytes (dot) or 4 (sum) read per
// element, a few dozen flops, so in principle memory: 2^24 x 8 B /
// 3.35 TB/s = 0.040 ms. The lane contract leaves 1024 sequential walks
// of n / 1024 steps each, so only 1024 threads can run. The carried
// chain per step is short (s + v, then two adds on c) and the products
// do not depend on it, so the walk is held by the loads in flight, not
// by the arithmetic: one warp a CTA (32 CTAs, each on its own SM), the
// walk in chunks of U steps with the next chunk's loads issued before
// the current chunk's arithmetic (as K5 does), 2U loads a thread in
// flight. Staging deeper chunks in shared memory (cp.async or TMA) is
// the redesign that would approach the byte bound.

#include "common.cuh"

namespace {

constexpr int LANES = 1024;      // the (8, 128) lane tile
constexpr int THREADS = 32;      // lanes per CTA
constexpr int U = 32;            // blocks per chunk
constexpr float kSplitter = 4097.f;   // 2^12 + 1

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float a1 = __fsub_rn(s, b);
  const float b1 = __fsub_rn(s, a1);
  e = __fadd_rn(__fsub_rn(a, a1), __fsub_rn(b, b1));
}

__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  const float c = __fmul_rn(kSplitter, a);
  hi = __fsub_rn(c, __fsub_rn(c, a));
  lo = __fsub_rn(a, hi);
}

__device__ __forceinline__ void two_prod(float a, float b, float& p,
                                         float& e) {
  p = __fmul_rn(a, b);
  float ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  // ((ah * bh - p) + ah * bl + al * bh) + al * bl, left to right
  e = __fadd_rn(__fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ah, bh), p),
                                    __fmul_rn(ah, bl)),
                          __fmul_rn(al, bh)),
                __fmul_rn(al, bl));
}

template <bool DOT>
__device__ __forceinline__ void load_chunk(const float* __restrict__ x,
                                           const float* __restrict__ y,
                                           long long j0, long long n,
                                           int lane, float* xv, float* yv) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = (j0 + u) * LANES + lane;
    const bool in = i < n;
    xv[u] = in ? x[i] : 0.f;
    if (DOT) yv[u] = in ? y[i] : 0.f;
  }
}

template <bool DOT>
__global__ void __launch_bounds__(THREADS)
    lanes_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ out, long long n) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  const long long nb = (n + LANES - 1) / LANES;
  float s = 0.f, c = 0.f;
  float xv[U], yv[U];
  load_chunk<DOT>(x, y, 0, n, lane, xv, yv);
  for (long long j0 = 0; j0 < nb; j0 += U) {
    float xn[U], yn[U];
    load_chunk<DOT>(x, y, j0 + U, n, lane, xn, yn);   // in flight meanwhile
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j0 + u < nb) {
        float err;
        if (DOT) {
          float p, e;
          two_prod(xv[u], yv[u], p, e);
          two_sum(s, p, s, err);
          c = __fadd_rn(c, err);
          c = __fadd_rn(c, e);   // product error is already second-order
        } else {
          two_sum(s, xv[u], s, err);
          c = __fadd_rn(c, err);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      xv[u] = xn[u];
      if (DOT) yv[u] = yn[u];
    }
  }
  out[2 * lane] = s;
  out[2 * lane + 1] = c;
}

}  // namespace

// C entry point (loaded with ctypes by repro_torch/kernels/vrp_dot.py).
// x (and y when dot != 0) contiguous f32 of n elements; out a contiguous
// (8, 128, 2) f32 tensor of lane pairs (s, c). Returns the launch's
// cudaGetLastError() code.
extern "C" int repro_vrp_lanes(const void* x, const void* y, void* out,
                               long long n, int dot, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* o = static_cast<float*>(out);
  if (dot)
    lanes_kernel<true><<<LANES / THREADS, THREADS, 0, s>>>(xf, yf, o, n);
  else
    lanes_kernel<false><<<LANES / THREADS, THREADS, 0, s>>>(xf, yf, o, n);
  return static_cast<int>(cudaGetLastError());
}
