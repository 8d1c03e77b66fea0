// K7: the STX/SPU weighted stencils, 3x3 on (M, N) (K7a) and 3x3x3 on
// (D, M, N) (K7b), zero boundary.
//
// Replaces repro/kernels/stx_stencil.py::stencil2d_pallas (body
// _st2d_kernel) and ::stencil3d_pallas (body _st3d_kernel). Same
// function: out[i, j] = sum over (di, dj) of w[di, dj] * x[i + di - 1,
// j + dj - 1] (and over dd first in 3-D), neighbours outside the grid
// reading zero. Every term is computed, zero weights included, as the
// Pallas body does, accumulated from 0 in its order (dd, then di, then
// dj) with the product and the sum rounded on their own (__fmul_rn,
// __fadd_rn: no fused multiply-add), so in f32 the output equals the
// plain version (kernels/ref.py::stencil2d / stencil3d) bit for bit.
// bf16 input accumulates in f32 and is rounded to bf16 once.
//
// What bounds it on the H100: one read and one write of the grid, 2
// flops a term, so memory: 2 x 8192^2 x 4 B / 3.35 TB/s = 0.160 ms for
// the 2-D case, 2 x 512^3 x 4 B / 3.35 TB/s = 0.320 ms for the 3-D one.
// What the design does about it:
//   * no padded copy (the Pallas wrapper pads with jnp.pad): a CTA
//     stages its output tile plus a one-cell halo in shared memory with
//     a bounds check, out of range reading zero, consecutive threads on
//     consecutive columns;
//   * 2-D: a 16 x 64 output tile, 4 rows a thread;
//   * 3-D: an 8 x 64 column of the (M, N) plane marching down a chunk
//     of 32 planes with a ring of three staged planes, so each input
//     plane is staged once per chunk instead of three times;
//   * the 9 or 27 weights (the Pallas kernel's SMEM table) are read once
//     a CTA into shared memory from a device pointer: no host sync.
// The halo and the chunk edges re-read 16-37% of the input, mostly from
// L2.

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int TN = 64;            // output columns of a tile
constexpr int TY = 4;             // thread rows
constexpr int THREADS = TN * TY;
constexpr int TM2 = 16;           // 2-D tile rows
constexpr int TM3 = 8;            // 3-D tile rows
constexpr int DC = 32;            // 3-D planes per chunk

// Stage rows i0-1 .. i0+TM and columns j0-1 .. j0+TN of one (M, N)
// plane as f32; out of range (or an absent plane) reads zero.
template <typename T, int TM>
__device__ __forceinline__ void stage(float (*s)[TN + 2],
                                      const T* __restrict__ plane,
                                      bool present, int i0, int j0, int M,
                                      int N) {
  for (int idx = threadIdx.x; idx < (TM + 2) * (TN + 2); idx += THREADS) {
    const int r = idx / (TN + 2), c = idx % (TN + 2);
    const int gi = i0 - 1 + r, gj = j0 - 1 + c;
    s[r][c] = present && gi >= 0 && gi < M && gj >= 0 && gj < N
                  ? to_f32(plane[static_cast<long long>(gi) * N + gj])
                  : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    stencil2d_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     T* __restrict__ o, int M, int N) {
  __shared__ float s[TM2 + 2][TN + 2];
  __shared__ float sw[9];
  if (threadIdx.x < 9) sw[threadIdx.x] = w[threadIdx.x];
  const long long plane = static_cast<long long>(blockIdx.z) * M * N;
  const int i0 = blockIdx.y * TM2, j0 = blockIdx.x * TN;
  stage<T, TM2>(s, x + plane, true, i0, j0, M, N);
  __syncthreads();
  const int tx = threadIdx.x % TN, ty = threadIdx.x / TN;
  const int gj = j0 + tx;
#pragma unroll
  for (int r = ty; r < TM2; r += TY) {
    float acc = 0.f;
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
        acc = __fadd_rn(acc, __fmul_rn(sw[3 * di + dj], s[r + di][tx + dj]));
    const int gi = i0 + r;
    if (gi < M && gj < N)
      o[plane + static_cast<long long>(gi) * N + gj] = from_f32<T>(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    stencil3d_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     T* __restrict__ o, int D, int M, int N, int chunks) {
  __shared__ float s[3][TM3 + 2][TN + 2];
  __shared__ float sw[27];
  if (threadIdx.x < 27) sw[threadIdx.x] = w[threadIdx.x];
  const long long psize = static_cast<long long>(M) * N;
  const long long vol = static_cast<long long>(blockIdx.z / chunks) * D * psize;
  const int d0 = (blockIdx.z % chunks) * DC;
  const int d1 = min(D, d0 + DC);
  const int i0 = blockIdx.y * TM3, j0 = blockIdx.x * TN;
  const T* xv = x + vol;
  // ring slot (d - d0 + 1) % 3 holds plane d
  stage<T, TM3>(s[0], d0 >= 1 ? xv + (d0 - 1) * psize : xv, d0 >= 1, i0,
                j0, M, N);
  stage<T, TM3>(s[1], xv + d0 * psize, true, i0, j0, M, N);
  const int tx = threadIdx.x % TN, ty = threadIdx.x / TN;
  const int gj = j0 + tx;
  for (int d = d0; d < d1; ++d) {
    const int k = d - d0;
    stage<T, TM3>(s[(k + 2) % 3], xv + (d + 1) * psize, d + 1 < D, i0, j0,
                  M, N);
    __syncthreads();
#pragma unroll
    for (int r = ty; r < TM3; r += TY) {
      float acc = 0.f;
#pragma unroll
      for (int dd = 0; dd < 3; ++dd) {
        const float(*p)[TN + 2] = s[(k + dd) % 3];
#pragma unroll
        for (int di = 0; di < 3; ++di)
#pragma unroll
          for (int dj = 0; dj < 3; ++dj)
            acc = __fadd_rn(acc, __fmul_rn(sw[9 * dd + 3 * di + dj],
                                           p[r + di][tx + dj]));
      }
      const int gi = i0 + r;
      if (gi < M && gj < N)
        o[vol + d * psize + static_cast<long long>(gi) * N + gj] =
            from_f32<T>(acc);
    }
    __syncthreads();   // the next stage overwrites plane d - 1's slot
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* o, bool three_d,
                   int B, int D, int M, int N, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  T* ot = static_cast<T*>(o);
  if (three_d) {
    const int chunks = (D + DC - 1) / DC;
    const dim3 grid((N + TN - 1) / TN, (M + TM3 - 1) / TM3, B * chunks);
    stencil3d_kernel<T><<<grid, THREADS, 0, stream>>>(xt, wt, ot, D, M, N,
                                                      chunks);
  } else {
    const dim3 grid((N + TN - 1) / TN, (M + TM2 - 1) / TM2, B);
    stencil2d_kernel<T><<<grid, THREADS, 0, stream>>>(xt, wt, ot, M, N);
  }
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes by repro_torch/kernels/
// stx_stencil.py). x and o contiguous (B, M, N) (three_d == 0) or
// (B, D, M, N) of one type (dtype: kF32 or kBF16); w 9 or 27 contiguous
// f32 weights on the device. Returns the launch's cudaGetLastError()
// code.
extern "C" int repro_stencil(const void* x, const void* w, void* o,
                             int dtype, int three_d, int B, int D, int M,
                             int N, void* stream) {
  const long long z = three_d ? static_cast<long long>(B) * ((D + DC - 1) / DC)
                              : B;
  if (B < 1 || D < 1 || M < 1 || N < 1 || z > 65535 ||
      (M + TM3 - 1) / TM3 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == repro::kBF16
          ? launch<__nv_bfloat16>(x, w, o, three_d != 0, B, D, M, N, s)
          : launch<float>(x, w, o, three_d != 0, B, D, M, N, s);
  return static_cast<int>(err);
}
