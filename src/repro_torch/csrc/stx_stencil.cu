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
// What bounds it on the H100: one read and one write of the grid, so
// memory: 2 x 8192^2 x 4 B / 3.35 TB/s = 0.160 ms for the 2-D case,
// 2 x 512^3 x 4 B / 3.35 TB/s = 0.320 ms for the 3-D one. The bit-exact
// order sets a second floor: 27 rounded products and 27 rounded sums a
// point, 512^3 x 54 / (132 SMs x 128 lanes x 1.98 GHz) = 0.22 ms of
// issue, under the byte bound only if loads overlap the arithmetic.
//
// K7a, and K7b's "simt" body (bf16, N not a multiple of 4, a base no
// tensor map takes): a CTA stages its output tile plus a one-cell halo
// in shared memory with a bounds check (out of range reads zero), then
// computes; 2-D a 16 x 64 tile, 4 rows a thread; 3-D an 8 x 64 column
// marching down a chunk of 32 planes through a ring of three staged
// planes. Staging is synchronous and every term is its own shared load:
// 512^3 x 27 words of shared-memory traffic alone take ~0.43 ms.
//
// K7b's "ring" body (f32, N a multiple of 4, x 16-byte aligned): a CTA
// owns a 32 x 64 output tile of a chunk of 64 planes (halo re-read 1.1x,
// chunk edges 3%; 1024 CTAs at 512^3). A 4-D tensor map over (N, M, D, B)
// loads one plane's 34 x 72 window at (j0 - 4, i0 - 1, d, b) (a box's
// inner start must sit on 16 bytes: a start at j0 - 1 faults with an
// illegal instruction, so the window starts three columns early and
// spans 72 for the 66 it needs): TMA writes the elements outside the volume
// as zeros, so the boundary costs no branch, and planes -1 and D read
// zero without touching the next volume. A producer thread keeps up to
// five planes in a ring of 128-byte aligned slots on full / empty
// mbarriers. Each of 128 consumer threads owns 4 x 4 outputs and reads
// each input plane once, as a 6 x 6 window (a 16-byte and two 4-byte
// shared loads a row): plane p adds its dd = 0 terms to output plane
// p + 1, dd = 1 to plane p and dd = 2 to plane p - 1, three rolling sets
// of accumulators. Each output still receives its 27 terms in (dd, di,
// dj) order, since planes arrive in increasing order and window rows in
// increasing di. That is 2.25 shared words a point instead of 27.

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hw = repro::hopper;
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


// ---------------------------------------------------------------------------
// K7b body "ring"
// ---------------------------------------------------------------------------

constexpr int RM = 32, RN = 64;            // output tile
constexpr int RB = 4, CB = 4;              // a thread's outputs: rows x cols
                                           // (CB: one 16-byte access)
constexpr int WM = RM + 2;                 // window rows of a slot
constexpr int WN = RN + 8;                 // window columns j0 - 4 .. j0 + 67
constexpr int RDC = 64;                    // planes a chunk
constexpr int SLOTS = 5;
constexpr int CONSUMERS = (RM / RB) * (RN / CB);   // 128
constexpr int RING_THREADS = CONSUMERS + 32;       // + the producer warp
constexpr int BOX_BYTES = WM * WN * 4;
constexpr int SLOT_BYTES = (BOX_BYTES + 127) / 128 * 128;
constexpr int RING_SMEM = 128 + SLOTS * SLOT_BYTES + 2 * SLOTS * 8;

using Acc = float[RB][CB];

// Input plane p's terms through a thread's 6 x 6 window (s + 3: its
// top-left corner in the slot; s + 4 16-byte aligned): dd 0 into n
// (output plane p + 1), dd 1 into c (plane p), dd 2 into v (plane
// p - 1). Window row rr feeds output row r = rr - di, so each output
// takes its terms in (di, dj) order.
__device__ __forceinline__ void add_plane(const float* s, const float (&w)[27],
                                          Acc& n, Acc& c, Acc& v) {
#pragma unroll
  for (int rr = 0; rr < RB + 2; ++rr) {
    const float* row = s + rr * WN;
    const float4 mid = *reinterpret_cast<const float4*>(row + 4);
    const float win[CB + 2] = {row[3], mid.x, mid.y, mid.z, mid.w, row[8]};
#pragma unroll
    for (int di = 0; di < 3; ++di) {
      const int r = rr - di;
      if (r < 0 || r >= RB) continue;
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
#pragma unroll
        for (int k = 0; k < CB; ++k) {
          const float xv = win[k + dj];
          n[r][k] = __fadd_rn(n[r][k], __fmul_rn(w[3 * di + dj], xv));
          c[r][k] = __fadd_rn(c[r][k], __fmul_rn(w[9 + 3 * di + dj], xv));
          v[r][k] = __fadd_rn(v[r][k], __fmul_rn(w[18 + 3 * di + dj], xv));
        }
    }
  }
}

struct Plane3 {
  const float* slots;     // slot 0 plus this thread's window offset
  uint64_t* full;
  uint64_t* empty;
  float* out;             // output plane d0 at this thread's corner
  long long psize;        // M * N
  int rows, lane;         // output rows of this thread inside M; lane
  bool cols;              // this thread's CB columns inside N
};

// Input plane q of the chunk (plane d0 - 1 + q): add its terms, free its
// slot, and store output plane d0 + q - 2 (complete now) from v.
__device__ __forceinline__ void plane_step(const Plane3& g, int q, int N,
                                           const float (&w)[27], Acc& n,
                                           Acc& c, Acc& v) {
  const int k = q % SLOTS;
  hw::bar_wait(g.full + k, (q / SLOTS) & 1);
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < CB; ++j) n[r][j] = 0.f;
  add_plane(g.slots + k * (SLOT_BYTES / 4), w, n, c, v);
  __syncwarp();
  if (g.lane == 0) hw::mbar_arrive(g.empty + k);
  if (q >= 2 && g.cols) {
    float* o = g.out + (q - 2) * g.psize;
#pragma unroll
    for (int r = 0; r < RB; ++r)
      if (r < g.rows)
        *reinterpret_cast<float4*>(o + static_cast<long long>(r) * N) =
            make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
  }
}

__global__ void __launch_bounds__(RING_THREADS, 3)
    stencil3d_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const float* __restrict__ wg, float* __restrict__ o,
                         int D, int M, int N, int chunks) {
  extern __shared__ unsigned char smem_raw[];
  // aligned by pointer arithmetic: a round trip through an integer would
  // lose the shared address space and make every access a generic one
  unsigned char* smem =
      smem_raw + ((128 - (hw::smem_u32(smem_raw) & 127)) & 127);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SLOTS * SLOT_BYTES);
  uint64_t* empty = full + SLOTS;
  const int b = blockIdx.z / chunks;
  const int d0 = (blockIdx.z % chunks) * RDC, d1 = min(D, d0 + RDC);
  const int i0 = blockIdx.y * RM, j0 = blockIdx.x * RN;
  const int planes = d1 - d0 + 2;            // input planes d0 - 1 .. d1

  if (threadIdx.x == 0) {
    for (int k = 0; k < SLOTS; ++k) {
      hw::mbar_init(full + k, 1);
      hw::mbar_init(empty + k, CONSUMERS / 32);
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS) {
      for (int q = 0; q < planes; ++q) {
        const int k = q % SLOTS;
        if (q >= SLOTS) hw::bar_wait(empty + k, ((q / SLOTS) - 1) & 1);
        hw::mbar_arrive_expect_tx(full + k, BOX_BYTES);
        hw::tma_load_4d(smem + k * SLOT_BYTES, &xmap, full + k, j0 - 4,
                        i0 - 1, d0 - 1 + q, b);
      }
    }
    return;
  }

  float w[27];
#pragma unroll
  for (int i = 0; i < 27; ++i) w[i] = wg[i];
  const int tx = threadIdx.x % (RN / CB), ty = threadIdx.x / (RN / CB);
  const int gi = i0 + RB * ty, gj = j0 + CB * tx;
  Plane3 g;
  g.slots = reinterpret_cast<const float*>(smem) + RB * ty * WN + CB * tx;
  g.full = full;
  g.empty = empty;
  g.psize = static_cast<long long>(M) * N;
  g.out = o + (static_cast<long long>(b) * D + d0) * g.psize +
          static_cast<long long>(gi) * N + gj;
  g.rows = M - gi;
  g.lane = threadIdx.x % 32;
  g.cols = gj < N;
  Acc s0, s1, s2;
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < CB; ++j) s1[r][j] = s2[r][j] = 0.f;
  // the roles (next, current, previous) rotate by one plane a step
  for (int q = 0; q < planes; q += 3) {
    plane_step(g, q, N, w, s0, s1, s2);
    if (q + 1 < planes) plane_step(g, q + 1, N, w, s2, s0, s1);
    if (q + 2 < planes) plane_step(g, q + 2, N, w, s1, s2, s0);
  }
}

// The 4-D map over a contiguous (B, D, M, N) f32 volume as (N, M, D, B),
// whose loads write one plane's WM x WN window.
bool volume_map(CUtensorMap* map, const float* x, int B, int D, int M,
                int N) {
  const uint64_t dims[4] = {static_cast<uint64_t>(N),
                            static_cast<uint64_t>(M),
                            static_cast<uint64_t>(D),
                            static_cast<uint64_t>(B)};
  const uint64_t row = static_cast<uint64_t>(N) * 4;
  const uint64_t strides[3] = {row, row * M, row * M * D};
  const uint32_t box[4] = {WN, WM, 1, 1};
  return hw::make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, dims,
                      strides, box);
}

cudaError_t launch_ring3(const float* x, const float* w, float* o, int B,
                         int D, int M, int N, cudaStream_t stream) {
  CUtensorMap xmap;
  if (!volume_map(&xmap, x, B, D, M, N)) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      stencil3d_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      RING_SMEM);
  if (attr != cudaSuccess) return attr;
  const int chunks = (D + RDC - 1) / RDC;
  const dim3 grid((N + RN - 1) / RN, (M + RM - 1) / RM, B * chunks);
  stencil3d_tma_kernel<<<grid, RING_THREADS, RING_SMEM, stream>>>(
      xmap, w, o, D, M, N, chunks);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes by repro_torch/kernels/
// stx_stencil.py). x and o contiguous (B, M, N) (three_d == 0) or
// (B, D, M, N) of one type (dtype: kF32 or kBF16); w 9 or 27 contiguous
// f32 weights on the device. body 0 runs "simt"; body 1 K7b's "ring",
// for f32, N a multiple of 4 and a 16-byte aligned x (anything else is
// refused, never rerun on the other body). Returns the launch's
// cudaGetLastError() code.
extern "C" int repro_stencil(const void* x, const void* w, void* o,
                             int dtype, int three_d, int B, int D, int M,
                             int N, int body, void* stream) {
  const long long z = three_d ? static_cast<long long>(B) * ((D + DC - 1) / DC)
                              : B;
  if (B < 1 || D < 1 || M < 1 || N < 1 || z > 65535 ||
      (M + TM3 - 1) / TM3 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (body == 1) {
    if (!three_d || dtype != repro::kF32 || N % 4 != 0 ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(o) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    err = launch_ring3(static_cast<const float*>(x),
                       static_cast<const float*>(w), static_cast<float*>(o),
                       B, D, M, N, s);
  } else if (body == 0) {
    err = dtype == repro::kBF16
              ? launch<__nv_bfloat16>(x, w, o, three_d != 0, B, D, M, N, s)
              : launch<float>(x, w, o, three_d != 0, B, D, M, N, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
