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
// written once for 2 flops, so memory: 3 * B * T * D * 4 B / 3.35 TB/s,
// 0.0376 ms at serving's (8, 512, 2560) and 0.0470 ms at the long
// admission's (2, 2560, 2560) in f32. The recurrence is sequential in T
// and stays so: any scan that runs in parallel over T rounds in another
// order and would lose the bit-equality. The chain is no limit either:
// 2,560 dependent steps of a rounded multiply then a rounded add, ~8-10
// cycles a step, are ~10-13 us at 1.98 GHz. What a design must supply is
// bytes in flight: by Little's law 3.35 TB/s at ~1 us of latency wants
// ~3 MB in flight across the card.
//
// Two bodies, chosen by the wrapper from dtype, shape and alignment alone:
//
// "ring" (f32 or bf16, D * elem a multiple of 16 bytes, a and x 16-byte
// aligned). A CTA owns one batch row b and C = 32 consecutive channels
// (rows of 128 bytes in f32). 3-D tensor maps over (D, T, B) bring R x C
// tiles of a and x (R = 64) into a ring of S stages in shared memory, S
// set from the shape so that the grid keeps ~5 MiB of a and x loading (2
// stages at the long admission's 160 CTAs; at least 2 where T spans two
// tiles, at most 8): a box never
// crosses into the next batch row, and rows past T read as zeros and are
// never stored. One producer thread keeps the ring full on full / empty
// mbarriers; one warp walks the chain, lane c channel d0 + c, reading
// each step's a and x from shared memory (the next 16 rows loaded before
// the current 16 are added) and storing h_t straight to device memory,
// C lanes of a row in one coalesced store. More bytes in flight (4
// stages, or 16 channels a CTA for twice the CTAs) measured slower, so
// what holds it above the byte bound is likely the rate the memory
// serves this pattern at: 128-byte rows strided by D * 4 bytes, read and
// written row by row.
//
// "simt" (what no tensor map takes: D * elem not a multiple of 16, an
// unaligned base): the kernel of the first port, one thread per (b, d)
// channel with 16 time steps of loads in flight. At (2, 2560, 2560) that
// is 80 CTAs of 2 warps and ~0.65 MB in flight: 3.6x the byte bound.

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hw = repro::hopper;
using repro::from_f32;
using repro::to_f32;

// ---------------------------------------------------------------------------
// body "simt"
// ---------------------------------------------------------------------------

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
cudaError_t launch_simt(const void* a, const void* x, const void* h0,
                        void* o, int B, int Tn, int D, cudaStream_t stream) {
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  scan_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x),
      static_cast<const float*>(h0), static_cast<T*>(o), Tn, D);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// body "ring"
// ---------------------------------------------------------------------------

constexpr int C = 32;            // channels a CTA: one lane each
constexpr int TILE = 2048;       // elements of a (and of x) a stage holds
constexpr int GROUP = 16;        // rows a walker loads ahead of its adds
constexpr int MAX_STAGES = 8;
constexpr long long IN_FLIGHT = 5 << 20;   // bytes the grid keeps loading

template <typename T>
struct ScanRing {
  static constexpr int R = TILE / C;              // 64 time rows
  static constexpr int SLOT = TILE * sizeof(T);   // one input's tile
  static constexpr int STAGE = 2 * SLOT;          // a then x
  static constexpr int THREADS = 64;              // walker, producer warps
  static constexpr int smem(int S) { return 128 + S * STAGE + 2 * S * 8; }
  static_assert(R % (2 * GROUP) == 0 && R <= 256 && SLOT % 128 == 0,
                "tile");
  static_assert(C * sizeof(T) % 16 == 0 && C == 32,
                "box rows of 16-byte multiples, one lane a channel");
};

// Stages for (B, Tn, D) of `elem`-byte values: enough that the grid
// keeps IN_FLIGHT bytes of a and x loading, at least two (one lands while
// the other is walked), at most one a tile of T and MAX_STAGES.
int ring_stages(int B, int Tn, int D, int elem) {
  const long long ctas = static_cast<long long>(B) * ((D + C - 1) / C);
  const long long stage = 2LL * TILE * elem;
  const int tiles = (Tn + TILE / C - 1) / (TILE / C);
  int S = static_cast<int>((2 * IN_FLIGHT + ctas * stage) /
                           (2 * ctas * stage));            // rounded
  S = S < 2 ? 2 : S;
  S = S < tiles ? S : tiles;
  return S < MAX_STAGES ? S : MAX_STAGES;
}

struct Rows {
  float a[GROUP], x[GROUP];
};

// GROUP rows of this lane's channel from a stage (row-major R x C).
template <typename T>
__device__ __forceinline__ void load_group(Rows& v, const T* a,
                                           const T* x, int r0) {
#pragma unroll
  for (int u = 0; u < GROUP; ++u) {
    v.a[u] = to_f32(a[(r0 + u) * C]);
    v.x[u] = to_f32(x[(r0 + u) * C]);
  }
}

// The chain over GROUP loaded rows, each h_t stored (o advanced a row of
// D per step).
template <typename T>
__device__ __forceinline__ float step_group(float h, const Rows& v,
                                            T*& o, long long D, bool live) {
#pragma unroll
  for (int u = 0; u < GROUP; ++u) {
    h = __fadd_rn(__fmul_rn(v.a[u], h), v.x[u]);
    if (live) *o = from_f32<T>(h);
    o += D;
  }
  return h;
}

// This lane's walk over one stage of `rows` rows: a, x its channel's
// column in the stage, o its h_t for the stage's first row.
template <typename T>
__device__ __forceinline__ float walk(float h, const T* a, const T* x, T* o,
                                      long long D, int rows, bool live) {
  constexpr int R = ScanRing<T>::R;
  if (rows < R) {                  // the last stage of a ragged T: plain loop
    for (int r = 0; r < rows; ++r) {
      h = __fadd_rn(__fmul_rn(to_f32(a[r * C]), h), to_f32(x[r * C]));
      if (live) *o = from_f32<T>(h);
      o += D;
    }
    return h;
  }
  Rows p, q;
  load_group<T>(p, a, x, 0);
#pragma unroll
  for (int g = 0; g < R / GROUP; g += 2) {
    load_group<T>(q, a, x, (g + 1) * GROUP);
    h = step_group(h, p, o, D, live);
    if (g + 2 < R / GROUP) load_group<T>(p, a, x, (g + 2) * GROUP);
    h = step_group(h, q, o, D, live);
  }
  return h;
}

// Warp 0 walks, lane c on channel d0 + c; warp 1's first thread
// keeps the ring full. Stage t % S holds time rows [t R, t R + R) of a
// and x: producer -> full (TMA bytes landed); walker -> empty (read).
template <typename T>
__global__ void __launch_bounds__(ScanRing<T>::THREADS)
    scan_tma_kernel(const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap xmap,
                    const float* __restrict__ h0, T* __restrict__ o, int Tn,
                    int D, int S) {
  using G = ScanRing<T>;
  constexpr int R = G::R;
  extern __shared__ unsigned char smem_raw[];
  // aligned by pointer arithmetic: a round trip through an integer would
  // lose the shared address space and make every access a generic one
  unsigned char* smem =
      smem_raw + ((128 - (hw::smem_u32(smem_raw) & 127)) & 127);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * G::STAGE);
  uint64_t* empty = full + S;
  auto as = [&](int k) {
    return reinterpret_cast<T*>(smem + k * G::STAGE);
  };
  auto xs = [&](int k) {
    return reinterpret_cast<T*>(smem + k * G::STAGE + G::SLOT);
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = blockIdx.x * C, b = blockIdx.y;
  const int ntiles = (Tn + R - 1) / R;

  if (threadIdx.x == 0) {
    for (int k = 0; k < S; ++k) {
      hw::mbar_init(full + k, 1);
      hw::mbar_init(empty + k, 1);
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 1) {
    if (lane == 0) {
      for (int t = 0; t < ntiles; ++t) {
        const int k = t % S;
        if (t >= S) hw::bar_wait(empty + k, ((t / S) - 1) & 1);
        hw::mbar_arrive_expect_tx(full + k, G::STAGE);
        hw::tma_load_3d(as(k), &amap, full + k, d0, t * R, b);
        hw::tma_load_3d(xs(k), &xmap, full + k, d0, t * R, b);
      }
    }
    return;
  }

  const int d = d0 + lane;
  const bool live = d < D;
  float h = live && h0 != nullptr ? h0[static_cast<long long>(b) * D + d]
                                  : 0.f;
  T* out = o + static_cast<long long>(b) * Tn * D + d;
  for (int t = 0; t < ntiles; ++t) {
    const int k = t % S;
    hw::bar_wait(full + k, (t / S) & 1);
    h = walk<T>(h, as(k) + lane, xs(k) + lane,
                out + static_cast<long long>(t) * R * D, D,
                min(R, Tn - t * R), live);
    __syncwarp();
    if (lane == 0) hw::mbar_arrive(empty + k);
  }
}

// A 3-D map over a contiguous (B, T, D) tensor of T as (D, T, B), whose
// loads write R x C boxes (channels innermost).
template <typename T>
bool scan_map(CUtensorMap* map, const void* base, int B, int Tn, int D,
              int R) {
  const uint64_t dims[3] = {static_cast<uint64_t>(D),
                            static_cast<uint64_t>(Tn),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[2] = {D * sizeof(T),
                               static_cast<uint64_t>(Tn) * D * sizeof(T)};
  const uint32_t box[3] = {static_cast<uint32_t>(C),
                           static_cast<uint32_t>(R), 1};
  return hw::make_map(map,
                      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      3, base, dims, strides, box);
}

template <typename T>
cudaError_t launch_ring(const void* a, const void* x, const void* h0,
                        void* o, int B, int Tn, int D,
                        cudaStream_t stream) {
  using G = ScanRing<T>;
  CUtensorMap amap, xmap;
  if (!scan_map<T>(&amap, a, B, Tn, D, G::R) ||
      !scan_map<T>(&xmap, x, B, Tn, D, G::R))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      scan_tma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::smem(MAX_STAGES));
  if (attr != cudaSuccess) return attr;
  const int S = ring_stages(B, Tn, D, sizeof(T));
  const dim3 grid((D + C - 1) / C, B);
  scan_tma_kernel<T><<<grid, G::THREADS, G::smem(S), stream>>>(
      amap, xmap, static_cast<const float*>(h0), static_cast<T*>(o), Tn, D,
      S);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes by repro_torch/kernels/
// rglru_scan.py). a, x and o contiguous (B, T, D) of one type (dtype:
// kF32 or kBF16); h0 a contiguous (B, D) f32 carry or null (zeros).
// body 0 runs "simt"; body 1 "ring", for D * elem a multiple of 16
// bytes and 16-byte aligned a and x (anything else is refused, never
// rerun on the other body). Returns the launch's cudaGetLastError() code.
extern "C" int repro_rglru_scan(const void* a, const void* x, const void* h0,
                                void* o, int dtype, int B, int Tn, int D,
                                int body, void* stream) {
  if (B < 1 || B > 65535 || Tn < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == repro::kBF16;
  cudaError_t err;
  if (body == 1) {
    const int elem = bf16 ? 2 : 4;
    if ((static_cast<long long>(D) * elem) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    err = bf16 ? launch_ring<__nv_bfloat16>(a, x, h0, o, B, Tn, D, s)
               : launch_ring<float>(a, x, h0, o, B, Tn, D, s);
  } else if (body == 0) {
    err = bf16 ? launch_simt<__nv_bfloat16>(a, x, h0, o, B, Tn, D, s)
               : launch_simt<float>(a, x, h0, o, B, Tn, D, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
