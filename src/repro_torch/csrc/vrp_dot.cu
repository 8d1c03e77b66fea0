// K8: the VRP tile's compensated dot (K8a) and sum (K8b), and the
// compensated tree that finalizes their lanes.
//
// Replaces repro/kernels/vrp_dot.py::vrp_dot_pallas (body _dot_kernel)
// and ::vrp_sum_pallas (body _sum_kernel). Same function: flat f32
// inputs of n elements; element i belongs to lane i mod 1024 of an
// (8, 128) lane tile, and each lane walks its elements in block order
// (i = j * 1024 + lane, j = 0 .. ceil(n / 1024) - 1), keeping a
// Neumaier pair (s, c): two_sum(s, v) -> (s, err), c += err, and for
// the dot v = p of Dekker's two_prod(x, y) -> (p, e) with c += e after
// (Veltkamp splitter 2^12 + 1). The lanes' (8, 128, 2) pairs are the
// Pallas kernel's output; finalize_kernel merges them into the (2,)
// expansion as repro/kernels/ops.py::_finalize_expansion does
// (core/vrp.py tree_sum at K = 2), in the same order.
//
// The partition and the order are the contract: with every operation
// rounded on its own (__fadd_rn, __fsub_rn, __fmul_rn; nvcc would
// otherwise contract c - (c - a) with c = 4097 * a, or a * b - p, into
// a fused multiply-add and break the error-free transforms) the lanes
// equal the plain version (kernels/ref.py::vrp_dot_lanes) and the Pallas
// kernel bit for bit, and so does the finalized expansion. The ragged
// tail reads as zeros inside the kernels: no padded copy is made.
//
// What bounds it on the H100. Bytes: 8 (dot) or 4 (sum) read per
// element, 2^26 x 8 B / 3.35 TB/s = 0.160 ms at the 8192^2 plate. But
// the lane contract leaves 1024 walks of n / 1024 dependent steps each:
// the carried s costs one rounded add a step and the carried c one
// (sum) or two (dot: c += err; c += e, not reassociable), ~4 cycles an
// add, so 65,536 steps take ~0.13-0.15 ms (sum) and ~0.27-0.30 ms (dot)
// at the card's clocks, whatever the bytes. No design under this
// contract reaches the byte bound; the chain is the floor. The ring
// body below is held above it by its load path (the TMA boxes of this
// partition are 32-byte rows, which the memory serves well below its
// rate) and by the shared-memory passes of its split walk.
//
// Two bodies, chosen by the wrapper from n and alignment alone:
//
// "ring" (n >= 1024, x and y 16-byte aligned). CTA b owns the L lanes
// [b L, b L + L) (L = 8: 128 CTAs, one an SM). x (and y) viewed as
// rows of 1024 lanes come in R x L tiles (R L = 2048 elements, 8 KB) by
// TMA into a ring of 6-8 slots, up to 64 KB in flight an SM. The walk
// of a tile is split over warps so that no warp issues more than the
// chain needs, and the walkers read and write 16 bytes (four steps) at
// a time:
//   producer   one thread keeps the TMA ring full;
//   prep       (2 warps, 4 for the dot) lays each landed tile out
//              lane-major (a lane's steps contiguous) in a work slot:
//              v = x, or for the dot Dekker's two_prod (p, e);
//   s walker   carries s: s = s + v row by row, each s stored;
//   err        (2 warps) the error of every step from (s_prev, s_new,
//              v), exactly what two_sum(s_prev, v) gives, written over v;
//   c walker   carries c: c = c + err (and c = c + e for the dot), then
//              frees the work slot.
// The rows past the last whole one (n % 1024 != 0) are one more step of
// every lane, taken after the ring from plain loads (zeros past n), as
// the Pallas kernel walks its zero-padded last block.
//
// "simt" (n < 1024, or a base no tensor map takes, such as x[1:]): the
// kernel of the first port, one thread a lane, 32 blocks ahead in
// registers. Held by the loads in flight (4 KB an SM): ~20x its bound.

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hw = repro::hopper;

constexpr int LANES = 1024;      // the (8, 128) lane tile
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

// ---------------------------------------------------------------------------
// body "simt"
// ---------------------------------------------------------------------------

constexpr int THREADS = 32;      // lanes per CTA
constexpr int U = 32;            // blocks per chunk

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

// ---------------------------------------------------------------------------
// body "ring"
// ---------------------------------------------------------------------------

constexpr int TILE = 2048;       // elements of a ring tile (R rows x L lanes)
constexpr int GROUP = 16;        // rows a walker loads ahead of its adds
constexpr int HB = 8;            // elements a helper thread loads at once

// Warp roles: the s walker, the c walker, the producer, then the
// helpers (first the prep helpers, then the err helpers).
constexpr int W_S = 0, W_C = 1, W_PRODUCER = 2, W_HELPERS = 3;

template <bool DOT, int L>
struct Ring {
  static constexpr int R = TILE / L;             // 256, 128, 64 rows
  static constexpr int RS = R + 4;   // a lane's row in the work buffers
  static constexpr int LOADS = DOT ? 6 : 8;      // TMA ring stages
  static constexpr int WORKS = 4;                // work ring stages
  static constexpr int HP = DOT ? 4 : 2;         // prep helper warps
  static constexpr int HE = 2;                   // err helper warps
  static constexpr int WARPS = W_HELPERS + HP + HE;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int TILE_BYTES = TILE * 4;
  static constexpr int LOAD_SLOT = TILE_BYTES * (DOT ? 2 : 1);
  static constexpr int BUF = (L * RS * 4 + 127) / 128 * 128;
  static constexpr int WORK_SLOT = BUF * (DOT ? 3 : 2);   // v (e) s
  static constexpr int BARS = 2 * LOADS + 4 * WORKS;
  static constexpr int SMEM =
      128 + LOADS * LOAD_SLOT + WORKS * WORK_SLOT + BARS * 8 + 2 * L * 4;
  // RS = 4 mod 32: L lanes' 16-byte accesses to one column of rows hit
  // distinct banks, and so do a warp's 4 rows x 8 lanes of single words
  static_assert(R % (2 * GROUP) == 0 && R <= 256 && RS % 32 == 4, "tile");
  static_assert(SMEM <= 232448, "shared memory");
};

// GROUP rows of a lane, contiguous: four 16-byte loads.
__device__ __forceinline__ void load_rows(float4 (&d)[GROUP / 4],
                                          const float* v, int r0) {
#pragma unroll
  for (int q = 0; q < GROUP / 4; ++q)
    d[q] = *reinterpret_cast<const float4*>(v + r0 + 4 * q);
}

// s over GROUP rows, each s stored four rows at a time (16 bytes).
__device__ __forceinline__ float add_store(float s,
                                           const float4 (&v)[GROUP / 4],
                                           float* sb) {
#pragma unroll
  for (int q = 0; q < GROUP / 4; ++q) {
    float4 o;
    o.x = s = __fadd_rn(s, v[q].x);
    o.y = s = __fadd_rn(s, v[q].y);
    o.z = s = __fadd_rn(s, v[q].z);
    o.w = s = __fadd_rn(s, v[q].w);
    *reinterpret_cast<float4*>(sb + 4 * q) = o;
  }
  return s;
}

template <bool DOT>
__device__ __forceinline__ float add_c(float c, const float4 (&err)[GROUP / 4],
                                       const float4 (&e)[GROUP / 4]) {
#pragma unroll
  for (int q = 0; q < GROUP / 4; ++q) {
    // product error after the step's error: already second-order
    c = __fadd_rn(c, err[q].x);
    if (DOT) c = __fadd_rn(c, e[q].x);
    c = __fadd_rn(c, err[q].y);
    if (DOT) c = __fadd_rn(c, e[q].y);
    c = __fadd_rn(c, err[q].z);
    if (DOT) c = __fadd_rn(c, e[q].z);
    c = __fadd_rn(c, err[q].w);
    if (DOT) c = __fadd_rn(c, e[q].w);
  }
  return c;
}

// Carry s over a tile: v this lane's values (lane-major, row r at v[r]),
// sb this lane's row of the s buffer: sb[3] the s before the tile,
// sb[4 + r] the s after row r. A whole tile is unrolled, and the loads
// of the next GROUP rows are issued before the adds of the current ones,
// so the chain never waits on shared memory.
template <int R>
__device__ __forceinline__ float carry_s(float s, const float* v, float* sb,
                                         int rows) {
  sb[3] = s;
  if (rows < R) {                  // the last tile, once: plain loop
    for (int r = 0; r < rows; ++r) sb[4 + r] = s = __fadd_rn(s, v[r]);
    return s;
  }
  float4 a[GROUP / 4], b[GROUP / 4];
  load_rows(a, v, 0);
#pragma unroll
  for (int g = 0; g < R / GROUP; g += 2) {
    load_rows(b, v, (g + 1) * GROUP);
    s = add_store(s, a, sb + 4 + g * GROUP);
    if (g + 2 < R / GROUP) load_rows(a, v, (g + 2) * GROUP);
    s = add_store(s, b, sb + 4 + (g + 1) * GROUP);
  }
  return s;
}

// Carry c over a tile: c = c + err, and for the dot c = c + e (both
// lane-major), loads ahead as in carry_s.
template <bool DOT, int R>
__device__ __forceinline__ float carry_c(float c, const float* err,
                                         const float* e, int rows) {
  if (rows < R) {
    for (int r = 0; r < rows; ++r) {
      c = __fadd_rn(c, err[r]);
      if (DOT) c = __fadd_rn(c, e[r]);
    }
    return c;
  }
  float4 a[GROUP / 4], b[GROUP / 4], ae[GROUP / 4], be[GROUP / 4];
  load_rows(a, err, 0);
  if (DOT) load_rows(ae, e, 0);
#pragma unroll
  for (int g = 0; g < R / GROUP; g += 2) {
    load_rows(b, err, (g + 1) * GROUP);
    if (DOT) load_rows(be, e, (g + 1) * GROUP);
    c = add_c<DOT>(c, a, ae);
    if (g + 2 < R / GROUP) {
      load_rows(a, err, (g + 2) * GROUP);
      if (DOT) load_rows(ae, e, (g + 2) * GROUP);
    }
    c = add_c<DOT>(c, b, be);
  }
  return c;
}

// The ring body. Two rings of slots in shared memory: the TMA ring holds
// the tiles of x (and y) as they land (R rows x L lanes, row-major); the
// work ring holds, lane-major (a lane's rows contiguous, row r of lane l
// at l * RS + 4 + r), the step values v (x, or the product p), the
// product errors e (dot) and the carried s, and then the step errors
// err over v. A tile t goes through TMA slot t % LOADS and work slot
// t % WORKS:
//   producer  TMA into the TMA slot          -> full
//   prep      v (and e) into the work slot   -> prep, and frees the TMA slot
//   s walker  s row by row                   -> sdone
//   err       err of each step               -> edone
//   c walker  c row by row                   -> empty: frees the work slot
template <bool DOT, int L>
__global__ void __launch_bounds__(Ring<DOT, L>::THREADS)
    ring_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap ymap,
                const float* __restrict__ x, const float* __restrict__ y,
                float* __restrict__ out, long long n) {
  using G = Ring<DOT, L>;
  constexpr int R = G::R, RS = G::RS, SL = G::LOADS, SW = G::WORKS;
  extern __shared__ unsigned char smem_raw[];
  // aligned by pointer arithmetic: a round trip through an integer would
  // lose the shared address space and make every access a generic one
  unsigned char* smem =
      smem_raw + ((128 - (hw::smem_u32(smem_raw) & 127)) & 127);
  unsigned char* work = smem + SL * G::LOAD_SLOT;
  uint64_t* full = reinterpret_cast<uint64_t*>(work + SW * G::WORK_SLOT);
  uint64_t* freed = full + SL;          // prep read the TMA slot
  uint64_t* prep = full + 2 * SL;       // v (and e) written
  uint64_t* sdone = prep + SW;          // s stored
  uint64_t* edone = prep + 2 * SW;      // err written over v
  uint64_t* empty = prep + 3 * SW;      // c carried: the work slot is free
  float* fin = reinterpret_cast<float*>(full + G::BARS);
  auto xs = [&](int k) {
    return reinterpret_cast<float*>(smem + k * G::LOAD_SLOT);
  };
  auto ys = [&](int k) { return xs(k) + TILE; };
  auto vs = [&](int k) {
    return reinterpret_cast<float*>(work + k * G::WORK_SLOT);
  };
  auto es = [&](int k) { return vs(k) + G::BUF / 4; };
  auto ss = [&](int k) { return vs(k) + (DOT ? 2 : 1) * (G::BUF / 4); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int l0 = blockIdx.x * L;
  const long long nfull = n / LANES;
  const int ntiles = static_cast<int>((nfull + R - 1) / R);
  auto rows_of = [&](int t) {
    return static_cast<int>(
        min(static_cast<long long>(R), nfull - 1LL * t * R));
  };

  if (threadIdx.x == 0) {
    for (int k = 0; k < SL; ++k) {
      hw::mbar_init(full + k, 1);
      hw::mbar_init(freed + k, 32 * G::HP);
    }
    for (int k = 0; k < SW; ++k) {
      hw::mbar_init(prep + k, 32 * G::HP);
      hw::mbar_init(sdone + k, 32);
      hw::mbar_init(edone + k, 32 * G::HE);
      hw::mbar_init(empty + k, 32);
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  float s = 0.f, c = 0.f;
  if (warp == W_PRODUCER) {
    if (lane == 0) {
      for (int t = 0; t < ntiles; ++t) {
        const int k = t % SL;
        if (t >= SL) hw::bar_wait(freed + k, ((t / SL) - 1) & 1);
        hw::mbar_arrive_expect_tx(full + k, G::LOAD_SLOT);
        hw::tma_load_2d(xs(k), &xmap, full + k, l0, t * R);
        if (DOT) hw::tma_load_2d(ys(k), &ymap, full + k, l0, t * R);
      }
    }
  } else if (warp == W_S) {
    for (int t = 0; t < ntiles; ++t) {
      const int k = t % SW, rows = rows_of(t);
      hw::bar_wait(prep + k, (t / SW) & 1);
      if (lane < L)
        s = carry_s<R>(s, vs(k) + lane * RS + 4, ss(k) + lane * RS, rows);
      hw::mbar_arrive(sdone + k);
    }
  } else if (warp == W_C) {
    for (int t = 0; t < ntiles; ++t) {
      const int k = t % SW, rows = rows_of(t);
      hw::bar_wait(edone + k, (t / SW) & 1);
      if (lane < L)
        c = carry_c<DOT, R>(c, vs(k) + lane * RS + 4, es(k) + lane * RS + 4,
                            rows);
      hw::mbar_arrive(empty + k);
    }
  } else if (warp < W_HELPERS + G::HP) {
    // prep: the landed tile into the work slot, lane-major: v = x (sum),
    // or (v, e) = two_prod(x, y) (dot)
    const int h = threadIdx.x - 32 * W_HELPERS;
    constexpr int STRIDE = 32 * G::HP;
    for (int t = 0; t < ntiles; ++t) {
      const int kl = t % SL, k = t % SW, m = rows_of(t) * L;
      hw::bar_wait(full + kl, (t / SL) & 1);
      if (t >= SW) hw::bar_wait(empty + k, ((t / SW) - 1) & 1);
      const float* xt = xs(kl);
      const float* yt = ys(kl);
      float* vt = vs(k);
      float* et = es(k);
      for (int i0 = h; i0 < TILE; i0 += STRIDE * HB) {
        float a[HB], b[HB];
#pragma unroll
        for (int j = 0; j < HB; ++j) {
          const int i = i0 + j * STRIDE;
          a[j] = i < m ? xt[i] : 0.f;
          if (DOT) b[j] = i < m ? yt[i] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < HB; ++j) {
          const int i = i0 + j * STRIDE;
          const int w = (i % L) * RS + 4 + i / L;   // lane i % L, row i / L
          if (DOT) {
            float p, e;
            two_prod(a[j], b[j], p, e);
            if (i < m) {
              vt[w] = p;
              et[w] = e;
            }
          } else if (i < m) {
            vt[w] = a[j];
          }
        }
      }
      hw::mbar_arrive(freed + kl);
      hw::mbar_arrive(prep + k);
    }
  } else {
    // err of each step from (s before, s after, v), in place over v
    const int h = threadIdx.x - 32 * (W_HELPERS + G::HP);
    constexpr int STRIDE = 32 * G::HE;
    for (int t = 0; t < ntiles; ++t) {
      const int k = t % SW, m = rows_of(t) * L;
      hw::bar_wait(sdone + k, (t / SW) & 1);
      float* vt = vs(k);
      const float* sb = ss(k);
      for (int i0 = h; i0 < TILE; i0 += STRIDE * HB) {
        float a[HB], sn[HB], b[HB];
#pragma unroll
        for (int j = 0; j < HB; ++j) {
          const int i = i0 + j * STRIDE;
          const int w = (i % L) * RS + 4 + i / L;
          a[j] = i < m ? sb[w - 1] : 0.f;
          sn[j] = i < m ? sb[w] : 0.f;
          b[j] = i < m ? vt[w] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < HB; ++j) {
          const int i = i0 + j * STRIDE;
          // two_sum(a, b) with its sum sn = a + b already rounded
          const float a1 = __fsub_rn(sn[j], b[j]);
          const float b1 = __fsub_rn(sn[j], a1);
          const float err =
              __fadd_rn(__fsub_rn(a[j], a1), __fsub_rn(b[j], b1));
          if (i < m) vt[(i % L) * RS + 4 + i / L] = err;
        }
      }
      hw::mbar_arrive(edone + k);
    }
  }

  // the lanes' last step over the partial row, then the pairs
  if (warp == W_S && lane < L) fin[lane] = s;
  if (warp == W_C && lane < L) fin[L + lane] = c;
  __syncthreads();
  if (warp == W_PRODUCER && lane < L) {
    float sl = fin[lane], cl = fin[L + lane];
    const long long rem = n - nfull * LANES;
    if (rem > 0) {
      const bool in = l0 + lane < rem;
      const long long i = nfull * LANES + l0 + lane;
      const float v = in ? x[i] : 0.f;
      float err;
      if (DOT) {
        float p, e;
        two_prod(v, in ? y[i] : 0.f, p, e);
        two_sum(sl, p, sl, err);
        cl = __fadd_rn(cl, err);
        cl = __fadd_rn(cl, e);
      } else {
        two_sum(sl, v, sl, err);
        cl = __fadd_rn(cl, err);
      }
    }
    out[2 * (l0 + lane)] = sl;
    out[2 * (l0 + lane) + 1] = cl;
  }
}

// A map over a flat f32 vector seen as `rows` rows of 1024 lanes, whose
// loads write R x L boxes (lanes innermost). False when
// cuTensorMapEncodeTiled refuses it (a base that is not 16-byte aligned).
bool rows_map(CUtensorMap* map, const float* base, long long rows, int L,
              int R) {
  const uint64_t dims[2] = {LANES, static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {LANES * sizeof(float)};
  const uint32_t box[2] = {static_cast<uint32_t>(L), static_cast<uint32_t>(R)};
  return hw::make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims,
                      strides, box);
}

template <bool DOT, int L>
cudaError_t launch_ring(const float* x, const float* y, float* out,
                        long long n, cudaStream_t stream) {
  using G = Ring<DOT, L>;
  CUtensorMap xmap, ymap;
  if (!rows_map(&xmap, x, n / LANES, L, G::R) ||
      !rows_map(&ymap, y, n / LANES, L, G::R))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ring_kernel<DOT, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::SMEM);
  if (attr != cudaSuccess) return attr;
  ring_kernel<DOT, L><<<LANES / L, G::THREADS, G::SMEM, stream>>>(
      xmap, ymap, x, y, out, n);
  return cudaGetLastError();
}

template <bool DOT>
cudaError_t launch_ring_l(const float* x, const float* y, float* out,
                          long long n, int L, cudaStream_t stream) {
  switch (L) {
    case 8: return launch_ring<DOT, 8>(x, y, out, n, stream);
    case 16: return launch_ring<DOT, 16>(x, y, out, n, stream);
    case 32: return launch_ring<DOT, 32>(x, y, out, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// the finalize: core/vrp.py tree_sum(lanes.reshape(-1, 2), K = 2)
// ---------------------------------------------------------------------------

constexpr int FIN_THREADS = LANES / 2;

// vrp.add at K = 2: the four terms (h, l, bh, bl) through renormalize's
// bubble, two passes of (t_i, t_{i+1}) = two_sum(t_i, t_{i+1}) for
// i = 2, 1, 0; (h, l) <- (t_0, t_1).
__device__ __forceinline__ void vp_add(float& h, float& l, float bh,
                                       float bl) {
  float t0 = h, t1 = l, t2 = bh, t3 = bl;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    two_sum(t2, t3, t2, t3);
    two_sum(t1, t2, t1, t2);
    two_sum(t0, t1, t0, t1);
  }
  h = t0;
  l = t1;
}

// One CTA: level 1 merges the pairs (2i, 2i + 1) of the 1024 lanes
// (lane r * 128 + c of the (8, 128) tile), each level after it the
// pairs of the level before, 10 levels down to the (2,) expansion.
__global__ void __launch_bounds__(FIN_THREADS)
    finalize_kernel(const float* __restrict__ lanes, float* __restrict__ out) {
  __shared__ float2 buf[2][FIN_THREADS];
  const int i = threadIdx.x;
  float h = lanes[4 * i], l = lanes[4 * i + 1];
  vp_add(h, l, lanes[4 * i + 2], lanes[4 * i + 3]);
  int p = 0;
  for (int m = FIN_THREADS; m > 1; m /= 2, p ^= 1) {
    if (i < m) buf[p][i] = make_float2(h, l);
    __syncthreads();
    if (i < m / 2) {
      const float2 a = buf[p][2 * i], b = buf[p][2 * i + 1];
      h = a.x;
      l = a.y;
      vp_add(h, l, b.x, b.y);
    }
  }
  if (i == 0) {
    out[0] = h;
    out[1] = l;
  }
}

}  // namespace

// C entry points (loaded with ctypes by repro_torch/kernels/vrp_dot.py).
//
// repro_vrp_lanes: x (and y when dot != 0) contiguous f32 of n
// elements; lanes a contiguous (8, 128, 2) f32 tensor of lane pairs
// (s, c). body 0 runs "simt"; body 1 "ring" with lanes_per_cta L of 8,
// 16 or 32, for n >= 1024 and 16-byte aligned bases (anything else is
// refused, never rerun on the other body). When `expansion` is not null the
// finalize follows on the same stream and writes the (2,) expansion
// there. Returns the launches' cudaGetLastError() code.
extern "C" int repro_vrp_lanes(const void* x, const void* y, void* lanes,
                               void* expansion, long long n, int dot, int body,
                               int lanes_per_cta, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* o = static_cast<float*>(lanes);
  cudaError_t err;
  if (body == 1) {
    if (n < LANES || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(y) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    err = dot ? launch_ring_l<true>(xf, yf, o, n, lanes_per_cta, s)
              : launch_ring_l<false>(xf, yf, o, n, lanes_per_cta, s);
  } else if (body == 0) {
    if (dot)
      lanes_kernel<true><<<LANES / THREADS, THREADS, 0, s>>>(xf, yf, o, n);
    else
      lanes_kernel<false><<<LANES / THREADS, THREADS, 0, s>>>(xf, yf, o, n);
    err = cudaGetLastError();
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || expansion == nullptr) return static_cast<int>(err);
  finalize_kernel<<<1, FIN_THREADS, 0, s>>>(o, static_cast<float*>(expansion));
  return static_cast<int>(cudaGetLastError());
}

// repro_vrp_finalize: lanes a contiguous (8, 128, 2) f32 tensor, out a
// (2,) f32 tensor for the expansion [hi, lo].
extern "C" int repro_vrp_finalize(const void* lanes, void* out,
                                  void* stream) {
  finalize_kernel<<<1, FIN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lanes), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
