// K3: multi-query attention over the block-paged KV pool (speculative
// verify and suffix prefill).
//
// Replaces repro/kernels/paged_attention.py::paged_verify_attention_pallas
// (body _pv_kernel). Same function: q (B, K1, Hq, D) holds K1 query rows
// per sequence at positions lengths[b] + j; k/v pools are (NB, BS, Hkv,
// D); logical block i of sequence b lives in block_table[b, i]. lengths
// counts the tokens cached BEFORE the window (K2's counts the current
// token too). Row j sees keys kpos < lengths[b] + 1 + j and, with a
// window, kpos >= that limit - window; positions past the table
// (nbmax * BS) do not exist. f32 online softmax, a row that sees no key
// gives 0. Output (B, K1, Hq, D).
//
// What bounds it on the H100, in its two regimes on the main path:
//   * the verify step (K1 = spec_tokens + 1, about 5): ~1 flop per byte
//     of K/V, so memory. Every visible K/V row must be read once for all
//     K1 rows of its sequence, as the TPU kernel's point was;
//   * the suffix prefill of a partial prefix hit (K1 = W, 16..640): ~4 D
//     flops per K/V element per row, so operations. Done here on the CUDA
//     cores in f32 (no tensor cores yet), far from the bf16 tensor-core
//     bound.
// The design, one simple kernel for both:
//   * the query rows of one kv head are (row j, group g) PAIRS, K1 * G of
//     them; a CTA of 8 warps serves a tile of R pairs of one (sequence,
//     kv head), grid (Hkv, B, ceil(K1 * G / R)). Two tile shapes: R = 8
//     (a warp per pair) when the window has at most 32 pairs, so a verify
//     window of K1 <= 8 / G rows reads each pool block once and a smaller
//     one spreads over more CTAs; R = 64 (16 x 16 lanes, 4 pairs a
//     thread) for the suffix regime, where each K/V tile is reused by 64
//     rows. A warp whose pairs are all past the window skips the math;
//   * the CTA walks keys from the lowest window floor to the highest
//     limit of its pairs, clamped at nbmax * BS, 64 tokens at a time. It
//     looks up block_table[b, kpos / BS] only for positions in that
//     range, so rows whose limit runs past the table, the NULL tail of a
//     suffix-prefill chain and unallocated growth are never dereferenced;
//   * each 64-token K/V tile is gathered from the pool with 16-byte
//     coalesced loads into registers while the previous tile is being
//     computed, then stored to shared memory as f32 (K transposed, padded
//     strides); every thread computes a (pairs x keys) block of scores
//     and a (pairs x dims) block of the output, as K1 does for prefill.
// K4 (the quantized pool, JAX's _dequant inside _pv_kernel): the payload
// type P is a template parameter apart from the query/output type T. An
// int8 or fp8 (e4m3) payload travels in the same 16-byte loads (16
// elements a load against 8 in bf16, so a warp covers twice the tokens
// per load) together with the row's f32 (token, head) scale; the
// multiply happens where the tile is unpacked into shared memory as f32,
// so the math after the gather is unchanged and the dequantized rows
// exist only in shared memory.
// Tensor cores (wgmma + TMA) for the suffix regime and split-K across
// CTAs for long verify contexts are later steps.

#include <math_constants.h>

#include <climits>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::IsQuant;
using repro::kMaskValue;
using repro::to_f32;
using repro::unpack16;

constexpr int THREADS = 256;     // 8 warps
constexpr int BK = 64;           // keys per shared-memory tile

struct PvParams {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;          // (NB, BS, Hkv), quantized pools only
  const float* v_scale;
  const int* block_table;
  const int* lengths;
  void* o;
  int K1, Hq, Hkv, BS, nbmax, window;
  float scale;
};

// Issue the 16-byte loads of the K/V rows at positions [k0, k0 + BK)
// (those below ``hi``; the rest read as zeros) into registers, and for a
// quantized payload each loaded row's (token, head) scales.
template <typename P, int D, int NLD>
__device__ __forceinline__ void load_tile(uint4 (&kr)[NLD], uint4 (&vr)[NLD],
                                          float (&ks)[NLD], float (&vs)[NLD],
                                          const P* kp, const P* vp,
                                          const float* ksp, const float* vsp,
                                          const int* table, int BS, int Hkv,
                                          long long tok, int k0, int hi) {
  constexpr int VN = repro::kVec<P>;
  constexpr int CH = D / VN;
#pragma unroll
  for (int n = 0; n < NLD; ++n) {
    const int idx = threadIdx.x + n * THREADS;
    const int kpos = k0 + idx / CH;
    kr[n] = vr[n] = make_uint4(0u, 0u, 0u, 0u);
    ks[n] = vs[n] = 0.f;
    if (idx < BK * CH && kpos < hi) {
      const long long trow =
          static_cast<long long>(table[kpos / BS]) * BS + kpos % BS;
      const long long row = trow * tok + (idx % CH) * VN;
      kr[n] = *reinterpret_cast<const uint4*>(kp + row);
      vr[n] = *reinterpret_cast<const uint4*>(vp + row);
      if constexpr (IsQuant<P>::value) {
        ks[n] = ksp[trow * Hkv];
        vs[n] = vsp[trow * Hkv];
      }
    }
  }
}

template <int D, int RG, int RPT>
constexpr size_t pv_smem_bytes() {
  return sizeof(float) * (RG * RPT * (D + 1) + D * (BK + 1) + BK * D +
                          RG * RPT * (BK + 1));
}

template <typename T, typename P, int D, int RG, int RPT>
__global__ void __launch_bounds__(THREADS) pv_kernel(PvParams p) {
  constexpr int CL = THREADS / RG;            // lanes sharing a pair
  constexpr int R = RG * RPT;                 // pairs per CTA
  constexpr int KPT = BK / CL;                // keys per thread
  constexpr int DPT = D >= CL ? D / CL : 1;   // output dims per thread
  constexpr int VN = repro::kVec<P>;
  constexpr int CH = D / VN;                  // 16-byte chunks per row
  constexpr int NLD = (BK * CH + THREADS - 1) / THREADS;
  extern __shared__ float smem[];
  float* Qs = smem;                           // [R][D + 1]
  float* Kt = Qs + R * (D + 1);               // [D][BK + 1]  (k transposed)
  float* Vs = Kt + D * (BK + 1);              // [BK][D]
  float* Ps = Vs + BK * D;                    // [R][BK + 1]

  const int tid = threadIdx.x;
  const int rg = tid / CL;
  const int cl = tid % CL;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int G = p.Hq / p.Hkv;
  const int t0 = blockIdx.z * R;              // first pair of the tile
  const int n_live = min(R, p.K1 * G - t0);
  const int len = p.lengths[b];
  const int s_max = p.nbmax * p.BS;           // positions past the table

  // pair r of the tile -> query row j = (t0 + r) / G, head hk*G + g
  const T* qb = static_cast<const T*>(p.q) +
                static_cast<long long>(b) * p.K1 * p.Hq * D;
  for (int idx = tid; idx < R * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    float x = 0.f;
    if (r < n_live) {
      const int j = (t0 + r) / G, g = (t0 + r) % G;
      x = to_f32(qb[(static_cast<long long>(j) * p.Hq + hk * G + g) * D + d]);
    }
    Qs[r * (D + 1) + d] = x;
  }

  // this thread's pairs r = rg + RG * i: key limits and window floors
  int lim[RPT], flo[RPT];
  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + RG * i;
    const int limit = len + 1 + (t0 + r) / G;   // the floor's origin
    lim[i] = r < n_live ? min(limit, s_max) : 0;
    flo[i] = p.window > 0 ? limit - p.window : INT_MIN;
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  // the tile's key range: lowest floor to highest limit (uniform in CTA)
  const int hi = min(len + 1 + (t0 + n_live - 1) / G, s_max);
  const int lo = p.window > 0 ? max(0, len + 1 + t0 / G - p.window) : 0;
  const int* table = p.block_table + static_cast<long long>(b) * p.nbmax;
  const long long tok = static_cast<long long>(p.Hkv) * D;   // token stride
  const P* kp = static_cast<const P*>(p.k_pool) + hk * D;
  const P* vp = static_cast<const P*>(p.v_pool) + hk * D;
  const float* ksp = p.k_scale + hk;          // unused for a float pool
  const float* vsp = p.v_scale + hk;
  const bool d_on = D >= CL || cl < D;        // D = 16 with 32 lanes
  // the warp's first row group; its pairs only grow from there, so a
  // warp whose first pair is past the tile has nothing to compute
  const bool live = (tid / 32) * (32 / CL) < n_live;

  uint4 kr[NLD], vr[NLD];
  float ks[NLD], vs[NLD];
  if (lo < hi)
    load_tile<P, D, NLD>(kr, vr, ks, vs, kp, vp, ksp, vsp, table, p.BS,
                         p.Hkv, tok, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();   // previous tile consumed (and Qs written)
#pragma unroll
    for (int n = 0; n < NLD; ++n) {
      const int idx = tid + n * THREADS;
      if (idx < BK * CH) {
        const int jj = idx / CH, d0 = (idx % CH) * VN;
        float kf[VN], vf[VN];
        unpack16<P>(kr[n], kf);
        unpack16<P>(vr[n], vf);
        if constexpr (IsQuant<P>::value) {   // fused dequant (K4)
#pragma unroll
          for (int e = 0; e < VN; ++e) {
            kf[e] *= ks[n];
            vf[e] *= vs[n];
          }
        }
#pragma unroll
        for (int e = 0; e < VN; ++e) {
          Kt[(d0 + e) * (BK + 1) + jj] = kf[e];
          Vs[jj * D + d0 + e] = vf[e];
        }
      }
    }
    __syncthreads();
    if (k0 + BK < hi)   // the next tile's loads fly during this one's math
      load_tile<P, D, NLD>(kr, vr, ks, vs, kp, vp, ksp, vsp, table, p.BS,
                           p.Hkv, tok, k0 + BK, hi);
    if (live) {   // scores and the online softmax of this tile
      float s[RPT][KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int u = 0; u < KPT; ++u) s[i][u] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[RPT], kv[KPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) qv[i] = Qs[(rg + RG * i) * (D + 1) + d];
#pragma unroll
        for (int u = 0; u < KPT; ++u) kv[u] = Kt[d * (BK + 1) + cl + CL * u];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int u = 0; u < KPT; ++u) s[i][u] = fmaf(qv[i], kv[u], s[i][u]);
      }

#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float mx = kMaskValue;
#pragma unroll
        for (int u = 0; u < KPT; ++u) {
          const int kpos = k0 + cl + CL * u;
          const bool valid = kpos < lim[i] && kpos >= flo[i];
          s[i][u] = valid ? s[i][u] * p.scale : -CUDART_INF_F;
          mx = fmaxf(mx, s[i][u]);
        }
        // the CL lanes sharing pair i are one warp (CL 32) or half-warp
#pragma unroll
        for (int off = CL / 2; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float corr = expf(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < KPT; ++u) {
          const float pr = expf(s[i][u] - m_new);   // masked: exp(-inf) = 0
          Ps[(rg + RG * i) * (BK + 1) + cl + CL * u] = pr;
          sum += pr;
        }
#pragma unroll
        for (int off = CL / 2; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l[i] = l[i] * corr + sum;
        m[i] = m_new;
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] *= corr;
      }
    }
    __syncthreads();   // Ps complete
    if (!live) continue;

#pragma unroll 4
    for (int jj = 0; jj < BK; ++jj) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(rg + RG * i) * (BK + 1) + jj];
#pragma unroll
      for (int e = 0; e < DPT; ++e)
        vv[e] = d_on ? Vs[jj * D + cl + CL * e] : 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
    }
  }

  if (!live) return;
  T* ob = static_cast<T*>(p.o) + static_cast<long long>(b) * p.K1 * p.Hq * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + RG * i;
    if (r >= n_live || !d_on) continue;
    const int j = (t0 + r) / G, g = (t0 + r) % G;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      ob[(static_cast<long long>(j) * p.Hq + hk * G + g) * D + cl + CL * e] =
          from_f32<T>(acc[i][e] * inv);
  }
}

template <typename T, typename P, int D, int RG, int RPT>
cudaError_t launch(const PvParams& p, int B, cudaStream_t stream) {
  constexpr size_t smem = pv_smem_bytes<D, RG, RPT>();
  cudaError_t err = cudaFuncSetAttribute(
      pv_kernel<T, P, D, RG, RPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr int R = RG * RPT;
  const int pairs = p.K1 * (p.Hq / p.Hkv);
  const dim3 grid(p.Hkv, B, (pairs + R - 1) / R);
  pv_kernel<T, P, D, RG, RPT><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename P, int D>
cudaError_t launch_tile(const PvParams& p, int B, cudaStream_t stream) {
  // verify windows (<= 32 pairs): tiles of 8; suffix prefill: 64
  if (p.K1 * (p.Hq / p.Hkv) <= 32) return launch<T, P, D, 8, 1>(p, B, stream);
  return launch<T, P, D, 16, 4>(p, B, stream);
}

template <typename T, typename P>
cudaError_t dispatch_d(const PvParams& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_tile<T, P, 16>(p, B, stream);
    case 32: return launch_tile<T, P, 32>(p, B, stream);
    case 64: return launch_tile<T, P, 64>(p, B, stream);
    case 128: return launch_tile<T, P, 128>(p, B, stream);
    case 256: return launch_tile<T, P, 256>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Payload code: the query type's own code (a float pool), kI8 or kFP8.
template <typename T>
cudaError_t dispatch(const PvParams& p, int pdtype, int B, int D,
                     cudaStream_t stream) {
  if (pdtype == repro::kI8) return dispatch_d<T, int8_t>(p, B, D, stream);
  if (pdtype == repro::kFP8)
    return dispatch_d<T, __nv_fp8_e4m3>(p, B, D, stream);
  return dispatch_d<T, T>(p, B, D, stream);
}

}  // namespace

// C entry point (loaded with ctypes by repro_torch/kernels/
// paged_attention.py). All tensors contiguous, the pools 16-byte
// aligned; block_table and lengths int32; k_scale / v_scale (NB, BS,
// Hkv) f32 when pdtype is kI8 or kFP8 (else unused). Returns the
// launch's cudaGetLastError() code.
extern "C" int repro_paged_verify_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_table,
    const void* lengths, void* o, int dtype, int pdtype, int B, int K1,
    int Hq, int Hkv, int D, int BS, int nbmax, int window, float scale,
    void* stream) {
  const bool quant = pdtype == repro::kI8 || pdtype == repro::kFP8;
  if (quant ? (k_scale == nullptr || v_scale == nullptr) : pdtype != dtype)
    return static_cast<int>(cudaErrorInvalidValue);
  PvParams p;
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.block_table = static_cast<const int*>(block_table);
  p.lengths = static_cast<const int*>(lengths);
  p.o = o;
  p.K1 = K1;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.BS = BS;
  p.nbmax = nbmax;
  p.window = window;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == repro::kBF16
                        ? dispatch<__nv_bfloat16>(p, pdtype, B, D, s)
                        : dispatch<float>(p, pdtype, B, D, s);
  return static_cast<int>(err);
}
