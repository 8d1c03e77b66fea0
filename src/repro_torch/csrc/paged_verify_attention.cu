// K3: multi-query attention over the block-paged KV pool (speculative
// verify and suffix prefill), and K4 inside it (an int8 / fp8 pool).
//
// Replaces repro/kernels/paged_attention.py::paged_verify_attention_pallas
// (body _pv_kernel). Same function: q (B, K1, Hq, D) holds K1 query rows
// per sequence at positions lengths[b] + j; k/v pools are (NB, BS, Hkv,
// D); logical block i of sequence b lives in block_table[b, i]. lengths
// counts the tokens cached BEFORE the window (K2's counts the current
// token too). Row j sees keys kpos < lengths[b] + 1 + j and, with a
// window, kpos >= that limit - window; positions past the table (nbmax *
// BS) do not exist. f32 online softmax, a row that sees no key gives 0.
// Output (B, K1, Hq, D). K4 (JAX's _dequant inside _pv_kernel): an int8
// or fp8 (e4m3) payload times f32 per-(token, kv head) scales, the
// dequantized rows existing only on chip.
//
// What bounds it on the H100, in its two regimes on the main path:
//   * the verify step (K1 = spec_tokens + 1, 5; (row, group) pairs of a
//     kv head K1 * G = 5 to 20): bytes. Every visible K/V row is read
//     once for all pairs of its kv head, the TPU kernel's point; that is
//     2 * 2 * D bytes against 4 * D * pairs flops a token, under the ~295
//     flop/byte where the tensor cores would take over. The first design
//     (one CTA a (kv head, sequence) walking the whole context, 128 CTAs
//     on 132 SMs, 5 of 8 warps busy) ran at 0.29 TB/s of 3.35;
//   * the suffix prefill of a partial prefix hit (K1 = the suffix bucket
//     W, 32..max_len): operations, 4 D flops a (pair, key), 6.45 GFLOP at
//     the main path's (8, 256, 16/16, 128) over a 256-token prefix. On the
//     CUDA cores in f32 that is 15x from the tensor cores' bf16 rate.
// Three bodies, chosen by the wrapper from shapes and dtypes alone
// (kernels/paged_attention.py verify_body; never from lengths, so a
// captured CUDA graph replays for any lengths and table):
//   * split (fewer than 32 pairs, any q type and payload;
//     paged_verify_split.cuh): flash-decoding on K2's machinery. K2's plan
//     (split_plan, shapes only) cuts the keys into nsplit splits of bps
//     blocks, grid (Hkv, B, nsplit): 1280 CTAs at the main path's verify
//     where the first design had 128. A CTA reads its split's visible
//     table entries into shared memory first, then streams 32-token K/V
//     tiles through a ring of 16-byte cp.async copies (scales by 4-byte
//     copies), each tile read once for all pairs: pair r is row r / 4 of
//     warp r % 4 (2 or 8 rows a warp), its q row in shared memory in f32.
//     Scores run lane per token (K rows padded by 16 bytes, so a
//     quarter-warp's 16-byte reads hit distinct banks), the products lane
//     per head-dim slice with each row's probability by shuffle; K4's key
//     scale multiplies the score, its value scale the probability. The
//     math stays f32 on the CUDA cores (f32 verify within 1e-4, cuda ==
//     cpu tokens in the parity runs). A split's key range is clipped at
//     min(len + K1, nbmax * BS) and at row 0's floor; each row masks its
//     own limit and floor. Each split writes (m, l, acc) for every pair to
//     scratch and K2's combine kernel (paged_attention.cu), launched next
//     by the same C call, merges them over the B * K1 * Hq rows; with one
//     split the kernel normalises and writes the output itself;
//   * wgmma (bf16 q over a bf16, int8 or fp8 pool; D a multiple of 16 up
//     to 256; BS a multiple of 8 that divides 64 or is a multiple of it;
//     a table of at most 1024 entries; paged_verify_wgmma.cuh): a
//     FlashAttention-3-style forward on the tensor cores from K1's
//     blocks (hopper.cuh). A CTA holds BQ = 128 pairs (two consumer
//     warpgroups; 64 at D 256) of one (kv head, sequence), grid
//     (ceil(K1 G / BQ), Hkv, B): 256 CTAs at the main path's suffix, no
//     split. Q is loaded once with 16-byte loads into the 128B-swizzled
//     layout (the (j, g) pairs of G > 1 are no 2-D box of q). Over a bf16
//     pool a producer warp TMA-loads each 64-key K/V tile block by block
//     from the pool through a 4-D map over (D, Hkv, BS, NB) with box (64,
//     1, min(BS, 64), 1) per 128-byte column, one lane a box, from the
//     table entries staged in shared memory; a box no row sees loads from
//     block NB, past the map, as zeros. S = Q K^T and O += P V run as
//     wgmma m64nNk16 with f32 accumulators, P rounded to bf16 in
//     registers. The limit len + 1 + j is a causal diagonal shifted by
//     len: tiles past every limit or below every floor are never loaded,
//     tiles inside all of them run unmasked, the rest mask per element.
//     K4 here: TMA cannot dequantize, so the consumers stream payload
//     rows and scales by cp.async into a two-stage staging ring, multiply
//     each element by its scale, round to bf16 and write the swizzled
//     layout wgmma reads, then fence.proxy.async before the first wgmma
//     on the tile;
//   * simt (everything else: f32 suffix prefill, block sizes no tensor
//     map tiles, e.g. 6): the first design, below, unchanged. A CTA of 8
//     warps serves R pairs of one (sequence, kv head), grid (Hkv, B,
//     ceil(K1 G / R)), R = 8 up to 32 pairs and 64 past them; it walks
//     keys from the lowest floor to the highest limit of its pairs, 64 at
//     a time, gathering each tile with 16-byte loads into registers while
//     the previous one is computed, staged in shared memory as f32 (K
//     transposed); K4 multiplies the scale in as the tile is unpacked.
// No body dereferences a table entry of a block that no row of its CTA
// can see. A request a body cannot take is refused (cudaErrorInvalidValue,
// the wrapper raises), never rerouted to another body.
// The split and wgmma bodies are built one (query type, payload) pair a
// file (paged_verify_<t>_<p>.cu); this file holds the simt body and the
// C entry point.

#include <math_constants.h>

#include <climits>

#include "paged_verify_attention.cuh"

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
  const float* k_scale;          // (NB, BS, Hkp), quantized pools only
  const float* v_scale;
  const int* block_table;
  const int* lengths;
  void* o;
  int K1, Hq, Hkv, Hkp, BS, nbmax, window;   // Hkp: the pool's kv heads
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
                                          const int* table, int BS, int Hkp,
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
        ks[n] = ksp[trow * Hkp];
        vs[n] = vsp[trow * Hkp];
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
  const long long tok = static_cast<long long>(p.Hkp) * D;   // token stride
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
                         p.Hkp, tok, lo, hi);
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
                           p.Hkp, tok, k0 + BK, hi);
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

// The split body's instance for payload code pdtype (the query type's
// own code, kI8 or kFP8).
template <typename T>
cudaError_t split_dispatch(const repro::PvsParams& p, int pdtype, int B,
                           int D, cudaStream_t stream) {
  if (pdtype == repro::kI8)
    return repro::launch_pv_split<T, int8_t>(p, B, D, stream);
  if (pdtype == repro::kFP8)
    return repro::launch_pv_split<T, __nv_fp8_e4m3>(p, B, D, stream);
  return repro::launch_pv_split<T, T>(p, B, D, stream);
}

}  // namespace

// C entry point (loaded with ctypes by repro_torch/kernels/
// paged_attention.py). All tensors contiguous, the pools 16-byte
// aligned; block_table and lengths int32; k_scale / v_scale (NB, BS,
// Hkp) f32 when pdtype is kI8 or kFP8 (else unused). The pools hold Hkp
// kv heads, of which the call reads [kv_lo, kv_lo + Hkv) (common.cuh
// kv_range; the whole pool: kv_lo 0, Hkp = Hkv). body: 0 simt, 1
// wgmma, 2 split (the wrapper's verify_body). The split plan (body 2):
// bps blocks a split, nsplit splits covering the table (nsplit * bps >=
// nbmax); with nsplit > 1, ``scratch`` holds B * K1 * Hq * nsplit * (D +
// 2) f32: the splits' acc (B, K1, Hq, nsplit, D), then m and l (B, K1,
// Hq, nsplit), which K2's combine kernel, launched next on the same
// stream, merges into o. Returns the first non-zero cudaGetLastError()
// of its launches, each checked as it is made.
extern "C" int repro_paged_verify_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_table,
    const void* lengths, void* o, void* scratch, int dtype, int pdtype,
    int B, int K1, int Hq, int Hkv, int D, int BS, int NB, int nbmax,
    int window, float scale, int body, int bps, int nsplit, int kv_lo,
    int Hkp, void* stream) {
  const bool quant = pdtype == repro::kI8 || pdtype == repro::kFP8;
  if (quant ? (k_scale == nullptr || v_scale == nullptr) : pdtype != dtype)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Hkv < 1 || Hq % Hkv != 0 ||
      !repro::kv_range(k_pool, v_pool, k_scale, v_scale, pdtype, D, kv_lo,
                       Hkv, Hkp))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == repro::kBF16;
  if (body == 0) {
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
    p.Hkp = Hkp;
    p.BS = BS;
    p.nbmax = nbmax;
    p.window = window;
    p.scale = scale;
    return static_cast<int>(bf16 ? dispatch<__nv_bfloat16>(p, pdtype, B, D, s)
                                 : dispatch<float>(p, pdtype, B, D, s));
  }
  repro::PvsParams p;
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.block_table = static_cast<const int*>(block_table);
  p.lengths = static_cast<const int*>(lengths);
  p.o = o;
  p.m = p.l = p.acc = nullptr;
  p.K1 = K1;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Hkp = Hkp;
  p.D = D;
  p.BS = BS;
  p.NB = NB;
  p.nbmax = nbmax;
  p.window = window;
  p.bps = bps;
  p.nsplit = nsplit;
  p.scale = scale;
  if (body == 1) {                 // bf16 queries only
    if (!bf16) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err =
        pdtype == repro::kI8    ? repro::launch_pv_wgmma<int8_t>(p, B, D, s)
        : pdtype == repro::kFP8 ? repro::launch_pv_wgmma<__nv_fp8_e4m3>(
                                      p, B, D, s)
                                : repro::launch_pv_wgmma<__nv_bfloat16>(
                                      p, B, D, s);
    return static_cast<int>(err);
  }
  if (body != 2 || bps < 1 || bps > repro::kPvMaxSplitBlocks || nsplit < 1 ||
      nsplit > 65535 || static_cast<long long>(nsplit) * bps < nbmax ||
      (nsplit > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long parts = static_cast<long long>(B) * K1 * Hq * nsplit;
  float* acc = static_cast<float*>(scratch);
  if (nsplit > 1) {
    p.acc = acc;
    p.m = acc + parts * D;
    p.l = acc + parts * (D + 1);
  }
  cudaError_t err = bf16 ? split_dispatch<__nv_bfloat16>(p, pdtype, B, D, s)
                         : split_dispatch<float>(p, pdtype, B, D, s);
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  return repro_paged_decode_combine(p.m, p.l, acc, o, dtype, B * K1 * Hq,
                                    nsplit, D, stream);
}
