// K1: blocked online-softmax (flash) attention for prefill.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas
// (body _fa_kernel). Same function: q (B, Hq, Sq, D) attends k/v
// (B, Hkv, Skv, D) with GQA head map h -> h / (Hq / Hkv), key masks
// kpos < Skv, optional causal (kpos <= qpos) and optional window
// (kpos > qpos - window), f32 running (max, sum, acc), a row with no
// visible key gives 0. Output (B, Hq, Sq, D) in q's type. When asked
// (a non-null lse pointer: the training forward), both bodies also write
// each row's f32 log-sum-exp of its scaled scores, (B, Hq, Sq), -inf for
// a row that sees no key; the backward pass (flash_attention_bwd.cu)
// recomputes the probabilities from it. Serving passes null and writes
// nothing more.
//
// What bounds it on the H100: 4 * D flops per visible (q, k) pair
// against 2 bytes per element of q, k, v and the output, each read or
// written once. At the main path's prefill, (8, 16/16, 512, 128) causal,
// that is 8.6 GFLOP against 67 MB: the bytes bound it (0.020 ms at 3.35
// TB/s against 0.0087 ms at the tensor cores' 989 TFLOP/s), and shorter
// rows are more so. Long rows are bound by operations: recurrentgemma's
// (2, 10/1, 2560, 256) with its 2048-key window is 64 GFLOP, 0.065 ms.
// Either way the CUDA cores' 67 TFLOP/s f32 put the products 15x away
// from the tensor cores, so the bf16 path needs wgmma to come near
// either bound.
//
// Two bodies, chosen by the wrapper from the shape before the launch:
//   * wgmma (bf16; D a multiple of 8 up to 256; q, k, v strides
//     multiples of 8 elements with a contiguous head dim; 16-byte aligned
//     bases). A FlashAttention-3-style forward: a CTA holds BQ = 128 query
//     rows (two consumer warpgroups of 64) at D <= 128, or 64 rows (one
//     warpgroup: a 64 x 256 f32 O tile is 128 registers a thread) at D 256.
//     Q of one (b, h) is loaded once by TMA; a producer warp streams K and
//     V tiles of 128 keys (64 at D 256) into a 2-stage ring with full /
//     empty mbarriers.
//     S = Q K^T runs as wgmma from shared memory (K a K-major B); scale and
//     log2(e) multiply S in f32, the online softmax runs on the
//     accumulator fragments (row max and sum across the 4 lanes that share
//     a row, exp2f), and P, converted to bf16 in registers, is the register
//     A operand of O += P V (V an MN-major B through the transpose bit).
//     O stays in f32 registers; the epilogue divides by l and stores
//     masked. q, k and v are read through their strides by 4-D tensor maps
//     over (D, S, H, B), so the transposed (B, S, H, D) projections need no
//     copy and GQA / MQA reads the shared kv head in place. D below the
//     tile width (120 in 128, 16..64 in 64) is covered by TMA's zero fill:
//     those lanes add nothing to q.k and are never stored; ragged Sq and
//     Skv likewise load zeros, keys past Skv are masked.
//   * simt (f32, and bf16 calls TMA cannot describe): the CUDA cores in
//     f32. One CTA per (BQ-row q tile, b * Hq), q tile in shared memory,
//     k/v tiles of 64 keys staged as f32 (k transposed, padded strides) so
//     the RPT x 4 score and RPT x (DP/16) output register blocks of each
//     thread read without bank conflicts. Template width DP 16, 32, 64,
//     128 or 256 with the logical D (<= DP) a runtime value; DP = 256 takes
//     BQ = 32 rows (173,312 B of shared memory, 64 accumulators a thread).
//     f32 stays here: TF32 or bf16 products would break the f32 parity of
//     the cuda and cpu engines.
// Both bodies skip kv tiles entirely past the causal diagonal or outside
// the window before any load (the predicate of _fa_kernel) and mask keys
// inside the diagonal tiles.
// Left for later: a persistent grid, deeper warp specialisation
// (setmaxnreg: two consumer warpgroups at D 256 spill without it),
// overlapping the softmax of one tile with the products of the next
// (ping-pong warpgroups, intra-warpgroup pipelining), fp8 operands,
// clusters that multicast a shared K / V tile to the query tiles of one
// head.

#include <math_constants.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::from_f32;
using repro::kMaskValue;
using repro::to_f32;

constexpr int BK = 64;           // keys per kv tile
constexpr int THREADS = 128;     // 8 row groups x 16 column lanes
constexpr int KPT = BK / 16;     // keys per thread (cl, cl + 16, ...)

// Query rows per CTA for template width DP (see the head-dim note).
template <int DP>
constexpr int kBlockQ = DP > 128 ? 32 : 64;

struct FaParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                    // (B, Hq, Sq) or null
  int Hq, Sq, Skv, group, D;     // D: logical head dim (<= DP)
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int causal, window;
  float scale;
};

template <int DP>
constexpr size_t fa_smem_bytes() {
  constexpr int BQ = kBlockQ<DP>;
  return sizeof(float) *
         (BQ * (DP + 1) + DP * (BK + 1) + BK * DP + BQ * (BK + 1));
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS) fa_kernel(FaParams p) {
  constexpr int BQ = kBlockQ<DP>;
  constexpr int RPT = BQ / 8;    // query rows per thread
  constexpr int DPT = DP / 16;   // output dims per thread (cl + 16 * e)
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BQ][DP + 1]
  float* Kt = Qs + BQ * (DP + 1);         // [DP][BK + 1]  (k transposed)
  float* Vs = Kt + DP * (BK + 1);         // [BK][DP]
  float* Ps = Vs + BK * DP;               // [BQ][BK + 1]
  const int D = p.D;

  const int tid = threadIdx.x;
  const int rg = tid / 16;
  const int cl = tid % 16;
  const int b = blockIdx.y / p.Hq;
  const int h = blockIdx.y % p.Hq;
  const int hk = h / p.group;
  const int q_lo = blockIdx.x * BQ;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int idx = tid; idx < BQ * DP; idx += THREADS) {
    const int r = idx / DP, d = idx % DP;
    const int qp = q_lo + r;
    Qs[r * (DP + 1) + d] =
        qp < p.Sq && d < D ? to_f32(q[qp * p.q_ss + d]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  const int q_hi = min(q_lo + BQ, p.Sq) - 1;
  const int nk = (p.Skv + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k_lo = kt * BK;
    // Tile skip (uniform over the CTA): past the causal diagonal every
    // later tile is too; outside the window only this one.
    if (p.causal && k_lo > q_hi) break;
    if (p.window > 0 && k_lo + BK - 1 <= q_lo - p.window) continue;

    __syncthreads();   // previous tile fully consumed (and Qs written)
    for (int idx = tid; idx < BK * DP; idx += THREADS) {
      const int j = idx / DP, d = idx % DP;
      const int kp = k_lo + j;
      const bool in = kp < p.Skv && d < D;
      Kt[d * (BK + 1) + j] = in ? to_f32(k[kp * p.k_ss + d]) : 0.f;
      Vs[j * DP + d] = in ? to_f32(v[kp * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int u = 0; u < KPT; ++u) s[i][u] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(rg * RPT + i) * (DP + 1) + d];
#pragma unroll
      for (int u = 0; u < KPT; ++u) kv[u] = Kt[d * (BK + 1) + cl + 16 * u];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int u = 0; u < KPT; ++u) s[i][u] = fmaf(qv[i], kv[u], s[i][u]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q_lo + rg * RPT + i;
      float mx = kMaskValue;
#pragma unroll
      for (int u = 0; u < KPT; ++u) {
        const int kpos = k_lo + cl + 16 * u;
        bool valid = kpos < p.Skv;
        if (p.causal) valid = valid && kpos <= qpos;
        if (p.window > 0) valid = valid && kpos > qpos - p.window;
        s[i][u] = valid ? s[i][u] * p.scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][u]);
      }
      // the 16 lanes sharing these rows are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < KPT; ++u) {
        const float pr = expf(s[i][u] - m_new);   // masked: exp(-inf) = 0
        Ps[(rg * RPT + i) * (BK + 1) + cl + 16 * u] = pr;
        sum += pr;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= corr;
    }
    __syncthreads();   // Ps complete

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(rg * RPT + i) * (BK + 1) + j];
#pragma unroll
      for (int e = 0; e < DPT; ++e) vv[e] = Vs[j * DP + cl + 16 * e];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
    }
  }

  T* o = static_cast<T*>(p.o) + static_cast<long long>(blockIdx.y) * p.Sq * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qp = q_lo + rg * RPT + i;
    if (qp >= p.Sq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    if (p.lse != nullptr && cl == 0)
      p.lse[static_cast<long long>(blockIdx.y) * p.Sq + qp] =
          l[i] == 0.f ? -CUDART_INF_F : m[i] + logf(l[i]);
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      if (cl + 16 * e < D)
        o[static_cast<long long>(qp) * D + cl + 16 * e] =
            from_f32<T>(acc[i][e] * inv);
  }
}

template <typename T, int DP>
cudaError_t launch(const FaParams& p, int B, cudaStream_t stream) {
  constexpr int BQ = kBlockQ<DP>;
  constexpr size_t smem = fa_smem_bytes<DP>();
  static_assert(smem <= 232448, "K1 tile exceeds the H100's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, B * p.Hq);
  fa_kernel<T, DP><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The narrowest template width that holds the logical head dim.
template <typename T>
cudaError_t dispatch(const FaParams& p, int B, cudaStream_t stream) {
  if (p.D < 1) return cudaErrorInvalidValue;
  if (p.D <= 16) return launch<T, 16>(p, B, stream);
  if (p.D <= 32) return launch<T, 32>(p, B, stream);
  if (p.D <= 64) return launch<T, 64>(p, B, stream);
  if (p.D <= 128) return launch<T, 128>(p, B, stream);
  if (p.D <= 256) return launch<T, 256>(p, B, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// wgmma body (bf16)
// ---------------------------------------------------------------------------

namespace tc {

// Tile geometry for template width DP (64, 128 or 256 lanes of D).
template <int DP>
struct Cfg {
  static constexpr int NWG = DP > 128 ? 1 : 2;    // consumer warpgroups
  static constexpr int BQ = 64 * NWG;             // query rows a CTA
  static constexpr int BKV = DP > 128 ? 64 : 128; // keys a kv tile
  static constexpr int STAGES = 2;
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
  // every tile is DP / 64 column boxes of (rows x 128 B), 128B-swizzled
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BKV * DP * 2;   // K or V of one stage
  static constexpr size_t SMEM = Q_BYTES + STAGES * 2 * KV_BYTES + 1024;
};

// The wgmma body's own parameter block: only what the kernel reads (the
// maps carry pointers and strides). Passing FaParams itself, with the
// scale folded in the kernel, ran measurably slower on the card.
struct TcParams {
  __nv_bfloat16* o;
  float* lse;                                     // (B, Hq, Sq) or null
  int Hq, Sq, Skv, group, D, causal, window;
  float scale_log2;                               // scale * log2(e)
};

template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::THREADS, 1)
    fa_wgmma(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, TcParams p) {
  using C = Cfg<DP>;
  namespace hw = repro::hopper;
  constexpr int BKV = C::BKV;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full, full[C::STAGES], empty[C::STAGES];
  uint8_t* smem = smem_raw + ((1024 - (hw::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* KVs = smem + C::Q_BYTES;

  const int b = blockIdx.y / p.Hq, h = blockIdx.y % p.Hq, hk = h / p.group;
  // the longest causal rows first, so the short tiles fill the last wave
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * C::BQ;
  const int q_hi = min(q_lo + C::BQ, p.Sq) - 1;
  // the kv tiles [kt_lo, kt_hi) this q tile sees: past the causal diagonal
  // and wholly outside the window are skipped before any load
  int kt_hi = (p.Skv + BKV - 1) / BKV;
  if (p.causal) kt_hi = min(kt_hi, q_hi / BKV + 1);
  const int kt_lo = p.window > 0 ? max(0, (q_lo - p.window + 1) / BKV) : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hw::mbar_init(&q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], C::CONSUMERS);
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  if (warp == C::CONSUMERS / 32) {
    // producer: Q once, then K and V tiles through the ring
    if (lane == 0) {
      hw::mbar_arrive_expect_tx(&q_full, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c)
        hw::tma_load_4d(Qs + c * C::BQ * 128, &qmap, &q_full, 64 * c, q_lo, h,
                        b);
      for (int kt = kt_lo, it = 0; kt < kt_hi; ++kt, ++it) {
        const int s = it % C::STAGES;
        if (it >= C::STAGES)
          hw::mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
        uint8_t* ks = KVs + s * 2 * C::KV_BYTES;
        hw::mbar_arrive_expect_tx(&full[s], 2 * C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c) {
          hw::tma_load_4d(ks + c * BKV * 128, &kmap, &full[s], 64 * c,
                          kt * BKV, hk, b);
          hw::tma_load_4d(ks + C::KV_BYTES + c * BKV * 128, &vmap, &full[s],
                          64 * c, kt * BKV, hk, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q_lo + 64 wg .. + 63; this
  // thread rows r0 and r0 + 8 (the accumulator fragment layout)
  const int wg = warp / 4;
  const int r0 = q_lo + wg * 64 + (warp % 4) * 16 + lane / 4;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
  hw::mbar_wait(&q_full, 0);

  for (int kt = kt_lo, it = 0; kt < kt_hi; ++kt, ++it) {
    const int s = it % C::STAGES;
    const int k_lo = kt * BKV;
    const uint8_t* ks = KVs + s * 2 * C::KV_BYTES;
    const uint8_t* vs = ks + C::KV_BYTES;
    hw::mbar_wait(&full[s], (it / C::STAGES) & 1);

    // S = Q K^T over DP / 16 k16 steps (both K-major)
    float sc[BKV / 2];
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t a = hw::sw128_desc(
          Qs + (kk / 4) * C::BQ * 128 + wg * 64 * 128 + (kk % 4) * 32, 16,
          1024);
      const uint64_t bk =
          hw::sw128_desc(ks + (kk / 4) * BKV * 128 + (kk % 4) * 32, 16, 1024);
      hw::Wgmma<BKV>::template ss<0>(sc, a, bk, kk > 0);
    }
    hw::wgmma_commit();
    hw::wgmma_wait();
    hw::fence_regs(sc);

    // online softmax on the fragments, in the log2 domain
    const bool edge = k_lo + BKV > p.Skv ||
                      (p.causal && k_lo + BKV - 1 > q_lo) ||
                      (p.window > 0 && k_lo <= q_hi - p.window);
    float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float x = sc[4 * n + 2 * i + j] * p.scale_log2;
          if (edge) {
            const int kpos = k_lo + 8 * n + 2 * (lane % 4) + j;
            const int qpos = r0 + 8 * i;
            bool valid = kpos < p.Skv;
            if (p.causal) valid = valid && kpos <= qpos;
            if (p.window > 0) valid = valid && kpos > qpos - p.window;
            if (!valid) x = -CUDART_INF_F;
          }
          sc[4 * n + 2 * i + j] = x;
          mx[i] = fmaxf(mx[i], x);
        }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float pr = exp2f(sc[4 * n + 2 * i + j] - m[i]);  // masked: 0
          sc[4 * n + 2 * i + j] = pr;
          l[i] += pr;                       // this thread's share of the row
        }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[4 * n + 2 * i] *= corr[i];
        o[4 * n + 2 * i + 1] *= corr[i];
      }

    // O += P V: P as bf16 register A fragments (same layout as S's)
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = hw::pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    hw::fence_regs(o);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint64_t bv = hw::sw128_desc(vs + kk * 16 * 128, BKV * 128, 1024);
      hw::Wgmma<DP>::template rs<1>(o, pa[kk], bv, 1);
    }
    hw::wgmma_commit();
    hw::wgmma_wait();
    hw::fence_regs(o);
    hw::mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* out =
      p.o + static_cast<long long>(blockIdx.y) * p.Sq * p.D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int qpos = r0 + 8 * i;
    if (qpos >= p.Sq) continue;
    const float inv = 1.f / (li == 0.f ? 1.f : li);
    // m is in the log2 domain: ln(sum e^s) = (m + log2(l)) ln 2
    if (p.lse != nullptr && lane % 4 == 0)
      p.lse[static_cast<long long>(blockIdx.y) * p.Sq + qpos] =
          li == 0.f ? -CUDART_INF_F
                    : (m[i] + log2f(li)) * 0.6931471805599453f;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = 8 * n + 2 * (lane % 4);     // D % 8 == 0: both or none
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<long long>(qpos) * p.D + col) =
            __floats2bfloat162_rn(o[4 * n + 2 * i] * inv,
                                  o[4 * n + 2 * i + 1] * inv);
    }
  }
}

template <int DP>
cudaError_t launch(const FaParams& p, int B, int Hkv, cudaStream_t stream) {
  using C = Cfg<DP>;
  namespace hw = repro::hopper;
  CUtensorMap qmap, kmap, vmap;
  const uint64_t D = p.D;
  const uint64_t qdims[4] = {D, static_cast<uint64_t>(p.Sq),
                             static_cast<uint64_t>(p.Hq),
                             static_cast<uint64_t>(B)};
  const uint64_t kdims[4] = {D, static_cast<uint64_t>(p.Skv),
                             static_cast<uint64_t>(Hkv),
                             static_cast<uint64_t>(B)};
  const uint64_t qst[3] = {2ull * p.q_ss, 2ull * p.q_sh, 2ull * p.q_sb};
  const uint64_t kst[3] = {2ull * p.k_ss, 2ull * p.k_sh, 2ull * p.k_sb};
  const uint64_t vst[3] = {2ull * p.v_ss, 2ull * p.v_sh, 2ull * p.v_sb};
  const uint32_t qbox[4] = {64, C::BQ, 1, 1};
  const uint32_t kbox[4] = {64, C::BKV, 1, 1};
  if (!hw::make_bf16_map(&qmap, p.q, 4, qdims, qst, qbox) ||
      !hw::make_bf16_map(&kmap, p.k, 4, kdims, kst, kbox) ||
      !hw::make_bf16_map(&vmap, p.v, 4, kdims, vst, kbox))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fa_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + C::BQ - 1) / C::BQ, B * p.Hq);
  TcParams tp;
  tp.o = static_cast<__nv_bfloat16*>(p.o);
  tp.lse = p.lse;
  tp.Hq = p.Hq;
  tp.Sq = p.Sq;
  tp.Skv = p.Skv;
  tp.group = p.group;
  tp.D = p.D;
  tp.causal = p.causal;
  tp.window = p.window;
  tp.scale_log2 = p.scale * 1.4426950408889634f;
  fa_wgmma<DP><<<grid, C::THREADS, C::SMEM, stream>>>(qmap, kmap, vmap, tp);
  return cudaGetLastError();
}

// What the wgmma body takes (the wrapper's rule, checked again here so a
// wrong request is refused, never rerouted).
bool takes(const FaParams& p, int dtype) {
  const long long st[9] = {p.q_sb, p.q_sh, p.q_ss, p.k_sb, p.k_sh,
                           p.k_ss, p.v_sb, p.v_sh, p.v_ss};
  for (long long x : st)
    if (x % 8 != 0 || x <= 0) return false;
  const void* bases[3] = {p.q, p.k, p.v};
  for (const void* ptr : bases)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  return dtype == repro::kBF16 && p.D % 8 == 0 && p.D <= 256;
}

cudaError_t dispatch(const FaParams& p, int B, int Hkv, cudaStream_t stream) {
  if (p.D <= 64) return launch<64>(p, B, Hkv, stream);
  if (p.D <= 128) return launch<128>(p, B, Hkv, stream);
  return launch<256>(p, B, Hkv, stream);
}

}  // namespace tc

}  // namespace

// C entry point (loaded with ctypes by repro_torch/kernels/
// flash_attention.py). Strides are in elements; the head dim is
// contiguous. lse: null, or an f32 (B, Hq, Sq) output for each row's
// log-sum-exp (the training forward). body: 0 runs the SIMT body, 1 the
// wgmma body (bf16, D a multiple of 8 up to 256, every stride a
// positive multiple of 8, 16-byte aligned bases; anything else is
// refused with cudaErrorInvalidValue, never rerouted). Returns the
// launch's cudaGetLastError() code.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int B,
    int Hq, int Hkv, int Sq, int Skv, int D, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, int causal, int window,
    float scale, int body, void* stream) {
  FaParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.Hq = Hq;
  p.Sq = Sq;
  p.Skv = Skv;
  p.group = Hq / Hkv;
  p.D = D;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1)
    return static_cast<int>(tc::takes(p, dtype)
                                ? tc::dispatch(p, B, Hkv, s)
                                : cudaErrorInvalidValue);
  if (body != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = dtype == repro::kBF16
                        ? dispatch<__nv_bfloat16>(p, B, s)
                        : dispatch<float>(p, B, s);
  return static_cast<int>(err);
}
