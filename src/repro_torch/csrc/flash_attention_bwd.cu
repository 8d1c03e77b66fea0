// K1's backward: dQ, dK and dV of blocked (flash) attention.
//
// Replaces no Pallas kernel: the JAX package has no custom_vjp and trains
// through the jnp oracle (its trainer runs RunCtx(kernel_mode="ref")), so
// XLA differentiates repro/kernels/ref.py::flash_attention. On the card
// the forward is K1 (flash_attention.cu), whose output carries no
// gradient, so this kernel is what lets a loss reach q, k and v. Its
// contract is repro_torch/kernels/ref.py::flash_attention_bwd, the same
// formulas in torch, which the tests hold against jax.vjp of the oracle.
//
// FlashAttention-2's backward, from q, k, v, the forward's output O, the
// output gradient dO and the forward's per-row log-sum-exp lse (K1 writes
// it when asked):
//   delta_i = sum_d dO_id O_id                           (prep_kernel)
//   P_ij    = exp(S_ij scale - lse_i), S = Q K^T, 0 where masked or the
//             row sees no key (lse = -inf)
//   dV_j   += sum_i P_ij dO_i,  dS_ij = P_ij (dO_i . V_j - delta_i)
//   dK_j   += sum_i dS_ij Q_i scale                       (dkdv_kernel)
//   dQ_i    = sum_j dS_ij K_j scale                         (dq_kernel)
// with the masks of the forward (kpos < Skv, causal kpos <= qpos, window
// kpos > qpos - window). The dK / dV kernel runs one CTA per (batch, kv
// head, block of keys) and loops over the query blocks and the Hq / Hkv
// query heads of its GQA group in a fixed order, so the group's sum stays
// in registers: no atomics, and the result does not depend on the
// schedule (a resumed training run repeats its losses bit for bit). The
// dQ kernel runs one CTA per (batch, query head, block of queries) and
// loops over the key blocks; it recomputes S and dP rather than adding
// dQ with f32 atomics from the dK / dV kernel (FlashAttention-3's way),
// which would make the bits depend on the schedule. Both skip the blocks
// the causal and window masks empty before any load, as K1's forward
// does. Every sum is in f32, the gradients are rounded to the inputs'
// type on store.
//
// What bounds it on the H100: the five products of FlashAttention-2's
// backward, 10 D flops a visible (q, k) pair (2.5x the forward's four),
// against q, k, v, O, dO, lse, dQ, dK and dV moved once each. At olmo_1b's
// training shape, (4, 16/16, 2048, 128) causal bf16, that is 172 GFLOP
// against 0.27 GB: operations bind it (0.17 ms at the tensor cores' 989
// TFLOP/s, against 0.08 ms for the bytes). Keeping dQ in its own kernel
// costs 14 D flops a pair (S and dP twice), a floor 1.4x the bound.
//
// Two bodies, chosen by the wrapper from the inputs before the launch
// (flash_attention.bwd_body), the same rule as K1's forward:
//   * wgmma (bf16; D a multiple of 8 up to 256; q, k, v strides multiples
//     of 8 elements with a contiguous head dim; 16-byte aligned bases): a
//     FlashAttention-3-style body on Hopper's tensor cores. A CTA is two
//     warpgroups (eight warps: a ninth, a producer warp, would put three
//     warps on one of the SM's four register files and cap every thread
//     at 168 registers; ptxas then spilled dK / dV, with setmaxnreg too).
//     Thread 0 feeds TMA tiles through full / empty mbarrier rings, each
//     load STAGES - 1 tiles ahead, once the tile before it in that stage
//     is released (one arrival a warp). q, k and v are read through 4-D
//     tensor maps over (D, S, H, B), so the transposed (B, S, H, D)
//     projections need no copy; D below the tile width (120 in 128, 8..64
//     in 64) loads as zeros and is never stored. A pre-pass (prep_kernel)
//     writes delta and the lse in the log2 domain, padded to 64-row tiles,
//     so that a tile's rows ride on its barrier as one bulk copy.
//     - dK / dV (dkdv_wgmma): K and V of 128 keys load once; each
//       warpgroup owns 64 of them. Q and dO tiles of 64 query rows stream
//       through a 3-stage ring with their rows' lse and delta. S^T = K Q^T
//       and dP^T = V dO^T run from shared memory (ss); P^T = exp2(S^T
//       scale log2e - lse log2e) is computed on the accumulator fragments
//       while dP^T runs (the masks only on a tile that crosses one), then
//       dS^T = P^T (dP^T - delta). Both go back to shared memory as bf16
//       A tiles for dV += P^T dO and dK += dS^T Q (ss; dO and Q MN-major B
//       tiles through the transpose bit), which are left running into the
//       next tile. (The register-A form of those products, rs, which
//       needs no store, ran no faster here.) At D 256 a 64 x 256 f32 dK
//       and dV do not both fit a thread's registers: the CTA takes 64
//       keys, one warpgroup accumulates dV (recomputing only S^T), the
//       other dK (S^T and dP^T): 10 D flops a pair instead of the 8 of D
//       <= 128, on the same loads, and a 2-stage ring.
//     - dQ (dq_wgmma): Q and dO of 128 query rows (64 at D 256, one
//       warpgroup) load once, K and V tiles of 128 keys (64 at D 256)
//       stream through a 2-stage ring; S = Q K^T and dP = dO V^T (ss), dS
//       as above into a bf16 A tile, dQ += dS K (ss, K an MN-major B),
//       left running into the next tile.
//     Both grids take the heaviest blocks first, by groups of up to 8
//     heads, so that a head's streamed tiles are read from L2.
//     P and dS are the only operands rounded to bf16 (q, k, v, dO are bf16
//     already); their error stays inside the SIMT body's per-element limit
//     (tests/test_torch_bwd_body.py emulates it on the CPU).
//   * simt (f32, and bf16 calls TMA cannot describe): the CUDA cores in
//     f32, register tiles fed from shared memory; head dims 1..256 in the
//     narrowest template width of 16, 32, 64, 128 or 256 lanes (lanes past
//     D load zeros and store nothing). f32 stays here: TF32 or bf16
//     products would break the f32 parity of the cuda and cpu trainers.
// A request for the wgmma body that it does not take is refused with
// cudaErrorInvalidValue, never rerouted; nothing falls back.
// Left for later: a persistent grid (each CTA's K / V load and dK / dV
// store leave the SM's tensor cores idle), better overlap of the two
// warpgroups (they wait on the same ring tiles and stay in step; turns on
// named barriers, FlashAttention-3's ping-pong, ran slower here),
// splitting an MQA group across CTAs when the grid is smaller than the
// card (at recurrentgemma's (2, 10/1) the D 256 dK / dV grid is 64 CTAs
// on 132 SMs).

#include <math_constants.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int THREADS = 256;   // 16 row groups x 16 column lanes
constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;        // (B, Hq, Sq, D) contiguous
  const void* dout;     // (B, Hq, Sq, D) contiguous
  const float* lse;     // (B, Hq, Sq)
  float* lse2;          // scratch (B, Hq, sq_pad): lse in the log2 domain
  float* delta;         // scratch (B, Hq, sq_pad), both from prep_kernel
  void* dq;             // (B, Hq, Sq, D) contiguous
  void* dk;             // (B, Hkv, Skv, D) contiguous
  void* dv;             // (B, Hkv, Skv, D) contiguous
  int B, Hq, Hkv, Sq, Skv, group, D;
  int sq_pad;           // Sq rounded up to 64 rows
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int causal, window;
  float scale;
};

// Tile geometry for template width DP: BR rows a CTA (keys in dkdv, queries
// in dq), BC rows of the other side a step; each thread holds RPT x CPT
// scores and RPT x DPT outputs; shared rows are padded to odd strides.
template <int DP>
struct Tile {
  static constexpr int BR = DP > 128 ? 32 : 64;
  static constexpr int BC = BR;
  static constexpr int RPT = BR / 16;
  static constexpr int CPT = BC / 16;
  static constexpr int DPT = DP / 16;
  static constexpr int LD = DP + 1;
  static constexpr int LS = BC + 1;
  static constexpr size_t SMEM =
      sizeof(float) * (2 * BR * LD + 2 * BC * LD + 2 * BR * LS + 2 * BC);
};

__device__ __forceinline__ bool visible(const BwdParams& p, int qpos,
                                        int kpos) {
  bool ok = qpos < p.Sq && kpos < p.Skv;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  return ok;
}

// rows x DP tile of a strided (seq, D) matrix into shared memory as f32
template <typename T, int DP>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long stride, int lo, int n,
                                          int rows, int D) {
  for (int idx = threadIdx.x; idx < rows * DP; idx += THREADS) {
    const int r = idx / DP, d = idx % DP;
    const int pos = lo + r;
    dst[r * (DP + 1) + d] =
        pos < n && d < D ? to_f32(src[pos * stride + d]) : 0.f;
  }
}

// The rows' delta = rowsum(dO O) and lse in the log2 domain, one warp a
// row, each (b, h) padded to sq_pad = Sq rounded up to 64 rows (so that a
// wgmma ring tile's 64 values are one 256-byte bulk copy). The lse is +inf
// for a row that sees no key (-inf) or lies past Sq, so that exp2(s -
// lse) is 0 there (-inf - -inf would be NaN); delta is 0 past Sq.
template <typename T>
__global__ void __launch_bounds__(THREADS) prep_kernel(BwdParams p) {
  const long long rows = static_cast<long long>(p.B) * p.Hq * p.sq_pad;
  const long long row =
      static_cast<long long>(blockIdx.x) * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long bh = row / p.sq_pad;
  const int q = static_cast<int>(row % p.sq_pad);
  if (q >= p.Sq) {
    if (lane == 0) {
      p.lse2[row] = CUDART_INF_F;
      p.delta[row] = 0.f;
    }
    return;
  }
  const long long src = bh * p.Sq + q;
  const T* o = static_cast<const T*>(p.o) + src * p.D;
  const T* d = static_cast<const T*>(p.dout) + src * p.D;
  float s = 0.f;
  for (int c = lane; c < p.D; c += 32) s += to_f32(o[c]) * to_f32(d[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const float l = p.lse[src];
    p.lse2[row] = l == -CUDART_INF_F ? CUDART_INF_F : l * kLog2e;
    p.delta[row] = s;
  }
}

// The pre-pass on `stream`.
template <typename T>
cudaError_t prep(const BwdParams& p, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.B) * p.Hq * p.sq_pad;
  const int per_block = THREADS / 32;
  prep_kernel<T><<<static_cast<unsigned>((rows + per_block - 1) / per_block),
                   THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(BwdParams p) {
  using C = Tile<DP>;
  constexpr int BR = C::BR, BC = C::BC, RPT = C::RPT, CPT = C::CPT,
                DPT = C::DPT, LD = C::LD, LS = C::LS;
  extern __shared__ float smem[];
  float* Ks = smem;             // [BR][LD]
  float* Vs = Ks + BR * LD;     // [BR][LD]
  float* Qs = Vs + BR * LD;     // [BC][LD]
  float* dOs = Qs + BC * LD;    // [BC][LD]
  float* Ps = dOs + BC * LD;    // [BR][LS]  P^T
  float* dSs = Ps + BR * LS;    // [BR][LS]  dS^T
  float* Ls = dSs + BR * LS;    // [BC] lse
  float* Ds = Ls + BC;          // [BC] delta
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int k_lo = blockIdx.x * BR;   // early keys see the most queries
  const int k_hi = min(k_lo + BR, p.Skv) - 1;
  const int D = p.D;

  load_rows<T, DP>(Ks, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh,
                   p.k_ss, k_lo, p.Skv, BR, D);
  load_rows<T, DP>(Vs, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh,
                   p.v_ss, k_lo, p.Skv, BR, D);

  // the query blocks that see any key of [k_lo, k_hi]
  int qb_lo = 0, qb_hi = (p.Sq + BC - 1) / BC;
  if (p.causal) qb_lo = k_lo / BC;
  if (p.window > 0) qb_hi = min(qb_hi, (k_hi + p.window - 1) / BC + 1);

  float dk[RPT][DPT], dv[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int hh = 0; hh < p.group; ++hh) {
    const int h = hk * p.group + hh;
    const long long bh = static_cast<long long>(b) * p.Hq + h;
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dO = static_cast<const T*>(p.dout) + bh * p.Sq * D;
    const float* lse = p.lse + bh * p.Sq;
    const float* delta = p.delta + bh * p.sq_pad;
    for (int qb = qb_lo; qb < qb_hi; ++qb) {
      const int q_lo = qb * BC;
      __syncthreads();   // the previous step's tiles are consumed
      load_rows<T, DP>(Qs, q, p.q_ss, q_lo, p.Sq, BC, D);
      load_rows<T, DP>(dOs, dO, D, q_lo, p.Sq, BC, D);
      for (int idx = tid; idx < BC; idx += THREADS) {
        const int qp = q_lo + idx;
        Ls[idx] = qp < p.Sq ? lse[qp] : -CUDART_INF_F;
        Ds[idx] = qp < p.Sq ? delta[qp] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T on this thread's RPT keys x CPT
      // queries
      float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int u = 0; u < CPT; ++u) s[i][u] = dp[i][u] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DP; ++d) {
        float kv[RPT], vv[RPT], qv[CPT], ov[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          kv[i] = Ks[(ty * RPT + i) * LD + d];
          vv[i] = Vs[(ty * RPT + i) * LD + d];
        }
#pragma unroll
        for (int u = 0; u < CPT; ++u) {
          qv[u] = Qs[(tx + 16 * u) * LD + d];
          ov[u] = dOs[(tx + 16 * u) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int u = 0; u < CPT; ++u) {
            s[i][u] = fmaf(kv[i], qv[u], s[i][u]);
            dp[i][u] = fmaf(vv[i], ov[u], dp[i][u]);
          }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int u = 0; u < CPT; ++u) {
          const int r = ty * RPT + i, c = tx + 16 * u;
          const float l = Ls[c];
          const float pr = visible(p, q_lo + c, k_lo + r) && l != -CUDART_INF_F
                               ? expf(s[i][u] * p.scale - l)
                               : 0.f;
          Ps[r * LS + c] = pr;
          dSs[r * LS + c] = pr * (dp[i][u] - Ds[c]);
        }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q on this thread's RPT keys x DPT dims
#pragma unroll 4
      for (int j = 0; j < BC; ++j) {
        float pv[RPT], sv[RPT], ov[DPT], qv[DPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = Ps[(ty * RPT + i) * LS + j];
          sv[i] = dSs[(ty * RPT + i) * LS + j];
        }
#pragma unroll
        for (int e = 0; e < DPT; ++e) {
          ov[e] = dOs[j * LD + tx + 16 * e];
          qv[e] = Qs[j * LD + tx + 16 * e];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int e = 0; e < DPT; ++e) {
            dv[i][e] = fmaf(pv[i], ov[e], dv[i][e]);
            dk[i][e] = fmaf(sv[i], qv[e], dk[i][e]);
          }
      }
    }
  }

  const long long base =
      (static_cast<long long>(b) * p.Hkv + hk) * p.Skv * D;
  T* dk_out = static_cast<T*>(p.dk) + base;
  T* dv_out = static_cast<T*>(p.dv) + base;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kp = k_lo + ty * RPT + i;
    if (kp >= p.Skv) continue;
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const int c = tx + 16 * e;
      if (c < D) {
        dk_out[static_cast<long long>(kp) * D + c] =
            from_f32<T>(dk[i][e] * p.scale);
        dv_out[static_cast<long long>(kp) * D + c] = from_f32<T>(dv[i][e]);
      }
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS) dq_kernel(BwdParams p) {
  using C = Tile<DP>;
  constexpr int BR = C::BR, BC = C::BC, RPT = C::RPT, CPT = C::CPT,
                DPT = C::DPT, LD = C::LD, LS = C::LS;
  extern __shared__ float smem[];
  float* Qs = smem;             // [BR][LD]
  float* dOs = Qs + BR * LD;    // [BR][LD]
  float* Ks = dOs + BR * LD;    // [BC][LD]
  float* Vs = Ks + BC * LD;     // [BC][LD]
  float* dSs = Vs + BC * LD;    // [BR][LS]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.y / p.Hq, h = blockIdx.y % p.Hq, hk = h / p.group;
  const long long bh = static_cast<long long>(blockIdx.y);
  // the longest causal rows first, so the short tiles fill the last wave
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * BR;
  const int q_hi = min(q_lo + BR, p.Sq) - 1;
  const int D = p.D;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_rows<T, DP>(Qs, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh,
                   p.q_ss, q_lo, p.Sq, BR, D);
  load_rows<T, DP>(dOs, static_cast<const T*>(p.dout) + bh * p.Sq * D, D,
                   q_lo, p.Sq, BR, D);
  float lse[RPT], delta[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qp = q_lo + ty * RPT + i;
    lse[i] = qp < p.Sq ? p.lse[bh * p.Sq + qp] : -CUDART_INF_F;
    delta[i] = qp < p.Sq ? p.delta[bh * p.sq_pad + qp] : 0.f;
  }

  int kb_hi = (p.Skv + BC - 1) / BC;
  if (p.causal) kb_hi = min(kb_hi, q_hi / BC + 1);
  const int kb_lo = p.window > 0 ? max(0, (q_lo - p.window + 1) / BC) : 0;

  float dq[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) dq[i][e] = 0.f;

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k_lo = kb * BC;
    __syncthreads();   // the previous step's tiles are consumed
    load_rows<T, DP>(Ks, k, p.k_ss, k_lo, p.Skv, BC, D);
    load_rows<T, DP>(Vs, v, p.v_ss, k_lo, p.Skv, BC, D);
    __syncthreads();

    // S = Q K^T and dP = dO V^T on this thread's RPT queries x CPT keys
    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int u = 0; u < CPT; ++u) s[i][u] = dp[i][u] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[RPT], ov[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = Qs[(ty * RPT + i) * LD + d];
        ov[i] = dOs[(ty * RPT + i) * LD + d];
      }
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        kv[u] = Ks[(tx + 16 * u) * LD + d];
        vv[u] = Vs[(tx + 16 * u) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int u = 0; u < CPT; ++u) {
          s[i][u] = fmaf(qv[i], kv[u], s[i][u]);
          dp[i][u] = fmaf(ov[i], vv[u], dp[i][u]);
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        const int r = ty * RPT + i, c = tx + 16 * u;
        const float pr =
            visible(p, q_lo + r, k_lo + c) && lse[i] != -CUDART_INF_F
                ? expf(s[i][u] * p.scale - lse[i])
                : 0.f;
        dSs[r * LS + c] = pr * (dp[i][u] - delta[i]);
      }
    __syncthreads();

    // dQ += dS K on this thread's RPT queries x DPT dims
#pragma unroll 4
    for (int j = 0; j < BC; ++j) {
      float sv[RPT], kv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) sv[i] = dSs[(ty * RPT + i) * LS + j];
#pragma unroll
      for (int e = 0; e < DPT; ++e) kv[e] = Ks[j * LD + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int e = 0; e < DPT; ++e) dq[i][e] = fmaf(sv[i], kv[e], dq[i][e]);
    }
  }

  T* out = static_cast<T*>(p.dq) + bh * p.Sq * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qp = q_lo + ty * RPT + i;
    if (qp >= p.Sq) continue;
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const int c = tx + 16 * e;
      if (c < D)
        out[static_cast<long long>(qp) * D + c] =
            from_f32<T>(dq[i][e] * p.scale);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  using C = Tile<DP>;
  static_assert(C::SMEM <= 232448, "K1 backward tile exceeds shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  err = prep<T>(p, stream);
  if (err != cudaSuccess) return err;
  dkdv_kernel<T, DP><<<dim3((p.Skv + C::BR - 1) / C::BR, p.B * p.Hkv),
                       THREADS, C::SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T, DP><<<dim3((p.Sq + C::BR - 1) / C::BR, p.B * p.Hq), THREADS,
                     C::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// The narrowest template width that holds the logical head dim.
template <typename T>
cudaError_t dispatch(const BwdParams& p, cudaStream_t stream) {
  if (p.D < 1) return cudaErrorInvalidValue;
  if (p.D <= 16) return launch<T, 16>(p, stream);
  if (p.D <= 32) return launch<T, 32>(p, stream);
  if (p.D <= 64) return launch<T, 64>(p, stream);
  if (p.D <= 128) return launch<T, 128>(p, stream);
  if (p.D <= 256) return launch<T, 256>(p, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// wgmma body (bf16)
// ---------------------------------------------------------------------------

namespace tc {

namespace hw = repro::hopper;

constexpr int kRows = 64;          // rows of a TMA box, of a warpgroup's tile
constexpr int kATile = kRows * kRows * 2;   // a 64 x 64 bf16 A operand

// dK / dV: BK keys a CTA (64 a warpgroup; at D 256 both warpgroups share
// 64 keys, one holding dV, the other dK), query tiles of 64 rows through a
// ring of STAGES; 256 threads, so up to 255 registers a thread.
template <int DP>
struct DkdvCfg {
  static constexpr bool kSplit = DP > 128;
  static constexpr int BK = kSplit ? 64 : 128;
  static constexpr int STAGES = kSplit ? 2 : 3;
  static constexpr int THREADS = 256;
  static constexpr int KV_BYTES = BK * DP * 2;       // K or V
  static constexpr int QT_BYTES = kRows * DP * 2;    // Q or dO of one stage
  // the bf16 A tiles: P^T and dS^T of each warpgroup (one each at D 256)
  static constexpr int A_TILES = kSplit ? 2 : 4;
  static constexpr size_t SMEM = 2 * KV_BYTES + STAGES * 2 * QT_BYTES +
                                 A_TILES * kATile + 1024;
  static constexpr int TX = 2 * QT_BYTES + 2 * kRows * 4;  // + lse2, delta
};

// dQ: BQ query rows a CTA (64 a warpgroup), key tiles of BKV through a
// ring of STAGES (128 keys make S and dP m64n128 products: half the
// iterations of 64, and each A row read from shared memory feeds twice
// the work).
template <int DP>
struct DqCfg {
  static constexpr int NWG = DP > 128 ? 1 : 2;
  static constexpr int BQ = kRows * NWG;
  static constexpr int BKV = DP > 128 ? 64 : 128;
  static constexpr int STAGES = 2;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int Q_BYTES = BQ * DP * 2;        // Q or dO
  static constexpr int KV_BYTES = BKV * DP * 2;      // K or V of one stage
  static constexpr int DS_BYTES = kRows * BKV * 2;   // a warpgroup's dS
  static constexpr size_t SMEM = 2 * Q_BYTES + STAGES * 2 * KV_BYTES +
                                 NWG * DS_BYTES + 1024;
};

// What the two kernels read besides the tensor maps.
struct TcBwd {
  const float* lse2;             // (B, Hq, sq_pad), from prep_kernel
  const float* delta;
  __nv_bfloat16* dq;             // (B, Hq, Sq, D)
  __nv_bfloat16* dk;             // (B, Hkv, Skv, D)
  __nv_bfloat16* dv;
  int Hq, Hkv, Sq, Skv, sq_pad, group, D, causal, window;
  int head_group;                // heads whose blocks interleave in the grid
  float scale, scale_log2;       // scale, scale * log2(e)
};

// The largest divisor of n up to 8: a group of heads whose blocks run side
// by side, so that a head's K / V (dQ) or Q / dO (dK / dV) tiles are read
// from L2 by all its blocks (about a wave of CTAs on 132 SMs).
inline int head_group(int n) {
  for (int g = 8; g > 1; --g)
    if (n % g == 0) return g;
  return 1;
}

// The forward's key masks (a query past Sq has lse +inf instead).
__device__ __forceinline__ bool sees(const TcBwd& p, int qpos, int kpos) {
  bool ok = kpos < p.Skv;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  return ok;
}

// 2^x on the MUFU (flushing subnormal results to 0, as exp2f nearly does):
// one instruction where exp2f takes a few.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A stage is released by one arrival a warp, once all its lanes are done
// with it (the empty barriers count warps).
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) hw::mbar_arrive(bar);
}

// ROWS rows from `row0` of head h, batch b, all DP / 64 column boxes: box
// c's rows [64 r, 64 r + 64) land at (c ROWS + 64 r) 128 bytes, the layout
// of one ROWS-row box.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row0, int h,
                                          int b) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
#pragma unroll
    for (int r = 0; r < ROWS / kRows; ++r)
      hw::tma_load_4d(dst + (c * ROWS + r * kRows) * 128, map, bar, 64 * c,
                      row0 + kRows * r, h, b);
}

// Descriptors of a 128B-swizzled tile (every address below 256 KB, so a
// step is an add to the start field of a base descriptor).
// K-major operand (the head dim is the reduction): the base is rows
// [row0, row0 + 64) at k16 step 0; step kk of a tile of ROWS rows moves
// to box kk / 4 and 32 bytes a step inside its 128-byte rows.
__device__ __forceinline__ uint64_t kmajor(const uint8_t* t, int row0) {
  return hw::sw128_desc(t + row0 * 128, 16, 1024);
}
template <int ROWS>
__device__ __forceinline__ uint64_t kstep(uint64_t base, int kk) {
  return base + ((((kk / 4) * ROWS) * 128 + (kk % 4) * 32) >> 4);
}
// MN-major B (the tile's rows are the reduction, D is N across its DP / 64
// boxes ROWS * 128 bytes apart): step kk moves 16 rows.
template <int ROWS>
__device__ __forceinline__ uint64_t mnmajor(const uint8_t* t) {
  return hw::sw128_desc(t, ROWS * 128, 1024);
}
__device__ __forceinline__ uint64_t mnstep(uint64_t base, int kk) {
  return base + ((kk * 16 * 128) >> 4);
}

// A 64 x N f32 accumulator fragment of this warpgroup as a bf16 A operand
// in shared memory: N / 64 boxes of 64 rows of 128 bytes, the 128-byte
// swizzle of a TMA box (16-byte chunk c of row r at (c ^ r % 8) 16),
// K-major. The
// fragment's pairs land on 32 different banks a warp. Then each thread
// fences its stores to the async proxy and the warpgroup meets on its
// named barrier (1 + wg), so the ss wgmma after it reads the whole tile.
// The products take P and dS from shared memory rather than from
// registers: wgmma with a register A ran at a third of this rate here.
template <int N>
__device__ __forceinline__ void store_a(uint8_t* tile,
                                        const float (&x)[N / 2]) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < N / 8; ++n)            // column box n / 8, chunk n % 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + lane / 4 + 8 * i;
      *reinterpret_cast<uint32_t*>(tile + (n / 8) * kATile + r * 128 +
                                   (((n % 8) ^ (r % 8)) * 16) +
                                   4 * (lane % 4)) =
          hw::pack_bf16x2(x[4 * n + 2 * i], x[4 * n + 2 * i + 1]);
    }
}

__device__ __forceinline__ void publish_a() {
  hw::fence_proxy_async();
  hw::named_sync(1 + threadIdx.x / 128, 128);
}

// One warpgroup of the dK / dV kernel: keys [kw_lo, kw_lo + 64), rows
// key_row0.. of the CTA's K / V tiles; accumulates dV (kV) and / or dK
// (kK) over the n_it ring tiles, then stores them. Warp 0 of the CTA also
// feeds the ring: `issue(j)` loads tile j into stage j % STAGES once the
// tile before it in that stage is consumed, STAGES - 1 tiles ahead.
template <int DP, bool kV, bool kK, typename Issue>
__device__ __forceinline__ void dkdv_consume(
    const TcBwd& p, const uint8_t* Ks, const uint8_t* Vs, const uint8_t* ring,
    uint64_t* kv_full, uint64_t* full, uint64_t* empty,
    const float (*lse_s)[kRows], const float (*delta_s)[kRows], int b,
    int hk, int kw_lo, int key_row0, int qt_lo, int nq, int n_it,
    const Issue& issue, uint8_t* pbuf, uint8_t* sbuf) {
  using C = DkdvCfg<DP>;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int kw_hi = kw_lo + kRows - 1;
  const int kr = kw_lo + warp * 16 + lane / 4;   // keys kr and kr + 8
  const uint64_t kd0 = kmajor(Ks, key_row0), vd0 = kmajor(Vs, key_row0);
  const uint64_t qd0 = kmajor(ring, 0), qm0 = mnmajor<kRows>(ring);
  constexpr int kStageStep = (2 * C::QT_BYTES) >> 4;   // descriptor units
  constexpr int kDoStep = C::QT_BYTES >> 4;
  float dk[kK ? DP / 2 : 1], dv[kV ? DP / 2 : 1];
  const uint64_t pd0 = kmajor(pbuf, 0), sd0 = kmajor(sbuf, 0);
#pragma unroll
  for (int i = 0; i < (kK ? DP / 2 : 1); ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kV ? DP / 2 : 1); ++i) dv[i] = 0.f;
  hw::bar_wait(kv_full, 0);

  // dV / dK of a tile are left running into the next tile (its stage is
  // released once they are in): `held` is that stage, or -1
  int held = -1;
  for (int it = 0; it < n_it; ++it) {
    const int s = it % C::STAGES;
    const int q_lo = (qt_lo + it % nq) * kRows;
    hw::bar_wait(&full[s], (it / C::STAGES) & 1);
    // uniform over the warpgroup: does any of its keys see this tile?
    const bool live = kw_lo < p.Skv && (!p.causal || q_lo + kRows > kw_lo) &&
                      (p.window <= 0 || q_lo <= kw_hi + p.window - 1);
    float st[32];
    float dpt[kK ? 32 : 1];
    if (live) {
      // this iteration's bases, opaque so that no step is hoisted
      const uint64_t kd = hw::opaque(kd0), vd = hw::opaque(vd0);
      const uint64_t qd = hw::opaque(qd0) + s * kStageStep;
      // S^T = K Q^T, then (for dK) dP^T = V dO^T: 64 keys x 64 queries
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        hw::Wgmma<64>::template ss<0>(st, kstep<C::BK>(kd, kk),
                                      kstep<kRows>(qd, kk), kk > 0);
      hw::wgmma_commit();
      if constexpr (kK) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          hw::Wgmma<64>::template ss<0>(dpt, kstep<C::BK>(vd, kk),
                                        kstep<kRows>(qd + kDoStep, kk),
                                        kk > 0);
        hw::wgmma_commit();
        hw::wgmma_wait_upto<1>();  // the last dV / dK and S^T are in
      } else {
        hw::wgmma_wait();
      }
      hw::fence_regs(st);
    } else {
      hw::wgmma_wait();
    }
    if (held >= 0) release(&empty[held]);
    held = -1;
    // the stage of tile it - 1 is free once every thread has passed here
    if (threadIdx.x == 0 && it + C::STAGES - 1 < n_it)
      issue(it + C::STAGES - 1);
    __syncwarp();
    if (!live) {
      release(&empty[s]);
      continue;
    }

    // P^T on the fragments (row = key, column = query) while dP^T runs;
    // the masks only on a tile that crosses one (two loops, so that an
    // interior tile issues none of the mask arithmetic)
    const bool edge = kw_lo + kRows > p.Skv ||
                      (p.causal && kw_hi > q_lo) ||
                      (p.window > 0 && kw_lo <= q_lo + kRows - 1 - p.window);
    if (edge) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 8 * n + 2 * (lane % 4) + j;
          const float l2 = lse_s[s][col];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * n + 2 * i + j;
            const float pr = ex2(st[e] * p.scale_log2 - l2);
            st[e] = sees(p, q_lo + col, kr + 8 * i) ? pr : 0.f;
          }
        }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float l2 = lse_s[s][8 * n + 2 * (lane % 4) + j];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * n + 2 * i + j;
            st[e] = ex2(st[e] * p.scale_log2 - l2);
          }
        }
    }
    if constexpr (kV) store_a<kRows>(pbuf, st);
    // dS^T = P^T (dP^T - delta), into st: dpt is only read, since a value
    // written into it would reach the next tile's dP^T wgmma as its
    // accumulator and make ptxas serialise the wgmma pipeline (C7515)
    if constexpr (kK) {
      hw::wgmma_wait();
      hw::fence_regs(dpt);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float dl = delta_s[s][8 * n + 2 * (lane % 4) + j];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * n + 2 * i + j;
            st[e] *= dpt[e] - dl;
          }
        }
      store_a<kRows>(sbuf, st);
    }
    publish_a();

    // dV += P^T dO, dK += dS^T Q: bf16 A tiles, dO / Q MN-major
    const uint64_t qm = hw::opaque(qm0) + s * kStageStep;
    hw::wgmma_fence();
    if constexpr (kV) {
      const uint64_t pd = hw::opaque(pd0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hw::Wgmma<DP>::template ss<1>(dv, kstep<kRows>(pd, kk),
                                      mnstep(qm + kDoStep, kk), 1);
    }
    if constexpr (kK) {
      const uint64_t sd = hw::opaque(sd0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hw::Wgmma<DP>::template ss<1>(dk, kstep<kRows>(sd, kk),
                                      mnstep(qm, kk), 1);
    }
    hw::wgmma_commit();
    held = s;
  }
  hw::wgmma_wait();
  if constexpr (kV) hw::fence_regs(dv);
  if constexpr (kK) hw::fence_regs(dk);
  if (held >= 0) release(&empty[held]);

  const long long base = (static_cast<long long>(b) * p.Hkv + hk) * p.Skv;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = kr + 8 * i;
    if (kpos >= p.Skv) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = 8 * n + 2 * (lane % 4);      // D % 8 == 0: both or none
      if (col >= p.D) continue;
      const long long off = (base + kpos) * p.D + col;
      if constexpr (kK)
        *reinterpret_cast<__nv_bfloat162*>(p.dk + off) = __floats2bfloat162_rn(
            dk[4 * n + 2 * i] * p.scale, dk[4 * n + 2 * i + 1] * p.scale);
      if constexpr (kV)
        *reinterpret_cast<__nv_bfloat162*>(p.dv + off) =
            __floats2bfloat162_rn(dv[4 * n + 2 * i], dv[4 * n + 2 * i + 1]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(DkdvCfg<DP>::THREADS, 1)
    dkdv_wgmma(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap domap, TcBwd p) {
  using C = DkdvCfg<DP>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t kv_full, full[C::STAGES], empty[C::STAGES];
  __shared__ __align__(16) float lse_s[C::STAGES][kRows];
  __shared__ __align__(16) float delta_s[C::STAGES][kRows];
  uint8_t* smem = smem_raw + ((1024 - (hw::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Ks = smem;
  uint8_t* Vs = Ks + C::KV_BYTES;
  uint8_t* ring = Vs + C::KV_BYTES;
  uint8_t* abuf = ring + C::STAGES * 2 * C::QT_BYTES;

  // early keys see the most queries: block 0 of each of a group of heads
  // first, then block 1, ... (gridDim.x = heads a group x blocks)
  const int bhk = blockIdx.y * p.head_group + blockIdx.x % p.head_group;
  const int b = bhk / p.Hkv, hk = bhk % p.Hkv;
  const int k_lo = static_cast<int>(blockIdx.x / p.head_group) * C::BK;
  const int k_hi = min(k_lo + C::BK, p.Skv) - 1;
  // the query tiles [qt_lo, qt_hi) that see any key of [k_lo, k_hi], for
  // each head of the group in turn
  int qt_lo = 0, qt_hi = (p.Sq + kRows - 1) / kRows;
  if (p.causal) qt_lo = k_lo / kRows;
  if (p.window > 0) qt_hi = min(qt_hi, (k_hi + p.window - 1) / kRows + 1);
  const int nq = max(0, qt_hi - qt_lo);
  const int n_it = p.group * nq;

  if (threadIdx.x == 0) {
    hw::mbar_init(&kv_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], C::THREADS / 32);
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  // thread 0: tile j's Q and dO (TMA) and its rows' lse and delta (bulk
  // copies) into stage j % STAGES, once the tile before it there is
  // consumed
  const auto issue = [&](int j) {
    const int s = j % C::STAGES;
    const int h = hk * p.group + j / nq;
    const int q_lo = (qt_lo + j % nq) * kRows;
    if (j >= C::STAGES) hw::bar_wait(&empty[s], ((j / C::STAGES) & 1) ^ 1);
    uint8_t* Qs = ring + s * 2 * C::QT_BYTES;
    const long long row =
        (static_cast<long long>(b) * p.Hq + h) * p.sq_pad + q_lo;
    hw::mbar_arrive_expect_tx(&full[s], C::TX);
    load_tile<DP, kRows>(Qs, &qmap, &full[s], q_lo, h, b);
    load_tile<DP, kRows>(Qs + C::QT_BYTES, &domap, &full[s], q_lo, h, b);
    hw::bulk_load(lse_s[s], p.lse2 + row, kRows * 4, &full[s]);
    hw::bulk_load(delta_s[s], p.delta + row, kRows * 4, &full[s]);
  };
  if (threadIdx.x == 0) {
    hw::mbar_arrive_expect_tx(&kv_full, 2 * C::KV_BYTES);
    load_tile<DP, C::BK>(Ks, &kmap, &kv_full, k_lo, hk, b);
    load_tile<DP, C::BK>(Vs, &vmap, &kv_full, k_lo, hk, b);
    for (int j = 0; j < min(C::STAGES - 1, n_it); ++j) issue(j);
  }
  __syncwarp();

  const int wg = threadIdx.x / 128;
  if constexpr (C::kSplit) {
    // warpgroup 0 holds dV (its P^T tile first), 1 holds dK (its dS^T)
    uint8_t* own = abuf + wg * kATile;
    if (wg == 0)
      dkdv_consume<DP, true, false>(p, Ks, Vs, ring, &kv_full, full, empty,
                                    lse_s, delta_s, b, hk, k_lo, 0, qt_lo, nq,
                                    n_it, issue, own, own);
    else
      dkdv_consume<DP, false, true>(p, Ks, Vs, ring, &kv_full, full, empty,
                                    lse_s, delta_s, b, hk, k_lo, 0, qt_lo, nq,
                                    n_it, issue, own, own);
  } else {
    uint8_t* own = abuf + 2 * wg * kATile;       // P^T, then dS^T
    dkdv_consume<DP, true, true>(p, Ks, Vs, ring, &kv_full, full, empty,
                                 lse_s, delta_s, b, hk, k_lo + kRows * wg,
                                 kRows * wg, qt_lo, nq, n_it, issue, own,
                                 own + kATile);
  }
}

template <int DP>
__global__ void __launch_bounds__(DqCfg<DP>::THREADS, 1)
    dq_wgmma(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const __grid_constant__ CUtensorMap domap, TcBwd p) {
  using C = DqCfg<DP>;
  constexpr int BKV = C::BKV;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full, full[C::STAGES], empty[C::STAGES];
  uint8_t* smem = smem_raw + ((1024 - (hw::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* dOs = Qs + C::Q_BYTES;
  uint8_t* ring = dOs + C::Q_BYTES;
  uint8_t* abuf = ring + C::STAGES * 2 * C::KV_BYTES;   // dS of each

  // the longest causal rows first: the last query block of each of a group
  // of heads, then the one before, ... (gridDim.x = heads a group x blocks)
  const int bh0 = blockIdx.y * p.head_group + blockIdx.x % p.head_group;
  const int b = bh0 / p.Hq, h = bh0 % p.Hq, hk = h / p.group;
  const int nqb = gridDim.x / p.head_group;
  const int q_lo =
      (nqb - 1 - static_cast<int>(blockIdx.x / p.head_group)) * C::BQ;
  const int q_hi = min(q_lo + C::BQ, p.Sq) - 1;
  int kt_hi = (p.Skv + BKV - 1) / BKV;
  if (p.causal) kt_hi = min(kt_hi, q_hi / BKV + 1);
  const int kt_lo = p.window > 0 ? max(0, (q_lo - p.window + 1) / BKV) : 0;
  const int n_it = max(0, kt_hi - kt_lo);

  if (threadIdx.x == 0) {
    hw::mbar_init(&q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], C::THREADS / 32);
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  // thread 0: K and V of tile j into stage j % STAGES, once the tile
  // before it there is consumed
  const auto issue = [&](int j) {
    const int s = j % C::STAGES;
    if (j >= C::STAGES) hw::bar_wait(&empty[s], ((j / C::STAGES) & 1) ^ 1);
    uint8_t* ks = ring + s * 2 * C::KV_BYTES;
    const int k_lo = (kt_lo + j) * BKV;
    hw::mbar_arrive_expect_tx(&full[s], 2 * C::KV_BYTES);
    load_tile<DP, BKV>(ks, &kmap, &full[s], k_lo, hk, b);
    load_tile<DP, BKV>(ks + C::KV_BYTES, &vmap, &full[s], k_lo, hk, b);
  };
  if (threadIdx.x == 0) {
    hw::mbar_arrive_expect_tx(&q_full, 2 * C::Q_BYTES);
    load_tile<DP, C::BQ>(Qs, &qmap, &q_full, q_lo, h, b);
    load_tile<DP, C::BQ>(dOs, &domap, &q_full, q_lo, h, b);
    for (int j = 0; j < min(C::STAGES - 1, n_it); ++j) issue(j);
  }
  __syncwarp();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int qw_lo = q_lo + kRows * wg, qw_hi = qw_lo + kRows - 1;
  const int r = qw_lo + (warp % 4) * 16 + lane / 4;   // rows r and r + 8
  const long long bh = bh0;
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = r + 8 * i < p.Sq;
    l2[i] = in ? p.lse2[bh * p.sq_pad + r + 8 * i] : CUDART_INF_F;
    dl[i] = in ? p.delta[bh * p.sq_pad + r + 8 * i] : 0.f;
  }
  const uint64_t qd0 = kmajor(Qs, kRows * wg), od0 = kmajor(dOs, kRows * wg);
  const uint64_t kd0 = kmajor(ring, 0), km0 = mnmajor<BKV>(ring);
  constexpr int kStageStep = (2 * C::KV_BYTES) >> 4;  // descriptor units
  constexpr int kVStep = C::KV_BYTES >> 4;
  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  hw::bar_wait(&q_full, 0);

  // dQ += dS K of a tile is left running into the next tile (its stage
  // is released once it is in): `held` is that stage, or -1
  uint8_t* dsbuf = abuf + wg * C::DS_BYTES;
  const uint64_t dd0 = kmajor(dsbuf, 0);
  int held = -1;
  for (int it = 0; it < n_it; ++it) {
    const int s = it % C::STAGES;
    const int k_lo = (kt_lo + it) * BKV;
    hw::bar_wait(&full[s], (it / C::STAGES) & 1);
    const bool live = qw_lo < p.Sq && (!p.causal || k_lo <= qw_hi) &&
                      (p.window <= 0 || k_lo + BKV - 1 > qw_lo - p.window);
    float sc[BKV / 2], dp[BKV / 2];
    if (live) {
      const uint64_t qd = hw::opaque(qd0), od = hw::opaque(od0);
      const uint64_t kd = hw::opaque(kd0) + s * kStageStep;
      // S = Q K^T, then dP = dO V^T: 64 queries x BKV keys
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        hw::Wgmma<BKV>::template ss<0>(sc, kstep<C::BQ>(qd, kk),
                                       kstep<BKV>(kd, kk), kk > 0);
      hw::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        hw::Wgmma<BKV>::template ss<0>(dp, kstep<C::BQ>(od, kk),
                                       kstep<BKV>(kd + kVStep, kk), kk > 0);
      hw::wgmma_commit();
      hw::wgmma_wait_upto<1>();      // the last dQ and S are in
      hw::fence_regs(sc);
    } else {
      hw::wgmma_wait();
    }
    if (held >= 0) release(&empty[held]);
    held = -1;
    // the stage of tile it - 1 is free once every thread has passed here
    if (threadIdx.x == 0 && it + C::STAGES - 1 < n_it)
      issue(it + C::STAGES - 1);
    __syncwarp();
    if (!live) {
      release(&empty[s]);
      continue;
    }

    // P, with the masks only on a tile that crosses one (see dkdv)
    const bool edge = k_lo + BKV > p.Skv ||
                      (p.causal && k_lo + BKV - 1 > qw_lo) ||
                      (p.window > 0 && k_lo <= qw_hi - p.window);
    if (edge) {
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int e = 4 * n + 2 * i + j;
            const float pr = ex2(sc[e] * p.scale_log2 - l2[i]);
            sc[e] = sees(p, r + 8 * i, k_lo + 8 * n + 2 * (lane % 4) + j)
                        ? pr
                        : 0.f;
          }
    } else {
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int e = 4 * n + 2 * i + j;
            sc[e] = ex2(sc[e] * p.scale_log2 - l2[i]);
          }
    }
    hw::wgmma_wait();
    hw::fence_regs(dp);
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 4 * n + 2 * i + j;
          sc[e] *= dp[e] - dl[i];
        }

    // dQ += dS K: dS as a bf16 A tile, K MN-major
    const uint64_t km = hw::opaque(km0) + s * kStageStep;
    const uint64_t dd = hw::opaque(dd0);
    store_a<BKV>(dsbuf, sc);
    publish_a();
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      hw::Wgmma<DP>::template ss<1>(dq, kstep<kRows>(dd, kk), mnstep(km, kk),
                                    1);
    hw::wgmma_commit();
    held = s;
  }
  hw::wgmma_wait();
  hw::fence_regs(dq);
  if (held >= 0) release(&empty[held]);

  __nv_bfloat16* out = p.dq + bh * p.Sq * p.D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = r + 8 * i;
    if (qpos >= p.Sq) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = 8 * n + 2 * (lane % 4);
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<long long>(qpos) * p.D + col) =
            __floats2bfloat162_rn(dq[4 * n + 2 * i] * p.scale,
                                  dq[4 * n + 2 * i + 1] * p.scale);
    }
  }
}

template <int DP>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  using K = DkdvCfg<DP>;
  using Q = DqCfg<DP>;
  static_assert(K::SMEM + 2048 <= 232448 && Q::SMEM + 2048 <= 232448,
                "K1 backward tiles exceed the H100's shared memory");
  CUtensorMap qmap, kmap, vmap, domap;
  const uint64_t D = p.D, Sq = p.Sq, Hq = p.Hq;
  const uint64_t qdims[4] = {D, Sq, Hq, static_cast<uint64_t>(p.B)};
  const uint64_t kdims[4] = {D, static_cast<uint64_t>(p.Skv),
                             static_cast<uint64_t>(p.Hkv),
                             static_cast<uint64_t>(p.B)};
  const uint64_t qst[3] = {2ull * p.q_ss, 2ull * p.q_sh, 2ull * p.q_sb};
  const uint64_t kst[3] = {2ull * p.k_ss, 2ull * p.k_sh, 2ull * p.k_sb};
  const uint64_t vst[3] = {2ull * p.v_ss, 2ull * p.v_sh, 2ull * p.v_sb};
  const uint64_t dost[3] = {2 * D, 2 * Sq * D, 2 * Hq * Sq * D};  // contiguous
  const uint32_t box[4] = {64, kRows, 1, 1};
  if (!hw::make_bf16_map(&qmap, p.q, 4, qdims, qst, box) ||
      !hw::make_bf16_map(&kmap, p.k, 4, kdims, kst, box) ||
      !hw::make_bf16_map(&vmap, p.v, 4, kdims, vst, box) ||
      !hw::make_bf16_map(&domap, p.dout, 4, qdims, dost, box))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(K::SMEM));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_wgmma<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Q::SMEM));
  if (err != cudaSuccess) return err;
  TcBwd tp;
  tp.lse2 = p.lse2;
  tp.delta = p.delta;
  tp.dq = static_cast<__nv_bfloat16*>(p.dq);
  tp.dk = static_cast<__nv_bfloat16*>(p.dk);
  tp.dv = static_cast<__nv_bfloat16*>(p.dv);
  tp.Hq = p.Hq;
  tp.Hkv = p.Hkv;
  tp.Sq = p.Sq;
  tp.Skv = p.Skv;
  tp.sq_pad = p.sq_pad;
  tp.group = p.group;
  tp.D = p.D;
  tp.causal = p.causal;
  tp.window = p.window;
  tp.scale = p.scale;
  tp.scale_log2 = p.scale * kLog2e;
  err = prep<__nv_bfloat16>(p, stream);
  if (err != cudaSuccess) return err;
  tp.head_group = head_group(p.B * p.Hkv);
  dkdv_wgmma<DP><<<dim3(tp.head_group * ((p.Skv + K::BK - 1) / K::BK),
                        p.B * p.Hkv / tp.head_group),
                   K::THREADS, K::SMEM, stream>>>(qmap, kmap, vmap, domap, tp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tp.head_group = head_group(p.B * p.Hq);
  dq_wgmma<DP><<<dim3(tp.head_group * ((p.Sq + Q::BQ - 1) / Q::BQ),
                      p.B * p.Hq / tp.head_group),
                 Q::THREADS, Q::SMEM, stream>>>(qmap, kmap, vmap, domap, tp);
  return cudaGetLastError();
}

// What the wgmma body takes (the wrapper's rule, checked again here so a
// wrong request is refused, never rerouted): bf16, D a multiple of 8 up to
// 256, q / k / v strides positive multiples of 8 elements, every base
// 16-byte aligned (o, dout, dq, dk, dv are contiguous (..., D) tensors).
bool takes(const BwdParams& p, int dtype) {
  const long long st[9] = {p.q_sb, p.q_sh, p.q_ss, p.k_sb, p.k_sh,
                           p.k_ss, p.v_sb, p.v_sh, p.v_ss};
  for (long long x : st)
    if (x % 8 != 0 || x <= 0) return false;
  const void* bases[8] = {p.q, p.k, p.v, p.o, p.dout, p.dq, p.dk, p.dv};
  for (const void* ptr : bases)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  return dtype == repro::kBF16 && p.D > 0 && p.D % 8 == 0 && p.D <= 256;
}

cudaError_t dispatch(const BwdParams& p, cudaStream_t stream) {
  if (p.D <= 64) return launch<64>(p, stream);
  if (p.D <= 128) return launch<128>(p, stream);
  return launch<256>(p, stream);
}

}  // namespace tc

}  // namespace

// C entry point (loaded with ctypes by repro_torch/kernels/
// flash_attention.py). q, k, v are read through their strides (in
// elements, head dim contiguous); o, dout, dq, dk and dv are contiguous,
// lse is (B, Hq, Sq) f32, delta an f32 scratch of 2 B Hq Sq' (Sq' = Sq
// rounded up to 64: the rows' padded lse and delta). body: 0 runs the SIMT
// body, 1 the wgmma body (bf16, D a multiple of 8 up to 256, q / k / v
// strides positive multiples of 8, every base 16-byte aligned; anything
// else is refused with cudaErrorInvalidValue, never rerouted). Launches
// the pre-pass, then the dK / dV and the dQ kernels, on ``stream``;
// returns the first cudaGetLastError() code that is not cudaSuccess.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int Hq, int Hkv, int Sq, int Skv, int D,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, int causal, int window, float scale, int body,
    void* stream) {
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.sq_pad = (Sq + 63) / 64 * 64;
  p.lse2 = delta;     // the scratch: padded lse (log2), then padded delta
  p.delta = delta + static_cast<long long>(B) * Hq * p.sq_pad;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
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
    return static_cast<int>(tc::takes(p, dtype) ? tc::dispatch(p, s)
                                                : cudaErrorInvalidValue);
  if (body != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = dtype == repro::kBF16
                              ? dispatch<__nv_bfloat16>(p, s)
                              : dispatch<float>(p, s);
  return static_cast<int>(err);
}
