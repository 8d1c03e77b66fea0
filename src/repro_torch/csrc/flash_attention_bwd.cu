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
//   delta_i = sum_d dO_id O_id                          (delta_kernel)
//   P_ij    = exp(S_ij scale - lse_i), S = Q K^T, 0 where masked or the
//             row sees no key (lse = -inf)
//   dV_j   += sum_i P_ij dO_i,  dS_ij = P_ij (dO_i . V_j - delta_i)
//   dK_j   += sum_i dS_ij Q_i scale                       (dkdv_kernel)
//   dQ_i    = sum_j dS_ij K_j scale                         (dq_kernel)
// with the masks of the forward (kpos < Skv, causal kpos <= qpos, window
// kpos > qpos - window). dkdv_kernel runs one CTA per (batch, kv head,
// block of keys) and loops over the query blocks and the Hq / Hkv query
// heads of its GQA group, so the group's sum stays in registers: no
// atomics, and the result does not depend on the schedule. dq_kernel runs
// one CTA per (batch, query head, block of queries) and loops over the
// key blocks. Both skip the blocks the causal and window masks empty
// before any load, as K1's forward does. Every sum is in f32; bf16 inputs
// are widened on load and the gradients rounded to the inputs' type on
// store. Head dims 1..256 run in the narrowest template width of 16, 32,
// 64, 128 or 256 lanes (lanes past D load zeros and store nothing).
//
// What bounds it on the H100: the five products of FlashAttention-2's
// backward, 10 D flops a visible (q, k) pair (2.5x the forward's four),
// against q, k, v, O, dO, lse, dQ, dK and dV moved once each. At olmo_1b's
// training shape, (4, 16/16, 2048, 128) causal bf16, that is 172 GFLOP
// against 0.27 GB: operations bind it (0.17 ms at the tensor cores' 989
// TFLOP/s, against 0.08 ms for the bytes). This first kernel runs on the
// CUDA cores in f32 (67 TFLOP/s, and the two kernels recompute S and
// dO V^T, 14 D flops a pair), with register tiles fed from shared
// memory: simple and right first; a wgmma body is later work.

#include <math_constants.h>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int THREADS = 256;   // 16 row groups x 16 column lanes

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;        // (B, Hq, Sq, D) contiguous
  const void* dout;     // (B, Hq, Sq, D) contiguous
  const float* lse;     // (B, Hq, Sq)
  float* delta;         // (B, Hq, Sq) scratch, written by delta_kernel
  void* dq;             // (B, Hq, Sq, D) contiguous
  void* dk;             // (B, Hkv, Skv, D) contiguous
  void* dv;             // (B, Hkv, Skv, D) contiguous
  int B, Hq, Hkv, Sq, Skv, group, D;
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

// delta = rowsum(dO * O), one warp a row
template <typename T>
__global__ void __launch_bounds__(THREADS) delta_kernel(BwdParams p) {
  const long long rows = static_cast<long long>(p.B) * p.Hq * p.Sq;
  const long long row =
      static_cast<long long>(blockIdx.x) * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = static_cast<const T*>(p.o) + row * p.D;
  const T* d = static_cast<const T*>(p.dout) + row * p.D;
  float s = 0.f;
  for (int c = lane; c < p.D; c += 32) s += to_f32(o[c]) * to_f32(d[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) p.delta[row] = s;
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
    const float* delta = p.delta + bh * p.Sq;
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
    delta[i] = qp < p.Sq ? p.delta[bh * p.Sq + qp] : 0.f;
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
  const long long rows = static_cast<long long>(p.B) * p.Hq * p.Sq;
  const int per_block = THREADS / 32;
  delta_kernel<T><<<static_cast<unsigned>((rows + per_block - 1) / per_block),
                    THREADS, 0, stream>>>(p);
  err = cudaGetLastError();
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

}  // namespace

// C entry point (loaded with ctypes by repro_torch/kernels/
// flash_attention.py). q, k, v are read through their strides (in
// elements, head dim contiguous); o, dout, dq, dk and dv are contiguous,
// lse and delta (scratch) are (B, Hq, Sq) f32. Launches the delta pass,
// then the dK / dV and the dQ kernels, on ``stream``; returns the first
// cudaGetLastError() code that is not cudaSuccess.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int Hq, int Hkv, int Sq, int Skv, int D,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, int causal, int window, float scale, void* stream) {
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
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
  const cudaError_t err = dtype == repro::kBF16
                              ? dispatch<__nv_bfloat16>(p, s)
                              : dispatch<float>(p, s);
  return static_cast<int>(err);
}
