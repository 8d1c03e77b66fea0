// K1: blocked online-softmax (flash) attention for prefill.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas
// (body _fa_kernel). Same function: q (B, Hq, Sq, D) attends k/v
// (B, Hkv, Skv, D) with GQA head map h -> h / (Hq / Hkv), key masks
// kpos < Skv, optional causal (kpos <= qpos) and optional window
// (kpos > qpos - window), f32 running (max, sum, acc), a row with no
// visible key gives 0. Output (B, Hq, Sq, D) in q's type.
//
// What bounds it on the H100: at the prefill shapes of the main path
// (D = 128, Sq = Skv up to 512) the work is ~4 * D flops per visible
// (q, k) pair against 4 * D bytes per row read once, so the tensor-core
// rate (989 TFLOP/s bf16) bounds it, not memory. This first version
// does its products on the CUDA cores in f32 (no wgmma), so it runs far
// from that bound; what the design does about the rest:
//   * one CTA per (BQ-row q tile, b * Hq): the q tile stays in shared
//     memory and the CTA computes its own kv head, so GQA and MQA
//     (group 10 for recurrentgemma) need no copy of k/v and q/k/v are
//     read once per CTA from their strided layout (no transpose copy in
//     front of the kernel);
//   * k/v tiles of 64 keys are staged in shared memory as f32 (k
//     transposed, padded strides) so the RPT x 4 score and RPT x (DP/16)
//     output register blocks of each thread read without bank
//     conflicts;
//   * kv tiles entirely past the causal diagonal or outside the window
//     are skipped before any load, the predicate of _fa_kernel;
//   * the ragged edge (Sq, Skv not multiples of the tiles) is masked in
//     the kernel instead of padding the inputs.
// Head dims: the template width DP is 16, 32, 64, 128 or 256, and the
// logical head dim D (<= DP) is a runtime value. Lanes past D load zero
// (the zero tail adds nothing to q.k) and store nothing, so a head dim
// that is no power of two (h2o-danube's 120, in a DP = 128 tile) runs
// without a padded copy of q/k/v. DP = 256 (gemma, recurrentgemma)
// takes BQ = 32 query rows a CTA instead of 64: at 64 the f32 staging
// needs 214,528 B of shared memory and 128 accumulators a thread on top
// of the score block, which spills; at 32 it is 173,312 B and 64.
// Tensor cores (wgmma + TMA) are the next step for this kernel.

#include <math_constants.h>

#include "common.cuh"

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

}  // namespace

// C entry point (loaded with ctypes by repro_torch/kernels/
// flash_attention.py). Strides are in elements; the head dim is
// contiguous. Returns the launch's cudaGetLastError() code.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hkv, int Sq, int Skv, int D, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, int causal, int window,
    float scale, void* stream) {
  FaParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
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
  cudaError_t err = dtype == repro::kBF16
                        ? dispatch<__nv_bfloat16>(p, B, s)
                        : dispatch<float>(p, B, s);
  return static_cast<int>(err);
}
