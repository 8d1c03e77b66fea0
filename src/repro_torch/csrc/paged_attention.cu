// K2: single-token decode attention over the block-paged KV pool.
//
// Replaces repro/kernels/paged_attention.py::paged_decode_attention_pallas
// (body _pa_kernel). Same function: q (B, Hq, D) holds one query row per
// sequence; k/v pools are (NB, BS, Hkv, D); logical block i of sequence
// b lives in physical block block_table[b, i]; keys are visible when
// kpos < lengths[b] (the count includes the current token) and, with a
// window, kpos >= lengths[b] - window. Softmax runs online in f32 and a
// sequence that sees no key gives a zero row. Output (B, Hq, D).
//
// What bounds it on the H100: memory. Every visible K/V row is read
// once and used for `group` dot products of length D, ~1 flop per byte,
// far below the ~295 flop/byte where the tensor cores would take over.
// The design therefore only tries to read each needed byte once and
// keep enough loads in flight:
//   * one CTA per (sequence, kv head): the CTA reads block_table[b, i]
//     and lengths[b] itself (no scalar prefetch) and serves all `group`
//     query heads of that kv head, so GQA reads each K/V row once;
//   * it walks only the logical blocks the length and window can see,
//     O(sum ceil(len / BS)) block reads as in _pa_kernel, and never
//     dereferences a table entry outside that range (retired slots and
//     pad tails point at the null block 0, which is therefore never
//     read unmasked);
//   * the CTA's 8 warps take interleaved blocks; in a warp each lane
//     owns D/32 consecutive elements of a row (coalesced 256-byte row
//     reads at D = 128 bf16), TC tokens are loaded together before their
//     shuffle reductions so loads overlap, and the 8 warp-partial
//     softmax states are merged through shared memory at the end.
// Split-K across CTAs (flash-decoding) and TMA are later steps.

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::kMaskValue;
using repro::to_f32;

constexpr int NW = 8;            // warps per CTA
constexpr int TC = 4;            // tokens loaded together per warp

struct PaParams {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* block_table;
  const int* lengths;
  void* o;
  int Hq, Hkv, BS, nbmax, window;
  float scale;
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(NW * 32) pa_kernel(PaParams p) {
  constexpr int DPL = D >= 32 ? D / 32 : 1;   // elements per lane
  __shared__ float sm_m[NW][G];
  __shared__ float sm_l[NW][G];
  __shared__ float sm_acc[NW][G][D];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d0 = lane * DPL;
  const bool lane_on = d0 < D;                // D = 16: lanes 16.. idle
  const int len = p.lengths[b];

  const T* qb = static_cast<const T*>(p.q) +
                (static_cast<long long>(b) * p.Hq + hk * G) * D;
  float qv[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      qv[g][e] = lane_on ? to_f32(qb[g * D + d0 + e]) : 0.f;

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kMaskValue;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
  }

  const int lo = p.window > 0 ? max(0, len - p.window) : 0;
  const int i_lo = lo / p.BS;
  const int i_hi = min((len + p.BS - 1) / p.BS, p.nbmax);
  const int* table = p.block_table + static_cast<long long>(b) * p.nbmax;
  const long long row = static_cast<long long>(p.Hkv) * D;  // token stride
  const T* kp = static_cast<const T*>(p.k_pool) + hk * D + d0;
  const T* vp = static_cast<const T*>(p.v_pool) + hk * D + d0;

  for (int i = i_lo + warp; i < i_hi; i += NW) {
    const long long blk = static_cast<long long>(table[i]) * p.BS * row;
    for (int t0 = 0; t0 < p.BS; t0 += TC) {
      bool valid[TC];
      float kv[TC][DPL], vv[TC][DPL];
#pragma unroll
      for (int t = 0; t < TC; ++t) {
        const int tok = t0 + t;
        const int kpos = i * p.BS + tok;
        valid[t] = tok < p.BS && kpos < len && kpos >= lo;
        const long long off = blk + tok * row;
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          const bool ld = valid[t] && lane_on;
          kv[t][e] = ld ? to_f32(kp[off + e]) : 0.f;
          vv[t][e] = ld ? to_f32(vp[off + e]) : 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s[TC];
#pragma unroll
        for (int t = 0; t < TC; ++t) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < DPL; ++e) part = fmaf(qv[g][e], kv[t][e], part);
          s[t] = part;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
#pragma unroll
          for (int t = 0; t < TC; ++t)
            s[t] += __shfl_xor_sync(0xffffffffu, s[t], off);
        float mx = kMaskValue;
#pragma unroll
        for (int t = 0; t < TC; ++t) {
          s[t] *= p.scale;
          if (valid[t]) mx = fmaxf(mx, s[t]);
        }
        const float m_new = fmaxf(m[g], mx);
        const float corr = expf(m[g] - m_new);
        float sum = 0.f;
        float pr[TC];
#pragma unroll
        for (int t = 0; t < TC; ++t) {
          pr[t] = valid[t] ? expf(s[t] - m_new) : 0.f;
          sum += pr[t];
        }
        l[g] = l[g] * corr + sum;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          float a = acc[g][e] * corr;
#pragma unroll
          for (int t = 0; t < TC; ++t) a = fmaf(pr[t], vv[t][e], a);
          acc[g][e] = a;
        }
      }
    }
  }

  // Merge the NW warp-partial (m, l, acc) states of each query row.
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
    if (lane_on) {
#pragma unroll
      for (int e = 0; e < DPL; ++e) sm_acc[warp][g][d0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  T* ob = static_cast<T*>(p.o) +
          (static_cast<long long>(b) * p.Hq + hk * G) * D;
  for (int idx = threadIdx.x; idx < G * D; idx += NW * 32) {
    const int g = idx / D, d = idx % D;
    float mx = kMaskValue;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * c;
      a += sm_acc[w][g][d] * c;
    }
    ob[idx] = from_f32<T>(a / (lsum == 0.f ? 1.f : lsum));
  }
}

template <typename T, int D>
cudaError_t launch_g(const PaParams& p, int B, int G, cudaStream_t stream) {
  const dim3 grid(p.Hkv, B);
  switch (G) {
    case 1: pa_kernel<T, D, 1><<<grid, NW * 32, 0, stream>>>(p); break;
    case 2: pa_kernel<T, D, 2><<<grid, NW * 32, 0, stream>>>(p); break;
    case 4: pa_kernel<T, D, 4><<<grid, NW * 32, 0, stream>>>(p); break;
    case 8: pa_kernel<T, D, 8><<<grid, NW * 32, 0, stream>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const PaParams& p, int B, int G, int D,
                     cudaStream_t stream) {
  switch (D) {
    case 16: return launch_g<T, 16>(p, B, G, stream);
    case 32: return launch_g<T, 32>(p, B, G, stream);
    case 64: return launch_g<T, 64>(p, B, G, stream);
    case 128: return launch_g<T, 128>(p, B, G, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point (loaded with ctypes by repro_torch/kernels/
// paged_attention.py). All tensors contiguous; block_table and lengths
// int32. Returns the launch's cudaGetLastError() code.
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_table, const void* lengths, void* o, int dtype, int B,
    int Hq, int Hkv, int D, int BS, int nbmax, int window, float scale,
    void* stream) {
  PaParams p;
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.block_table = static_cast<const int*>(block_table);
  p.lengths = static_cast<const int*>(lengths);
  p.o = o;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.BS = BS;
  p.nbmax = nbmax;
  p.window = window;
  p.scale = scale;
  const int G = Hq / Hkv;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == repro::kBF16
                        ? dispatch<__nv_bfloat16>(p, B, G, D, s)
                        : dispatch<float>(p, B, G, D, s);
  return static_cast<int>(err);
}
