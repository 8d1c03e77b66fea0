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
// K4 (the quantized pool, JAX's _dequant inside _pa_kernel): the payload
// type P is a template parameter apart from the query/output type T. An
// int8 or fp8 (e4m3) payload carries f32 scales of (NB, BS, Hkv); each
// lane converts its row slice to f32 as it loads it and, once the loads
// of its TC tokens are in flight, multiplies it by the (token, head)
// scale, so the dequantized rows exist only in registers. The bytes per
// visible token and kv head fall from 2 * D * 2 (bf16) to 2 * (D + 4),
// and the bound with them.
// Split-K across CTAs (flash-decoding) and TMA are later steps.

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::IsQuant;
using repro::kMaskValue;
using repro::to_f32;

constexpr int NW = 8;            // warps per CTA
constexpr int TC = 4;            // tokens loaded together per warp

struct PaParams {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;          // (NB, BS, Hkv), quantized pools only
  const float* v_scale;
  const int* block_table;
  const int* lengths;
  void* o;
  int Hq, Hkv, BS, nbmax, window;
  float scale;
};

template <typename T, typename P, int D, int G>
__global__ void __launch_bounds__(NW * 32) pa_kernel(PaParams p) {
  constexpr int DPL = D >= 32 ? D / 32 : 1;   // elements per lane
  constexpr bool Q = IsQuant<P>::value;
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
  const P* kp = static_cast<const P*>(p.k_pool) + hk * D + d0;
  const P* vp = static_cast<const P*>(p.v_pool) + hk * D + d0;

  for (int i = i_lo + warp; i < i_hi; i += NW) {
    // the block's first token row, and its offset in payload elements:
    // a token's offset then costs one multiply-add
    const long long brow = static_cast<long long>(table[i]) * p.BS;
    const long long blk = brow * row;
    for (int t0 = 0; t0 < p.BS; t0 += TC) {
      bool valid[TC];
      float kv[TC][DPL], vv[TC][DPL], ks[TC], vs[TC];
#pragma unroll
      for (int t = 0; t < TC; ++t) {
        const int tok = t0 + t;
        const int kpos = i * p.BS + tok;
        valid[t] = tok < p.BS && kpos < len && kpos >= lo;
        const bool ld = valid[t] && lane_on;
        const long long off = blk + tok * row;
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          kv[t][e] = ld ? to_f32(kp[off + e]) : 0.f;
          vv[t][e] = ld ? to_f32(vp[off + e]) : 0.f;
        }
        if constexpr (Q) {     // one scale per (row, head)
          const long long s = (brow + tok) * p.Hkv + hk;
          ks[t] = ld ? p.k_scale[s] : 0.f;
          vs[t] = ld ? p.v_scale[s] : 0.f;
        }
      }
      if constexpr (Q) {       // fused dequant (K4), after every load
#pragma unroll
        for (int t = 0; t < TC; ++t)
#pragma unroll
          for (int e = 0; e < DPL; ++e) {
            kv[t][e] *= ks[t];
            vv[t][e] *= vs[t];
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

// The merge keeps NW * G * D f32 in static shared memory (at most 48
// KB), so G * D is at most 1024: D 256 takes groups up to 4.
constexpr int kMaxGroupDims = 1024;

template <typename T, typename P, int D>
cudaError_t launch_g(const PaParams& p, int B, int G, cudaStream_t stream) {
  const dim3 grid(p.Hkv, B);
  switch (G) {
    case 1: pa_kernel<T, P, D, 1><<<grid, NW * 32, 0, stream>>>(p); break;
    case 2: pa_kernel<T, P, D, 2><<<grid, NW * 32, 0, stream>>>(p); break;
    case 4: pa_kernel<T, P, D, 4><<<grid, NW * 32, 0, stream>>>(p); break;
    case 8:
      if constexpr (8 * D <= kMaxGroupDims) {
        pa_kernel<T, P, D, 8><<<grid, NW * 32, 0, stream>>>(p);
        break;
      }
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t dispatch_d(const PaParams& p, int B, int G, int D,
                       cudaStream_t stream) {
  switch (D) {
    case 16: return launch_g<T, P, 16>(p, B, G, stream);
    case 32: return launch_g<T, P, 32>(p, B, G, stream);
    case 64: return launch_g<T, P, 64>(p, B, G, stream);
    case 128: return launch_g<T, P, 128>(p, B, G, stream);
    case 256: return launch_g<T, P, 256>(p, B, G, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Payload code: the query type's own code (a float pool), kI8 or kFP8.
template <typename T>
cudaError_t dispatch(const PaParams& p, int pdtype, int B, int G, int D,
                     cudaStream_t stream) {
  if (pdtype == repro::kI8) return dispatch_d<T, int8_t>(p, B, G, D, stream);
  if (pdtype == repro::kFP8)
    return dispatch_d<T, __nv_fp8_e4m3>(p, B, G, D, stream);
  return dispatch_d<T, T>(p, B, G, D, stream);
}

}  // namespace

// C entry point (loaded with ctypes by repro_torch/kernels/
// paged_attention.py). All tensors contiguous, the pools 16-byte
// aligned; block_table and lengths int32; k_scale / v_scale (NB, BS,
// Hkv) f32 when pdtype is kI8 or kFP8 (else unused). Returns the
// launch's cudaGetLastError() code.
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_table,
    const void* lengths, void* o, int dtype, int pdtype, int B, int Hq,
    int Hkv, int D, int BS, int nbmax, int window, float scale,
    void* stream) {
  const bool quant = pdtype == repro::kI8 || pdtype == repro::kFP8;
  if (quant ? (k_scale == nullptr || v_scale == nullptr) : pdtype != dtype)
    return static_cast<int>(cudaErrorInvalidValue);
  PaParams p;
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
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
                        ? dispatch<__nv_bfloat16>(p, pdtype, B, G, D, s)
                        : dispatch<float>(p, pdtype, B, G, D, s);
  return static_cast<int>(err);
}
