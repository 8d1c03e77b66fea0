// K2: single-token decode attention over the block-paged KV pool, split
// over the keys (flash-decoding), and the pass that combines the splits.
//
// Replaces repro/kernels/paged_attention.py::paged_decode_attention_pallas
// (body _pa_kernel). Same function: q (B, Hq, D) holds one query row per
// sequence; k/v pools are (NB, BS, Hkv, D); logical block i of sequence
// b lives in physical block block_table[b, i]; keys are visible when
// kpos < lengths[b] (the count includes the current token) and, with a
// window, kpos >= lengths[b] - window; positions past the table (nbmax *
// BS) do not exist. Softmax runs online in f32 and a sequence that sees
// no key gives a zero row. Output (B, Hq, D).
//
// What bounds it on the H100: bytes. Every visible K/V row is read once
// and used for `group` dot products of length D, ~1 flop per byte, far
// below the ~295 flop/byte where the tensor cores would take over, so
// the arithmetic stays on the CUDA cores in f32. The first design (one
// CTA per (kv head, sequence), each warp walking its blocks with
// element-wide loads) was bound by latency instead: 128 CTAs on 132
// SMs, and the longest sequence's warps waited on ~20 round trips to
// memory one after another. This design keeps the bytes in flight:
//   * split-K: the grid is (Hkv, B, nsplit). CTA s of a (kv head,
//     sequence) takes logical blocks [s * bps, (s + 1) * bps) of its
//     table, clipped to what the length and window can see; a split that
//     sees nothing writes an empty state and exits. bps and nsplit come
//     from the wrapper's plan (kernels/paged_attention.py split_plan),
//     a function of shapes only, so a captured CUDA graph replays for any
//     lengths and table;
//   * table first: the CTA reads its split's visible table entries into
//     shared memory in one load before it touches the pool. Entries of
//     blocks no key of the split can see are never read (they may hold
//     anything);
//   * 16-byte asynchronous copies: every visible token's K and V row for
//     this kv head (D payload elements, strided by the pool's Hkp * D)
//     streams into a ring of S tiles of TT tokens in shared memory with
//     cp.async.cg, one commit group per tile and all S tiles in flight
//     (64 tokens at D 128 bf16: the whole 4-block split of the main
//     path). Masked tokens of a tile are zero-filled, never read;
//   * each lane owns a CB-byte chunk of a row (16 bytes, narrower where a
//     large GQA group would run out of registers), so R = row bytes / CB
//     lanes share a row and a warp takes 32 / R tokens at once; shared
//     memory is read in CB-byte words, bank-conflict free (a warp reads
//     32 consecutive chunks), and unpacked with repro::Word. Each token
//     slot keeps its own online-softmax state, merged across slots with
//     shuffles and across the 4 warps through shared memory;
//   * every split writes its (m, l) and unnormalised f32 accumulator to
//     scratch (m = kMaskValue, l = 0, acc = 0 where it saw no key: finite,
//     so exp(m_s - m*) never meets inf - inf); pa_combine_kernel merges
//     them in split order, a warp per query row. With one split the
//     kernel normalises and writes the output itself.
// K4 (the quantized pool, JAX's _dequant inside _pa_kernel): the payload
// type P is a template parameter apart from the query/output type T. An
// int8 or fp8 (e4m3) payload rides the same 16-byte copies (16 elements
// a copy against 8 in bf16), and the f32 per-(token, head) scales, 4
// bytes strided by Hkv (below the 16-byte minimum of a TMA box), ride
// 4-byte cp.async.ca copies in the same commit group. Each element is
// converted to f32 and then multiplied by its scale, _dequant's order,
// in registers; the dequantized rows exist nowhere else. The bytes per
// visible token and kv head fall from 2 * D * 2 (bf16) to 2 * (D + 4).
//
// The split kernel lives in paged_attention_split.cuh and is built one
// (query type, payload) pair a file (paged_attention_<t>_<p>.cu); this
// file holds the combine kernel and the C entry points.

#include "paged_attention.cuh"

namespace {

using repro::from_f32;
using repro::kMaskValue;
using repro::kMaxSplitBlocks;
using repro::launch_split;
using repro::PaParams;

constexpr int kCombineRows = 4;       // query rows (warps) per combine CTA

// The splits' partial states of each query row merged in a fixed order:
// m* = max_s m_s, w_s = exp(m_s - m*), out = sum_s w_s acc_s / sum_s w_s
// l_s (0 where the row saw no key). A warp per row: its lanes load the
// splits' m and l together and reduce them with shuffles, then every
// lane sums the float4s of the row it owns over the splits.
template <typename T, int D>
__global__ void __launch_bounds__(kCombineRows * 32)
    pa_combine_kernel(const float* m, const float* l, const float* acc,
                      T* o, int rows, int nsplit) {
  constexpr int V4 = D / 4;                  // float4s in a row
  constexpr int PER = (V4 + 31) / 32;        // per lane
  const int row = blockIdx.x * kCombineRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* mr = m + static_cast<long long>(row) * nsplit;
  const float* lr = l + static_cast<long long>(row) * nsplit;
  float mx = kMaskValue;
  for (int s = lane; s < nsplit; s += 32) mx = fmaxf(mx, mr[s]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float lsum = 0.f;
  for (int s = lane; s < nsplit; s += 32)
    lsum = fmaf(expf(mr[s] - mx), lr[s], lsum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
  float4 a[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) a[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(mr[s] - mx);
    const float4* ar = reinterpret_cast<const float4*>(
        acc + (static_cast<long long>(row) * nsplit + s) * D);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int v = lane + 32 * k;
      if (v < V4) {
        const float4 x = ar[v];
        a[k].x = fmaf(w, x.x, a[k].x);
        a[k].y = fmaf(w, x.y, a[k].y);
        a[k].z = fmaf(w, x.z, a[k].z);
        a[k].w = fmaf(w, x.w, a[k].w);
      }
    }
  }
  const float den = lsum == 0.f ? 1.f : lsum;
  T* orow = o + static_cast<long long>(row) * D;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int v = lane + 32 * k;
    if (v < V4) {
      orow[4 * v] = from_f32<T>(a[k].x / den);
      orow[4 * v + 1] = from_f32<T>(a[k].y / den);
      orow[4 * v + 2] = from_f32<T>(a[k].z / den);
      orow[4 * v + 3] = from_f32<T>(a[k].w / den);
    }
  }
}

// Payload code: the query type's own code (a float pool), kI8 or kFP8.
template <typename T>
cudaError_t dispatch(const PaParams& p, int pdtype, int B, int G, int D,
                     cudaStream_t stream) {
  if (pdtype == repro::kI8) return launch_split<T, int8_t>(p, B, G, D, stream);
  if (pdtype == repro::kFP8)
    return launch_split<T, __nv_fp8_e4m3>(p, B, G, D, stream);
  return launch_split<T, T>(p, B, G, D, stream);
}

template <typename T, int D>
cudaError_t combine_launch(const float* m, const float* l, const float* acc,
                           void* o, int rows, int nsplit,
                           cudaStream_t stream) {
  const int grid = (rows + kCombineRows - 1) / kCombineRows;
  pa_combine_kernel<T, D><<<grid, kCombineRows * 32, 0, stream>>>(
      m, l, acc, static_cast<T*>(o), rows, nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t combine_d(const float* m, const float* l, const float* acc,
                      void* o, int rows, int nsplit, int D,
                      cudaStream_t s) {
  switch (D) {
    case 16: return combine_launch<T, 16>(m, l, acc, o, rows, nsplit, s);
    case 32: return combine_launch<T, 32>(m, l, acc, o, rows, nsplit, s);
    case 64: return combine_launch<T, 64>(m, l, acc, o, rows, nsplit, s);
    case 128: return combine_launch<T, 128>(m, l, acc, o, rows, nsplit, s);
    case 256: return combine_launch<T, 256>(m, l, acc, o, rows, nsplit, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points (loaded with ctypes by repro_torch/kernels/
// paged_attention.py). All tensors contiguous, the pools 16-byte
// aligned; block_table and lengths int32; k_scale / v_scale (NB, BS,
// Hkp) f32 when pdtype is kI8 or kFP8 (else unused). The pools hold Hkp
// kv heads, of which the call reads [kv_lo, kv_lo + Hkv) (common.cuh
// kv_range; the whole pool: kv_lo 0, Hkp = Hkv). The split plan:
// bps blocks a split, nsplit splits covering the table (nsplit * bps >=
// nbmax). o is (B, Hq, D) in dtype. With nsplit > 1, ``scratch`` holds
// B * Hq * nsplit * (D + 2) f32: the splits' acc (B, Hq, nsplit, D), then
// m and l (B, Hq, nsplit); the split kernel fills it and the combine
// kernel, launched next on the same stream, writes o. Returns the first
// non-zero cudaGetLastError() of its launches, each checked as it is
// made.
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_table,
    const void* lengths, void* o, void* scratch, int dtype, int pdtype,
    int B, int Hq, int Hkv, int D, int BS, int nbmax, int window,
    float scale, int bps, int nsplit, int kv_lo, int Hkp, void* stream) {
  const bool quant = pdtype == repro::kI8 || pdtype == repro::kFP8;
  if (quant ? (k_scale == nullptr || v_scale == nullptr) : pdtype != dtype)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!repro::kv_range(k_pool, v_pool, k_scale, v_scale, pdtype, D, kv_lo,
                       Hkv, Hkp))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bps < 1 || bps > kMaxSplitBlocks || nsplit < 1 || nsplit > 65535 ||
      static_cast<long long>(nsplit) * bps < nbmax || o == nullptr ||
      (nsplit > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long parts = static_cast<long long>(B) * Hq * nsplit;
  float* acc = static_cast<float*>(scratch);
  PaParams p;
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.block_table = static_cast<const int*>(block_table);
  p.lengths = static_cast<const int*>(lengths);
  p.o = o;
  p.acc = nsplit > 1 ? acc : nullptr;
  p.m = nsplit > 1 ? acc + parts * D : nullptr;
  p.l = nsplit > 1 ? acc + parts * (D + 1) : nullptr;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Hkp = Hkp;
  p.BS = BS;
  p.nbmax = nbmax;
  p.window = window;
  p.bps = bps;
  p.nsplit = nsplit;
  p.scale = scale;
  const int G = Hq / Hkv;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == repro::kBF16;
  cudaError_t err = bf16 ? dispatch<__nv_bfloat16>(p, pdtype, B, G, D, s)
                         : dispatch<float>(p, pdtype, B, G, D, s);
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  const int rows = B * Hq;
  err = bf16 ? combine_d<__nv_bfloat16>(p.m, p.l, acc, o, rows, nsplit, D, s)
             : combine_d<float>(p.m, p.l, acc, o, rows, nsplit, D, s);
  return static_cast<int>(err);
}

// The combine pass alone, over partial states the caller holds: m, l
// (rows, nsplit) and acc (rows, nsplit, D) f32 -> o (rows, D) in dtype.
extern "C" int repro_paged_decode_combine(const void* m, const void* l,
                                          const void* acc, void* o,
                                          int dtype, int rows, int nsplit,
                                          int D, void* stream) {
  if (rows < 0 || nsplit < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const float* mp = static_cast<const float*>(m);
  const float* lp = static_cast<const float*>(l);
  const float* ap = static_cast<const float*>(acc);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == repro::kBF16
          ? combine_d<__nv_bfloat16>(mp, lp, ap, o, rows, nsplit, D, s)
          : combine_d<float>(mp, lp, ap, o, rows, nsplit, D, s);
  return static_cast<int>(err);
}
