// K3's wgmma body (bf16 queries; the suffix prefill on the tensor cores)
// and launch_pv_wgmma's definition (design note:
// paged_verify_attention.cu). Included only by the paged_verify_bf16_<p>.cu
// files, each of which instantiates launch_pv_wgmma for one payload.
#pragma once

#include <climits>

#include <math_constants.h>

#include "hopper.cuh"
#include "paged_verify_attention.cuh"

namespace {
namespace pvw {

namespace hw = repro::hopper;
using repro::IsQuant;
using repro::kMaskValue;
using repro::kPvMaxTable;
using repro::PvsParams;

constexpr int BKV = 64;          // keys a K/V tile

// Tile geometry for payload P and template width DP (64, 128 or 256
// lanes of D).
template <typename P, int DP>
struct Cfg {
  static constexpr bool Q = IsQuant<P>::value;
  static constexpr int NWG = DP > 128 ? 1 : 2;    // consumer warpgroups
  static constexpr int BQ = 64 * NWG;             // (row, group) pairs a CTA
  static constexpr int CONSUMERS = 128 * NWG;
  // a bf16 pool adds one TMA producer warp; a quantized pool is loaded
  // and dequantized by the consumers themselves
  static constexpr int THREADS = CONSUMERS + (Q ? 0 : 32);
  static constexpr int STAGES = 2;
  // every tile is DP / 64 column boxes of (rows x 128 B), 128B-swizzled
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BKV * DP * 2;   // a bf16 K or V tile
  // bf16 pool: STAGES (K, V) tile pairs written by TMA; quantized pool:
  // one bf16 pair written by the dequant pass, and STAGES staging
  // stages of payload rows (DP bytes apart) and f32 scales (cp.async)
  static constexpr int KV_TILES = Q ? 2 * KV_BYTES : STAGES * 2 * KV_BYTES;
  static constexpr int STG_BYTES = Q ? 2 * BKV * DP + 2 * BKV * 4 : 0;
  static constexpr size_t SMEM =
      Q_BYTES + KV_TILES + STAGES * STG_BYTES + 1024;
};

// Byte offset of 16-byte chunk c of row r in a 128B-swizzled tile of
// ``rows`` rows (column block c / 8, 1024-byte aligned): the swizzle TMA
// writes and the wgmma descriptors read.
__device__ __forceinline__ int sw128_offset(int rows, int r, int c) {
  return (c / 8) * rows * 128 + r * 128 + (((c % 8) ^ (r % 8)) << 4);
}

template <typename P, int DP>
__global__ void __launch_bounds__(Cfg<P, DP>::THREADS, 1)
    pv_wgmma(const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, PvsParams p) {
  using C = Cfg<P, DP>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[C::STAGES], empty[C::STAGES];
  __shared__ int sm_tab[kPvMaxTable];
  uint8_t* smem = smem_raw + ((1024 - (hw::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* KVs = smem + C::Q_BYTES;
  uint8_t* stg = KVs + C::KV_TILES;

  const int G = p.Hq / p.Hkv;
  const int R = p.K1 * G;
  // the tiles of the longest rows first, so the short ones fill the
  // last wave
  const int r_lo = (gridDim.x - 1 - blockIdx.x) * C::BQ;
  const int r_hi = min(r_lo + C::BQ, R) - 1;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // Row j of the window sees keys [len + 1 + j - window, len + 1 + j),
  // clipped at the table's end: a causal diagonal shifted by len. The
  // CTA's keys run from its first row's floor to its last row's limit;
  // tiles outside them are skipped before any load.
  const int len = p.lengths[b];
  const int s_max = p.nbmax * p.BS;
  const int j_lo = r_lo / G, j_hi = r_hi / G;
  const int lim_lo = min(len + 1 + j_lo, s_max);
  const int key_hi = min(len + 1 + j_hi, s_max);
  const int key_lo = p.window > 0 ? max(0, len + 1 + j_lo - p.window) : 0;
  const int floor_hi = p.window > 0 ? len + 1 + j_hi - p.window : INT_MIN;
  const bool any = key_lo < key_hi;
  const int kt_lo = key_lo / BKV;
  const int kt_hi = any ? (key_hi + BKV - 1) / BKV : kt_lo;
  const int blk0 = key_lo / p.BS;
  const int nblk = any ? (key_hi - 1) / p.BS - blk0 + 1 : 0;

  // the table entries of the visible blocks, and only those: entries
  // past every row's limit (a suffix chain's NULL tail) may hold anything
  const int* table = p.block_table + static_cast<long long>(b) * p.nbmax;
  for (int t = threadIdx.x; t < nblk; t += C::THREADS)
    sm_tab[t] = table[blk0 + t];
  // Q: pair r_lo + r is (j, g) = divmod(r_lo + r, G), a row of q at
  // (b, j, hk * G + g); plain 16-byte loads into the swizzled layout
  // (the pairs of G > 1 are no 2-D box of q), zeros past the window and
  // past D
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  for (int idx = threadIdx.x; idx < C::BQ * (DP / 8); idx += C::THREADS) {
    const int r = idx / (DP / 8), c = idx % (DP / 8);
    const int pair = r_lo + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (pair < R && c * 8 < p.D) {
      const int j = pair / G, g = pair % G;
      v = *reinterpret_cast<const uint4*>(
          q + ((static_cast<long long>(b) * p.K1 + j) * p.Hq + hk * G + g) *
                  p.D + c * 8);
    }
    *reinterpret_cast<uint4*>(Qs + sw128_offset(C::BQ, r, c)) = v;
  }
  if (!C::Q && threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], C::CONSUMERS);
    }
    hw::fence_barrier_init();
  }
  hw::fence_proxy_async();         // Q's stores, for wgmma
  __syncthreads();                 // sm_tab, Q, the barriers

  if constexpr (!C::Q) {
    if (warp == C::CONSUMERS / 32) {
      // producer: the K and V tiles block by block from the pool, through
      // the ring; lane i loads the i-th (boxr-key) box of a tile. A box
      // no row can see loads from block NB, out of the map: TMA writes
      // zeros and reads nothing, so no table entry past the limits is used
      const int boxr = min(p.BS, BKV);
      const int nbox = BKV / boxr;
      for (int kt = kt_lo, it = 0; kt < kt_hi; ++kt, ++it) {
        const int s = it % C::STAGES;
        if (it >= C::STAGES)
          hw::mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
        if (lane == 0) hw::mbar_arrive_expect_tx(&full[s], 2 * C::KV_BYTES);
        __syncwarp();
        if (lane < nbox) {
          const int key0 = kt * BKV + lane * boxr;
          const int blk = key0 / p.BS;
          const bool vis = key0 < key_hi && key0 + boxr > key_lo;
          const int nb = vis ? sm_tab[blk - blk0] : p.NB;
          const int off = key0 - blk * p.BS;
          uint8_t* kd = KVs + s * 2 * C::KV_BYTES + lane * boxr * 128;
#pragma unroll
          for (int c = 0; c < DP / 64; ++c) {
            hw::tma_load_4d(kd + c * BKV * 128, &kmap, &full[s], 64 * c, hk,
                            off, nb);
            hw::tma_load_4d(kd + C::KV_BYTES + c * BKV * 128, &vmap, &full[s],
                            64 * c, hk, off, nb);
          }
        }
      }
      return;
    }
  }

  // K4: start the copies of tile kt's payload rows and scales into
  // staging stage st; keys outside [key_lo, key_hi) are zero-filled
  // (payload and scale), never read
  auto load_stage = [&](int kt, int st) {
    uint8_t* base = stg + st * C::STG_BYTES;
    const int pcs = p.D / 16;                     // 16-byte pieces a row
    const uint8_t* kpool = static_cast<const uint8_t*>(p.k_pool);
    const uint8_t* vpool = static_cast<const uint8_t*>(p.v_pool);
    for (int idx = threadIdx.x; idx < BKV * pcs; idx += C::THREADS) {
      const int t = idx / pcs, pc = idx % pcs;
      const int key = kt * BKV + t;
      const bool ok = key >= key_lo && key < key_hi;
      long long off = 0;
      if (ok) {
        const int blk = key / p.BS;
        off = ((static_cast<long long>(sm_tab[blk - blk0]) * p.BS +
                (key - blk * p.BS)) * p.Hkp + hk) * p.D + pc * 16;
      }
      repro::cp_async16(base + t * DP + pc * 16, kpool + off, ok ? 16 : 0);
      repro::cp_async16(base + (BKV + t) * DP + pc * 16, vpool + off,
                        ok ? 16 : 0);
    }
    float* sc = reinterpret_cast<float*>(base + 2 * BKV * DP);
    for (int t = threadIdx.x; t < BKV; t += C::THREADS) {
      const int key = kt * BKV + t;
      const bool ok = key >= key_lo && key < key_hi;
      long long so = 0;
      if (ok) {
        const int blk = key / p.BS;
        so = (static_cast<long long>(sm_tab[blk - blk0]) * p.BS +
              (key - blk * p.BS)) * p.Hkp + hk;
      }
      repro::cp_async4(sc + t, p.k_scale + so, ok ? 4 : 0);
      repro::cp_async4(sc + BKV + t, p.v_scale + so, ok ? 4 : 0);
    }
  };
  // K4: payload x scale, rounded to bf16, into the swizzled K and V
  // tiles wgmma reads (_dequant's product; the rows exist nowhere else)
  auto dequant = [&](int st) {
    const uint8_t* base = stg + st * C::STG_BYTES;
    const float* sc = reinterpret_cast<const float*>(base + 2 * BKV * DP);
    constexpr int CH = DP / 8;                    // 16-byte bf16 chunks a row
    for (int idx = threadIdx.x; idx < 2 * BKV * CH; idx += C::THREADS) {
      const int kv = idx / (BKV * CH), rem = idx % (BKV * CH);
      const int t = rem / CH, c = rem % CH;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (c * 8 < p.D) {
        const uint2 u = *reinterpret_cast<const uint2*>(
            base + (kv * BKV + t) * DP + c * 8);
        float f[8];
        repro::Word<P>::unpack(u.x, f);
        repro::Word<P>::unpack(u.y, f + 4);
        const float s = sc[kv * BKV + t];
        out.x = hw::pack_bf16x2(f[0] * s, f[1] * s);
        out.y = hw::pack_bf16x2(f[2] * s, f[3] * s);
        out.z = hw::pack_bf16x2(f[4] * s, f[5] * s);
        out.w = hw::pack_bf16x2(f[6] * s, f[7] * s);
      }
      *reinterpret_cast<uint4*>(KVs + kv * C::KV_BYTES +
                                sw128_offset(BKV, t, c)) = out;
    }
  };
  if constexpr (C::Q) {
#pragma unroll
    for (int st = 0; st < C::STAGES; ++st) {
      if (kt_lo + st < kt_hi) load_stage(kt_lo + st, st);
      repro::cp_async_commit();
    }
  }

  // consumers: warpgroup wg owns tile rows 64 wg .. + 63; this thread
  // rows t0 and t0 + 8 (the accumulator fragment layout), each a (j, g)
  // pair with its own limit and floor
  const int wg = warp / 4;
  const int t0 = wg * 64 + (warp % 4) * 16 + lane / 4;
  int lim[2], flo[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int limit = len + 1 + (r_lo + t0 + 8 * i) / G;
    lim[i] = min(limit, s_max);
    flo[i] = p.window > 0 ? limit - p.window : INT_MIN;
  }
  const float scale_log2 = p.scale * 1.4426950408889634f;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};

  for (int kt = kt_lo, it = 0; kt < kt_hi; ++kt, ++it) {
    const int s = it % C::STAGES;
    const int k_lo = kt * BKV;
    const uint8_t* ks;
    if constexpr (C::Q) {
      repro::cp_async_wait<C::STAGES - 1>();   // stage s landed here ...
      __syncthreads();             // ... and everywhere; last tile's wgmma done
      dequant(s);
      hw::fence_proxy_async();
      __syncthreads();             // K, V tiles written; stage s consumed
      if (kt + C::STAGES < kt_hi) load_stage(kt + C::STAGES, s);
      repro::cp_async_commit();
      ks = KVs;
    } else {
      ks = KVs + s * 2 * C::KV_BYTES;
      hw::mbar_wait(&full[s], (it / C::STAGES) & 1);
    }
    const uint8_t* vs = ks + C::KV_BYTES;

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

    // online softmax on the fragments, in the log2 domain; a tile wholly
    // below every row's limit and above every floor runs unmasked
    const bool edge = k_lo + BKV > lim_lo || k_lo < floor_hi;
    float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float x = sc[4 * n + 2 * i + j] * scale_log2;
          if (edge) {
            const int kpos = k_lo + 8 * n + 2 * (lane % 4) + j;
            if (kpos >= lim[i] || kpos < flo[i]) x = -CUDART_INF_F;
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
    if constexpr (!C::Q) hw::mbar_arrive(&empty[s]);
  }
  if constexpr (C::Q) repro::cp_async_wait<0>();   // (only empty groups)

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int pair = r_lo + t0 + 8 * i;
    if (pair >= R) continue;
    const int j = pair / G, g = pair % G;
    __nv_bfloat16* orow =
        out + ((static_cast<long long>(b) * p.K1 + j) * p.Hq + hk * G + g) *
                  p.D;
    const float inv = 1.f / (li == 0.f ? 1.f : li);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = 8 * n + 2 * (lane % 4);     // D % 8 == 0: both or none
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[4 * n + 2 * i] * inv,
                                  o[4 * n + 2 * i + 1] * inv);
    }
  }
}

template <typename P, int DP>
cudaError_t launch(const PvsParams& p, int B, cudaStream_t stream) {
  using C = Cfg<P, DP>;
  static_assert(C::SMEM + 4 * kPvMaxTable + 64 <= 232448,
                "K3 wgmma tile exceeds the H100's shared memory");
  CUtensorMap kmap{}, vmap{};      // unused over a quantized pool
  if constexpr (!C::Q) {
    // the pool (NB, BS, Hkp, D) from its first head read as a 4-D map
    // over (D, Hkv, BS, NB) with the pool's strides: a box is (64 lanes
    // of D, one kv head, min(BS, 64) tokens, one block)
    const uint64_t D = p.D;
    const uint64_t dims[4] = {D, static_cast<uint64_t>(p.Hkv),
                              static_cast<uint64_t>(p.BS),
                              static_cast<uint64_t>(p.NB)};
    const uint64_t st[3] = {2 * D, 2 * D * p.Hkp, 2 * D * p.Hkp * p.BS};
    const uint32_t box[4] = {
        64, 1, static_cast<uint32_t>(p.BS < BKV ? p.BS : BKV), 1};
    if (!hw::make_bf16_map(&kmap, p.k_pool, 4, dims, st, box) ||
        !hw::make_bf16_map(&vmap, p.v_pool, 4, dims, st, box))
      return cudaErrorInvalidValue;
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      pv_wgmma<P, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (attr != cudaSuccess) return attr;
  const int R = p.K1 * (p.Hq / p.Hkv);
  const dim3 grid((R + C::BQ - 1) / C::BQ, p.Hkv, B);
  pv_wgmma<P, DP><<<grid, C::THREADS, C::SMEM, stream>>>(kmap, vmap, p);
  return cudaGetLastError();
}

}  // namespace pvw
}  // namespace

// What the wgmma body takes (the wrapper's verify_body, checked again
// here so that a wrong request is refused, never rerouted): D a multiple
// of 16 up to 256, BS a multiple of 8 that divides the 64-key tile or is a
// multiple of it (a block's swizzle atoms line up with the tile's), a
// table of at most kPvMaxTable entries, 16-byte aligned q and pools.
template <typename P>
cudaError_t repro::launch_pv_wgmma(const PvsParams& p, int B, int D,
                                   cudaStream_t stream) {
  const bool tiles = p.BS % 8 == 0 && p.BS > 0 &&
                     (pvw::BKV % p.BS == 0 || p.BS % pvw::BKV == 0);
  const void* bases[3] = {p.q, p.k_pool, p.v_pool};
  for (const void* ptr : bases)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return cudaErrorInvalidValue;
  if (D != p.D || D % 16 != 0 || D > 256 || !tiles ||
      p.nbmax > kPvMaxTable || p.Hkv < 1 || p.Hq % p.Hkv != 0)
    return cudaErrorInvalidValue;
  if (D <= 64) return pvw::launch<P, 64>(p, B, stream);
  if (D <= 128) return pvw::launch<P, 128>(p, B, stream);
  return pvw::launch<P, 256>(p, B, stream);
}
