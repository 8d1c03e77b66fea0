// K3's split body and launch_pv_split's definition (design note:
// paged_verify_attention.cu). Included only by the paged_verify_<t>_<p>.cu
// files, each of which instantiates launch_pv_split for one pair.
#pragma once

#include <climits>

#include <math_constants.h>

#include "paged_verify_attention.cuh"

namespace {
namespace pvs {

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::from_f32;
using repro::IsQuant;
using repro::kMaskValue;
using repro::kPvMaxRows;
using repro::kPvMaxSplitBlocks;
using repro::PvsParams;
using repro::to_f32;
using repro::Word;

constexpr int NW = 4;                 // warps per CTA; row r is warp r % NW's
constexpr int THREADS = NW * 32;
constexpr int TT = 32;                // tokens a tile: one a lane for scores
constexpr int kRingBytes = 40960;     // shared memory for the tile ring

constexpr int clamp_int(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The split body's geometry for payload P and head dim D.
template <typename P, int D>
struct Geo {
  static constexpr bool Q = IsQuant<P>::value;
  static constexpr int RB = D * static_cast<int>(sizeof(P));  // row bytes
  static constexpr int KRS = RB + 16;   // K row stride: a lane a row, no
                                        // two lanes of a quarter-warp on a bank
  static constexpr int VN = 16 / static_cast<int>(sizeof(P));  // a chunk
  static constexpr int EPL = D >= 32 ? D / 32 : 1;  // V elements a lane
  static constexpr int STAGE = TT * (KRS + RB) + (Q ? 2 * TT * 4 : 0);
  static constexpr int S = clamp_int(kRingBytes / STAGE, 2, 4);  // tiles
  template <int RW>
  static constexpr int smem() {
    return S * STAGE + NW * RW * D * 4;   // the ring, then q rows in f32
  }
};

// N elements of P at ``src`` (aligned to their size) as f32.
template <typename P, int N>
__device__ __forceinline__ void load_elems(const unsigned char* src,
                                           float* out) {
  constexpr int BYTES = N * static_cast<int>(sizeof(P));
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      repro::unpack16<P>(reinterpret_cast<const uint4*>(src)[i],
                         out + i * repro::kVec<P>);
  } else if constexpr (BYTES == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    Word<P>::unpack(u.x, out);
    Word<P>::unpack(u.y, out + Word<P>::N);
  } else if constexpr (BYTES == 4) {
    Word<P>::unpack(*reinterpret_cast<const unsigned*>(src), out);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = to_f32(reinterpret_cast<const P*>(src)[e]);
  }
}

// Start the copies of the tile of keys [t0, t0 + TT) into ring stage
// ``st``: each token's K row (padded to KRS bytes) and V row of kv head
// hk, 16-byte cp.async pieces, and for a quantized payload its two
// scales by 4-byte copies. Tokens at or past khi are zero-filled, never
// read; the table entries are the split's, staged in sm_tab from entry
// i_first.
template <typename P, int D>
__device__ __forceinline__ void load_tile(unsigned char* st,
                                          const PvsParams& p,
                                          const int* sm_tab, int i_first,
                                          int hk, int t0, int khi) {
  using Gm = Geo<P, D>;
  constexpr int RB = Gm::RB, KRS = Gm::KRS, PIECES = RB / 16;
  const unsigned char* kpool = static_cast<const unsigned char*>(p.k_pool);
  const unsigned char* vpool = static_cast<const unsigned char*>(p.v_pool);
  const long long row_stride = static_cast<long long>(p.Hkp) * RB;
  auto token_row = [&](int kpos) {   // BS need not be a power of two
    const int i = kpos / p.BS;
    return static_cast<long long>(sm_tab[i - i_first]) * p.BS +
           (kpos - i * p.BS);
  };
  for (int idx = threadIdx.x; idx < TT * PIECES; idx += THREADS) {
    const int tt = idx / PIECES;
    const int pc = idx % PIECES;
    const bool ok = t0 + tt < khi;
    const long long off =
        ok ? token_row(t0 + tt) * row_stride + hk * RB + pc * 16 : 0;
    cp_async16(st + tt * KRS + pc * 16, kpool + off, ok ? 16 : 0);
    cp_async16(st + TT * KRS + tt * RB + pc * 16, vpool + off, ok ? 16 : 0);
  }
  if constexpr (Gm::Q) {
    float* sc = reinterpret_cast<float*>(st + TT * (KRS + RB));
    for (int tt = threadIdx.x; tt < TT; tt += THREADS) {
      const bool ok = t0 + tt < khi;
      const long long s = ok ? token_row(t0 + tt) * p.Hkp + hk : 0;
      cp_async4(sc + tt, p.k_scale + s, ok ? 4 : 0);
      cp_async4(sc + TT + tt, p.v_scale + s, ok ? 4 : 0);
    }
  }
}

// One (kv head, sequence, split) a CTA, every (row j, group g) pair of
// the window served from the same tiles: pair r = j * G + g is row i =
// r / NW of warp r % NW, at most RW rows a warp.
template <typename T, typename P, int D, int RW>
__global__ void __launch_bounds__(THREADS) pv_split_kernel(PvsParams p) {
  using Gm = Geo<P, D>;
  constexpr int S = Gm::S, KRS = Gm::KRS, RB = Gm::RB, VN = Gm::VN;
  constexpr int EPL = Gm::EPL, PIECES = RB / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sm_tab[kPvMaxSplitBlocks];
  float* Qs = reinterpret_cast<float*>(smem + S * Gm::STAGE);  // [NW RW][D]

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int G = p.Hq / p.Hkv;
  const int R = p.K1 * G;
  const int nrw = warp < R ? (R - warp + NW - 1) / NW : 0;  // warp-uniform

  // The split's keys [klo, khi): its blocks, clipped below by row 0's
  // window floor and above by row K1 - 1's limit and the table's end.
  const int len = p.lengths[b];
  const int s_max = p.nbmax * p.BS;
  const int lo = p.window > 0 ? max(0, len + 1 - p.window) : 0;
  const int hi = min(len + p.K1, s_max);
  const int span = p.bps * p.BS;
  const int klo = max(split * span, lo);
  const int khi = min((split + 1) * span, hi);

  float m[RW], l[RW], acc[RW][EPL];
  int lim[RW], flo[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int limit = len + 1 + (warp + NW * i) / G;
    lim[i] = min(limit, s_max);
    flo[i] = p.window > 0 ? limit - p.window : INT_MIN;
    m[i] = kMaskValue;
    l[i] = 0.f;                    // this lane's share of the row's sum
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[i][e] = 0.f;
  }
  const int d0 = lane * EPL;       // the V elements this lane owns
  const bool d_on = d0 < D;

  if (klo < khi) {                 // the same branch for the whole CTA
    const int i_first = klo / p.BS;
    const int nblk = (khi - 1) / p.BS - i_first + 1;
    const int* table = p.block_table +
                       static_cast<long long>(b) * p.nbmax + i_first;
    for (int t = threadIdx.x; t < nblk; t += THREADS) sm_tab[t] = table[t];
    const T* qb = static_cast<const T*>(p.q) +
                  static_cast<long long>(b) * p.K1 * p.Hq * D;
    for (int idx = threadIdx.x; idx < min(R, NW * RW) * D; idx += THREADS) {
      const int r = idx / D, d = idx % D;
      const int j = r / G, g = r % G;
      Qs[r * D + d] =
          to_f32(qb[(static_cast<long long>(j) * p.Hq + hk * G + g) * D + d]);
    }
    __syncthreads();               // sm_tab, Qs

    auto load = [&](int tile) {
      load_tile<P, D>(smem + (tile % S) * Gm::STAGE, p, sm_tab, i_first, hk,
                      klo + tile * TT, khi);
    };

    const int ntiles = (khi - klo + TT - 1) / TT;
#pragma unroll
    for (int t = 0; t < S; ++t) {
      if (t < ntiles) load(t);
      cp_async_commit();
    }
    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait<S - 1>();      // tile t is in this thread's stage ...
      __syncthreads();             // ... and in every thread's
      const unsigned char* kb = smem + (t % S) * Gm::STAGE;
      const unsigned char* vb = kb + TT * KRS;
      const float* sc = reinterpret_cast<const float*>(vb + TT * RB);
      const int t0 = klo + t * TT;
      if (nrw > 0) {
        // scores: lane = token, q rows broadcast from shared memory
        const int kpos = t0 + lane;
        const bool tok_ok = kpos < khi;
        float s[RW];
#pragma unroll
        for (int i = 0; i < RW; ++i) s[i] = 0.f;
        const unsigned char* krow = kb + lane * KRS;
#pragma unroll 2
        for (int c = 0; c < PIECES; ++c) {
          float kf[VN];
          repro::unpack16<P>(*reinterpret_cast<const uint4*>(krow + c * 16),
                             kf);
#pragma unroll
          for (int i = 0; i < RW; ++i) {
            if (i < nrw) {
              const float4* qr = reinterpret_cast<const float4*>(
                  Qs + (warp + NW * i) * D + c * VN);
#pragma unroll
              for (int v = 0; v < VN / 4; ++v) {
                const float4 qq = qr[v];
                s[i] = fmaf(qq.x, kf[4 * v], s[i]);
                s[i] = fmaf(qq.y, kf[4 * v + 1], s[i]);
                s[i] = fmaf(qq.z, kf[4 * v + 2], s[i]);
                s[i] = fmaf(qq.w, kf[4 * v + 3], s[i]);
              }
            }
          }
        }
        // the online softmax of each row over this tile; K4's key scale
        // multiplies the score, its value scale the probability
        const float ksc = Gm::Q ? sc[lane] : 1.f;
        const float vsc = Gm::Q ? sc[TT + lane] : 1.f;
        float pr[RW];
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          pr[i] = 0.f;
          if (i < nrw) {
            const bool valid = tok_ok && kpos < lim[i] && kpos >= flo[i];
            const float x = valid ? s[i] * ksc * p.scale : -CUDART_INF_F;
            float mx = x;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            const float corr = expf(m[i] - m_new);
            const float e = valid ? expf(x - m_new) : 0.f;
            l[i] = l[i] * corr + e;
            m[i] = m_new;
#pragma unroll
            for (int k = 0; k < EPL; ++k) acc[i][k] *= corr;
            pr[i] = e * vsc;
          }
        }
        // acc += p v: lane = its EPL elements of the row, p by shuffle
        const int ntok = min(TT, khi - t0);
#pragma unroll 4
        for (int tt = 0; tt < ntok; ++tt) {
          float vv[EPL];
          if (d_on) {
            load_elems<P, EPL>(vb + tt * RB + d0 * static_cast<int>(sizeof(P)),
                               vv);
          } else {
#pragma unroll
            for (int k = 0; k < EPL; ++k) vv[k] = 0.f;
          }
#pragma unroll
          for (int i = 0; i < RW; ++i) {
            if (i < nrw) {
              const float pt = __shfl_sync(0xffffffffu, pr[i], tt);
#pragma unroll
              for (int k = 0; k < EPL; ++k) acc[i][k] = fmaf(pt, vv[k], acc[i][k]);
            }
          }
        }
      }
      __syncthreads();             // every thread is done with stage t % S
      if (t + S < ntiles) load(t + S);
      cp_async_commit();
    }
    cp_async_wait<0>();            // (only empty groups are left)
  }

  // Each row's state: normalised output with one split, else the
  // split's (m, l, acc) for the combine pass (m = kMaskValue, l = 0,
  // acc = 0 where the split saw no key of the row).
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    if (i >= nrw) continue;
    float lsum = l[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    const int r = warp + NW * i;
    const int j = r / G, g = r % G;
    const long long row =
        (static_cast<long long>(b) * p.K1 + j) * p.Hq + hk * G + g;
    if (p.nsplit == 1) {
      const float inv = 1.f / (lsum == 0.f ? 1.f : lsum);
      if (d_on) {
        T* o = static_cast<T*>(p.o) + row * D + d0;
#pragma unroll
        for (int k = 0; k < EPL; ++k) o[k] = from_f32<T>(acc[i][k] * inv);
      }
    } else {
      const long long pr = row * p.nsplit + split;
      if (d_on) {
#pragma unroll
        for (int k = 0; k < EPL; ++k) p.acc[pr * D + d0 + k] = acc[i][k];
      }
      if (lane == 0) {
        p.m[pr] = m[i];
        p.l[pr] = lsum;
      }
    }
  }
}

template <typename T, typename P, int D, int RW>
cudaError_t launch_rw(const PvsParams& p, int B, cudaStream_t stream) {
  constexpr int smem = Geo<P, D>::template smem<RW>();
  static_assert(smem <= 227 * 1024 - 4 * kPvMaxSplitBlocks,
                "K3 split tile exceeds the H100's shared memory");
  static const cudaError_t attr = cudaFuncSetAttribute(
      pv_split_kernel<T, P, D, RW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.Hkv, B, p.nsplit);
  pv_split_kernel<T, P, D, RW><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// Two warp depths: 2 rows a warp (up to 8 pairs: the verify step at
// group 1) and 8 (up to 32).
template <typename T, typename P, int D>
cudaError_t launch_d(const PvsParams& p, int B, cudaStream_t stream) {
  const int R = p.K1 * (p.Hq / p.Hkv);
  if (R <= 2 * NW) return launch_rw<T, P, D, 2>(p, B, stream);
  if (R <= kPvMaxRows) return launch_rw<T, P, D, 8>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace pvs
}  // namespace

template <typename T, typename P>
cudaError_t repro::launch_pv_split(const PvsParams& p, int B, int D,
                                   cudaStream_t stream) {
  switch (D) {
    case 16: return pvs::launch_d<T, P, 16>(p, B, stream);
    case 32: return pvs::launch_d<T, P, 32>(p, B, stream);
    case 64: return pvs::launch_d<T, P, 64>(p, B, stream);
    case 128: return pvs::launch_d<T, P, 128>(p, B, stream);
    case 256: return pvs::launch_d<T, P, 256>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}
