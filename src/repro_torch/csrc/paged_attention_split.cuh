// K2's split kernel and launch_split's definition (design note:
// paged_attention.cu). Included only by the paged_attention_<t>_<p>.cu
// files, each of which instantiates launch_split for one pair.
#pragma once

#include "paged_attention.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::from_f32;
using repro::IsQuant;
using repro::kMaskValue;
using repro::kMaxGroupDims;
using repro::kMaxSplitBlocks;
using repro::PaParams;
using repro::to_f32;
using repro::Word;

constexpr int NW = 4;                 // warps per CTA
constexpr int THREADS = NW * 32;
constexpr int U = 2;                  // tokens per token slot and tile
constexpr int kRingBytes = 32768;     // shared memory for the tile ring

// Elements of P a lane holds when it reads ``cb``-byte chunks of a
// ``rb``-byte row (a row of more than 32 chunks gives a lane several).
template <typename P>
constexpr int lane_elems(int rb, int cb) {
  return (rb / cb > 32 ? rb / cb / 32 : 1) * cb / static_cast<int>(sizeof(P));
}

// The widest chunk (16, 8 or 4 bytes) that keeps G * elements-per-lane
// (the accumulator's registers; q's as many) at 32 or fewer.
template <typename P>
constexpr int chunk_bytes(int rb, int g) {
  int cb = 16;
  while (cb > 4 && g * lane_elems<P>(rb, cb) > 32) cb /= 2;
  return cb;
}

constexpr int clamp_int(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The split kernel's geometry for payload P, head dim D and group G.
template <typename P, int D, int G>
struct Geo {
  static constexpr bool Q = IsQuant<P>::value;
  static constexpr int RB = D * static_cast<int>(sizeof(P));  // row bytes
  static constexpr int CB = chunk_bytes<P>(RB, G);  // lane chunk bytes
  static constexpr int NCH = RB / CB;               // chunks in a row
  static constexpr int R = NCH < 32 ? NCH : 32;     // lanes on one row
  static constexpr int NC = NCH / R;                // chunks per lane
  static constexpr int EPC = CB / static_cast<int>(sizeof(P));
  static constexpr int EPL = NC * EPC;              // elements per lane
  static constexpr int SLOTS = 32 / R;              // token slots a warp
  static constexpr int TT = NW * SLOTS * U;         // tokens per tile
  static constexpr int PIECES = RB / 16;            // 16-byte copies a row
  static constexpr int STAGE = 2 * TT * RB + (Q ? 2 * TT * 4 : 0);
  static constexpr int S = clamp_int(kRingBytes / STAGE, 2, 4);  // tiles
  static constexpr int MERGE = 4 * NW * G * (D + 2);  // warp merge, f32
  static constexpr int SMEM = S * STAGE > MERGE ? S * STAGE : MERGE;
};

// One CB-byte chunk of payload P from shared memory, unpacked to f32.
template <typename P, int CB>
__device__ __forceinline__ void load_chunk(const unsigned char* src,
                                           float* out) {
  if constexpr (CB == 16) {
    repro::unpack16<P>(*reinterpret_cast<const uint4*>(src), out);
  } else if constexpr (CB == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    Word<P>::unpack(u.x, out);
    Word<P>::unpack(u.y, out + Word<P>::N);
  } else {
    Word<P>::unpack(*reinterpret_cast<const unsigned*>(src), out);
  }
}

template <typename T, typename P, int D, int G>
__global__ void __launch_bounds__(THREADS) pa_split_kernel(PaParams p) {
  using Gm = Geo<P, D, G>;
  constexpr int R = Gm::R, NC = Gm::NC, EPC = Gm::EPC, EPL = Gm::EPL;
  constexpr int TT = Gm::TT, S = Gm::S, RB = Gm::RB, CB = Gm::CB;
  __shared__ __align__(16) unsigned char smem[Gm::SMEM];
  __shared__ int sm_tab[kMaxSplitBlocks];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slot = lane / R;       // the token slot of this lane's warp
  const int r = lane % R;          // the lane's place on the row

  // The split's visible keys [klo, khi): its blocks, clipped by the
  // window floor, the length and the table's end.
  const int len = p.lengths[b];
  const int lo = p.window > 0 ? max(0, len - p.window) : 0;
  const int span = p.bps * p.BS;
  const int klo = max(split * span, lo);
  const int khi = min(min((split + 1) * span, len), p.nbmax * p.BS);

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kMaskValue;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  if (klo < khi) {                 // the same branch for the whole CTA
    const int i_first = klo / p.BS;
    const int nblk = (khi - 1) / p.BS - i_first + 1;
    const int* table = p.block_table +
                       static_cast<long long>(b) * p.nbmax + i_first;
    for (int t = threadIdx.x; t < nblk; t += THREADS) sm_tab[t] = table[t];

    // lane element e = c * EPC + j is element (c * R + r) * EPC + j of
    // the row
    const T* qb = static_cast<const T*>(p.q) +
                  (static_cast<long long>(b) * p.Hq + hk * G) * D;
    float qv[G][EPL];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < EPC; ++j)
          qv[g][c * EPC + j] = to_f32(qb[g * D + (c * R + r) * EPC + j]);
    __syncthreads();               // sm_tab

    const unsigned char* kpool = static_cast<const unsigned char*>(p.k_pool);
    const unsigned char* vpool = static_cast<const unsigned char*>(p.v_pool);
    const long long row_stride = static_cast<long long>(p.Hkp) * RB;

    // Physical token row of visible key kpos (the table entry is in
    // sm_tab); BS need not be a power of two.
    auto token_row = [&](int kpos) {
      const int i = kpos / p.BS;
      return static_cast<long long>(sm_tab[i - i_first]) * p.BS +
             (kpos - i * p.BS);
    };
    // Start the copies of tile ``tile`` (keys klo + tile * TT ...) into
    // its ring stage; tokens at or past khi are zero-filled.
    auto load_tile = [&](int tile) {
      unsigned char* st = smem + (tile % S) * Gm::STAGE;
      const int t0 = klo + tile * TT;
      for (int idx = threadIdx.x; idx < TT * Gm::PIECES; idx += THREADS) {
        const int tt = idx / Gm::PIECES;
        const int pc = idx % Gm::PIECES;
        const bool ok = t0 + tt < khi;
        const long long off =
            ok ? token_row(t0 + tt) * row_stride + hk * RB + pc * 16 : 0;
        cp_async16(st + tt * RB + pc * 16, kpool + off, ok ? 16 : 0);
        cp_async16(st + (TT + tt) * RB + pc * 16, vpool + off, ok ? 16 : 0);
      }
      if constexpr (Gm::Q) {
        float* sc = reinterpret_cast<float*>(st + 2 * TT * RB);
        for (int tt = threadIdx.x; tt < TT; tt += THREADS) {
          const bool ok = t0 + tt < khi;
          const long long s = ok ? token_row(t0 + tt) * p.Hkp + hk : 0;
          cp_async4(sc + tt, p.k_scale + s, ok ? 4 : 0);
          cp_async4(sc + TT + tt, p.v_scale + s, ok ? 4 : 0);
        }
      }
    };

    const int ntiles = (khi - klo + TT - 1) / TT;
#pragma unroll
    for (int t = 0; t < S; ++t) {
      if (t < ntiles) load_tile(t);
      cp_async_commit();
    }
    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait<S - 1>();      // tile t is in this thread's stage ...
      __syncthreads();             // ... and in every thread's
      const unsigned char* kb = smem + (t % S) * Gm::STAGE;
      const unsigned char* vb = kb + TT * RB;
      const float* sc = reinterpret_cast<const float*>(vb + TT * RB);
      const int t0 = klo + t * TT;
      bool valid[U];
      float kv[U][EPL], vv[U][EPL];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int tt = (u * NW + warp) * Gm::SLOTS + slot;
        valid[u] = t0 + tt < khi;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int off = tt * RB + (c * R + r) * CB;
          load_chunk<P, CB>(kb + off, &kv[u][c * EPC]);
          load_chunk<P, CB>(vb + off, &vv[u][c * EPC]);
        }
        if constexpr (Gm::Q) {     // fused dequant (K4)
          const float ks = sc[tt], vs = sc[TT + tt];
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            kv[u][e] *= ks;
            vv[u][e] *= vs;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) part = fmaf(qv[g][e], kv[u][e], part);
          s[u] = part;
        }
#pragma unroll
        for (int off = R / 2; off > 0; off >>= 1)
#pragma unroll
          for (int u = 0; u < U; ++u)
            s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
        float mx = kMaskValue;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          s[u] *= p.scale;
          if (valid[u]) mx = fmaxf(mx, s[u]);
        }
        const float m_new = fmaxf(m[g], mx);
        const float corr = expf(m[g] - m_new);
        float pr[U], sum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          pr[u] = valid[u] ? expf(s[u] - m_new) : 0.f;
          sum += pr[u];
        }
        l[g] = l[g] * corr + sum;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          float a = acc[g][e] * corr;
#pragma unroll
          for (int u = 0; u < U; ++u) a = fmaf(pr[u], vv[u][e], a);
          acc[g][e] = a;
        }
      }
      __syncthreads();             // every thread is done with stage t % S
      if (t + S < ntiles) load_tile(t + S);
      cp_async_commit();
    }
    cp_async_wait<0>();            // (only empty groups are left)
  }

  // Merge the token slots of each warp (lanes r, r + R, ... hold the
  // same elements) ...
#pragma unroll
  for (int off = R; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo2 = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float c1 = expf(m[g] - mn), c2 = expf(mo - mn);
      l[g] = l[g] * c1 + lo2 * c2;
      m[g] = mn;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * c1 + ao * c2;
      }
    }
  // ... then the NW warps' states through shared memory (the ring is
  // free: every tile has been consumed).
  float* sm_m = reinterpret_cast<float*>(smem);        // [NW][G]
  float* sm_l = sm_m + NW * G;                         // [NW][G]
  float* sm_acc = sm_l + NW * G;                       // [NW][G][D]
  __syncthreads();
  if (slot == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (r == 0) {
        sm_m[warp * G + g] = m[g];
        sm_l[warp * G + g] = l[g];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < EPC; ++j)
          sm_acc[(warp * G + g) * D + (c * R + r) * EPC + j] =
              acc[g][c * EPC + j];
    }
  }
  __syncthreads();
  const long long row0 = static_cast<long long>(b) * p.Hq + hk * G;
  for (int idx = threadIdx.x; idx < G * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    float mx = kMaskValue;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w * G + g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(sm_m[w * G + g] - mx);
      lsum += sm_l[w * G + g] * c;
      a += sm_acc[(w * G + g) * D + d] * c;
    }
    if (p.nsplit == 1) {
      static_cast<T*>(p.o)[(row0 + g) * D + d] =
          from_f32<T>(a / (lsum == 0.f ? 1.f : lsum));
    } else {
      const long long pr = (row0 + g) * p.nsplit + split;
      p.acc[pr * D + d] = a;
      if (d == 0) {
        p.m[pr] = mx;
        p.l[pr] = lsum;
      }
    }
  }
}

template <typename T, typename P, int D>
cudaError_t launch_g(const PaParams& p, int B, int G, cudaStream_t stream) {
  const dim3 grid(p.Hkv, B, p.nsplit);
  switch (G) {
    case 1: pa_split_kernel<T, P, D, 1><<<grid, THREADS, 0, stream>>>(p); break;
    case 2: pa_split_kernel<T, P, D, 2><<<grid, THREADS, 0, stream>>>(p); break;
    case 4: pa_split_kernel<T, P, D, 4><<<grid, THREADS, 0, stream>>>(p); break;
    case 8:
      if constexpr (8 * D <= kMaxGroupDims) {
        pa_split_kernel<T, P, D, 8><<<grid, THREADS, 0, stream>>>(p);
        break;
      }
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

template <typename T, typename P>
cudaError_t repro::launch_split(const PaParams& p, int B, int G, int D,
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
