// K3's split and wgmma bodies as the C entry point sees them (design
// note: paged_verify_attention.cu): their parameters and launchers, whose
// instances are built one (query type T, payload P) pair a file by
// paged_verify_<t>_<p>.cu from paged_verify_split.cuh (every pair) and
// paged_verify_wgmma.cuh (bf16 queries), so nvcc compiles the pairs in
// parallel.
#pragma once

#include "common.cuh"

// K2's combine pass (paged_attention.cu), which the split body launches
// next on the same stream to merge its partial states.
extern "C" int repro_paged_decode_combine(const void* m, const void* l,
                                          const void* acc, void* o,
                                          int dtype, int rows, int nsplit,
                                          int D, void* stream);

namespace repro {

constexpr int kPvMaxSplitBlocks = 128;  // table entries a split CTA holds
constexpr int kPvMaxRows = 32;          // (row, group) pairs a split CTA
constexpr int kPvMaxTable = 1024;       // table entries a wgmma CTA holds

struct PvsParams {
  const void* q;                 // (B, K1, Hq, D)
  const void* k_pool;            // (NB, BS, Hkv, D)
  const void* v_pool;
  const float* k_scale;          // (NB, BS, Hkp), quantized pools only
  const float* v_scale;
  const int* block_table;        // (B, nbmax)
  const int* lengths;            // (B,) tokens before the window
  void* o;                       // (B, K1, Hq, D) when nsplit == 1
  float* m;                      // (B, K1, Hq, nsplit) when nsplit > 1
  float* l;
  float* acc;                    // (B, K1, Hq, nsplit, D)
  // Hkv: the kv heads the grid walks; Hkp: the pool's kv heads (its
  // token row stride), the pointers already at the first head read
  int K1, Hq, Hkv, Hkp, D, BS, NB, nbmax, window, bps, nsplit;
  float scale;
};

// The split body of query type T over payload P on grid (Hkv, B, nsplit)
// for head dim D; cudaErrorInvalidValue for a shape it has no instance
// of (D, or more than kPvMaxRows pairs), else the launch's
// cudaGetLastError().
template <typename T, typename P>
cudaError_t launch_pv_split(const PvsParams& p, int B, int D,
                            cudaStream_t stream);

// The wgmma body (bf16 queries) over payload P: grid (ceil(K1 * G / BQ),
// Hkv, B). cudaErrorInvalidValue for a shape no tensor map or tile
// takes (checked again here: a wrong request is refused, never
// rerouted), else the launch's cudaGetLastError().
template <typename P>
cudaError_t launch_pv_wgmma(const PvsParams& p, int B, int D,
                            cudaStream_t stream);

}  // namespace repro
