// K2's split kernel as its C entry points see it (design note:
// paged_attention.cu): its parameters and launch_split, whose instances
// are built one (query type T, payload P) pair a file by
// paged_attention_<t>_<p>.cu from paged_attention_split.cuh, so nvcc
// compiles the pairs in parallel (the kernel is fully unrolled over head
// dim and GQA group, 19 instances a pair).
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kMaxSplitBlocks = 128;  // table entries a CTA can hold

// The warp merge holds NW * G * (D + 2) f32 in the ring's shared memory
// and a lane at least G * D / 32 accumulator elements, so G * D is at
// most 1024: D 256 takes groups up to 4.
constexpr int kMaxGroupDims = 1024;

struct PaParams {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;          // (NB, BS, Hkp), quantized pools only
  const float* v_scale;
  const int* block_table;
  const int* lengths;
  void* o;                       // (B, Hq, D) when nsplit == 1
  float* m;                      // (B, Hq, nsplit) when nsplit > 1
  float* l;
  float* acc;                    // (B, Hq, nsplit, D)
  // Hkv: the kv heads the grid walks; Hkp: the pool's kv heads (its
  // token row stride), the pointers already at the first head read
  int Hq, Hkv, Hkp, BS, nbmax, window, bps, nsplit;
  float scale;
};

// Launch the split kernel of query type T over payload P on grid (Hkv, B,
// nsplit) for head dim D and group G; cudaErrorInvalidValue for a (D, G)
// it has no instance of, else the launch's cudaGetLastError().
template <typename T, typename P>
cudaError_t launch_split(const PaParams& p, int B, int G, int D,
                         cudaStream_t stream);

}  // namespace repro
