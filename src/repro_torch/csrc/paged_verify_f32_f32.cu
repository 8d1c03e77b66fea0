// K3's split body for f32 queries over an f32 pool, in a file of its own so
// that nvcc builds the six (query, payload) pairs in parallel.
#include "paged_verify_split.cuh"

template cudaError_t repro::launch_pv_split<float, float>(
    const repro::PvsParams&, int, int, cudaStream_t);
