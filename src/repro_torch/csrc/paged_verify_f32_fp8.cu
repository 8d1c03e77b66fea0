// K3's split body for f32 queries over an fp8 (e4m3) pool (K4), in a file of
// its own so that nvcc builds the six (query, payload) pairs in parallel.
#include "paged_verify_split.cuh"

template cudaError_t repro::launch_pv_split<float, __nv_fp8_e4m3>(
    const repro::PvsParams&, int, int, cudaStream_t);
