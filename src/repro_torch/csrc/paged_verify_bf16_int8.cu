// K3's split and wgmma bodies for bf16 queries over an int8 pool (K4), in a
// file of its own so that nvcc builds the six (query, payload) pairs in
// parallel.
#include "paged_verify_split.cuh"
#include "paged_verify_wgmma.cuh"

template cudaError_t repro::launch_pv_split<__nv_bfloat16, int8_t>(
    const repro::PvsParams&, int, int, cudaStream_t);
template cudaError_t repro::launch_pv_wgmma<int8_t>(
    const repro::PvsParams&, int, int, cudaStream_t);
